"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
nvcc, at first use, into `build/kernels/lib<name>-<hash>.so` at the
repository root (`build/` is git-ignored), then loaded with ctypes. The
file name carries a hash of the source and flags, so an edited kernel
never loads a stale library. nvcc's -Xptxas -v report is kept beside
the library (`<library>.ptxas.txt`), so a process that finds the
library already built still reads its registers and spills.
`build(...)` starts one nvcc per source, all at once, and waits for all
of them.

Nothing here runs at import time: the CPU tests import every module of
the port on a host without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["KERNELS", "build", "load", "build_logs", "NVCC_FLAGS"]

# every csrc/<name>.cu of the port
KERNELS = ("quant_matmul", "flash_attention", "fused_ce", "fused_update",
           "threefry")

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

# name -> {"seconds": build wall time (0 when cached), "cached": whether
# the library was built before this call, "ptxas": nvcc's -Xptxas -v report}
build_logs: dict = {}
_LIBS: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the CUDA "
                       "kernels of paddle_tpu_torch are built on first use")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _report_path(lib: Path) -> Path:
    return lib.with_name(lib.name + ".ptxas.txt")


def build(*names: str) -> None:
    """Compile every named kernel whose library or ptxas report is
    missing, one nvcc process per source, all started together. Every
    name ends with its entry in `build_logs`, cached or not."""
    todo = []
    for name in names:
        lib = _lib_path(name)
        report = _report_path(lib)
        if lib.exists() and report.exists():
            build_logs.setdefault(name, {"seconds": 0.0, "cached": True,
                                         "ptxas": report.read_text()})
        else:
            todo.append(name)
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = {"seconds": time.perf_counter() - t0,
                            "cached": False, "ptxas": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        report = tmp.with_name(tmp.name + ".ptxas")
        report.write_text(log)
        os.replace(report, _report_path(out))   # before the library
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build(name)
        lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib
