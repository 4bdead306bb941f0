"""The port's kernel build (kernels/_build.py) on a host without nvcc: a
stand-in compiler that writes a library and a -Xptxas -v style report
shows that the report is kept beside the library, read back when the
library is cached (so chip_smoke.py's spill check holds on a warm build),
rebuilt when it is missing, and that a failed build raises and leaves
nothing to load.
"""
import importlib.util
import pathlib
import sys

import pytest

from paddle_tpu_torch.kernels import _build

REPORT = """\
ptxas info    : Compiling entry function '_Z19flash_bwd_dq_kernelILi64EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z19flash_bwd_dq_kernelILi64EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers
ptxas info    : Compiling entry function '_Z20flash_bwd_dkv_kernelILi64EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z20flash_bwd_dkv_kernelILi64EEvv
    0 bytes stack frame, {spill} bytes spill stores, 0 bytes spill loads
ptxas info    : Used 166 registers
"""

FAKE_NVCC = """\
import pathlib, sys
args = sys.argv[1:]
calls = pathlib.Path({calls!r})
calls.write_text(calls.read_text() + "x")
sys.stdout.write({report!r})
if {fail!r}:
    sys.exit(1)
pathlib.Path(args[args.index("-o") + 1]).write_bytes(b"library")
"""


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """Point the build at a fresh directory and a stand-in nvcc; returns
    a function that installs it (spill bytes, failure) and one that
    counts its runs."""
    calls = tmp_path / "calls"
    calls.write_text("")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "build_logs", {})

    def install(spill=0, fail=False):
        script = tmp_path / "nvcc"
        script.write_text(f"#!{sys.executable}\n" + FAKE_NVCC.format(
            calls=str(calls), report=REPORT.format(spill=spill),
            fail=fail))
        script.chmod(0o755)
        monkeypatch.setattr(_build, "_nvcc", lambda: str(script))

    return install, lambda: len(calls.read_text())


def test_cached_library_keeps_its_ptxas_report(fake_nvcc, monkeypatch):
    install, runs = fake_nvcc
    install()
    _build.build("flash_attention")
    first = _build.build_logs["flash_attention"]
    assert runs() == 1 and not first["cached"]
    lib = _build._lib_path("flash_attention")
    assert lib.read_bytes() == b"library"
    # a later process: no log in memory, the library on disk
    monkeypatch.setattr(_build, "build_logs", {})
    _build.build("flash_attention")
    again = _build.build_logs["flash_attention"]
    assert runs() == 1 and again["cached"]
    assert again["ptxas"] == first["ptxas"]
    _chip_smoke().check_no_spills(again["ptxas"])


def test_cached_report_still_shows_spills(fake_nvcc, monkeypatch):
    install, runs = fake_nvcc
    install(spill=24)
    _build.build("flash_attention")
    monkeypatch.setattr(_build, "build_logs", {})
    _build.build("flash_attention")
    assert runs() == 1
    with pytest.raises(AssertionError, match="spills"):
        _chip_smoke().check_no_spills(
            _build.build_logs["flash_attention"]["ptxas"])


def test_library_without_report_is_rebuilt(fake_nvcc, monkeypatch):
    install, runs = fake_nvcc
    install()
    _build.build("flash_attention")
    lib = _build._lib_path("flash_attention")
    _build._report_path(lib).unlink()
    monkeypatch.setattr(_build, "build_logs", {})
    _build.build("flash_attention")
    assert runs() == 2
    assert not _build.build_logs["flash_attention"]["cached"]
    assert _build._report_path(lib).read_text() == \
        _build.build_logs["flash_attention"]["ptxas"]


def test_failed_build_raises_and_leaves_nothing_to_load(fake_nvcc):
    install, runs = fake_nvcc
    install(fail=True)
    with pytest.raises(RuntimeError, match="nvcc exited 1"):
        _build.build("flash_attention")
    lib = _build._lib_path("flash_attention")
    assert runs() == 1
    assert not lib.exists() and not _build._report_path(lib).exists()
    assert list(lib.parent.iterdir()) == []
