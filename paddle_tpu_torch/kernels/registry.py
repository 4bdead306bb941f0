"""Evidence-gated kernel selection registry.

Counterpart of paddle_tpu/kernels/registry.py, copied (the port imports
nothing of the reference): a persistent per-(kernel, backend-class,
shape-bucket) winner table naming WHICH IMPLEMENTATION a selectable
kernel runs with, and the roofline plausibility gate that every measured
entry must pass to load or to be adopted.

Differences from the reference:
- the backend classes are "cuda" (the card) and "cpu";
- the gate's anchors are an H100's (989 TFLOP/s bf16 dense, 3.35 TB/s
  HBM3), with the reference's floors of 0.5 TFLOP/s and 20 GB/s;
- the table lives at `perf/torch_kernel_registry.json`, never at the
  reference's `perf/kernel_registry.json` (whose validation admits only
  the "tpu" and "cpu" classes). No table is committed: an absent table
  means every consult site keeps its default;
- the reference's resolution counters (`monitor.counter`) wait for the
  port's profiler (ROADMAP A7).

Entry kinds:
- `measured`: impl + ms + flops/bytes evidence; must sit inside the
  physical window (`gate_ms` returns None) to load OR to be adopted.
- `policy`: impl + human reason, no performance claim.

The consult sites read `winner(kernel, backend=...)` through this
module's namespace, so a caller can force a route in-process by
rebinding `registry.winner`, as the reference's tools/ablate_step.py
does with its own.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

# ---------------------------------------------------------------- gate
# Roofline anchors: NVIDIA H100 SXM, dense bf16 tensor-core peak and HBM3
PEAK_BF16_TFLOPS = 989.0
PEAK_HBM_GBS = 3350.0
# Below these effective rates a kernel-sized timing measures the host,
# not the card
FLOOR_TFLOPS = 0.5
FLOOR_GBS = 20.0


def plausible_ms(flops: float = 0.0, bytes_moved: float = 0.0):
    """Physical window (lo_ms, hi_ms) for ONE application of a kernel of
    known arithmetic/memory volume. lo = half the roofline time (nothing
    runs 2x faster than the roofline); hi = the time implied by the
    FLOOR_* effective rates (anything slower is a measurement artifact,
    not a slow kernel)."""
    lo_s = max(flops / (PEAK_BF16_TFLOPS * 1e12),
               bytes_moved / (PEAK_HBM_GBS * 1e9)) / 2.0
    hi_s = max(flops / (FLOOR_TFLOPS * 1e12),
               bytes_moved / (FLOOR_GBS * 1e9), 1e-6)
    return lo_s * 1e3, hi_s * 1e3


def gate_ms(ms: float, flops: float = 0.0, bytes_moved: float = 0.0):
    """None if `ms` is physically plausible for the given volumes, else a
    short reason string for the record."""
    lo, hi = plausible_ms(flops, bytes_moved)
    if ms < lo:
        return f"implausibly fast: {ms:.3f} ms < {lo:.3f} ms (2x roofline)"
    if ms > hi:
        return (f"implausibly slow: {ms:.3f} ms > {hi:.1f} ms "
                "(sub-floor effective rate; likely host-bound)")
    return None


# ------------------------------------------------------------- registry
REGISTRY_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "perf", "torch_kernel_registry.json")

BACKENDS = ("cuda", "cpu")

# selectable kernels and their legal impl names, as the reference's;
# "pallas" names the port's hand-written kernel of that route. An entry
# naming anything else is invalid.
KNOWN_IMPLS: Dict[str, tuple] = {
    "attention": ("pallas", "jax_flash", "splash", "xla"),
    # "pallas" = the two-pass CE (kernels 5 and 6: forward saving the
    # lse, backward from it), the default; "pallas_fused" = the one-pass
    # CE+grad (kernel 4), for paths that always take the gradient;
    # "jax" = the plain f32 form
    "ce": ("pallas", "jax", "pallas_fused"),
    # "jax" = the plain per-leaf AdamW (default and oracle), "pallas" =
    # one leaves_update kernel launch over a table of every leaf
    "fused_update": ("jax", "pallas"),
    "varlen_attention": ("blockwise", "dense"),
    "decode_attention": ("dense", "mixed"),
    "spec_decode": ("off", "spec"),
    "quant_matmul": ("off", "xla", "pallas"),
    "multi_tick": ("off", "scan"),
}

_DOCS: Dict[str, Optional[dict]] = {}   # path -> parsed doc (memoized)


def backend_class(device=None) -> str:
    """"cuda" for a CUDA device (or, with no device, when a card is
    present), "cpu" for everything else."""
    if device is None:
        import torch
        return "cuda" if torch.cuda.is_available() else "cpu"
    kind = device if isinstance(device, str) else device.type
    return "cuda" if kind.split(":")[0] == "cuda" else "cpu"


def seq_bucket(n: int) -> str:
    """Power-of-two shape bucket for sequence-sized dims ('S1024')."""
    b = 1
    while b < max(int(n), 1):
        b *= 2
    return f"S{b}"


def _key(kernel: str, backend: str, bucket: str) -> str:
    return f"{kernel}::{backend}::{bucket}"


def _load(path: Optional[str] = None) -> dict:
    path = path or REGISTRY_PATH
    if path not in _DOCS:
        try:
            with open(path) as f:
                _DOCS[path] = json.load(f)
        except (OSError, ValueError):
            _DOCS[path] = {}
    return _DOCS[path] or {}


def _reset() -> None:
    """Drop the memoized file reads (tests; a table written by another
    process otherwise applies from the next process)."""
    _DOCS.clear()


def _entry_problem(key: str, ent) -> Optional[str]:
    """One entry's verdict: None when well-formed AND evidence-gated,
    else the reason. One rule for load-time trust and adopt-time
    gating."""
    parts = key.split("::")
    if len(parts) != 3:
        return f"{key}: key is not kernel::backend::bucket"
    kernel, backend, _bucket = parts
    if backend not in BACKENDS:
        return f"{key}: unknown backend class {backend!r}"
    if not isinstance(ent, dict):
        return f"{key}: entry is not an object"
    impl = ent.get("impl")
    legal = KNOWN_IMPLS.get(kernel)
    if legal is not None and impl not in legal:
        return f"{key}: impl {impl!r} not one of {legal}"
    kind = ent.get("kind")
    if kind == "policy":
        if not ent.get("reason"):
            return f"{key}: policy entry with no reason"
        return None
    if kind != "measured":
        return f"{key}: kind {kind!r} is neither measured nor policy"
    ms = ent.get("ms")
    flops = float(ent.get("flops", 0.0) or 0.0)
    bytes_moved = float(ent.get("bytes_moved", 0.0) or 0.0)
    if not isinstance(ms, (int, float)) or ms <= 0:
        return f"{key}: measured entry with no ms"
    if flops <= 0 and bytes_moved <= 0:
        return (f"{key}: measured entry carries no arithmetic/memory "
                "volume, so plausibility cannot be checked")
    reason = gate_ms(float(ms), flops=flops, bytes_moved=bytes_moved)
    if reason:
        return f"{key}: {reason}"
    return None


def validate(doc: Optional[dict] = None,
             path: Optional[str] = None) -> list:
    """Every problem in the table (empty list = clean). An entry that
    fails here is never served by winner()."""
    if doc is None:
        doc = _load(path)
    return [p for key, ent in (doc.get("entries") or {}).items()
            for p in [_entry_problem(key, ent)] if p]


def winner(kernel: str, backend: Optional[str] = None,
           bucket: str = "*", path: Optional[str] = None) -> Optional[str]:
    """The registered impl for (kernel, backend class, bucket), falling
    back from the exact bucket to the '*' wildcard; None when the table
    has no trustworthy row (the consult site keeps its default)."""
    backend = backend or backend_class()
    entries = _load(path).get("entries") or {}
    for b in dict.fromkeys((bucket, "*")):
        key = _key(kernel, backend, b)
        ent = entries.get(key)
        if ent is not None and _entry_problem(key, ent) is None:
            return ent.get("impl")
    return None


def entry(kernel: str, backend: str, bucket: str = "*",
          path: Optional[str] = None) -> Optional[dict]:
    """Raw entry read (inspection/tests); no validation applied."""
    return (_load(path).get("entries") or {}).get(
        _key(kernel, backend, bucket))


def adopt(kernel: str, impl: str, ms: float, flops: float = 0.0,
          bytes_moved: float = 0.0, backend: Optional[str] = None,
          bucket: str = "*", source: str = "", window: str = "",
          path: Optional[str] = None) -> Optional[str]:
    """Persist a measured winner: the only write path, and it refuses
    anything the plausibility gate rejects. Returns None on success or
    the rejection reason (the file is then untouched). Atomic tmp +
    rename write."""
    backend = backend or backend_class()
    path = path or REGISTRY_PATH
    ent = {"impl": impl, "kind": "measured", "ms": round(float(ms), 3),
           "flops": float(flops), "bytes_moved": float(bytes_moved),
           "source": source, "window": window}
    key = _key(kernel, backend, bucket)
    problem = _entry_problem(key, ent)
    if problem:
        return problem
    doc = dict(_load(path))
    entries = dict(doc.get("entries") or {})
    entries[key] = ent
    doc["entries"] = entries
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError as e:
        return f"registry write failed: {e}"
    _DOCS[path] = doc
    return None
