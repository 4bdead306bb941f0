"""Live memory reads: the HBM gauges, a census of a step's tensors, the
process's resident bytes.

Counterpart of three functions of paddle_tpu/profiler/mem_audit.py:
`live_array_census` :186, `host_rss_bytes` :212 and `publish_hbm_gauges`
:229. The rest of that module (compiled_memory_stats, the audits of a
compiled step against the cost model's ledger) reads XLA's compiled
memory analysis, which an eager step does not have; it comes with
`profiler.cost_analysis`, which raises until then.

- `publish_hbm_gauges`: `hbm.bytes_in_use` and `hbm.peak_bytes` from
  torch.cuda.memory_allocated / max_memory_allocated, the largest over
  the local cards this process allocated on (and `.d<i>` per card where
  more than one did); the process's resident bytes where no card holds
  any (the CPU). Host-side allocator reads: no device synchronization.
- `live_array_census`: torch has no `jax.live_arrays()`, so the census
  names the tensors of trees the caller passes (a step's arguments) by
  shape, dtype and pin, with their leaf names, and adds what else the
  card's allocator holds (torch.cuda.memory_stats) as one row.
"""
from __future__ import annotations

import os
import sys
from typing import Optional

from . import monitor


def host_rss_bytes() -> Optional[int]:
    """Resident-set bytes of this process (the CPU stand-in for
    hbm.bytes_in_use)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        try:
            import resource
            return resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024
        except (ImportError, OSError):
            return None


def _card_rows():
    """(card, bytes in use, peak bytes) for each local card this process
    has allocated on; [] without CUDA, or before CUDA was initialized
    (reading a card's allocator never creates a context on it)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available() or \
            not torch.cuda.is_initialized():
        return []
    rows = []
    for i in range(torch.cuda.device_count()):
        peak = int(torch.cuda.max_memory_allocated(i))
        if peak:
            rows.append((i, int(torch.cuda.memory_allocated(i)), peak))
    return rows


def publish_hbm_gauges() -> None:
    """The `hbm.bytes_in_use` / `hbm.peak_bytes` gauges: the largest over
    the local cards (the envelope an out-of-memory error meets), with
    `.d<i>` detail where more than one card reports; the process's
    resident bytes where none does. Called at each telemetry flush."""
    rows = _card_rows()
    if rows:
        monitor.gauge("hbm.bytes_in_use").set(max(r[1] for r in rows))
        monitor.gauge("hbm.peak_bytes").set(max(r[2] for r in rows))
        if len(rows) > 1:
            for i, used, peak in rows:
                monitor.gauge(f"hbm.bytes_in_use.d{i}").set(used)
                monitor.gauge(f"hbm.peak_bytes.d{i}").set(peak)
        return
    rss = host_rss_bytes()
    if rss is None:
        return
    monitor.gauge("hbm.bytes_in_use").set(rss)
    peak_g = monitor.gauge("hbm.peak_bytes")
    peak_g.set(max(rss, int(peak_g.value)))


def _named(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def live_array_census(trees=None, pins=None, limit: int = 32) -> dict:
    """The tensors of `trees` ({name: tree}, e.g. a step's params,
    opt_state and batch) grouped by (shape, dtype, pin): {"rows": {key:
    {"count", "bytes", "leaves"}}, "total_bytes", "other_bytes"},
    byte-sorted and cut to the `limit` largest groups. `pins` ({name:
    tree of Shardings beside the tree}) gives each leaf's spec. Each
    storage counts once. Where the tensors are on a card, the row
    "allocator/other" holds what its allocator holds beyond them
    (`other_bytes`). Reads metadata only, never a tensor's values."""
    import torch
    rows: dict = {}
    total = 0
    seen = set()
    device = None
    for name, tree in (trees or {}).items():
        pin_tree = (pins or {}).get(name)
        for path, t in _named(tree):
            if not isinstance(t, torch.Tensor):
                continue
            pin = pin_tree
            for part in path.split("/") if path else ():
                pin = pin.get(part) if isinstance(pin, dict) else None
            spec = getattr(pin, "spec", None)
            key = f"{tuple(t.shape)}/{str(t.dtype).replace('torch.', '')}" \
                  f"/{spec}"
            nbytes = t.numel() * t.element_size()
            ptr = (t.device, t.untyped_storage().data_ptr())
            row = rows.setdefault(key, {"count": 0, "bytes": 0,
                                        "leaves": []})
            row["count"] += 1
            row["leaves"].append(f"{name}/{path}" if path else name)
            if ptr in seen:
                continue
            seen.add(ptr)
            row["bytes"] += nbytes
            total += nbytes
            if t.device.type == "cuda":
                device = t.device
    rows = dict(sorted(rows.items(),
                       key=lambda kv: -kv[1]["bytes"])[:int(limit)])
    other = None
    if device is not None:
        held = int(torch.cuda.memory_stats(device).get(
            "allocated_bytes.all.current", 0))
        other = max(held - total, 0)
        rows["allocator/other"] = {"count": None, "bytes": other,
                                   "leaves": []}
    return {"rows": rows, "total_bytes": total, "other_bytes": other}
