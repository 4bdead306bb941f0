"""Fused dequant-matmul for weight-only int8 serving.

Counterpart of paddle_tpu/kernels/quant_matmul.py. `quant_matmul`
computes (x @ w_q) * scale with an f32 accumulator and casts to
x.dtype: x [..., K] float, w_q [K, N] int8, scale [N] f32 (the stored
abs-max / 127 of quantization/serving.py).

- On a CUDA tensor it launches the hand-written Hopper kernel
  (csrc/quant_matmul.cu, the port of the TPU kernel
  `_pallas_quant_matmul`/`_qmm_kernel`), after checking dtype, shape,
  contiguity and device, and raises on anything else. It never falls
  back to the plain version on the card. bf16 x runs on tensor cores
  with the tile and split-K plan of `_plan` (cached per shape); the
  wrapper keeps the split-K workspace and a zeroed counter buffer per
  (device, stream), which the kernel leaves zeroed after each call.
  f32 x runs the CUDA-core kernel.
- On a CPU tensor it runs `quant_matmul_ref`, the plain PyTorch version
  of the same function (the reference's `_xla_quant_matmul`).

`launches` counts kernel launches; it moves only where the kernel is
launched, so a run can show that its path went through the kernel. A
call under CUDA graph capture only records the launch and does not
count there; it counts in `captured`, the launches recorded into
graphs, which each replay of such a graph runs once more.

Selection and the kill switch follow the reference
(paddle_tpu/kernels/quant_matmul.py:91-103): env PADDLE_TPU_QUANT >
the registry's winner for "quant_matmul" at the backend class of the
engine's device (kernels/registry.py) > off. Env off-values disable
weight-only quant even for engines built with quant="int8"; on-values
and the impl names 'xla'/'pallas' enable it; anything else warns on
stderr and counts as off (a typo must kill, not enable). Where an
engine's int8 sites run the kernel is `matmul_impl`'s: the global kill
switch PADDLE_TPU_DISABLE_PALLAS turns them into the plain version.
"""
from __future__ import annotations

import ctypes
import functools
import math
import os
import sys
from typing import NamedTuple

import torch

__all__ = ["ENV_QUANT", "quant_impl", "resolve_quant", "matmul_impl",
           "quant_matmul", "quant_matmul_ref", "leaf_matmul", "launches",
           "captured"]

ENV_QUANT = "PADDLE_TPU_QUANT"

_OFF_VALUES = frozenset({"0", "off", "false", "no", "fp", "dense"})
_ON_VALUES = frozenset({"1", "on", "true", "yes", "int8"})
_IMPL_VALUES = frozenset({"xla", "pallas"})

launches = 0
captured = 0

_SUPPORTED_X = (torch.bfloat16, torch.float32)


def _env_value() -> str:
    """Read and classify PADDLE_TPU_QUANT: '' (unset), 'off', 'xla' or
    'pallas'. Unrecognized values are 'off' with a stderr warning."""
    env = os.environ.get(ENV_QUANT, "").strip().lower()
    if not env:
        return ""
    if env in _IMPL_VALUES:
        return env
    if env in _ON_VALUES:
        return "xla"
    if env not in _OFF_VALUES:
        print(f"[quant_matmul] {ENV_QUANT}={env!r} is not one of "
              f"{sorted(_IMPL_VALUES | _ON_VALUES)} / "
              f"{sorted(_OFF_VALUES)}; treating as 'off' (the kill "
              "switch fails safe)", file=sys.stderr, flush=True)
    return "off"


def quant_impl(device=None) -> str:
    """Selector: env PADDLE_TPU_QUANT > registry winner ('quant_matmul',
    the backend class of `device`; with none, "cuda" when a card is
    present) > 'off'. Re-read at each engine build."""
    env = _env_value()
    if env:
        return env
    from . import registry
    return registry.winner("quant_matmul",
                           backend=registry.backend_class(device)) or "off"


def resolve_quant(knob: str, device=None) -> bool:
    """Engine-build resolution of the quant knob ('auto'|'off'|'int8')
    for an engine on `device`. An env off value disables quantization
    even for knob='int8'."""
    if _env_value() == "off":
        return False
    if knob == "off":
        return False
    if knob == "int8":
        return True
    if knob == "auto":
        return quant_impl(device) != "off"
    raise ValueError(f"quant {knob!r} (auto|off|int8)")


def matmul_impl(device=None) -> str:
    """Which implementation an int8 site of an engine on `device` runs
    (reference quant_matmul.py:122-139): "pallas", the kernel, on the
    card unless the global kill switch is set (env
    PADDLE_TPU_DISABLE_PALLAS or flash_attention.use_pallas), else
    "xla", the plain version `quant_matmul_ref`. It leaves quantization
    alone: an engine that quantized its weights keeps serving them. Read
    at engine build, like `quant_impl`."""
    from . import registry
    from .flash_attention import _pallas_enabled
    if registry.backend_class(device) == "cuda" and _pallas_enabled():
        return "pallas"
    return "xla"


def quant_matmul_ref(x, w_q, scale):
    """The plain version: (x @ w_q) * scale in f32, cast to x.dtype."""
    lead = x.shape[:-1]
    y = (x.reshape(-1, x.shape[-1]).float() @ w_q.float()) * scale.float()
    return y.reshape(*lead, w_q.shape[1]).to(x.dtype)


# the bf16 kernel's tile: 128 output columns a block, K in 32-row chunks
TILE_N, TILE_K = 128, 32
# at most this many blocks share one output tile over K: the serial
# reduction of more partials cost more than the SMs they filled
# (tools/torch_qmm_plan_ab.py; PERF.md, PR 5)
MAX_SPLITS = 16


class QmmPlan(NamedTuple):
    bm: int                 # rows of x a block: 8, 16 or 64
    m_tiles: int
    n_tiles: int
    chunks: int             # TILE_K-row chunks of K
    chunks_per_split: int   # chunks each split's block walks
    splits: int             # blocks that share one output tile over K
    workspace_floats: int   # f32 partials, 0 without a split


@functools.lru_cache(maxsize=256)
def _plan(M: int, K: int, N: int, sm_count: int,
          max_splits: int = MAX_SPLITS) -> QmmPlan:
    """Tile and split-K plan of the bf16 kernel for x [M, K] . w [K, N].
    Decode-sized M (<= 16 rows, bound by the weight bytes) splits K over
    enough blocks to fill one wave of `sm_count` blocks, but over no more
    than `max_splits` a tile; split s walks chunks s * chunks_per_split
    onwards, so every K row is read by exactly one block. Prefill M
    (64-row tiles, bound by operations) never splits."""
    bm = 8 if M <= 8 else 16 if M <= 16 else 64
    m_tiles, n_tiles = math.ceil(M / bm), math.ceil(N / TILE_N)
    chunks = math.ceil(K / TILE_K)
    tiles = m_tiles * n_tiles
    cps, splits = max(chunks, 1), 1
    if bm <= 16 and tiles < sm_count and chunks > 1:
        cps = max(1, chunks // math.ceil(sm_count / tiles))
        if math.ceil(chunks / cps) > max_splits:
            cps = math.ceil(chunks / max_splits)
        splits = math.ceil(chunks / cps)
    ws = tiles * splits * bm * TILE_N if splits > 1 else 0
    return QmmPlan(bm, m_tiles, n_tiles, chunks, cps, splits, ws)


_SM_COUNT: dict = {}
_SPLIT_BUFS: dict = {}
# buffers `_split_bufs` outgrew: a CUDA graph that captured a launch
# holds their addresses, so they are never freed
_RETIRED_BUFS: list = []
_ENTRIES: dict = {}


def _sm_count(dev) -> int:
    n = _SM_COUNT.get(dev.index)
    if n is None:
        n = _SM_COUNT[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def _split_bufs(dev, stream: int, plan: QmmPlan):
    """The split-K workspace (f32 partials) and one int32 counter a tile,
    kept per (device, stream) and grown as needed, so the hot path
    allocates nothing. The counters are zero between calls (the kernel's
    last block of each tile resets its counter); calls on one stream run
    in order, so they share both, and calls on two streams never race.
    A buffer replaced by a larger one stays allocated (`_RETIRED_BUFS`):
    a CUDA graph may have baked its address."""
    key = (dev.index, stream)
    ws, ctr = _SPLIT_BUFS.get(key, (None, None))
    tiles = plan.m_tiles * plan.n_tiles
    if ws is None or ws.numel() < plan.workspace_floats:
        if ws is not None:
            _RETIRED_BUFS.append(ws)
        ws = torch.empty(max(plan.workspace_floats, 1 << 16),
                         dtype=torch.float32, device=dev)
    if ctr is None or ctr.numel() < tiles:
        if ctr is not None:
            _RETIRED_BUFS.append(ctr)
        ctr = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=dev)
    _SPLIT_BUFS[key] = (ws, ctr)
    return ws, ctr


def _entry(name: str):
    """The library's C entry point `name`, its ctypes signature set once."""
    fn = _ENTRIES.get(name)
    if fn is None:
        from . import _build
        fn = getattr(_build.load("quant_matmul"), name)
        if name == "quant_matmul_bf16":
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn


def _launch(x2d, w_q, scale, plan=None):
    """Launch the kernel; `plan` overrides `_plan`'s (the split A/B tool
    times other plans through it)."""
    global launches, captured
    M, K = x2d.shape
    N = w_q.shape[1]
    dev = x2d.device
    y = torch.empty((M, N), dtype=x2d.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if x2d.dtype == torch.bfloat16:
            plan = plan or _plan(M, K, N, _sm_count(dev))
            ws = ctr = None
            if plan.splits > 1:
                ws, ctr = _split_bufs(dev, stream, plan)
            err = _entry("quant_matmul_bf16")(
                x2d.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                y.data_ptr(), None if ws is None else ws.data_ptr(),
                None if ctr is None else ctr.data_ptr(), M, K, N,
                plan.bm, plan.chunks_per_split, plan.splits, stream)
        else:
            err = _entry("quant_matmul_f32")(
                x2d.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                y.data_ptr(), M, K, N, stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error "
                           f"{err} at M={M} K={K} N={N}")
    # a launch under CUDA graph capture is recorded, not run: the graph's
    # replays run it, and the engine counts those (counters
    # "graph_replays")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return y


def _check_cuda_operands(x, w_q, scale) -> None:
    dev = x.device
    for name, t in (("w_q", w_q), ("scale", scale)):
        if t.device != dev:
            raise ValueError(f"quant_matmul: {name} on {t.device}, x on "
                             f"{dev}")
    if x.dtype not in _SUPPORTED_X:
        raise TypeError(f"quant_matmul: x dtype {x.dtype} (bfloat16|float32)")
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"quant_matmul: w_q {w_q.dtype} / scale "
                        f"{scale.dtype} (int8 / float32)")
    if w_q.dim() != 2 or scale.dim() != 1 or scale.shape[0] != w_q.shape[1] \
            or x.shape[-1] != w_q.shape[0]:
        raise ValueError(f"quant_matmul: shapes x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)}, scale {tuple(scale.shape)}")
    for name, t in (("x", x), ("w_q", w_q), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"quant_matmul: {name} is not contiguous")


def quant_matmul(x, w_q, scale):
    """y = x @ dequant(w_q): [..., K] x [K, N] -> [..., N] in x.dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise."""
    if x.device.type == "cpu":
        return quant_matmul_ref(x, w_q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    _check_cuda_operands(x, w_q, scale)
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    if x2d.shape[0] == 0 or w_q.shape[1] == 0:
        return x.new_zeros(*lead, w_q.shape[1])
    return _launch(x2d, w_q, scale).reshape(*lead, w_q.shape[1])


def leaf_matmul(x, leaves, name: str, qmm=quant_matmul):
    """x [B, T, K] @ leaf `name` [K, N]: the fp einsum when the tree holds
    the fp weight, `qmm` (the fused dequant-matmul) when it holds the
    int8 pair `<name>_q` + `<name>_scale`."""
    w_q = leaves.get(name + "_q")
    if w_q is not None:
        return qmm(x, w_q, leaves[name + "_scale"])
    return torch.einsum("btk,kn->btn", x, leaves[name].to(x.dtype))
