"""Threefry-2x32 random bits: the plain version and the Hopper kernel's
wrapper, under the serving sampler's draws (inference/prng.py).

The reference draws its sampling noise through jax.random (threefry,
partitionable bits) inside XLA (paddle_tpu/inference/serving.py
:530-556); it has no Pallas kernel for it.

- `threefry2x32(k1, k2, x1, x2)`: the hash (jax._src.prng
  `_threefry2x32_lowering`) as int64 torch ops masked to 32 bits, on
  Python ints or tensors broadcast together: 20 rounds in five groups
  of four, rotations (13, 15, 26, 6) / (17, 29, 16, 24), the key
  schedule (k1, k2, k1 ^ k2 ^ 0x1BD11BDA) injected after each group.
  Exact on any device.
- `bits_ref(k1, k2, n, fold=())`: the plain version of a batched draw:
  int64 [rows, n] of the two output words xored, over counters
  (j >> 32, j & 0xffffffff) for j < n, one key a row: (k1, k2) (Python
  ints, one key for every row, or int64 [rows] tensors) folded in with
  each of `fold`'s int [rows] tensors in turn, fold_in(key, d) being
  threefry2x32(key, (0, d)).
- `bits(k1, k2, n, fold=())`: the same draw. CPU tensors run
  `bits_ref`; CUDA tensors launch `threefry_bits_kernel` of
  csrc/threefry.cu (one launch, the fold_ins included, in place of the
  plain version's ~170 elementwise ones a hash) after checking its
  operands, or raise. `launches["threefry_bits"]` counts kernel
  launches; one recorded under CUDA graph capture counts in `captured`
  instead (the graph's replays run it).
"""
import ctypes

import torch

__all__ = ["threefry2x32", "bits_ref", "bits", "launches", "captured"]

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

launches = {"threefry_bits": 0}
captured = 0


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of the counts (x1, x2) under the key
    (k1, k2); every operand a Python int or an int64 tensor of 32-bit
    values, broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & M32
    b = (x2 + ks[1]) & M32
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            a = (a + b) & M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(group + 1) % 3]) & M32
        b = (b + ks[(group + 2) % 3] + group + 1) & M32
    return a, b


def _fold(k1, k2, fold):
    for d in fold:
        k1, k2 = threefry2x32(k1, k2, 0, d.long() & M32)
    return k1, k2


def _rows(k1, k2, fold):
    tensors = [t for t in (k1, k2, *fold) if isinstance(t, torch.Tensor)]
    if not tensors:
        raise ValueError("threefry bits: no tensor gives the rows")
    return tensors[0]


def bits_ref(k1, k2, n: int, fold=()):
    """(k1, k2) Python ints or int64 [rows], `fold` int [rows] tensors ->
    int64 [rows, n]: row i's draw of n partitionable random bits under
    its key folded in with each fold tensor's row i."""
    like = _rows(k1, k2, fold)
    k1, k2 = _fold(k1, k2, fold)
    rows = like.shape[0]
    k1, k2 = (w.expand(rows) if isinstance(w, torch.Tensor)
              else torch.full((rows,), w, dtype=torch.int64,
                              device=like.device) for w in (k1, k2))
    idx = torch.arange(n, dtype=torch.int64, device=like.device)
    w0, w1 = threefry2x32(k1[:, None], k2[:, None], idx >> 32, idx & M32)
    return w0 ^ w1


def _check_operands(k1, k2, n, fold):
    like = _rows(k1, k2, fold)
    if isinstance(k1, torch.Tensor) != isinstance(k2, torch.Tensor):
        raise TypeError("threefry bits: k1 and k2 both tensors or both "
                        "ints")
    if len(fold) > 2:
        raise ValueError(f"threefry bits: {len(fold)} folds, the kernel "
                         "takes at most 2")
    for name, t in (("k1", k1), ("k2", k2)):
        if isinstance(t, torch.Tensor):
            if t.dtype != torch.int64 or t.dim() != 1:
                raise TypeError(f"threefry bits: {name} {t.dtype} "
                                f"{tuple(t.shape)}, want int64 [rows]")
        elif not 0 <= t <= M32:
            raise ValueError(f"threefry bits: {name} {t} is no 32-bit word")
    for name, t in [("k1", k1), ("k2", k2)] + [
            (f"fold[{i}]", d) for i, d in enumerate(fold)]:
        if not isinstance(t, torch.Tensor):
            continue
        if t.dtype not in (torch.int32, torch.int64) or t.dim() != 1:
            raise TypeError(f"threefry bits: {name} {t.dtype} "
                            f"{tuple(t.shape)}, want an int [rows]")
        if t.device != like.device or t.shape != like.shape:
            raise ValueError(f"threefry bits: {name} {tuple(t.shape)} on "
                             f"{t.device}, want {tuple(like.shape)} on "
                             f"{like.device}")
    if n < 0:
        raise ValueError(f"threefry bits: n {n}")


def bits(k1, k2, n: int, fold=()):
    """`bits_ref`'s draw: the plain version on CPU tensors, the kernel
    on CUDA tensors (or raise)."""
    global captured
    like = _rows(k1, k2, fold)
    if like.device.type == "cpu":
        return bits_ref(k1, k2, n, fold)
    if like.device.type != "cuda":
        raise ValueError(f"threefry bits: unsupported device {like.device}")
    _check_operands(k1, k2, n, fold)
    from . import _build
    fn = _build.load("threefry").threefry_bits
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_uint] * 2 + [
        ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    keyed = isinstance(k1, torch.Tensor)
    if keyed:
        k1, k2 = k1.contiguous(), k2.contiguous()
    # the low 32 bits of each datum, as fold_in masks them
    data = [d.to(torch.int32).contiguous() for d in fold]
    data += [None] * (2 - len(data))
    rows = like.shape[0]
    out = torch.empty((rows, n), dtype=torch.int64, device=like.device)
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream(like.device).cuda_stream
        err = fn(k1.data_ptr() if keyed else None,
                 k2.data_ptr() if keyed else None,
                 0 if keyed else k1, 0 if keyed else k2,
                 *(None if d is None else d.data_ptr() for d in data),
                 out.data_ptr(), rows, n, stream)
    if err != 0:
        raise RuntimeError(f"threefry bits kernel launch failed: CUDA error "
                           f"{err} at rows={rows} n={n}")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches["threefry_bits"] += 1
    return out
