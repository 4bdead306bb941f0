"""The port's threefry sampling: its own copy of what the reference's
serving sampler (paddle_tpu/inference/serving.py `_slot_keys` and
`_sample`, :530-556) draws through `jax.random`, on jax 0.9.0's
defaults: the threefry2x32 implementation (`jax_default_prng_impl`),
partitionable random bits (`jax_threefry_partitionable` True), and the
"low" Gumbel mode of `jax.random.categorical`.

- `threefry2x32(k1, k2, x1, x2)`: the Threefry-2x32 hash
  (jax._src.prng `_threefry2x32_lowering`), kernels/threefry.py's;
- `prng_key(seed)`: `jax.random.PRNGKey` (the seed's high and low 32
  bits) as two Python ints;
- `fold_in(key, data)`: threefry2x32 of the key over the count
  (0, data), as `threefry_seed(data)` lays it out;
- `random_bits(key, shape, fold=())`: the partitionable draw
  (`_threefry_random_bits_partitionable`): each element's flat index
  split into hi and lo 32-bit counters, hashed, the two halves xored,
  under the key folded in with each of `fold`'s [N] tensors (a batch of
  keys), through kernels/threefry.py `bits` (on the card one launch of
  the hand kernel for the whole batch, the fold_ins included, on the
  CPU the plain version);
- `uniform(key, shape, minval, fold=())`: `jax._src.random._uniform`
  in f32: the top 23 bits as the mantissa of a float in [1, 2), minus
  1, scaled to [minval, 1) and clamped to minval;
- `gumbel(key, shape, fold=())`: -log(-log(u)) over u = uniform(tiny);
- `categorical(key, logits)`: argmax over the last dim of logits plus
  the Gumbel noise drawn over the logits' last-dim shape.

A key is a pair (k1, k2) of Python ints or of int64 tensors holding
32-bit values (a batch of keys: one [N] tensor each). The hash is exact
on any device (int64 ops masked to 32 bits on the CPU, 32-bit unsigned
words in the kernel), and with tensor keys nothing reads a value back
to the host: a sampler built on it stays capture-safe inside a CUDA
graph.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ..kernels.threefry import bits, threefry2x32

__all__ = ["threefry2x32", "prng_key", "fold_in", "random_bits",
           "uniform", "gumbel", "categorical"]

M32 = 0xFFFFFFFF
_F32_TINY = torch.finfo(torch.float32).tiny

Word = Union[int, torch.Tensor]


def prng_key(seed: int) -> Tuple[int, int]:
    """jax.random.PRNGKey(seed) for a seed in [0, 2^64): (high, low)."""
    seed = int(seed)
    return (seed >> 32) & M32, seed & M32


def fold_in(key, data: Word):
    """jax.random.fold_in(key, data): data a Python int or an int tensor
    (a batch of keys, one a row)."""
    if isinstance(data, torch.Tensor):
        data = data.long() & M32
    return threefry2x32(key[0], key[1], 0, data)


def random_bits(key, shape: Sequence[int], device=None, fold=()
                ) -> torch.Tensor:
    """32 random bits a draw over `shape` (jax.random.bits): an int64
    tensor of [*key batch, *shape] values in [0, 2^32). `fold`: int [N]
    tensors, each folded into the key in turn (a batch of N keys,
    fold_in(...fold_in(key, fold[0])..., fold[-1]) a row), in the same
    launch as the draw on the card. Python-int key words with no fold
    draw on `device` (default: the CPU)."""
    n = math.prod(int(d) for d in shape)
    fold = tuple(fold)
    words = [w for w in (*key, *fold) if isinstance(w, torch.Tensor)]
    if fold:
        k1, k2 = (w.reshape(-1).long() if isinstance(w, torch.Tensor)
                  else w for w in key)
        fold = tuple(d.reshape(-1) for d in fold)
        lead = tuple(torch.broadcast_shapes(*(w.shape for w in words)))
    elif words:
        k1, k2 = torch.broadcast_tensors(*(
            w if isinstance(w, torch.Tensor) else torch.full_like(
                words[0], w) for w in key))
        lead = tuple(k1.shape)
        k1, k2 = (w.reshape(-1).long().contiguous() for w in (k1, k2))
    else:
        k1, k2 = (torch.tensor([w], dtype=torch.int64, device=device)
                  for w in key)
        lead = ()
    out = bits(k1, k2, n, fold)
    return out.reshape(lead + tuple(int(d) for d in shape))


def uniform(key, shape: Sequence[int], minval: float = 0.0, device=None,
            fold=()) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, 1.0), under the
    key folded in with `fold` (random_bits)."""
    bits = random_bits(key, shape, device, fold)
    # the mantissa's 23 bits under the exponent of 1.0
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    # minval and the span (1 - minval, rounded to f32) as f32 values,
    # on the host (no tensor, so no device sync); a float tensor's op
    # with a Python scalar computes in the tensor's dtype
    lo = float(np.float32(minval))
    span = float(np.float32(1.0) - np.float32(lo))
    return torch.clamp_min((f - 1.0) * span + lo, lo)


def gumbel(key, shape: Sequence[int], device=None, fold=()) -> torch.Tensor:
    """jax.random.gumbel(key, shape, float32) in its "low" mode, under
    the key folded in with `fold` (random_bits)."""
    u = uniform(key, shape, minval=_F32_TINY, device=device, fold=fold)
    return -torch.log(-torch.log(u))


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """jax.random.categorical(key, logits) over the last dim: the index
    of the largest logits + Gumbel noise, the noise drawn over the last
    dim's shape with `key` (a batch of keys: one per leading row)."""
    g = gumbel(key, (logits.shape[-1],), device=logits.device)
    return torch.argmax(g + logits, dim=-1)
