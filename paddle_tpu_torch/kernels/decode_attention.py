"""Decode-path attention over a KV cache — the shared seam of every cached
forward (greedy decode, the serving engine's slot pool).

Counterpart of paddle_tpu/kernels/decode_attention.py (dense layout).
Reference analog: the masked single-step branch of
fused_multi_transformer_op.cu. At T=1 attention is a bandwidth-bound
matvec over the cache, so it stays dense masked einsums here, as in the
reference (no Pallas kernel there to port).

The cache semantics of the reference are kept exactly, because torch
indexing does neither by default:
- a scalar `pos` write is a dynamic_update_slice, whose start CLAMPS to
  [0, S - T];
- a per-row T=1 write is a vmapped dynamic_update_slice, so each row's
  start clamps to [0, S - 1];
- a per-row T>1 write is a scatter whose out-of-range rows DROP.

Unlike the reference, which returns a new cache, `write_kv` writes the
cache in place (it is the largest buffer of the serving engine) and
returns it.

The paged layout (`gather_pages`, `write_kv_paged`) waits for the paged
serving slice.
"""
from __future__ import annotations

import math

import torch

__all__ = ["write_kv", "cached_attention", "attended_tokens"]


def _is_scalar(pos) -> bool:
    return not isinstance(pos, torch.Tensor) or pos.dim() == 0


def _query_positions(pos, B: int, T: int, device) -> torch.Tensor:
    """Absolute positions of the T queries per row -> [B, T] int64."""
    offs = torch.arange(T, device=device)[None, :]
    if _is_scalar(pos):
        return (int(pos) + offs).expand(B, T)
    return pos.to(device=device, dtype=torch.int64)[:, None] + offs


def write_kv(kc, k, pos):
    """Write the step's k (or v) [B, T, KV, hd] into the cache
    [B, S, KV, hd] at `pos` (scalar or [B]), in place; returns kc."""
    k = k.to(kc.dtype)
    B, T = k.shape[:2]
    S = kc.shape[1]
    if _is_scalar(pos):
        start = min(max(int(pos), 0), S - T)
        kc[:, start:start + T] = k
        return kc
    rows = torch.arange(B, device=kc.device)
    if T == 1:
        start = pos.to(device=kc.device, dtype=torch.int64).clamp(0, S - 1)
        kc[rows, start] = k[:, 0]
        return kc
    qpos = _query_positions(pos, B, T, kc.device)
    keep = qpos < S
    kc[rows[:, None].expand(B, T)[keep], qpos[keep]] = k[keep]
    return kc


def attended_tokens(positions, active):
    """Total cache tokens this tick's attention admits: per active row,
    positions[b] cache slots plus the current token."""
    return torch.where(active, positions + 1,
                       torch.zeros_like(positions)).sum().to(torch.int32)


def cached_attention(q, kc, vc, pos, impl: str = "dense"):
    """Masked attention of q [B, T, H, hd] against kc/vc [B, S, KV, hd];
    query t of row b sits at position pos[b] + t (pos scalar or [B]) and
    sees cache slots <= that position. GQA folds the group axis (KV < H)
    without repeating KV. Returns ctx [B, T, H, hd] float32.

    'dense' computes scores and context in f32 whatever the cache dtype;
    'mixed' runs both products in the cache dtype with an f32 softmax."""
    B, T, H, hd = q.shape
    S, KV = kc.shape[1], kc.shape[2]
    G = H // KV
    if impl not in ("dense", "mixed"):
        raise ValueError(f"unknown decode_attention impl {impl!r} "
                         "(dense|mixed)")
    dot_dt = kc.dtype if impl == "mixed" else torch.float32
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=dot_dt)
    qf = q.reshape(B, T, KV, G, hd).to(dot_dt) * scale.to(q.device)
    s = torch.einsum("btkgd,bskd->bkgts", qf, kc.to(dot_dt))
    qpos = _query_positions(pos, B, T, q.device)                   # B,T
    mask = (torch.arange(S, device=q.device)[None, None, :]
            <= qpos[..., None])[:, None, None, :, :]
    s = torch.where(mask, s.float(), torch.tensor(float("-inf"),
                                                   device=q.device))
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bkgts,bskd->btkgd",
                       p.to(dot_dt) if impl == "mixed" else p,
                       vc.to(dot_dt))
    return ctx.reshape(B, T, H, hd).float()
