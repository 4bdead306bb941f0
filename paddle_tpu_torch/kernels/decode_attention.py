"""Decode-path attention over a KV cache — the shared seam of every cached
forward (greedy decode, the serving engine's slot pool).

Counterpart of paddle_tpu/kernels/decode_attention.py.
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

The paged layout (vLLM's PagedAttention block pool) is the reference's
too: K/V live in pages [P, page_size, KV, hd] shared by every slot, a
per-slot table [B, max_pages] maps logical positions to pages,
`gather_pages` re-linearizes a slot's view so the attention math (and
the stream) is that of the dense cache, and `write_kv_paged` scatters
the step's K/V through the table, in place. Page 0 is scratch: freed
table entries and positions past the table land there, and the position
mask never admits it. Many rows may write page 0 in one call; which
write wins is left open (a plain `index_put_`, never an accumulate).

Selection: `decode_attn_impl(device)` is env PADDLE_TPU_DECODE_ATTN_IMPL
> the registry winner "decode_attention" for the device's backend class
> "dense"; "paged" picks the cache LAYOUT, and a paged view runs the
dense f32 math (`attn_math_impl`).
"""
from __future__ import annotations

import math
import os

import torch

__all__ = ["write_kv", "cached_attention", "attended_tokens",
           "decode_attn_impl", "attn_math_impl", "gather_pages",
           "write_kv_paged", "kv_view_extent", "write_and_attend",
           "cache_pspecs"]

ENV_DECODE_ATTN = "PADDLE_TPU_DECODE_ATTN_IMPL"


def decode_attn_impl(device=None) -> str:
    """Selector: env PADDLE_TPU_DECODE_ATTN_IMPL > registry winner
    'decode_attention' (the backend class of `device`) > 'dense'."""
    env = os.environ.get(ENV_DECODE_ATTN)
    if env:
        return env
    from . import registry
    return registry.winner("decode_attention",
                           backend=registry.backend_class(device)) or "dense"


def attn_math_impl(impl=None, device=None) -> str:
    """The attention math of a selector value: 'paged' is a cache
    layout, and its gathered view runs the 'dense' f32 math."""
    impl = impl or decode_attn_impl(device)
    return "dense" if impl == "paged" else impl


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
    # no boolean mask (a mask index is a nonzero, a host sync that CUDA
    # graph capture refuses): a token past S is redirected to S - 1 with
    # the value that already lands there, the row's token at S - 1 or,
    # when the whole window is past S, the cache's own old value, so
    # duplicate indices carry equal bits and nothing past S is written
    qpos = _query_positions(pos, B, T, kc.device)
    dst = qpos.clamp(max=S - 1)
    src = (dst - qpos[:, :1]).clamp(min=0)
    vals = k[rows[:, None], src]
    vals = torch.where((qpos[:, :1] < S)[..., None, None], vals,
                       kc[rows, S - 1][:, None])
    kc[rows[:, None].expand(B, T), dst] = vals
    return kc


def gather_pages(pages, table):
    """Per-slot cache views from the page pool: pages [P, page_size, KV,
    hd], table [B, max_pages] of page ids -> [B, max_pages * page_size,
    KV, hd], view index p holding what was written at logical position
    p. Unmapped entries show the scratch page, which the mask hides."""
    B, mp = table.shape
    v = pages.index_select(0, table.reshape(-1).long())
    return v.reshape(B, mp * pages.shape[1], *pages.shape[2:])


def _page_slots(pages, table, pos, B: int, T: int):
    """(page ids, offsets), each [B * T], where the T tokens of each row
    at pos(+t) land: (table[b, p // page_size], p % page_size), or the
    scratch page 0 for a position past the table (never a clamp onto a
    tail page)."""
    ps, mp = pages.shape[1], table.shape[1]
    qpos = _query_positions(pos, B, T, pages.device)               # B,T
    raw = qpos // ps
    page_id = table.to(pages.device).long().gather(1, raw.clamp(0, mp - 1))
    page_id = torch.where(raw < mp, page_id, 0)
    return page_id.reshape(-1), (qpos % ps).reshape(-1)


def write_kv_paged(pages, table, k, pos):
    """Scatter the step's k (or v) [B, T, KV, hd] into the page pool
    [P, page_size, KV, hd] through the table [B, max_pages], in place;
    returns pages (slots as `_page_slots`)."""
    B, T = k.shape[:2]
    pages[_page_slots(pages, table, pos, B, T)] = \
        k.to(pages.dtype).reshape(B * T, *k.shape[2:])
    return pages


def write_and_attend(q, k, v, kc, vc, pos, pt=None, kv_heads=None):
    """One layer's cache step, write then attend, in either layout:
    dense kc/vc [B, S, KV, hd], or pages [P, page_size, KV, hd] with the
    table `pt` [B, max_pages]. Returns ctx [B, T, H, hd] float32.
    `kv_heads` [a, b): the queries attend only those KV heads of the
    cache (a tensor-parallel rank whose cache stays whole while it owns
    a share of the query heads); all of them by default."""
    def heads(c):
        return c if kv_heads is None else c.narrow(
            2, kv_heads[0], kv_heads[1] - kv_heads[0])

    if pt is None:
        write_kv(kc, k, pos)
        write_kv(vc, v, pos)
        return cached_attention(q, heads(kc), heads(vc), pos)
    B, T = k.shape[:2]
    slots = _page_slots(kc, pt, pos, B, T)        # shared by k and v
    kc[slots] = k.to(kc.dtype).reshape(B * T, *k.shape[2:])
    vc[slots] = v.to(vc.dtype).reshape(B * T, *v.shape[2:])
    return cached_attention(q, gather_pages(heads(kc), pt),
                            gather_pages(heads(vc), pt), pos)


def cache_pspecs(paged: bool, tp_axis: str = "tp"):
    """The specs of the decode cache's leaves on a tensor-parallel serving
    mesh (inference/serving.py `mesh=`). Both layouts are rank 5 with
    the KV-head axis at position 3, dense [L, N, max_len, KV, hd] and
    paged [L, P, page_size, KV, hd], so one spec head-shards either:
    each rank holds every slot's (or page's) full position range for
    its heads, which keeps the writes and the page gather local. The
    page table stays whole: it indexes pages, not heads. Where tp does
    not divide KV (deep GQA, MQA), the engine's shape-aware degrade
    (parallel.mesh.sharding_for with shape=) keeps the leaf whole on
    every rank, as the reference's does."""
    from ..parallel.mesh import P
    kv = P(None, None, None, tp_axis, None)
    specs = {"k": kv, "v": kv}
    if paged:
        specs["pt"] = P()
    return specs


def kv_view_extent(paged: bool, max_len: int, max_pages: int = 0,
                   page_size: int = 0) -> int:
    """The per-row cache positions one decode-attention call reads: the
    dense row's max_len, or the paged view's max_pages * page_size."""
    return max_pages * page_size if paged else max_len


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
    'mixed' runs both products in the cache dtype with an f32 softmax;
    'paged' (a gathered view) runs the dense math."""
    B, T, H, hd = q.shape
    S, KV = kc.shape[1], kc.shape[2]
    G = H // KV
    impl = attn_math_impl(impl)
    if impl not in ("dense", "mixed"):
        raise ValueError(f"unknown decode_attention impl {impl!r} "
                         "(dense|mixed|paged)")
    dot_dt = kc.dtype if impl == "mixed" else torch.float32
    # built on the device: a host tensor here would be an upload inside
    # the tick, which CUDA graph capture refuses
    scale = torch.full((), 1.0 / math.sqrt(hd), dtype=dot_dt,
                       device=q.device)
    qf = q.reshape(B, T, KV, G, hd).to(dot_dt) * scale
    s = torch.einsum("btkgd,bskd->bkgts", qf, kc.to(dot_dt))
    qpos = _query_positions(pos, B, T, q.device)                   # B,T
    mask = (torch.arange(S, device=q.device)[None, None, :]
            <= qpos[..., None])[:, None, None, :, :]
    s = s.float().masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bkgts,bskd->btkgd",
                       p.to(dot_dt) if impl == "mixed" else p,
                       vc.to(dot_dt))
    return ctx.reshape(B, T, H, hd).float()
