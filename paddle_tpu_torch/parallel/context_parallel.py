"""Context parallelism: ring attention and Ulysses all-to-all, over the
'sp' mesh axis.

Counterpart of paddle_tpu/parallel/context_parallel.py (`_chunk_update`
:35, the forward ring :62, the backward ring :96, `ulysses_attention_local`
:165, `_pad_seq` / `_cp_call` :189-211, `ring_attention` /
`ulysses_attention` :213-227). Paddle itself has neither (SURVEY.md
§2.5).

- Ring: each rank holds one sequence chunk of q, k and v. Each step
  updates an online softmax (m, l, acc), all in f32, against the k/v
  chunk the rank holds, then passes that chunk to the next rank of the
  ring (`collective.exchange`: one hop). The backward is a second ring
  that passes (k, v) and the chunk's (dk, dv) together, so each chunk's
  gradient is home after n hops. Both are one torch.autograd.Function.
  The reference's ring steps n times and rotates after each; here a
  chunk that the causal or kv_len mask hides wholly is skipped (its
  update leaves (m, l, acc) exactly as they are) and the last forward
  hop, whose chunk nobody reads, is not made. k and v travel in their
  own dtype and are widened to f32 on arrival (exact); dk and dv in f32.
- Ulysses: `all_to_all` re-shards [B, S/n, H, D] -> [B, S, H/n, D]
  (heads sharded instead of the sequence), attention runs on the whole
  sequence for the rank's heads through `attn` (GPT passes its
  `flash_attention_fn`: the hand kernels on the card), and a second
  all-to-all brings the output back to sequence chunks. H must be a
  multiple of n.

`ring_attention` and `ulysses_attention` take q/k/v [B, S, H, D] that
every rank of the 'sp' group holds alike (the reference's arrays, whose
sequence GSPMD shards), as the GPT step computes everything outside
attention: each enters through `copy_to` (its gradient summed over the
group), any S is padded to a multiple of n and masked with kv_len, each
rank takes its chunk, and the output leaves through an all-gather whose
backward keeps the rank's slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .collective import (all_to_all, copy_to, exchange, gather_from,
                         group_size)

__all__ = ["ring_attention", "ulysses_attention", "ring_attention_local",
           "ulysses_attention_local"]


def _rank(group) -> int:
    if group is None:
        return 0
    import torch.distributed as dist
    return dist.get_rank(group)


def _hop(t, group):
    """t passed one step along the ring (rank i to i + 1): what rank
    i - 1 held."""
    n = group_size(group)
    if n == 1:
        return t
    me = _rank(group)
    slot = [(i, (i + 1) % n) for i in range(n)]
    got = exchange(slot, {(me, (me + 1) % n): t}, group, t.shape, t.dtype,
                   t.device)
    return got[((me - 1) % n, me)]


def _hidden(q_off, k_off, Sq, causal, kv_len) -> bool:
    """Whether the mask hides every (query, key) pair of a chunk."""
    if kv_len is not None and k_off >= kv_len:
        return True
    return bool(causal) and k_off > q_off + Sq - 1


def _mask(s, q_off, k_off, causal, kv_len, fill):
    Sq, Sc = s.shape[-2:]
    kpos = k_off + torch.arange(Sc, device=s.device)
    keep = torch.ones(Sq, Sc, dtype=torch.bool, device=s.device)
    if kv_len is not None:
        keep = keep & (kpos < kv_len)[None, :]
    if causal:
        qpos = q_off + torch.arange(Sq, device=s.device)
        keep = keep & (qpos[:, None] >= kpos[None, :])
    return s.masked_fill(~keep, fill)


def _chunk_update(carry, q, k, v, q_off, k_off, causal, kv_len=None):
    """One online-softmax update of (m, l, acc) against a k/v chunk
    (reference :35). q [B, H, Sq, D] f32, pre-scaled by 1/sqrt(D); k, v
    [B, H, Sc, D] f32; q_off, k_off the chunks' global positions."""
    m, l, acc = carry
    s = _mask(q @ k.transpose(-1, -2), q_off, k_off, causal, kv_len,
              -math.inf)
    m_new = torch.maximum(m, s.amax(-1))
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isneginf(s), 0.0, p)
    corr = torch.exp(torch.where(torch.isneginf(m), 0.0, m) - m_safe)
    corr = torch.where(torch.isneginf(m), 0.0, corr)
    l_new = l * corr + p.sum(-1)
    acc_new = acc * corr[..., None] + p @ v
    return m_new, l_new, acc_new


def _ring_fwd(q, k, v, group, causal, kv_len):
    """Forward ring (reference :62): local q, k, v [B, Sl, H, D] ->
    (out [B, Sl, H, D] in q's dtype, lse [B, H, Sl] f32)."""
    B, Sl, H, D = q.shape
    n, idx = group_size(group), _rank(group)
    qt = q.transpose(1, 2).float() * (1.0 / math.sqrt(D))
    kv = torch.stack([k, v])
    m = torch.full((B, H, Sl), -math.inf, device=q.device)
    l = torch.zeros((B, H, Sl), device=q.device)
    acc = torch.zeros((B, H, Sl, D), device=q.device)
    for s in range(n):
        src = (idx - s) % n
        if not _hidden(idx * Sl, src * Sl, Sl, causal, kv_len):
            kt, vt = (t.transpose(1, 2).float() for t in kv.unbind(0))
            m, l, acc = _chunk_update((m, l, acc), qt, kt, vt, idx * Sl,
                                      src * Sl, causal, kv_len)
        if s < n - 1:
            kv = _hop(kv, group)
    l_safe = l.clamp(min=1e-37)
    out = (acc / l_safe[..., None]).to(q.dtype)
    lse = torch.where(torch.isneginf(m), -math.inf, m + torch.log(l_safe))
    return out.transpose(1, 2), lse


def _ring_bwd(q, k, v, out, lse, do, group, causal, kv_len):
    """Backward ring (reference :96): (k, v) and their (dk, dv) pass
    together, so dk and dv are home after n hops."""
    B, Sl, H, D = q.shape
    n, idx = group_size(group), _rank(group)
    scale = 1.0 / math.sqrt(D)
    qt = q.transpose(1, 2).float()
    dot = do.transpose(1, 2).float()
    delta = (dot * out.transpose(1, 2).float()).sum(-1)        # [B, H, Sl]
    dq = torch.zeros_like(qt)
    kv = torch.stack([k, v])
    dkv = torch.zeros((2, B, H, Sl, D), device=q.device)
    for s in range(n):
        src = (idx - s) % n
        if not _hidden(idx * Sl, src * Sl, Sl, causal, kv_len):
            kt, vt = (t.transpose(1, 2).float() for t in kv.unbind(0))
            sc = (qt @ kt.transpose(-1, -2)) * scale
            p = _mask(torch.exp(sc - lse[..., None]), idx * Sl, src * Sl,
                      causal, kv_len, 0.0)
            dkv[1] += p.transpose(-1, -2) @ dot
            ds = p * (dot @ vt.transpose(-1, -2) - delta[..., None]) * scale
            dq += ds @ kt
            dkv[0] += ds.transpose(-1, -2) @ qt
        if s < n - 1:
            kv = _hop(kv, group)
        dkv = _hop(dkv, group)
    return (dq.transpose(1, 2).to(q.dtype),
            dkv[0].transpose(1, 2).to(k.dtype),
            dkv[1].transpose(1, 2).to(v.dtype))


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, kv_len):
        out, lse = _ring_fwd(q, k, v, group, causal, kv_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, causal, kv_len)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_ring_bwd(q, k, v, out, lse, do, *ctx.args), None, None,
                None)


def ring_attention_local(q, k, v, group, causal=False,
                         kv_len: Optional[int] = None):
    """Per-shard ring attention: q, k, v this rank's sequence chunk
    [B, S/n, H, D] of the `group` ring (chunk r on group rank r)."""
    return _RingAttention.apply(q, k, v, group, bool(causal), kv_len)


def ulysses_attention_local(q, k, v, group, causal=False,
                            kv_len: Optional[int] = None, attn=None):
    """Per-shard Ulysses attention: q, k, v this rank's sequence chunk
    [B, S/n, H, D]; all-to-all to [B, S, H/n, D], `attn` (default the
    flash kernels' `flash_attention_fn`) on the whole sequence, and
    all-to-all back. H must be a multiple of n."""
    if attn is None:
        from ..kernels.flash_attention import flash_attention_fn as attn
    n = group_size(group)
    if q.shape[2] % n:
        raise ValueError(f"ulysses_attention needs num_heads "
                         f"({q.shape[2]}) to be a multiple of the ring "
                         f"size ({n}); use ring attention")
    qh, kh, vh = (all_to_all(t, group, 2, 1) for t in (q, k, v))
    out = attn(qh, kh, vh, causal=causal, kv_len=kv_len)
    return all_to_all(out, group, 1, 2)


def _pad_seq(x, mult: int):
    pad = (-x.shape[1]) % mult
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], 1)


def _cp_call(local_fn, q, k, v, group, causal):
    """q, k, v [B, S, H, D] alike on every rank of `group`: each enters
    through copy_to, S is padded to a multiple of the group size and
    masked with kv_len, the rank's chunk runs `local_fn`, and the
    output, gathered over the group (its backward keeps the rank's
    slice), loses the padding."""
    n = group_size(group)
    S = q.shape[1]
    q, k, v = (_pad_seq(copy_to(t, group), n) for t in (q, k, v))
    kv_len = S if k.shape[1] != S else None
    Sl = q.shape[1] // n
    r = _rank(group)
    q, k, v = (t[:, r * Sl:(r + 1) * Sl] for t in (q, k, v))
    out = local_fn(q, k, v, group, causal=causal, kv_len=kv_len)
    out = gather_from(out.contiguous(), group, 1, grad="split")
    return out[:, :S]


def _group(mesh, axis):
    if mesh is None:
        return None
    from .mesh import axis_group
    return axis_group(mesh, axis)


def ring_attention(q, k, v, mesh, axis: str = "sp", causal=False):
    """Ring attention over mesh axis `axis`: q, k, v [B, S, H, D] alike
    on every rank of the axis, any S (padded to the ring size)."""
    return _cp_call(ring_attention_local, q, k, v, _group(mesh, axis),
                    causal)


def ulysses_attention(q, k, v, mesh, axis: str = "sp", causal=False,
                      attn=None):
    """Ulysses attention over mesh axis `axis` (q, k, v as
    ring_attention's); raises when the axis does not divide the heads."""
    group = _group(mesh, axis)
    n = group_size(group)
    if q.shape[2] % n:
        raise ValueError(
            f"ulysses_attention needs num_heads ({q.shape[2]}) to be a "
            f"multiple of the '{axis}' axis size ({n}); use ring "
            "attention for this head count")

    def local(q, k, v, group, causal, kv_len):
        return ulysses_attention_local(q, k, v, group, causal, kv_len,
                                       attn=attn)
    return _cp_call(local, q, k, v, group, causal)
