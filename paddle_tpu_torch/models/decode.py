"""Shared greedy-decode loop for the cached model families.

Counterpart of paddle_tpu/models/decode.py: `greedy_accept` (the
speculative acceptance rule), `next_pow2`, `prompt_bucket` and
`greedy_generate_with`, the per-request oracle the serving engine is
held to. The prompt is padded to its power-of-two bucket and the true
length picks the last real logits, exactly as the engine's bucketed
prefill does, so the two give identical streams.
"""
from __future__ import annotations

import torch

__all__ = ["greedy_accept", "next_pow2", "prompt_bucket",
           "greedy_generate_with"]


def greedy_accept(draft, target):
    """Greedy speculative acceptance (Leviathan et al. 2023, exact under
    argmax decoding): draft [N, g] proposed tokens, target [N, g+1] the
    target's greedy tokens at the same query positions. Returns m [N] in
    0..g, the number of leading drafts equal to the target's own choice;
    the emitter takes target[:, :m+1]."""
    ok = (draft == target[:, :draft.shape[1]]).to(torch.int32)
    return torch.cumprod(ok, dim=1).sum(dim=1).to(torch.int32)


def next_pow2(n: int, lo: int = 8) -> int:
    """Smallest power of two >= max(n, lo)."""
    b = lo
    while b < n:
        b *= 2
    return b


def prompt_bucket(n: int, max_len: int, lo: int = 8) -> int:
    """Padded prompt length for a true length `n`: the power-of-two
    bucket, clamped to the cache length."""
    if n > max_len:
        raise ValueError(f"prompt length {n} exceeds max_len {max_len}")
    return min(next_pow2(n, lo), max_len)


@torch.no_grad()
def greedy_generate_with(forward_cached, init_cache, params, prompt,
                         cfg, max_new_tokens: int, max_len=None):
    """Greedy decode: prefill the bucketed prompt once, then single-token
    steps through the cache. prompt [B, T0] (a tensor on the params'
    device) -> [B, T0 + max_new_tokens]."""
    B, T0 = prompt.shape
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0; "
                         f"got {max_new_tokens}")
    if max_new_tokens == 0:
        return prompt
    if max_len is None:
        tb0 = next_pow2(T0)
        max_len = min(cfg.max_seq_len, next_pow2(tb0 + max_new_tokens))
    if T0 + max_new_tokens > max_len:
        raise ValueError(
            f"prompt ({T0}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_len ({max_len})")
    tb = prompt_bucket(T0, max_len)
    dev = prompt.device
    padded = torch.zeros((B, tb), dtype=torch.int64, device=dev)
    padded[:, :T0] = prompt
    cache = init_cache(cfg, B, max_len, device=dev)
    logits, cache = forward_cached(params, padded, cache, 0, cfg)
    tok = torch.argmax(logits[:, T0 - 1].float(), dim=-1)
    out = [tok]
    for i in range(max_new_tokens - 1):
        lg, cache = forward_cached(params, tok[:, None], cache, T0 + i, cfg)
        tok = torch.argmax(lg[:, -1].float(), dim=-1)
        out.append(tok)
    gen = torch.stack(out, dim=1).to(prompt.dtype)
    return torch.cat([prompt, gen], dim=1)
