"""Speculative decoding inside the serving tick: self-draft propose and
one-pass verify (Leviathan et al. 2023; Chen et al. 2023).

Counterpart of paddle_tpu/inference/spec_decode.py. Each tick runs
`gamma` draft steps through the first `draft_layers` layers of the
target (`forward_cached(..., layers=K)`: same weights, same cache) and
ONE full-depth verify pass over [cur, d1..dgamma], so a tick emits 1 to
gamma+1 tokens, each the target's own greedy token: the streams equal
the non-spec engine's.

One difference from the reference follows from the port's in-place
cache. The reference's draft writes a throwaway first-K-layers view;
here the draft writes the real cache, layers < K, at positions
pos..pos+gamma-1 of each active row. That is harmless because:
- the verify pass writes every one of those positions at full depth
  before it attends (write then attend), so no draft bits survive the
  tick below the row's new position, and those above it are masked
  until later writes replace them in order;
- a T=1 dense write clamps to the row's last position (as the
  reference's draft view does), which the verify pass rewrites too;
- under the paged layout the engine makes every page of the tick's span
  private before the tick (`_prepare_tick_pages`, span gamma+1, clamped
  to the request's envelope), and positions past the envelope's pages
  land on the scratch page, so a draft never writes a shared or
  registered page.

The host pulls ONE array per tick: the [N, gamma+1] emission matrix.
Column 0 is always a real token (or the -1 quarantine verdict), accepted
tokens follow, and SPEC_PAD (-2) fills the rest. A sampled row (temp >
0) takes verify row 0, the logits and noise of the non-spec tick, and
its acceptance is forced to 0. A non-finite draft row forces acceptance
0 (the slot advances one token); only non-finite verify rows the slot
emits quarantine it.

Selection: `PADDLE_TPU_SPEC_DECODE` > registry winner "spec_decode"
(the device's backend class) > off; an off value of the env var
disables speculation even for spec_decode="spec" (the kill switch).
"""
from __future__ import annotations

import os
import sys

import torch

from ..models.decode import greedy_accept

__all__ = ["SPEC_PAD", "spec_decode_impl", "resolve_spec", "spec_tick"]

ENV_SPEC_DECODE = "PADDLE_TPU_SPEC_DECODE"

# emission-matrix pad: -1 is the quarantine verdict, real ids are never
# negative
SPEC_PAD = -2

_OFF_VALUES = frozenset({"0", "off", "dense", "false", "no"})
_ON_VALUES = frozenset({"1", "spec", "on", "true", "yes"})


def _env_value() -> str:
    """PADDLE_TPU_SPEC_DECODE classified: '' (unset), 'off' or 'spec'.
    An unrecognized value is 'off' with a warning: a typo must not turn
    the kill switch into an enable."""
    env = os.environ.get(ENV_SPEC_DECODE, "").strip().lower()
    if not env:
        return ""
    if env in _ON_VALUES:
        return "spec"
    if env not in _OFF_VALUES:
        print(f"[spec_decode] {ENV_SPEC_DECODE}={env!r} is not one of "
              f"{sorted(_ON_VALUES)} / {sorted(_OFF_VALUES)}; treating "
              "as 'off'", file=sys.stderr, flush=True)
    return "off"


def spec_decode_impl(device=None) -> str:
    """Selector: env PADDLE_TPU_SPEC_DECODE > registry winner
    'spec_decode' (the backend class of `device`) > 'off'."""
    env = _env_value()
    if env:
        return env
    from ..kernels import registry
    return registry.winner("spec_decode",
                           backend=registry.backend_class(device)) or "off"


def resolve_spec(knob: str, device=None) -> bool:
    """Engine-build resolution of the spec_decode knob ('auto'|'off'|
    'spec'). An env off value wins even over knob='spec'."""
    if _env_value() == "off":
        return False
    if knob == "off":
        return False
    if knob == "spec":
        return True
    if knob == "auto":
        return spec_decode_impl(device) == "spec"
    raise ValueError(f"spec_decode {knob!r} (auto|off|spec)")


def _spec_core(params, cache, toks, positions, active, temps, top_ks,
               req_ids, gen_idx, seed, *, fwd, cfg, max_top_k, sampling,
               guard, gamma, draft_layers, oor_pos=None):
    """One propose-and-verify round over the [N] slot arrays; the cache
    is written in place. Returns (emit [N, gamma+1], new_tok [N], adv
    [N], m [N]): the emission matrix, the last emitted token, the
    position advance (m + 1 for active rows, else 0) and the raw
    acceptance count."""
    from .serving import _sample

    def at(p):
        # under the paged layout an inactive row writes past the table,
        # onto the scratch page (serving._decode_tick)
        return p if oor_pos is None else torch.where(
            active, p, torch.full_like(p, oor_pos))

    # draft: gamma greedy steps through the first draft_layers layers
    d_tok = toks
    cols = []
    draft_ok = torch.ones_like(active)
    for i in range(gamma):
        lg_d, _ = fwd(params, d_tok[:, None], cache, at(positions + i), cfg,
                      layers=draft_layers)
        row = lg_d[:, 0].float()
        draft_ok = draft_ok & torch.isfinite(row).all(dim=-1)
        d_tok = torch.argmax(row, dim=-1).to(torch.int32)
        cols.append(d_tok)
    draft = torch.stack(cols, dim=1)                          # [N, gamma]

    # verify: one full-depth pass over [cur, d1..dgamma] at pos..pos+gamma
    vt = torch.cat([toks[:, None], draft], dim=1)
    logits, _ = fwd(params, vt, cache, at(positions), cfg)
    lg = logits.float()                                   # [N, gamma+1, V]
    tgt = torch.argmax(lg, dim=-1).to(torch.int32)
    m = torch.where(draft_ok, greedy_accept(draft, tgt), 0).to(torch.int32)
    if sampling:
        first = _sample(lg[:, 0], temps, top_ks, seed, req_ids, gen_idx,
                        max_top_k)
        m = torch.where(temps > 0.0, 0, m).to(torch.int32)
        emit0 = torch.where(temps > 0.0, first, tgt[:, 0])
    else:
        emit0 = tgt[:, 0]
    col = torch.arange(gamma + 1, device=toks.device)[None, :]
    pad = torch.full_like(tgt, SPEC_PAD)
    emit = torch.where(col <= m[:, None], tgt, pad)
    emit[:, 0] = torch.where(active, emit0, torch.zeros_like(emit0))
    emit = torch.where(active[:, None] | (col == 0), emit, pad)
    if guard:
        # quarantine only over the rows the slot emits
        bad = (~torch.isfinite(lg).all(dim=-1) & (col <= m[:, None])).any(1)
        emit[:, 0] = torch.where(active & bad, -1, emit[:, 0])
    adv = torch.where(active, m + 1, 0).to(torch.int32)
    last = emit.gather(1, m[:, None].long())[:, 0]
    new_tok = torch.where(active, last, toks).to(torch.int32)
    return emit, new_tok, adv, m


@torch.no_grad()
def spec_tick(params, cache, state, seed, *, fwd, cfg, max_top_k, sampling,
              guard, gamma, draft_layers, oor_pos=None):
    """The speculative decode tick (serving._decode_tick's counterpart,
    same state tuple): returns (emit [N, gamma+1], the advanced state)."""
    toks, positions, active, temps, top_ks, req_ids, gen_idx = state
    emit, new_tok, adv, _ = _spec_core(
        params, cache, toks, positions, active, temps, top_ks, req_ids,
        gen_idx, seed, fwd=fwd, cfg=cfg, max_top_k=max_top_k,
        sampling=sampling, guard=guard, gamma=gamma,
        draft_layers=draft_layers, oor_pos=oor_pos)
    return emit, (new_tok, positions + adv, active, temps, top_ks, req_ids,
                  gen_idx + adv)
