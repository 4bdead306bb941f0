"""Multi-tick decode: K serving ticks per dispatch.

Counterpart of paddle_tpu/inference/multi_tick.py. The reference fuses K
decode ticks into one jitted lax.scan, so the host pays one dispatch and
one pull per K tokens. Here the K ticks are a Python loop of plain
tensor ops with no host sync in it (no `.item()`, no `.cpu()`, no
boolean-mask indexing, no `nonzero`): on the CPU it runs eagerly, and
on the card the serving engine captures it once per `sampling` flag in
a CUDA graph, so a dispatch is one graph replay and one host pull.

Early exit: the host is not in the loop, so the device decides when a
slot stops emitting. An `alive` mask retires a slot when it (a) samples
its request's EOS id, (b) exhausts its max_new_tokens budget, (c)
crosses the engine's max_len, or (d) trips the isfinite quarantine:
the host's four finish rules (`ServingEngine._maybe_finish` and the
poisoned path), so each slot's progression is what K host-mediated
ticks would give. Retired rows keep computing (fixed shape) but write
at their frozen position (dense: write then attend masks it, as for an
inactive row) or at `oor_pos` (paged: the scratch page), their columns
pad with MT_PAD, and their positions and token indices freeze.

The pull is the [N, K] emission matrix ([N, K * (gamma+1)] under
speculative decode, whose loop body is spec_decode._spec_core): column
order is emission order, MT_PAD (-2, the spec sentinel; -1 stays the
quarantine verdict) marks "no token", and the host replays the columns
through the engine's `_emit_token`.

Sampled streams are those of the single tick: the noise keys on (seed,
request id, token index) at every step.

Selection: `PADDLE_TPU_MULTI_TICK` is the env override and the kill
switch. An off value ("0"/"1"/"off"/"false"/"no"/"single") flattens
every engine to single-tick even when built with multi_tick=K, an
integer >= 2 sets K for knob-0 engines, "on"/"scan" gives them
DEFAULT_MULTI_TICK_K, and anything else fails safe to off with a stderr
warning. Otherwise the registry's "multi_tick" winner for the device's
backend class decides; no table is committed, so the default is off.
"""
from __future__ import annotations

import os
import sys

import torch

from .spec_decode import SPEC_PAD as MT_PAD   # the same sentinel space

__all__ = ["MT_PAD", "ENV_MULTI_TICK", "DEFAULT_MULTI_TICK_K",
           "multi_tick_impl", "resolve_multi_tick", "multi_tick_ticks",
           "multi_tick_spec_ticks"]

ENV_MULTI_TICK = "PADDLE_TPU_MULTI_TICK"

# the K a knob-0 engine gets when the env or the registry enables
# multi-tick (the reference's default)
DEFAULT_MULTI_TICK_K = 4

_OFF_VALUES = frozenset({"0", "1", "off", "false", "no", "single"})
_ON_VALUES = frozenset({"on", "true", "yes", "scan"})


def _env_value():
    """PADDLE_TPU_MULTI_TICK classified: '' (unset), 'off', 'scan'
    (enable at the default K), or an int K >= 2. An unrecognized value
    is 'off' with a stderr warning: a typo must fail toward the
    single-tick shape."""
    env = os.environ.get(ENV_MULTI_TICK, "").strip().lower()
    if not env:
        return ""
    if env in _OFF_VALUES:
        return "off"
    if env in _ON_VALUES:
        return "scan"
    try:
        k = int(env)
    except ValueError:
        k = 0
    if k >= 2:
        return k
    print(f"[multi_tick] {ENV_MULTI_TICK}={env!r} is not an int >= 2 "
          f"or one of {sorted(_ON_VALUES)} / {sorted(_OFF_VALUES)}; "
          "treating as 'off' (the kill switch fails safe)",
          file=sys.stderr, flush=True)
    return "off"


def _registry_winner(device):
    from ..kernels import registry
    return registry.winner("multi_tick",
                           backend=registry.backend_class(device))


def multi_tick_impl(device=None):
    """Selector: env PADDLE_TPU_MULTI_TICK > registry winner
    'multi_tick' (the backend class of `device`) > 'off'. Returns 'off',
    'scan', or an int K from a numbered env value."""
    env = _env_value()
    if env:
        return env
    return _registry_winner(device) or "off"


def resolve_multi_tick(knob=0, device=None) -> int:
    """Engine-build resolution of the multi_tick knob to the ticks per
    dispatch K (1 = the single tick). Knob 0/'auto' consults env >
    registry; an explicit K >= 1 wins except against an env off value,
    which flattens even an explicit K."""
    if knob in (None, "auto"):
        knob = 0
    k = int(knob)
    if k < 0:
        raise ValueError(f"multi_tick must be >= 0 (0 = auto); got {knob}")
    env = _env_value()
    if env == "off":
        return 1
    if k >= 1:
        return k
    if isinstance(env, int):
        return env
    if env == "scan":
        return DEFAULT_MULTI_TICK_K
    return DEFAULT_MULTI_TICK_K if _registry_winner(device) == "scan" else 1


# ----------------------------------------------------------- tick bodies
@torch.no_grad()
def multi_tick_ticks(params, cache, state, seed, eos_ids, max_new, *, fwd,
                     cfg, max_top_k, sampling, guard, k_ticks, max_len,
                     oor_pos=None):
    """K non-spec decode ticks over the engine's state tuple (the
    counterpart of multi_tick_scan; each step is serving._decode_tick
    under the alive mask). `eos_ids` [N] (-1: no EOS check) and
    `max_new` [N] are the early-exit inputs. Returns (emit [N, K] int32, the advanced state);
    the cache is written in place."""
    from .serving import _decode_tick

    cur, pos, active, temps, top_ks, req_ids, gi = state
    alive = active
    cols = []
    for _ in range(k_ticks):
        nxt, (_, pos, _, _, _, _, gi) = _decode_tick(
            params, cache, (cur, pos, alive, temps, top_ks, req_ids, gi),
            seed, fwd=fwd, cfg=cfg, max_top_k=max_top_k, sampling=sampling,
            guard=guard, oor_pos=oor_pos)
        cols.append(torch.where(alive, nxt, torch.full_like(nxt, MT_PAD)))
        # the host's finish rules: quarantine (-1), EOS, length budget,
        # position ceiling
        dead = ((nxt < 0) | ((eos_ids >= 0) & (nxt == eos_ids))
                | (gi >= max_new) | (pos >= max_len))
        cur = torch.where(alive, nxt, cur)
        alive = alive & ~dead
    # `active` stays the host's mask: the host retires slots itself
    return torch.stack(cols, dim=1), (cur, pos, active, temps, top_ks,
                                      req_ids, gi)


@torch.no_grad()
def multi_tick_spec_ticks(params, cache, state, seed, eos_ids, max_new, *,
                          fwd, cfg, max_top_k, sampling, guard, gamma,
                          draft_layers, k_ticks, max_len, oor_pos=None):
    """K speculative rounds (spec_decode._spec_core) with the alive-mask
    early exit of `multi_tick_ticks`: a slot retires when a token it
    emitted in a block is its EOS, when the block's advance exhausts its
    budget or crosses max_len, or when the quarantine flags column 0.
    Returns (emit [N, K * (gamma+1)]: K blocks of gamma+1 columns, a
    retired slot's later blocks all MT_PAD; the advanced state)."""
    from .spec_decode import _spec_core

    cur, pos, active, temps, top_ks, req_ids, gi = state
    alive = active
    cols_idx = torch.arange(gamma + 1, device=cur.device)[None, :]
    blocks = []
    for _ in range(k_ticks):
        emit, new_tok, adv, m = _spec_core(
            params, cache, cur, pos, alive, temps, top_ks, req_ids, gi,
            seed, fwd=fwd, cfg=cfg, max_top_k=max_top_k, sampling=sampling,
            guard=guard, gamma=gamma, draft_layers=draft_layers,
            oor_pos=oor_pos)
        # the core parks 0 in column 0 of a dead row; the host needs PAD
        # there to see that the slot retired in an earlier block
        blocks.append(torch.where(alive[:, None], emit,
                                  torch.full_like(emit, MT_PAD)))
        pos, gi = pos + adv, gi + adv
        flagged = alive & (emit[:, 0] < 0)
        emitted = (cols_idx <= m[:, None]) & alive[:, None]
        hit_eos = (emitted & (eos_ids[:, None] >= 0)
                   & (emit == eos_ids[:, None])).any(dim=1)
        dead = flagged | hit_eos | (gi >= max_new) | (pos >= max_len)
        cur = torch.where(alive, new_tok, cur)
        alive = alive & ~dead
    return torch.cat(blocks, dim=1), (cur, pos, active, temps, top_ks,
                                      req_ids, gi)
