"""Pipeline schedule: the port's copy of what the pipelined train step
needs from paddle_tpu/parallel/pipeline.py (`bubble_fraction` :33,
`naive_bubble_fraction` :41, and the schedule statistics of
`spmd_pipeline(schedule_stats=True)` :82-90, :186-190).

The reference lifts its schedule into one SPMD program: a scan of
ppermute hops whose autodiff replays it in reverse. Here every rank runs
its stage on the host, as the reference analog's 1F1B loop does
(fleet/meta_parallel/pipeline_parallel.py:188, which the JAX module's
docstring cites): stage s runs pp-1-s warm-up forwards, then alternates
one forward and one backward, then drains the remaining backwards.

`one_f_one_b(pp, m)` gives each stage's order of work; `timeline(pp, m)`
places that work on a grid of slots of one unit each (a forward and a
backward take one slot alike), every item at the first slot where its
stage is free and its input has arrived: the forward of microbatch i on
stage s one slot after stage s-1's, the backward one slot after stage
s+1's. The step runs the slots in order, each followed by the handoffs
its work produced, so every rank issues the same handoffs in the same
order (which a handoff route made of all-reduces needs: each one is a
rendezvous of the whole pp group). On this grid 1F1B takes 2(m+pp-1)
slots and keeps each stage busy for 2m of them, so its bubble is the
reference's (pp-1)/(m+pp-1).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

__all__ = ["bubble_fraction", "naive_bubble_fraction", "one_f_one_b",
           "timeline", "schedule_stats"]

Work = Tuple[str, int]          # ("F" | "B", microbatch)


def bubble_fraction(n_stages: int, n_microbatches: int,
                    interleave: int = 1) -> float:
    """Idle fraction of the schedule: warm-up and cool-down slots over
    all slots, (p-1)/(m+p-1) without interleaving (reference :33)."""
    dead = interleave * n_stages - 1
    return dead / (n_microbatches + dead)


def naive_bubble_fraction(n_stages: int) -> float:
    """Layer-sharded sequential execution: one stage of p busy at a
    time (reference :41)."""
    return 1.0 - 1.0 / n_stages


def one_f_one_b(pp: int, m: int) -> List[List[Work]]:
    """Each stage's order of work under 1F1B over m microbatches:
    pp-1-s warm-up forwards (at most m), then one forward and one
    backward in turn, then the remaining backwards."""
    out = []
    for s in range(pp):
        warm = min(pp - 1 - s, m)
        order = [("F", i) for i in range(warm)]
        for i in range(m - warm):
            order += [("F", warm + i), ("B", i)]
        order += [("B", i) for i in range(m - warm, m)]
        out.append(order)
    return out


def timeline(pp: int, m: int) -> List[Dict[int, Work]]:
    """The slots of the 1F1B schedule: slot t maps each stage that works
    at t to its work. A forward on stage s needs stage s-1's forward of
    the same microbatch in an earlier slot, a backward stage s+1's
    backward (on the last stage, its own forward)."""
    orders = one_f_one_b(pp, m)
    done: Dict[Tuple[int, Work], int] = {}
    nxt = [0] * pp
    free = [0] * pp
    slots: List[Dict[int, Work]] = []
    while any(nxt[s] < len(orders[s]) for s in range(pp)):
        progressed = False
        for s in range(pp):
            if nxt[s] == len(orders[s]):
                continue
            kind, i = orders[s][nxt[s]]
            if kind == "F":
                dep = (s - 1, ("F", i)) if s > 0 else None
            else:
                dep = (s + 1, ("B", i)) if s < pp - 1 else (s, ("F", i))
            if dep is not None and dep not in done:
                continue
            t = max(free[s], done[dep] + 1 if dep is not None else 0)
            while len(slots) <= t:
                slots.append({})
            slots[t][s] = (kind, i)
            done[(s, (kind, i))] = t
            free[s] = t + 1
            nxt[s] += 1
            progressed = True
        if not progressed:
            raise RuntimeError(f"1F1B schedule stalled at pp={pp}, m={m}")
    return slots


def schedule_stats(pp: int, m: int) -> Dict[str, float]:
    """{"busy", "ticks", "stages"} of the schedule, the reference's
    statistics (:186-190): useful stage-slots, slots, stages; the bubble
    is 1 - busy / (stages * ticks)."""
    slots = timeline(pp, m)
    return {"busy": float(sum(len(t) for t in slots)),
            "ticks": float(len(slots)), "stages": float(pp)}
