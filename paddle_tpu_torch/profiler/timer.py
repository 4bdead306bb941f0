"""Throughput (ips) step timer.

Counterpart of paddle_tpu/profiler/timer.py (`Benchmark` :20,
`benchmark()` :102), copied: a global Benchmark with begin, step and end
hooks, reporting batch cost, reader cost and ips with warm-up-aware
summary statistics (p50 and nearest-rank p95). Host clock only: a step
on the card is timed up to whatever the caller synchronizes on.
"""
from __future__ import annotations

import time
from typing import Optional


class _Hint:
    def __init__(self):
        self.reader_cost = 0.0
        self.batch_cost = 0.0
        self.ips = 0.0


class Benchmark:
    """Step timer: call begin() once, step(num_samples) per iteration,
    end() to finish. `summary()` reports avg/p50 batch cost and ips,
    excluding the first `skip` steps (compile/warmup)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._begin_t: Optional[float] = None
        self._last_t: Optional[float] = None
        self._costs = []
        self._samples = []
        self._reader_t: Optional[float] = None
        self._reader_costs = []
        self.current_event = _Hint()

    def begin(self):
        self._begin_t = self._last_t = time.perf_counter()

    def before_reader(self):
        self._reader_t = time.perf_counter()

    def after_reader(self):
        if self._reader_t is not None:
            self._reader_costs.append(time.perf_counter() - self._reader_t)
            self._reader_t = None

    def step(self, num_samples: Optional[int] = None):
        now = time.perf_counter()
        if self._last_t is not None:
            dt = now - self._last_t
            self._costs.append(dt)
            self._samples.append(num_samples or 0)
            self.current_event.batch_cost = dt
            if num_samples:
                self.current_event.ips = num_samples / dt
        self._last_t = now

    def end(self):
        self._last_t = None

    # ------------------------------------------------------------- reporting
    def step_info(self, unit: str = "samples") -> str:
        e = self.current_event
        msg = f"batch_cost: {e.batch_cost * 1e3:.2f} ms"
        if self._reader_costs:
            msg += f", reader_cost: {self._reader_costs[-1] * 1e3:.2f} ms"
        if e.ips:
            msg += f", ips: {e.ips:.1f} {unit}/s"
        return msg

    def summary(self, skip: int = 1) -> dict:
        costs = self._costs[skip:] if len(self._costs) > skip else self._costs
        samples = (self._samples[skip:] if len(self._samples) > skip
                   else self._samples)
        if not costs:
            return {"steps": 0}
        total = sum(costs)
        n = len(costs)
        ordered = sorted(costs)
        out = {
            "steps": n,
            "samples": sum(samples),
            "avg_batch_cost_s": total / n,
            "p50_batch_cost_s": ordered[n // 2],
            # nearest-rank p95: the tail a p50/avg pair hides (one slow
            # reader stall per 20 steps shows up here)
            "p95_batch_cost_s": ordered[max(0, -(-95 * n // 100) - 1)],
        }
        tot_samples = sum(samples)
        if tot_samples:
            out["ips"] = tot_samples / total
        if self._reader_costs:
            out["avg_reader_cost_s"] = (sum(self._reader_costs)
                                        / len(self._reader_costs))
        return out


_BENCHMARK = Benchmark()


def benchmark() -> Benchmark:
    """The global Benchmark singleton (reference timer.py benchmark())."""
    return _BENCHMARK
