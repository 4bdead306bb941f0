"""The serving engine's guardrails in the port against the JAX package:
queue bounds, deadlines, quarantine, self-healing under every engine
fault kind, the watchdog, no-limbo resolution, the serving.* counters
and the facade's passthrough.

The load-bearing checks: under the same fault spec (each package's
`faults.install` with its own once-dir) a JAX engine and a port engine
(`device="cpu"`) give the same finish reasons, the same streams to the
bit, the same serving.* counter deltas and the same serving_tick records
tick for tick, on the dense, paged, spec and multi_tick=2 engines; and
the reference's engine tests hold on the port, with every expected
stream taken from the JAX engine."""
import os
import time

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.profiler import flight_recorder as jflight
from paddle_tpu.profiler import monitor as jmonitor
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch.inference import serving
from paddle_tpu_torch.inference.serving import (BackpressureError,
                                                ServingEngine,
                                                TERMINAL_REASONS)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.profiler import flight_recorder, monitor
from paddle_tpu_torch.profiler.serving_telemetry import TICK_FIELDS
from paddle_tpu_torch.testing import faults

MAXLEN = 32
V = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file runs (the suite runs several
    pytest-xdist workers side by side); restored after, so other files
    in the same worker keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_faults_and_flight():
    """Faults and the flight recorders are process-global: nothing a
    test installs or notes outlives it."""
    yield
    faults.uninstall()
    jfaults.uninstall()
    for rec in (flight_recorder.recorder(), jflight.recorder()):
        rec.clear()
        rec.set_dir(None)


@pytest.fixture(scope="module")
def setup():
    """The reference test's tiny GPT (tests/test_serving_robustness.py:
    37-41), its weights drawn with numpy at a std under which streams
    change from token to token."""
    jc = jgpt.GPTConfig(vocab_size=V, hidden_size=32, num_layers=2,
                        num_heads=2, ffn_hidden=64, max_seq_len=64,
                        sequence_parallel=False, remat=False,
                        dtype=jnp.float32)
    tc = tgpt.GPTConfig(vocab_size=V, hidden_size=32, num_layers=2,
                        num_heads=2, ffn_hidden=64, max_seq_len=64,
                        dtype=torch.float32)
    shapes = {k: v.shape for k, v in
              jgpt.init_gpt_params(jc, jax.random.PRNGKey(0)).items()}
    rng = np.random.RandomState(0)
    params = {}
    for k, shp in shapes.items():
        if k.endswith("_w") or k in ("wte", "wpe"):
            params[k] = rng.randn(*shp).astype(np.float32) * 0.3
        elif k.endswith("_scale"):
            params[k] = 1.0 + 0.1 * rng.randn(*shp).astype(np.float32)
        else:
            params[k] = 0.05 * rng.randn(*shp).astype(np.float32)
    return jc, tc, params


@pytest.fixture(scope="module")
def want(setup):
    """want(prompt, n): the JAX engine's fault-free greedy stream, one
    engine for the module, each prompt run once to 20 tokens (a shorter
    stream is its prefix)."""
    jc, _, params = setup
    eng = JaxEngine(params, jc, family="gpt", num_slots=4, max_len=64,
                    telemetry="off")
    memo = {}

    def get(prompt, n):
        key = np.asarray(prompt, np.int32).tobytes()
        if key not in memo:
            memo[key] = eng.generate([prompt], 20)[0]
        assert n <= 20
        return memo[key][:n]
    return get


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, n).astype(np.int32) for n in lens]


def _engine(setup, **kw):
    _, tc, params = setup
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", MAXLEN)
    return ServingEngine(params, tc, family="gpt", device="cpu", **kw)


def _assert_resolved(reqs):
    for r in reqs:
        assert r.done and r.finish_reason in TERMINAL_REASONS, \
            (r.id, r.done, r.finish_reason)
        assert r.slot is None


def _assert_clean(eng):
    """No slot leaked, mirrors agree, nothing queued."""
    assert all(r is None for r in eng._slot_req)
    assert not eng._active.any()
    assert not eng._queue


def _tokens(r):
    return np.asarray(r.tokens, np.int32)


# ------------------------------------------------- parity with the JAX engine
def _counters(mon):
    """{name: value} of every serving.* counter of a monitor registry."""
    reg = mon.registry()
    out = {}
    for name in mon.snapshot():
        stat = reg.get(name)
        if name.startswith("serving.") and stat.kind == "counter":
            out[name] = stat.value
    return out


def _records(eng):
    recs = eng.tick_records()
    ticks = [(r["tick"],) + tuple(r[f] for f in TICK_FIELDS)
             + tuple(r.get(k) for k in ("queue_depth", "prefilling",
                                        "pages_in_use"))
             for r in recs if r["kind"] == "serving_tick"]
    pre = [tuple(r[k] for k in ("tick", "chunk_len", "bucket", "final",
                                "slot"))
           for r in recs if r["kind"] == "serving_prefill"]
    return ticks, pre


def _run(side, setup, spec, once_dir, kw, drive):
    jc, tc, params = setup
    mon, flt = (jmonitor, jfaults) if side == "jax" else (monitor, faults)
    kw = dict(num_slots=2, max_len=MAXLEN, **kw)
    c0 = _counters(mon)
    if spec:
        flt.install(spec, once_dir=once_dir)
    try:
        if side == "jax":
            eng = JaxEngine(params, jc, family="gpt", **kw)
        else:
            eng = ServingEngine(params, tc, family="gpt", device="cpu", **kw)
        reqs = drive(eng)
    finally:
        if spec:
            flt.uninstall()
    c1 = _counters(mon)
    return {"reasons": [r.finish_reason for r in reqs],
            "streams": [list(map(int, r.tokens)) for r in reqs],
            "counters": {k: v - c0.get(k, 0) for k, v in c1.items()
                         if v - c0.get(k, 0)},
            "records": _records(eng), "eng": eng, "reqs": reqs}


def _submit_all(prompts, n):
    def drive(eng):
        reqs = [eng.submit(p, n) for p in prompts]
        eng.drain()
        return reqs
    return drive


def _cow_drive(eng):
    """A donor registers its page-aligned prompt; a sharer of the same
    prompt then matches every page and copies the last (the COW)."""
    aligned = _prompts([16], seed=99)[0]
    donor = eng.submit(aligned, 6)
    eng.drain()
    sharer = eng.submit(aligned, 6)
    eng.drain()
    return [donor, sharer]


SPEC = dict(spec_decode="spec", gamma=3, draft_layers=2)
PAGED = dict(kv_layout="paged", page_size=8)
# (fault spec, engine knobs, how the engine is driven)
PARITY = {
    "nan_logits-dense": ("nan_logits@2:1", {}, None),
    "nan_logits-paged": ("nan_logits@2:1", PAGED, None),
    "nan_logits-spec": ("nan_logits@2:1", SPEC, None),
    "nan_logits-mt2": ("nan_logits@2:1", dict(multi_tick=2), None),
    "draft_nan-spec": ("draft_nan@2:1", SPEC, None),
    "prefill_raise-dense": ("prefill_raise@0", {}, None),
    "prefill_raise-paged-chunked": ("prefill_raise@1",
                                    dict(PAGED, prefill_chunk=4), None),
    "decode_raise-dense": ("decode_raise@2", {}, None),
    "decode_raise-mt2": ("decode_raise@2", dict(multi_tick=2), None),
    "decode_raise-hard_reset": ("decode_raise@2", dict(retries=0), None),
    "oom-dense": ("oom@2", {}, None),
    # the stall outlasts the 1 s budget whatever the load, and lands
    # inside the 3 s backoff: exactly one retry on either engine
    "tick_stall-watchdog": ("tick_stall@1:1500",
                            dict(watchdog_timeout=1.0, retries=1,
                                 backoff_base=3.0), None),
    "cow_raise-paged": ("cow_raise@0", PAGED, _cow_drive),
    "clean-paged-chunked": ("", dict(PAGED, prefill_chunk=4), None),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_fault_parity_with_jax_engine(setup, tmp_path, case):
    """Under one fault spec the port's engine equals the JAX engine:
    finish reasons, streams to the bit, serving.* counter deltas, and
    the serving_tick / serving_prefill records tick for tick."""
    spec, kw, drive = PARITY[case]
    drive = drive or _submit_all(_prompts([3, 5, 8, 10], seed=9), 6)
    out = {side: _run(side, setup, spec, str(tmp_path / side), kw, drive)
           for side in ("jax", "torch")}
    j, t = out["jax"], out["torch"]
    _assert_resolved(t["reqs"])
    _assert_clean(t["eng"])
    assert t["reasons"] == j["reasons"]
    assert t["streams"] == j["streams"]
    # the reference counts one tick's int8 calls a K-tick dispatch
    # (ROADMAP C); these engines are fp, so both count none
    assert t["counters"] == j["counters"], (t["counters"], j["counters"])
    assert t["records"] == j["records"]
    if spec:
        assert t["counters"].get("serving.faults", 0) > 0 or \
            spec.startswith(("draft_nan", "tick_stall"))


def test_hard_reset_then_fresh_streams(setup, want):
    """After a hard reset the engine serves fresh requests with the
    clean streams, and the queue survives it."""
    faults.install("decode_raise@2")
    eng = _engine(setup, retries=0, num_slots=2)
    prompts = _prompts([4, 6, 5], seed=17)
    reqs = [eng.submit(p, 6) for p in prompts]
    eng.drain()
    faults.uninstall()
    assert [r.finish_reason for r in reqs[:2]] == ["evicted", "evicted"]
    assert reqs[2].finish_reason == "length"         # queued: survived
    np.testing.assert_array_equal(_tokens(reqs[2]), want(prompts[2], 6))
    out = eng.generate(prompts[:2], 6)
    for p, o in zip(prompts, out):
        np.testing.assert_array_equal(o, want(p, 6))
    _assert_clean(eng)


@pytest.mark.parametrize("kind", ["nan_logits", "draft_nan", "tick_stall",
                                  "prefill_raise", "decode_raise",
                                  "cow_raise", "oom"])
def test_fault_plan_actions_equal_reference(kind, tmp_path):
    """FaultPlan.on_serving_tick gives the reference's action dicts, tick
    for tick, and fires each fault once."""
    spec = f"{kind}@2:3,{kind}@4"
    plan = faults.FaultPlan(spec)
    ref = jfaults.FaultPlan(spec)
    got = [plan.on_serving_tick(t) for t in range(7)]
    assert got == [ref.on_serving_tick(t) for t in range(7)]
    assert sum(bool(a) for a in got) == 2


def test_install_wires_the_serving_hook():
    assert serving._FAULT_HOOK is None
    plan = faults.install("nan_logits@1:0")
    assert serving._FAULT_HOOK == plan.on_serving_tick
    faults.uninstall()
    assert serving._FAULT_HOOK is None


# --------------------------------------------------------- admission control
class TestAdmissionControl:
    def test_backpressure_reject(self, setup, want):
        rej0 = monitor.counter("serving.rejected").value
        eng = _engine(setup, num_slots=1, max_queue=2)
        prompts = _prompts([3, 4, 5, 6], seed=1)
        ok = [eng.submit(prompts[0], 3), eng.submit(prompts[1], 3)]
        with pytest.raises(BackpressureError) as ei:
            eng.submit(prompts[2], 3)
        assert ei.value.queue_depth == 2
        assert monitor.counter("serving.rejected").value == rej0 + 1
        eng.drain()
        _assert_resolved(ok)
        for p, r in zip(prompts, ok):
            np.testing.assert_array_equal(_tokens(r), want(p, 3))

    def test_shed_oldest_policy(self, setup, want):
        eng = _engine(setup, num_slots=1, max_queue=1,
                      queue_policy="shed_oldest")
        prompts = _prompts([3, 4, 5], seed=2)
        reqs = [eng.submit(p, 3) for p in prompts]   # never raises
        assert reqs[1].done and reqs[1].finish_reason == "evicted"
        assert reqs[1].tokens == []
        eng.drain()
        _assert_resolved(reqs)
        np.testing.assert_array_equal(_tokens(reqs[2]), want(prompts[2], 3))
        with pytest.raises(ValueError, match="queue_policy"):
            _engine(setup, queue_policy="drop_newest")

    def test_queue_ttl_expires_waiting_request(self, setup, want):
        eng = _engine(setup, num_slots=1, queue_ttl_s=0.05)
        long_p, short_p = _prompts([4, 3], seed=3)
        r1 = eng.submit(long_p, 8)
        r2 = eng.submit(short_p, 8)
        eng.step()               # r1 admitted; r2 still queued
        assert r1.slot is not None and not r2.done
        time.sleep(0.1)          # r2's wait exceeds the TTL
        eng.drain()
        assert r2.finish_reason == "timeout" and r2.tokens == []
        assert r1.finish_reason == "length"
        np.testing.assert_array_equal(_tokens(r1), want(long_p, 8))

    def test_cancel_queued_and_mid_decode(self, setup, want):
        eng = _engine(setup, num_slots=1)
        pa, pb = _prompts([5, 7], seed=4)
        ra = eng.submit(pa, 8)
        rb = eng.submit(pb, 6)
        eng.step()
        eng.step()
        assert ra.slot is not None
        assert ra.cancel() is True          # mid-decode: frees the slot
        assert ra.finish_reason == "cancelled" and ra.done
        assert ra.cancel() is False         # exactly once
        eng.drain()
        assert rb.finish_reason == "length"
        np.testing.assert_array_equal(_tokens(rb), want(pb, 6))
        np.testing.assert_array_equal(_tokens(ra),
                                      want(pa, 8)[:len(ra.tokens)])

    def test_cancel_queued_removes_from_queue(self, setup):
        eng = _engine(setup, num_slots=1)
        pa, pb = _prompts([4, 5], seed=5)
        eng.submit(pa, 4)
        rb = eng.submit(pb, 4)
        assert rb.cancel() is True          # still queued
        assert rb.finish_reason == "cancelled"
        eng.drain()
        _assert_clean(eng)


# ---------------------------------------------------------------- deadlines
class TestDeadlines:
    def test_deadline_ticks(self, setup, want):
        eng = _engine(setup, num_slots=2)
        pa, pb = _prompts([4, 6], seed=6)
        ra = eng.submit(pa, 20)
        rb = eng.submit(pb, 20, deadline_ticks=3)
        eng.drain()
        assert rb.finish_reason == "timeout"
        assert 0 < len(rb.tokens) < 20
        assert ra.finish_reason == "length"
        np.testing.assert_array_equal(_tokens(ra), want(pa, 20))
        np.testing.assert_array_equal(_tokens(rb),
                                      want(pb, 20)[:len(rb.tokens)])

    def test_deadline_s_dead_on_arrival(self, setup):
        t0 = monitor.counter("serving.timeout").value
        eng = _engine(setup)
        r = eng.submit(_prompts([4], seed=7)[0], 4, deadline_s=0.0)
        eng.drain()
        assert r.finish_reason == "timeout" and r.tokens == []
        assert monitor.counter("serving.timeout").value == t0 + 1
        assert not eng.has_work()

    def test_generate_deadline_passthrough(self, setup):
        eng = _engine(setup)
        outs = eng.generate(_prompts([3, 5], seed=8), 12, deadline_ticks=4)
        for o in outs:
            # the prefill token, then one a tick until the tick clock
            # passes the deadline (enforced after the tick's emissions)
            assert 0 < len(o) == 6 < 12

    def test_deadline_reaches_a_mid_prefill_slot(self, setup):
        """A slot mid-chunked-prefill times out even while no stream
        decodes, and its pages return to the pool."""
        eng = _engine(setup, kv_layout="paged", page_size=8,
                      prefill_chunk=4)
        r = eng.submit(_prompts([13], seed=26)[0], 4, deadline_ticks=2)
        eng.drain()
        assert r.finish_reason == "timeout" and r.tokens == []
        st = eng.pool_stats()
        assert st["pages_in_use"] == 0 and st["pages_reserved"] == 0


# -------------------------------------------------------------- quarantine
class TestQuarantine:
    def test_nan_logits_evicts_only_poisoned_slot(self, setup, want):
        p0 = monitor.counter("serving.poisoned").value
        prompts = _prompts([3, 5, 8, 10], seed=9)
        faults.install("nan_logits@2:1")
        eng = _engine(setup, num_slots=2)
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.drain()
        reasons = [r.finish_reason for r in reqs]
        assert reasons.count("poisoned") == 1, reasons
        assert monitor.counter("serving.poisoned").value == p0 + 1
        for p, r in zip(prompts, reqs):
            got = _tokens(r)
            if r.finish_reason == "poisoned":
                np.testing.assert_array_equal(got, want(p, 6)[:len(got)])
            else:                       # survivors: bit-identical
                assert r.finish_reason == "length"
                np.testing.assert_array_equal(got, want(p, 6))
        _assert_clean(eng)

    def test_prefill_quarantine_on_nan_params(self, setup):
        """Organic non-finite logits at prefill: the request resolves
        "poisoned" at admission and never holds a slot."""
        jc, tc, params = setup
        bad = dict(params)
        bad["wte"] = np.full_like(params["wte"], np.nan)
        eng = ServingEngine(bad, tc, family="gpt", num_slots=2,
                            max_len=MAXLEN, device="cpu")
        r = eng.submit(_prompts([4], seed=10)[0], 4)
        eng.drain()
        assert r.finish_reason == "poisoned" and r.tokens == []
        _assert_clean(eng)

    def test_guardrails_cost_no_pull_and_poison_resets(self, setup):
        """The quarantine and a fired poison add no host pull (one a
        prefill and one a dispatch), and the poison lanes are ones again
        after the dispatch that read them."""
        eng = _engine(setup, num_slots=2)
        pulls = [0]
        real = eng._pull

        def counted(value, stall_s=0.0):
            pulls[0] += 1
            return real(value, stall_s)
        eng._pull = counted
        faults.install("nan_logits@0:0")
        prompts = _prompts([7, 2, 11], seed=12)
        eng.generate(prompts, 5)
        faults.uninstall()
        c = eng.counters
        assert pulls[0] == c["prefills"] + c["decode_ticks"]
        assert torch.equal(eng._poison, torch.ones(2))
        assert torch.equal(eng._dpoison, torch.ones(2))


# ------------------------------------------------------------ self-healing
class TestSelfHealing:
    def test_prefill_raise_rolls_back_and_retries(self, setup, want):
        f0 = monitor.counter("serving.faults").value
        prompts = _prompts([3, 5, 8], seed=13)
        faults.install("prefill_raise@0")
        eng = _engine(setup, num_slots=2)
        reqs = [eng.submit(p, 5) for p in prompts]
        eng.drain()
        assert monitor.counter("serving.faults").value > f0
        _assert_resolved(reqs)
        for p, r in zip(prompts, reqs):       # fully transparent
            assert r.finish_reason == "length"
            np.testing.assert_array_equal(_tokens(r), want(p, 5))
        _assert_clean(eng)

    @pytest.mark.parametrize("k", [1, 2])
    def test_decode_raise_resyncs_and_retries(self, setup, want, k):
        """A decode that raises after the dispatch advanced the device
        state re-runs from the host mirrors: the slots do not advance
        twice (K = 2: the static buffers reload)."""
        prompts = _prompts([4, 7], seed=14)
        eng = _engine(setup, num_slots=2, multi_tick=k)
        real = eng._pull
        boom = {"n": 0}

        def raising_once(value, stall_s=0.0):
            out = real(value, stall_s)
            if eng._ticks == 2 and not boom["n"]:
                boom["n"] += 1
                raise RuntimeError("injected failure after the dispatch")
            return out
        eng._pull = raising_once
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.drain()
        assert boom["n"] == 1
        for p, r in zip(prompts, reqs):
            assert r.finish_reason == "length"
            np.testing.assert_array_equal(_tokens(r), want(p, 6))

    def test_prefill_retries_exhausted_evicts_not_limbo(self, setup, want,
                                                        monkeypatch):
        """A persistently raising prefill rolls the slot back and
        resolves the request; the engine then serves on."""
        eng = _engine(setup, retries=1, backoff_base=0.0)
        boom = {"n": 0}
        real = serving._prefill_slot

        def raising(*a, **k):
            boom["n"] += 1
            raise RuntimeError("injected dispatch failure")
        monkeypatch.setattr(serving, "_prefill_slot", raising)
        r = eng.submit(_prompts([4], seed=15)[0], 4)
        eng.drain()
        assert boom["n"] == 2                 # initial + 1 retry
        assert r.finish_reason == "evicted" and r.tokens == []
        _assert_clean(eng)
        monkeypatch.setattr(serving, "_prefill_slot", real)
        p = _prompts([5], seed=16)[0]
        np.testing.assert_array_equal(eng.generate([p], 4)[0], want(p, 4))

    def test_decode_retries_exhausted_hard_resets(self, setup, want):
        eng = _engine(setup, retries=0)
        real = eng._dispatch

        def raising(*a, **k):
            raise RuntimeError("injected dispatch failure")
        prompts = _prompts([4, 6], seed=17)
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.step()                        # admits both
        old = eng._cache["k"]
        eng._dispatch = raising
        eng.step()                        # decode fails -> hard reset
        _assert_resolved(reqs)
        assert all(r.finish_reason == "evicted" for r in reqs)
        _assert_clean(eng)
        assert eng._cache["k"] is not old          # reallocated
        eng._dispatch = real
        out = eng.generate([prompts[0]], 4)[0]
        np.testing.assert_array_equal(out, want(prompts[0], 4))

    def test_hard_reset_drops_the_graphs_and_the_pool(self, setup):
        """A hard reset drops what baked the old cache (the K-tick
        engine's graphs) and the paged pool's accounting."""
        eng = _engine(setup, kv_layout="paged", page_size=8, multi_tick=2)
        eng._graphs[False] = object()
        eng._graph_out[False] = object()
        eng._graph_held[False] = ()
        eng.submit(_prompts([9], seed=27)[0], 4)
        eng.step()
        assert eng._pool.stats()["pages_in_use"] > 0
        eng._hard_reset("test")
        assert not eng._graphs and not eng._graph_out \
            and not eng._graph_held
        st = eng._pool.stats()
        assert st["pages_in_use"] == 0 and st["pages_reserved"] == 0
        assert not eng._ptab.any()
        _assert_clean(eng)

    def test_watchdog_puller_recovers_after_hang(self):
        """A pull that exhausts the budget abandons the wedged worker:
        the next, healthy pull does not queue behind the dead one."""
        from paddle_tpu_torch.parallel.resilience import (StepHungError,
                                                          WatchdogPuller)
        p = WatchdogPuller(label="test")
        with pytest.raises(StepHungError):
            p.pull(lambda: (time.sleep(2.0), np.ones(1))[1],
                   timeout=0.05, retries=1, backoff_base=0.05,
                   backoff_max=0.05)
        t0 = time.perf_counter()
        out = p.pull(lambda: np.full((2,), 7.0), timeout=1.0, retries=1)
        assert time.perf_counter() - t0 < 1.0
        np.testing.assert_array_equal(out, np.full((2,), 7.0))

    def test_tick_stall_recovers_under_watchdog(self, setup, want):
        r0 = monitor.counter("serving.retries").value
        faults.install("tick_stall@1:300")
        eng = _engine(setup, watchdog_timeout=0.1, retries=3,
                      backoff_base=0.2)
        p = _prompts([4], seed=18)[0]
        out = eng.generate([p], 5)[0]
        assert monitor.counter("serving.retries").value > r0
        np.testing.assert_array_equal(out, want(p, 5))

    def test_hung_pull_hard_resets(self, setup, want):
        """A stall past the whole budget is a hang: the in-flight
        request is evicted, the engine resets and serves on."""
        faults.install("tick_stall@1:600")
        eng = _engine(setup, watchdog_timeout=0.05, retries=1,
                      backoff_base=0.05)
        p = _prompts([4], seed=28)[0]
        r = eng.submit(p, 5)
        eng.drain()
        assert r.finish_reason == "evicted"
        time.sleep(0.6)                   # the abandoned worker wakes
        faults.uninstall()
        eng.watchdog_timeout = 5.0        # no loaded host's pull hangs
        np.testing.assert_array_equal(eng.generate([p], 5)[0], want(p, 5))


# ------------------------------------------------------------------ no limbo
class TestNoLimbo:
    def test_abort_pending_resolves_everything(self, setup):
        eng = _engine(setup, num_slots=1)
        reqs = [eng.submit(p, 10) for p in _prompts([4, 5, 6], seed=19)]
        eng.step()
        assert eng.abort_pending() == 3
        _assert_resolved(reqs)
        assert all(r.finish_reason == "evicted" for r in reqs)
        assert not eng.has_work()
        with pytest.raises(ValueError):
            eng.abort_pending(reason="nonsense")

    def test_generate_max_ticks_never_limbo(self, setup, want):
        eng = _engine(setup, num_slots=1)
        prompts = _prompts([4, 5, 6, 7], seed=20)
        outs = eng.generate(prompts, 10, max_ticks=3)
        assert not eng.has_work()
        _assert_clean(eng)
        for p, o in zip(prompts, outs):     # partials are exact prefixes
            np.testing.assert_array_equal(o, want(p, 10)[:len(o)])
        assert any(len(o) < 10 for o in outs)

    def test_drain_without_max_ticks_still_completes(self, setup):
        eng = _engine(setup)
        outs = eng.generate(_prompts([3, 5], seed=21), 4)
        assert all(len(o) == 4 for o in outs)


# ------------------------------------------------------------ observability
class TestObservability:
    def test_queue_wait_histogram_and_cancel_counter(self, setup):
        c0 = monitor.counter("serving.cancelled").value
        eng = _engine(setup)
        r = eng.submit(_prompts([4], seed=22)[0], 6)
        eng.step()
        h = monitor.histogram("serving.queue_wait_ms").value
        assert h["n"] >= 1 and h["p50"] >= 0.0 and h["p99"] >= h["p50"]
        r.cancel()
        assert monitor.counter("serving.cancelled").value == c0 + 1

    def test_flight_dump_on_poison(self, setup, tmp_path):
        rec = flight_recorder.recorder()
        rec.clear()
        rec.set_dir(str(tmp_path))
        faults.install("nan_logits@1:0")
        eng = _engine(setup)
        eng.generate(_prompts([4], seed=24), 6)
        dumps = [f for f in os.listdir(str(tmp_path))
                 if f.endswith(".json") and "poisoned" in f]
        assert dumps
        doc = flight_recorder.load_dump(os.path.join(str(tmp_path),
                                                     dumps[0]))
        assert doc["kind"] == "flight_recorder"
        assert "monitor" in doc

    def test_oom_forensics_dump(self, setup, tmp_path, want):
        """An allocation failure at the decode seam leaves an
        oom_forensics dump naming the ledger and the engine's tensors,
        then the retry makes it transparent."""
        rec = flight_recorder.recorder()
        rec.set_dir(str(tmp_path))
        o0 = monitor.counter("serving.oom_forensics").value
        faults.install("oom@2")
        eng = _engine(setup)
        p = _prompts([5], seed=29)[0]
        np.testing.assert_array_equal(eng.generate([p], 6)[0], want(p, 6))
        assert monitor.counter("serving.oom_forensics").value == o0 + 1
        dumps = [f for f in os.listdir(str(tmp_path))
                 if "oom_forensics" in f]
        doc = flight_recorder.load_dump(os.path.join(str(tmp_path),
                                                     dumps[0]))
        oom = doc["config"]["oom_forensics"]
        assert oom["where"] == "decode"
        assert oom["ledger"]["components"] and oom["ledger"]["total"]
        assert oom["census"] and oom["live_bytes"] > 0


# --------------------------------------------------------------- the facade
class TestFacadePassthrough:
    def test_engine_kw_and_deadline_passthrough(self, setup):
        _, tc, params = setup
        from paddle_tpu_torch.models import GPTModel
        from paddle_tpu_torch.models.convert import params_from_jax
        gm = GPTModel(tc, device="cpu",
                      params=params_from_jax(params, "cpu"))
        prompts = _prompts([4, 6], seed=25)
        outs = gm.generate(prompts, 8, num_slots=2, max_len=MAXLEN,
                           deadline_ticks=3, max_ticks=16)
        assert all(0 < len(o) == 5 < 8 for o in outs)
        eng = gm._engine
        # same knobs: the cached engine; a new engine knob: a rebuild
        gm.generate(prompts, 4, num_slots=2, max_len=MAXLEN)
        assert gm._engine is eng
        gm.generate(prompts, 4, num_slots=2, max_len=MAXLEN, max_queue=8)
        assert gm._engine is not eng
        assert gm._engine.max_queue == 8
        outs = gm.generate(prompts, 8, num_slots=2, max_len=MAXLEN,
                           max_ticks=2)
        assert all(len(o) < 8 for o in outs) and not gm._engine.has_work()
