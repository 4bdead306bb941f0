"""The serving fleet in the port against the JAX package: the router
(inference/router.py) with live migration, requeue-replay, roles and
drain, the autoscaler (inference/autoscale.py), the engine's fleet seams
(snapshot_request, restore_request, detach_request, set_spec_drafts),
the router and journal fault kinds, and a SIGKILLed process replayed
from its journal.

The load-bearing checks:
- under the same fault spec (each package's `faults.install` with its
  own once-dir) and the same injected clock, a JAX router and a port
  router (`device="cpu"`) give the same finish reasons, the same streams
  to the bit, the same serving.* counter deltas (router, autoscale,
  brownout, admission, journal and the engines' own), the same
  requeues, migrations, fallbacks, handoffs and suspensions, and the
  same flight dumps: replica preemption on dense, paged, spec and K = 4
  replicas, migrate_raise, quota_flood, prefill/decode roles, a drain,
  the autoscaler's flood and idle, the brownout ladder, suspension;
- the fault plans' router and journal hooks give equal actions;
- a JAX snapshot and a port snapshot of the same request hold the same
  decode-state mirror and K/V;
- the reference's tests (tests/test_autoscale.py but TestPreemptGuard,
  which tests/test_torch_tp_serving.py holds at tp2 -> tp1) hold on the
  port, every expected stream taken from the JAX engine;
- a port child process SIGKILLed mid-run (`sigkill`) leaves a journal
  whose replay ends every admitted id exactly once, its greedy streams
  the JAX engine's;
- tools/telemetry_report.py reads a port router's `<path>.r<i>` files
  in its fleet mode and the port's serving.router.* names in its
  "router" block.
"""
import json
import os
import signal
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from paddle_tpu.inference import admission as jadm
from paddle_tpu.inference import autoscale as jauto
from paddle_tpu.inference import brownout as jbrown
from paddle_tpu.inference.router import create_router as jcreate_router
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.profiler import flight_recorder as jflight
from paddle_tpu.profiler import monitor as jmonitor
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch.inference import admission as tadm
from paddle_tpu_torch.inference import autoscale as tauto
from paddle_tpu_torch.inference import brownout as tbrown
from paddle_tpu_torch.inference.autoscale import AutoscaleConfig, Autoscaler
from paddle_tpu_torch.inference.journal import RequestJournal
from paddle_tpu_torch.inference.router import create_router
from paddle_tpu_torch.inference.serving import (ServingEngine,
                                                TERMINAL_REASONS)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.profiler import flight_recorder, monitor
from paddle_tpu_torch.testing import faults

MAXLEN = 32
V = 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_faults_and_flight():
    yield
    faults.uninstall()
    jfaults.uninstall()
    for rec in (flight_recorder.recorder(), jflight.recorder()):
        rec.clear()
        rec.set_dir(None)


@pytest.fixture(scope="module")
def setup():
    """The reference test's tiny GPT (tests/test_autoscale.py:40-45), its
    weights drawn with numpy at a std under which streams change from
    token to token."""
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
    """want(prompt, n): the JAX engine's greedy stream (one engine for
    the module, each prompt run once to 20 tokens)."""
    jc, _, params = setup
    eng = JaxEngine(params, jc, family="gpt", num_slots=4, max_len=MAXLEN,
                    telemetry="off")
    memo = {}

    def get(prompt, n):
        key = np.asarray(prompt, np.int32).tobytes()
        if key not in memo:
            memo[key] = eng.generate([prompt], min(
                20, MAXLEN - len(prompt)))[0]
        return memo[key][:n]
    return get


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, n).astype(np.int32) for n in lens]


def _router(setup, replicas=2, clock=None, **kw):
    _, tc, params = setup
    kw.setdefault("num_slots", 3)
    kw.setdefault("max_len", MAXLEN)
    return create_router(params, tc, replicas=replicas, family="gpt",
                         concurrent=False, clock=clock, device="cpu", **kw)


def _engine(setup, **kw):
    _, tc, params = setup
    kw.setdefault("max_len", MAXLEN)
    return ServingEngine(params, tc, family="gpt", device="cpu", **kw)


def _fake_clock():
    state = [0.0]

    def clock():
        return state[0]
    clock.advance = lambda dt: state.__setitem__(0, state[0] + dt)
    return clock


def _tokens(r):
    return np.asarray(r.tokens, np.int32)


# ------------------------------------------- the router against the JAX one
def _pkg(side, setup):
    """One package's fleet surface, for drives written once."""
    jc, tc, params = setup
    if side == "jax":
        def engine(**kw):
            return JaxEngine(params, jc, family="gpt", max_len=MAXLEN, **kw)

        def router(**kw):
            return jcreate_router(params, jc, family="gpt", max_len=MAXLEN,
                                  concurrent=False, **kw)
        return types.SimpleNamespace(engine=engine, router=router,
                                     adm=jadm, auto=jauto, brown=jbrown,
                                     faults=jfaults, monitor=jmonitor,
                                     flight=jflight)

    def engine(**kw):
        return ServingEngine(params, tc, family="gpt", max_len=MAXLEN,
                             device="cpu", **kw)

    def router(**kw):
        return create_router(params, tc, family="gpt", max_len=MAXLEN,
                             concurrent=False, device="cpu", **kw)
    return types.SimpleNamespace(engine=engine, router=router, adm=tadm,
                                 auto=tauto, brown=tbrown, faults=faults,
                                 monitor=monitor, flight=flight_recorder)


def _counters(mon):
    """{name: value} of every serving.* counter of a monitor registry."""
    reg = mon.registry()
    return {k: reg.get(k).value for k in mon.snapshot()
            if k.startswith("serving.") and reg.get(k).kind == "counter"}


def _submit(router, prompts, n=12, sampled=(1,), **kw):
    return [router.submit(p, n, temperature=0.8 if i in sampled else 0.0,
                          top_k=5 if i in sampled else 0, **kw)
            for i, p in enumerate(prompts)]


def _drive_kill(pk, **kw):
    r = pk.router(replicas=2, num_slots=4, max_top_k=8, **kw)
    reqs = _submit(r, _prompts([5, 8, 7, 6, 8], seed=11))
    r.drain()
    return r, reqs


def _drive_roles(pk):
    r = pk.router(replicas=2, num_slots=4, roles=["prefill", "decode"])
    prompts = _prompts([5, 8, 7, 6], seed=12)
    reqs = _submit(r, prompts[:2], sampled=())
    for _ in range(60):
        r.step()
        if r.stats()["handoffs"]:
            break
    r.kill_replica(0, reason="chaos")
    reqs += _submit(r, prompts[2:], sampled=())
    r.drain(max_ticks=400)
    return r, reqs


def _drive_drain(pk):
    r = pk.router(replicas=2, num_slots=3, max_top_k=8)
    reqs = _submit(r, _prompts([5, 8, 7], seed=9), n=14)
    for _ in range(4):
        r.step()
    r.drain_replica(0, migrate=True)
    r.drain()
    return r, reqs


def _drive_autoscale(pk):
    t = [0.0]
    r = pk.router(replicas=1, num_slots=2, clock=lambda: t[0])
    sc = pk.auto.Autoscaler(
        r, spawn=lambda: pk.engine(num_slots=2),
        cfg=pk.auto.AutoscaleConfig(min_replicas=1, max_replicas=3,
                                    breach_ticks=2, idle_ticks=3,
                                    cooldown_s=1.0))
    reqs = _submit(r, _prompts([6] * 6, seed=3), n=10, sampled=())
    for _ in range(60):
        if not r.has_work() and len(r.dispatchable()) == 1:
            break
        r.step()
        t[0] += 1.0
        sc.tick()
    return r, reqs


class _Obj:
    name = "ttft"


class _SLO:
    pairs = [(3600.0, 60.0)]
    objectives = [_Obj()]
    burn = 0.0

    def burn_rate(self, name, window, now=None):
        return self.burn


def _drive_brownout(pk):
    t = [0.0]
    r = pk.router(replicas=1, num_slots=4, admission={},
                  spec_decode="spec", gamma=2, draft_layers=1)
    slo = _SLO()
    ctrl = pk.brown.BrownoutController(
        r, slo=slo, cfg=pk.brown.BrownoutConfig(
            breach_ticks=2, recover_ticks=2, cooldown_s=0.0),
        clock=lambda: t[0])
    reqs = [r.submit(p, 12, priority=i % 2)
            for i, p in enumerate(_prompts([5, 8, 7, 6, 8, 4], seed=13))]
    levels = []
    for burn in (2.0, 0.0):
        slo.burn = burn
        for _ in range(8):
            r.step()
            t[0] += 1.0
            ctrl.tick()
            levels.append(ctrl.level)
    r.drain(max_ticks=400)
    r.levels = levels
    return r, reqs


def _drive_suspend(pk):
    r = pk.router(replicas=1, num_slots=2, admission={})
    prompts = _prompts([3, 4, 5], seed=42)
    low = [r.submit(p, 12, priority=0) for p in prompts[:2]]
    for _ in range(3):
        r.step()
    hi = r.submit(prompts[2], 12, priority=5)
    r.drain()
    return r, low + [hi]


def _drive_flood(pk):
    r = pk.router(replicas=1, num_slots=4, admission={
        "flood": pk.adm.TenantQuota(tokens_per_s=0.5, burst=7.0)})
    reqs = _submit(r, _prompts([5, 8, 7, 6], seed=14), sampled=())
    r.drain(max_ticks=400)
    return r, reqs


# name -> (fault spec, drive)
SCENARIOS = {
    "replica_preempt_dense": (
        "replica_preempt@3:0", lambda pk: _drive_kill(pk)),
    "replica_preempt_paged": (
        "replica_preempt@4:1", lambda pk: _drive_kill(
            pk, kv_layout="paged", page_size=8, prefill_chunk=8)),
    "replica_preempt_spec": (
        "replica_preempt@2:0", lambda pk: _drive_kill(
            pk, spec_decode="spec", gamma=2, draft_layers=1)),
    "replica_preempt_k4": (
        "replica_preempt@1:1", lambda pk: _drive_kill(pk, multi_tick=4)),
    "migrate_raise": (
        "migrate_raise@2,replica_preempt@3:0", lambda pk: _drive_kill(pk)),
    "quota_flood": ("quota_flood@2:6", _drive_flood),
    "prefill_role_death": (None, _drive_roles),
    "drain": (None, _drive_drain),
    "autoscale": (None, _drive_autoscale),
    "brownout_ladder": (None, _drive_brownout),
    "suspend_resume": (None, _drive_suspend),
}


def _fleet_run(side, setup, name, tmp):
    pk = _pkg(side, setup)
    spec, drive = SCENARIOS[name]
    fdir = os.path.join(tmp, side, "flight")
    os.makedirs(fdir)
    rec = pk.flight.recorder()
    rec.clear()
    rec.set_dir(fdir)
    c0 = _counters(pk.monitor)
    if spec:
        pk.faults.install(spec, once_dir=os.path.join(tmp, side, "once"))
    try:
        r, reqs = drive(pk)
    finally:
        pk.faults.uninstall()
        rec.set_dir(None)
    c1 = _counters(pk.monitor)
    st = r.stats()
    return {"streams": [list(map(int, q.tokens)) for q in reqs],
            "reasons": [q.finish_reason for q in reqs],
            "requeues": [q.requeues for q in reqs],
            "counters": {k: v - c0.get(k, 0) for k, v in c1.items()
                         if v - c0.get(k, 0)},
            # (requeues, migrations and handoffs are the counters'
            # process-wide totals: their deltas are compared above)
            "stats": {k: st[k] for k in ("replicas", "replicas_live",
                                         "replicas_dispatchable",
                                         "pending", "suspended")},
            "dumps": sorted(json.load(open(os.path.join(fdir, f)))[
                "reason"] for f in os.listdir(fdir)),
            "levels": getattr(r, "levels", None)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_router_equals_jax(setup, tmp_path, name):
    """The same drive under the same fault through both routers: equal
    reasons, streams, requeues, counter deltas, router stats and dumps;
    every request resolved, and each scenario's fault really bit."""
    got = _fleet_run("port", setup, name, str(tmp_path))
    ref = _fleet_run("jax", setup, name, str(tmp_path))
    assert got == ref
    assert all(why in TERMINAL_REASONS for why in got["reasons"])
    c = got["counters"]
    if name.startswith("replica_preempt") or name == "migrate_raise":
        assert c["serving.router.replica_deaths"] == 1
        assert c.get("serving.autoscale.migrations", 0) > 0
        assert got["reasons"] == ["length"] * len(got["reasons"])
    if name == "migrate_raise":
        assert c["serving.autoscale.migrate_fallbacks"] >= 1
        assert c["serving.router.requeues"] >= 1
    if name == "quota_flood":
        assert c["serving.admission.rejected.flood"] >= 1
    if name == "prefill_role_death":
        assert c["serving.router.handoffs"] >= 1
    if name == "autoscale":
        assert c["serving.autoscale.scale_out"] >= 1
        assert c["serving.autoscale.scale_in"] >= 1
    if name == "brownout_ladder":
        assert got["levels"][:8] == [0, 1, 1, 2, 2, 3, 3, 3]
        assert got["levels"][-1] == 0
        assert c["serving.brownout.escalations"] == 3
        assert c["serving.brownout.recoveries"] == 3
    if name == "suspend_resume":
        assert c["serving.admission.preemptions"] == 1
        assert c["serving.admission.resumes"] == 1


@pytest.mark.parametrize("kind", [
    "replica_preempt@2:1", "replica_preempt@0:0", "migrate_raise@1",
    "quota_flood@2:6", "quota_flood@1", "journal_torn@40",
    "replica_preempt@1:0,replica_preempt@1:1"])
def test_fault_hooks_give_equal_actions(tmp_path, kind):
    """on_router_tick, on_journal_recover and on_serving_tick of the two
    packages' plans, consulted alike, give the same actions and fire
    the same tokens once."""
    out = {}
    for side, fmod in (("port", faults), ("jax", jfaults)):
        plan = fmod.FaultPlan(kind, once_dir=str(tmp_path / side))
        acts = [plan.on_router_tick(t) for t in range(4)]
        acts.append(plan.on_journal_recover())
        acts.append(plan.on_journal_recover())
        plan2 = fmod.FaultPlan(kind, once_dir=str(tmp_path / side))
        acts.append([f.done for f in plan2.faults])
        out[side] = (acts, plan.fired)
    assert out["port"] == out["jax"]


def test_every_fleet_kind_parses():
    """The five fleet kinds parse on the port as on the reference (the
    step, the argument and its default)."""
    spec = ("replica_preempt@3:1,migrate_raise@2,quota_flood@2:6,"
            "sigkill@5,journal_torn@40,replica_preempt@4")
    got = [(f.kind, f.step, f.arg) for f in faults.FaultPlan(spec).faults]
    ref = [(f.kind, f.step, f.arg) for f in jfaults.FaultPlan(spec).faults]
    assert got == ref and len(got) == 6


def test_migrate_raise_on_the_engine_hook(setup):
    """migrate_raise aimed at the engine's tick hook arms the next
    snapshot to raise once, as the reference's does."""
    eng = _engine(setup, num_slots=2)
    req = eng.submit(_prompts([5], seed=1)[0], 8)
    faults.install("migrate_raise@1", once_dir=None)
    eng.step()
    eng.step()
    faults.uninstall()
    from paddle_tpu_torch.inference.serving import ServingFaultError
    with pytest.raises(ServingFaultError, match="migrate"):
        eng.snapshot_request(req)
    assert eng.snapshot_request(req) is not None


@pytest.mark.parametrize("layout", ["dense", "paged", "k4", "spec"])
def test_snapshot_equals_jax(setup, layout):
    """A JAX snapshot and a port snapshot of the same request after the
    same ticks: the same decode-state mirror, prompt, tokens and K/V,
    and the same kv_bytes."""
    jc, _, params = setup
    kw = {"dense": {}, "k4": dict(multi_tick=4),
          "spec": dict(spec_decode="spec", gamma=2, draft_layers=1),
          "paged": dict(kv_layout="paged", page_size=8,
                        prefill_chunk=8)}[layout]
    ticks = {"dense": 5, "paged": 6, "k4": 2, "spec": 2}[layout]
    prompts = _prompts([5, 13, 9], seed=17)
    snaps = []
    for eng in (JaxEngine(params, jc, family="gpt", num_slots=3,
                          max_len=MAXLEN, max_top_k=8, **kw),
                _engine(setup, num_slots=3, max_top_k=8, **kw)):
        reqs = _submit(eng, prompts, n=16)
        for _ in range(ticks):
            eng.step()
        snaps.append([eng.snapshot_request(r) for r in reqs])
    taken = 0
    for j, t in zip(*snaps):
        assert (j is None) == (t is None)
        if j is None:
            continue
        taken += 1
        for k in ("pos", "cur_tok", "gen_idx", "prng_id", "tokens",
                  "max_new_tokens", "temperature", "top_k", "eos_id",
                  "tenant", "priority", "kv_bytes"):
            assert j[k] == t[k], k
        np.testing.assert_array_equal(j["prompt"], t["prompt"])
        for k in ("kv_k", "kv_v"):
            np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                       rtol=1e-5, atol=1e-5)
    assert taken >= 2


def test_concurrent_router_equals_serial(setup):
    """concurrent=True steps the replicas on threads: the same streams,
    reasons and migrations as the serial router through a preemption."""
    out = []
    for conc in (False, True):
        _, tc, params = setup
        r = create_router(params, tc, replicas=3, family="gpt",
                          num_slots=2, max_len=MAXLEN, max_top_k=8,
                          concurrent=conc, device="cpu")
        reqs = _submit(r, _prompts([5, 9, 7, 6, 8], seed=15))
        for _ in range(3):
            r.step()
        r.kill_replica(1)
        r.drain()
        out.append(([list(map(int, q.tokens)) for q in reqs],
                    [q.finish_reason for q in reqs],
                    [q.requeues for q in reqs]))
        r.close()
    assert out[0] == out[1]


# ----------------------------------------------- the reference's own tests
class TestAutoscaler:
    def test_flood_scale_out_idle_scale_in(self, setup):
        clock = _fake_clock()
        r = _router(setup, replicas=1, num_slots=2, clock=clock)
        sc = Autoscaler(r, spawn=lambda: _engine(setup, num_slots=2),
                        cfg=AutoscaleConfig(min_replicas=1, max_replicas=3,
                                            breach_ticks=2, idle_ticks=3,
                                            cooldown_s=1.0))
        out0, in0 = sc._m_out.value, sc._m_in.value
        reqs = [r.submit(p, 20) for p in _prompts([6] * 8, seed=3)]
        peak = 1
        while r.has_work():
            r.step()
            clock.advance(1.0)
            sc.tick()
            peak = max(peak, len(r.dispatchable()))
        assert peak > 1 and sc._m_out.value - out0 >= 1
        for _ in range(12):
            r.step()
            clock.advance(1.0)
            sc.tick()
        assert len(r.dispatchable()) == 1
        assert sc._m_in.value - in0 >= 1
        assert all(q.done and q.finish_reason in ("eos", "length")
                   for q in reqs)
        assert sc._m_target.value == 1

    def test_cooldown_gates_actions(self, setup):
        clock = _fake_clock()
        r = _router(setup, replicas=1, num_slots=1, clock=clock)
        sc = Autoscaler(r, spawn=lambda: _engine(setup, num_slots=1),
                        cfg=AutoscaleConfig(min_replicas=1, max_replicas=4,
                                            breach_ticks=1, idle_ticks=100,
                                            cooldown_s=10.0))
        for p in _prompts([6] * 6, seed=4):
            r.submit(p, 24)
        r.step()
        assert sc.tick() == "scale_out"
        for _ in range(5):
            r.step()
            clock.advance(1.0)
            assert sc.tick() is None
        clock.advance(10.0)
        r.step()
        assert sc.tick() == "scale_out"
        r.drain()

    def test_hysteresis_dead_band_never_acts(self, setup):
        clock = _fake_clock()
        r = _router(setup, replicas=2, num_slots=2, clock=clock)
        sc = Autoscaler(r, spawn=lambda: None, cfg=AutoscaleConfig(
            min_replicas=1, max_replicas=4, breach_ticks=1, idle_ticks=1,
            cooldown_s=0.0))
        out0, in0 = sc._m_out.value, sc._m_in.value
        reqs = [r.submit(p, 24) for p in _prompts([5, 7], seed=5)]
        for _ in range(6):
            r.step()
            clock.advance(1.0)
            assert sc.tick() is None
            assert 0.25 < sc.occupancy() < 0.95
        assert sc._m_out.value == out0 and sc._m_in.value == in0
        r.drain()
        assert all(q.done for q in reqs)

    def test_bounds_respected(self, setup):
        clock = _fake_clock()
        r = _router(setup, replicas=1, num_slots=1, clock=clock)
        sc = Autoscaler(r, spawn=lambda: _engine(setup, num_slots=1),
                        cfg=AutoscaleConfig(min_replicas=1, max_replicas=2,
                                            breach_ticks=1, idle_ticks=1,
                                            cooldown_s=0.0))
        for p in _prompts([6] * 8, seed=6):
            r.submit(p, 24)
        for _ in range(6):
            r.step()
            clock.advance(1.0)
            sc.tick()
            assert len(r.dispatchable()) <= 2
        r.drain()
        for _ in range(6):
            r.step()
            clock.advance(1.0)
            sc.tick()
        assert len(r.dispatchable()) == 1


class TestGracefulDrain:
    def test_drain_invariants(self, setup):
        r = _router(setup, replicas=2)
        deaths0 = r._m_deaths.value
        reqs = [r.submit(p, 12) for p in _prompts([5, 7, 9, 6], seed=7)]
        r.step()
        assert len(r.replicas[1].inner) > 0
        assert r.drain_replica(1, migrate=False) == 0
        assert r.replicas[1].draining
        extra = r.submit(_prompts([4], seed=8)[0], 8)
        while not extra.done or r.has_work():
            r.step()
            assert extra.replica != 1 or extra.done
            if not r.replicas[1].alive:
                break
        while r.has_work():
            r.step()
        assert not r.replicas[1].alive
        assert not r.replicas[1].draining
        assert r._m_deaths.value == deaths0
        for q in reqs + [extra]:
            assert q.done and q.finish_reason in ("eos", "length")

    def test_drain_migrates_out_and_releases_fast(self, setup, want):
        prompts = _prompts([5, 9, 7], seed=9)
        r = _router(setup, replicas=2)
        reqs = [r.submit(p, 14) for p in prompts]
        for _ in range(4):
            r.step()
        on_r0 = sum(1 for q in reqs if q.replica == 0 and not q.done)
        assert on_r0 > 0
        assert r.drain_replica(0, migrate=True) == on_r0
        assert not r.replicas[0].inner
        r.step()
        assert not r.replicas[0].alive
        while r.has_work():
            r.step()
        for q, p in zip(reqs, prompts):
            np.testing.assert_array_equal(_tokens(q), want(p, 14))
            assert q.requeues == 0


class TestLiveMigration:
    @pytest.mark.parametrize("layout", ["dense", "paged", "spec", "k4"])
    def test_kill_replica_migrates_bit_identical(self, setup, want,
                                                 layout):
        kw = {"dense": {}, "paged": dict(kv_layout="paged", page_size=8),
              "spec": dict(spec_decode="spec", gamma=2,
                           draft_layers=2),
              "k4": dict(multi_tick=4)}[layout]
        prompts = _prompts([5, 9, 7, 6], seed=11)
        r = _router(setup, replicas=2, num_slots=4, **kw)
        mig0 = r._m_mig.value
        reqs = [r.submit(p, 14) for p in prompts]
        for _ in range(2 if layout in ("spec", "k4") else 5):
            r.step()
        assert any(not q.done for q in reqs)
        victim = max(r.replicas, key=lambda rep: sum(
            1 for o in rep.inner.values() if not o.done)).idx
        assert r.kill_replica(victim) == 0
        assert r._m_mig.value - mig0 > 0
        while r.has_work():
            r.step()
        for q, p in zip(reqs, prompts):
            np.testing.assert_array_equal(_tokens(q), want(p, 14))
            assert q.requeues == 0
            assert q.done and q.finish_reason in ("eos", "length")

    def test_zero_reprefill_observable(self, setup):
        """The survivor runs no prefill for a migrated request."""
        r = _router(setup, replicas=2)
        req = r.submit(_prompts([9], seed=12)[0], 14)
        for _ in range(4):
            r.step()
        src = req.replica
        dst = 1 - src
        assert r.replicas[dst].eng.counters["prefills"] == 0
        assert r.kill_replica(src) == 0
        assert req.replica == dst
        while r.has_work():
            r.step()
        assert req.done and req.finish_reason in ("eos", "length")
        assert r.replicas[dst].eng.counters["prefills"] == 0
        assert len(req.tokens) == 14 or req.finish_reason == "eos"

    def test_sampled_stream_migrates_bit_identical(self, setup):
        prompts = _prompts([5, 8], seed=13)
        rb = _router(setup, replicas=2, max_top_k=8)
        base = [rb.submit(p, 14, temperature=0.8, top_k=5)
                for p in prompts]
        while rb.has_work():
            rb.step()
        r = _router(setup, replicas=2, max_top_k=8)
        reqs = [r.submit(p, 14, temperature=0.8, top_k=5) for p in prompts]
        for _ in range(4):
            r.step()
        mig0 = r._m_mig.value
        victim = max(r.replicas, key=lambda rep: sum(
            1 for o in rep.inner.values() if not o.done)).idx
        assert r.kill_replica(victim) == 0
        while r.has_work():
            r.step()
        assert r._m_mig.value - mig0 > 0
        for q, w in zip(reqs, base):
            np.testing.assert_array_equal(_tokens(q), _tokens(w))

    def test_mid_prefill_falls_back_to_replay(self, setup, want):
        prompts = _prompts([13, 5], seed=14)
        r = _router(setup, replicas=2, kv_layout="paged", page_size=8,
                    prefill_chunk=4)
        fb0 = r._m_mig_fb.value
        reqs = [r.submit(p, 12) for p in prompts]
        r.step()
        assert reqs[0]._inner._pf_next is not None
        r.kill_replica(reqs[0].replica)
        assert r._m_mig_fb.value - fb0 >= 1
        assert reqs[0].requeues == 1
        while r.has_work():
            r.step()
        for q, p in zip(reqs, prompts):
            np.testing.assert_array_equal(_tokens(q), want(p, 12))
            assert q.done and q.finish_reason in ("eos", "length")

    def test_migrate_raise_fault_falls_back(self, setup, want):
        prompts = _prompts([5, 7], seed=15)
        r = _router(setup, replicas=2)
        fb0 = r._m_mig_fb.value
        reqs = [r.submit(p, 12) for p in prompts]
        faults.install("migrate_raise@2,replica_preempt@3:0")
        for _ in range(6):
            r.step()
        assert not r.replicas[0].alive
        assert r._m_mig_fb.value - fb0 >= 1
        while r.has_work():
            r.step()
        for q, p in zip(reqs, prompts):
            np.testing.assert_array_equal(_tokens(q), want(p, 12))
            assert q.done and q.finish_reason in ("eos", "length")
            # the replay reset the stream: no token twice
            assert len(q.tokens) == 12


class TestDeadlineRescope:
    def test_requeue_carries_remaining_budget(self, setup):
        clock = _fake_clock()
        r = _router(setup, replicas=2, clock=clock)
        req = r.submit(_prompts([5], seed=16)[0], 12, deadline_s=100.0)
        r.step()
        clock.advance(30.0)
        r.kill_replica(req.replica, migrate=False)
        assert req.requeues == 1
        r.step()
        assert req._inner is not None
        assert req._inner.deadline_s <= 70.0 + 1e-6
        assert req._inner.deadline_s > 60.0
        while r.has_work():
            r.step()
        assert req.done

    def test_exhausted_budget_resolves_timeout(self, setup):
        clock = _fake_clock()
        r = _router(setup, replicas=2, clock=clock)
        req = r.submit(_prompts([5], seed=17)[0], 12, deadline_s=5.0)
        r.step()
        clock.advance(6.0)
        src = req.replica
        r.kill_replica(src, migrate=False)
        survivor = r.replicas[1 - src].eng
        r.step()
        assert req.done and req.finish_reason == "timeout"
        assert req._inner is None
        assert not survivor.has_work()
        r.drain()

    def test_tick_budget_rescopes_too(self, setup):
        r = _router(setup, replicas=2)
        req = r.submit(_prompts([5], seed=18)[0], 24, deadline_ticks=6)
        for _ in range(3):
            r.step()
        r.kill_replica(req.replica, migrate=False)
        r.step()
        if req._inner is not None:
            assert req._inner.deadline_ticks <= 3
        while r.has_work():
            r.step()
        assert req.done and req.finish_reason == "timeout"


# ------------------------------------------------- a SIGKILLed process
CRASH_CHILD = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, {repo!r})
from paddle_tpu_torch.inference import create_router
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.testing import faults
params = dict(np.load({npz!r}))
cfg = GPTConfig(vocab_size={V}, hidden_size=32, num_layers=2, num_heads=2,
                ffn_hidden=64, max_seq_len=64, dtype=torch.float32)
faults.install("sigkill@{kill_at}", once_dir={once!r})
router = create_router(params, cfg, replicas=1, family="gpt", num_slots=2,
                       max_len={maxlen}, concurrent=False, device="cpu",
                       journal_dir={jdir!r})
for p in np.load({prompts!r}):
    router.submit(p, {gen})
router.drain(max_ticks=400)
sys.exit(3)
"""


def test_process_crash_replay(setup, want, tmp_path):
    """tools/chaos_serving.py process_crash_replay on the port: a child
    process SIGKILLed by `sigkill` mid-drain; the parent rebuilds a
    router over the same journal and replays it. Every admitted id ends
    exactly once across both processes, and the replayed greedy streams
    are the JAX engine's."""
    _, _, params = setup
    gen = 6
    prompts = np.stack(_prompts([6] * 5, seed=19))
    np.savez(tmp_path / "params.npz", **params)
    np.save(tmp_path / "prompts.npy", prompts)
    jdir = str(tmp_path / "journal")
    code = CRASH_CHILD.format(
        repo=REPO, npz=str(tmp_path / "params.npz"), V=V,
        kill_at=gen + 2, once=str(tmp_path / "once"), maxlen=MAXLEN,
        jdir=jdir, prompts=str(tmp_path / "prompts.npy"), gen=gen)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    replays0 = monitor.counter("serving.journal.replays").value
    router = _router(setup, replicas=1, num_slots=2, journal_dir=jdir)
    assert monitor.counter("serving.journal.replays").value > replays0
    streams = {}
    while router.has_work():
        for req, tok in router.step():
            streams.setdefault(req.id, []).append(int(tok))
    assert router.stats()["journal"]["replayable"] == 0
    router.close()
    wal = RequestJournal(jdir, fsync=False)
    admits, ends = set(), {}
    with open(wal.path, "rb") as f:
        for line in f:
            rec = wal._parse(line.rstrip(b"\n"))
            assert rec is not None
            if rec["ev"] == "admit":
                admits.add(rec["id"])
            else:
                ends[rec["id"]] = ends.get(rec["id"], 0) + 1
    wal.close()
    assert admits == set(range(len(prompts)))
    assert all(ends.get(i) == 1 for i in admits), ends
    # the child finished some before its death, the parent the rest
    assert 0 < len(streams) < len(prompts)
    for rid, toks in streams.items():
        np.testing.assert_array_equal(np.asarray(toks, np.int32),
                                      want(prompts[rid], gen))


# ------------------------------------------------------ the report schema
def test_telemetry_report_reads_the_port_router(setup, tmp_path):
    """tools/telemetry_report.py over a port router's run: the fleet mode
    merges its engines' `<path>.r<i>` files, and the report of its
    monitor export groups the port's serving.router.* and
    serving.autoscale.* names into the "router" and "autoscale"
    blocks."""
    path = str(tmp_path / "serve.jsonl")
    mon_path = str(tmp_path / "monitor.jsonl")
    monitor.registry().export_jsonl(mon_path)
    r = _router(setup, replicas=2, num_slots=4, telemetry_jsonl=path,
                telemetry_every=1)
    reqs = [r.submit(p, 8) for p in _prompts([5, 7, 6, 9], seed=20)]
    for _ in range(3):
        r.step()
    r.kill_replica(0)
    r.drain()
    for i, rep in enumerate(r.replicas):
        rep.eng.flush_telemetry()
        rep.eng.export_slo_jsonl(f"{path}.r{i}")
    monitor.registry().export_jsonl(mon_path)
    assert all(q.finish_reason == "length" and q.requeues == 0
               for q in reqs)
    tool = os.path.join(REPO, "tools", "telemetry_report.py")
    fleet = json.loads(subprocess.run(
        [sys.executable, tool, "--fleet", f"{path}.r0", f"{path}.r1"],
        capture_output=True, text=True, check=True).stdout)
    assert fleet["replicas"] == 2
    assert all(row["ticks"] > 0 for row in fleet["per_replica"])
    assert fleet["tokens_total"] == sum(
        row["tokens"] for row in fleet["per_replica"]) > 0
    assert fleet["fleet"]["ttft"]["n"] == len(reqs)
    doc = json.loads(subprocess.run(
        [sys.executable, tool, mon_path], capture_output=True, text=True,
        check=True).stdout)
    router = doc["serving"]["router"]
    assert router["replica_deaths"] == 1
    assert router["requests_submitted"] == len(reqs)
    assert router["requests_completed"] == len(reqs)
    assert router["replicas_live"] == 1
    assert router["dispatched.r0"] + router["dispatched.r1"] == len(reqs)
    assert doc["serving"]["autoscale"]["migrations"] >= 1


# ------------- the router cases of the reference's engine test files
class TestRouterCases:
    """The router cases of tests/test_tp_serving.py (TestRouter),
    test_multi_tick.py (TestRoleSplit) and test_serving_observability.py
    (the replica death's trace, the fleet report), on the port; the
    router over tp engines is tests/test_torch_tp_serving.py's."""

    def test_parity_and_balance(self, setup, want):
        prompts = _prompts(tuple(range(3, 13)), seed=10)
        # the per-replica dispatch counters are process-wide: deltas
        d0 = [monitor.counter(f"serving.router.dispatched.r{i}").value
              for i in (0, 1)]
        router = _router(setup, replicas=2, num_slots=3)
        got = router.generate(prompts, 6)
        for a, p in zip(got, prompts):
            np.testing.assert_array_equal(a, want(p, 6))
        disp = [r["dispatched"] - d for r, d in
                zip(router.stats()["per_replica"], d0)]
        assert sum(disp) == len(prompts)
        assert min(disp) >= len(prompts) // 2 - 1

    def test_replica_death_requeue(self, setup, want):
        prompts = _prompts(tuple(range(3, 13)), seed=11)
        router = _router(setup, replicas=2, num_slots=3)
        reqs = [router.submit(p, 6) for p in prompts]
        for _ in range(3):
            router.step()
        assert router.kill_replica(0) > 0
        assert router.kill_replica(0) == 0
        router.drain()
        assert all(r.done for r in reqs)
        assert all(r.finish_reason in ("length", "eos") for r in reqs)
        assert any(r.requeues == 1 for r in reqs)
        for r, p in zip(reqs, prompts):
            np.testing.assert_array_equal(_tokens(r), want(p, 6))

    def test_all_replicas_dead_never_limbo(self, setup):
        from paddle_tpu_torch.inference.serving import BackpressureError
        router = _router(setup, replicas=2, num_slots=2)
        reqs = [router.submit(p, 6) for p in _prompts((5, 7, 9), seed=12)]
        router.step()
        router.kill_replica(0)
        router.kill_replica(1)
        assert all(r.done and r.finish_reason == "evicted" for r in reqs)
        assert not router.has_work()
        with pytest.raises(BackpressureError):
            router.submit(_prompts((5,), seed=13)[0], 4)

    def test_router_backpressure_and_cancel(self, setup):
        from paddle_tpu_torch.inference import EngineRouter
        from paddle_tpu_torch.inference.serving import BackpressureError
        engines = [_engine(setup, num_slots=1, max_queue=1)
                   for _ in range(2)]
        router = EngineRouter(engines, max_queue=2, concurrent=False)
        accepted, rejected = [], 0
        for p in _prompts(tuple(range(3, 13)), seed=14):
            try:
                accepted.append(router.submit(p, 4))
            except BackpressureError:
                rejected += 1
        assert rejected > 0
        victim = accepted[-1]
        assert victim.cancel()
        assert victim.finish_reason == "cancelled"
        assert not victim.cancel()
        router.drain()
        assert all(r.done for r in accepted)

    def test_pool_exhausted_on_dispatch_never_limbo(self, setup):
        from paddle_tpu_torch.inference import EngineRouter
        big_ok = _engine(setup, num_slots=1, max_queue=1)
        tiny = _engine(setup, num_slots=1, kv_layout="paged", page_size=8,
                       num_pages=2)
        router = EngineRouter([big_ok, tiny], concurrent=False)
        small = _prompts((4, 4, 4), seed=20)
        for p in small:
            router.submit(p, 2)
        r_big = router.submit(_prompts((20,), seed=21)[0], 4)
        assert r_big.replica is None and not r_big.done
        router.kill_replica(0)
        router.drain()
        assert r_big.done and r_big.finish_reason == "evicted"
        assert not router.has_work()

    def test_handoff_parity_zero_reprefill(self, setup, want):
        prompts = _prompts((5, 7, 6, 5), seed=10)
        pre = monitor.counter("serving.prefills").value
        hand = monitor.counter("serving.router.handoffs").value
        router = _router(setup, replicas=2, num_slots=4,
                         roles=["prefill", "decode"])
        got = router.generate(prompts, 8)
        for a, p in zip(got, prompts):
            np.testing.assert_array_equal(a, want(p, 8))
        n = len(prompts)
        assert monitor.counter("serving.prefills").value - pre == n
        assert monitor.counter("serving.router.handoffs").value \
            - hand == n
        st = router.stats()
        assert [r["role"] for r in st["per_replica"]] == ["prefill",
                                                          "decode"]

    def test_prefill_death_degrades_not_stalls(self, setup):
        prompts = _prompts((5, 7, 6, 5), seed=10)
        router = _router(setup, replicas=2, num_slots=2,
                         roles=["prefill", "decode"])
        reqs = [router.submit(p, 6) for p in prompts[:2]]
        router.step()
        router.kill_replica(0, reason="drill")
        reqs += [router.submit(p, 6) for p in prompts[2:]]
        router.drain(max_ticks=200)
        assert all(r.done and r.finish_reason in ("length", "eos")
                   for r in reqs)

    @pytest.mark.parametrize("roles", [["prefill", "prefill"],
                                       ["decode", "decode"], ["prefill"],
                                       ["prefill", "turbo"]])
    def test_roles_validation(self, setup, roles):
        from paddle_tpu_torch.inference import EngineRouter
        engines = [_engine(setup, num_slots=1), _engine(setup, num_slots=1)]
        with pytest.raises(ValueError):
            EngineRouter(engines, roles=roles)

    def test_router_death_severs_and_replays_once(self, setup):
        from paddle_tpu_torch.profiler import tracing
        tracing.clear()
        router = _router(setup, replicas=2, num_slots=2, tracing=True)
        reqs = [router.submit(p, 6)
                for p in _prompts((5, 9, 13, 4, 7, 11), seed=2)]
        h = monitor.histogram("serving.router.dispatch_ms").value
        assert h["n"] >= 1 and h["p99"] >= h["p50"] >= 0.0
        for _ in range(3):
            router.step()
        assert router.kill_replica(0) > 0
        router.drain()
        tr = tracing.tracer()
        replayed = [r for r in reqs if r.requeues]
        assert replayed
        for r in reqs:
            terms = tr.terminal_spans(r.trace.trace_id)
            assert len(terms) == 1, r
            assert terms[0].attrs["reason"] in ("length", "eos")
        for r in replayed:
            spans = tr.spans(r.trace.trace_id)
            names = [s.name for s in spans]
            assert "severed" in names and "replay" in names
            assert [s for s in spans if s.attrs.get("severed")]
            replay = [s for s in spans if s.name == "replay"][0]
            assert replay.attrs["attempt"] == 1
            assert 1 in {s.attrs.get("attempt")
                         for s in spans if s.name == "prefill"}
        router2 = _router(setup, replicas=1, num_slots=2, tracing=True)
        rq = router2.submit(_prompts([5])[0], 6)
        router2.step()
        router2.kill_replica(0)
        assert rq.done and rq.finish_reason == "evicted"
        assert len(tr.terminal_spans(rq.trace.trace_id)) == 1

    def test_router_fan_out_and_fleet_merge(self, setup, tmp_path):
        sys.path.insert(0, os.path.join(REPO, "tools"))
        from telemetry_report import summarize_fleet
        base = str(tmp_path / "fleet.jsonl")
        router = _router(setup, replicas=2, num_slots=2,
                         telemetry_jsonl=base, telemetry_every=1)
        router.generate(_prompts((5, 9, 13, 4)), 4)
        paths = []
        for i, rep in enumerate(router.replicas):
            p = f"{base}.r{i}"
            rep.eng.flush_telemetry(timeout=10)
            rep.eng.export_slo_jsonl(p)
            assert os.path.isfile(p)
            paths.append(p)
        doc = summarize_fleet(paths, ttft_slo_ms=1e9, itl_slo_ms=1e9)
        assert doc["replicas"] == 2
        assert doc["tokens_total"] == sum(
            r["tokens"] for r in doc["per_replica"]) == 4 * (4 - 1)
        assert doc["balance"]["tokens"] == [6, 6]
        assert doc["fleet"]["ttft"]["n"] == 4
        assert doc["fleet"]["inter_token"]["n"] > 0
        assert doc["burn_rate"]["alerts"] == []
