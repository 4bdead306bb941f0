"""Overload resilience in the port against the JAX package: multi-tenant
admission (inference/admission.py), the brownout ladder
(inference/brownout.py), the crash-safe request journal
(inference/journal.py), and their router seams (suspend to host and
resume, journal replay, terminality of every shed, suspended or
rejected request).

The reference's tests (tests/test_admission.py, and
tests/test_serving_robustness.py TestOverloadTraceLeak) hold on the
port with every expected stream taken from the JAX engine; and the two
packages agree where they meet:
- the same charges, orders and preemption questions give the same
  answers, errors and stats from both admission controllers;
- one SLO trajectory drives both brownout controllers through the same
  levels, levers and serving.brownout.* counter deltas;
- the same journal events write byte-identical WALs; a WAL written by
  the JAX router replays in the port's router to the JAX replay's
  streams, and the reverse; a torn tail (`journal_torn`, each package's
  own `faults.install`) recovers to the same intact prefix in both.
"""
import os
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from paddle_tpu.inference import admission as jadm
from paddle_tpu.inference import brownout as jbrown
from paddle_tpu.inference import journal as jjournal
from paddle_tpu.inference.router import create_router as jcreate_router
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.profiler import flight_recorder as jflight
from paddle_tpu.profiler import monitor as jmonitor
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch.inference import admission as tadm
from paddle_tpu_torch.inference import brownout as tbrown
from paddle_tpu_torch.inference import journal as tjournal
from paddle_tpu_torch.inference.admission import (AdmissionController,
                                                  QuotaExceededError,
                                                  TenantQuota)
from paddle_tpu_torch.inference.brownout import (BROWNOUT_LEVELS,
                                                 BrownoutConfig,
                                                 BrownoutController)
from paddle_tpu_torch.inference.journal import WAL_NAME, RequestJournal
from paddle_tpu_torch.inference.router import EngineRouter, create_router
from paddle_tpu_torch.inference.serving import (ServingEngine,
                                                TERMINAL_REASONS)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.profiler import flight_recorder, monitor, tracing
from paddle_tpu_torch.testing import faults

MAXLEN = 32
V = 64


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
    """The reference test's tiny GPT (tests/test_admission.py:49-53), its
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
            memo[key] = eng.generate([prompt], 20)[0]
        return memo[key][:n]
    return get


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, n).astype(np.int32) for n in lens]


def _router(setup, **kw):
    _, tc, params = setup
    kw.setdefault("replicas", 1)
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", MAXLEN)
    kw.setdefault("concurrent", False)
    return create_router(params, tc, family="gpt", device="cpu", **kw)


def _jrouter(setup, **kw):
    jc, _, params = setup
    kw.setdefault("replicas", 1)
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", MAXLEN)
    kw.setdefault("concurrent", False)
    return jcreate_router(params, jc, family="gpt", **kw)


def _engine(setup, **kw):
    _, tc, params = setup
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", MAXLEN)
    return ServingEngine(params, tc, family="gpt", device="cpu", **kw)


def _req(rid, tenant="default", priority=0, done=False):
    return types.SimpleNamespace(id=rid, tenant=tenant, priority=priority,
                                 done=done)


def _assert_resolved(reqs):
    for r in reqs:
        assert r.done and r.finish_reason in TERMINAL_REASONS, \
            (r.id, r.done, r.finish_reason)
        assert r.slot is None


# ------------------------------------------------------------------ quotas
class TestTenantQuota:
    def test_rate_limited_needs_burst(self):
        with pytest.raises(ValueError, match="burst"):
            TenantQuota(tokens_per_s=5.0, burst=0.0)

    def test_weight_positive(self):
        with pytest.raises(ValueError, match="weight"):
            TenantQuota(weight=0.0)

    def test_default_is_unmetered(self):
        q = TenantQuota()
        assert q.tokens_per_s == 0.0 and q.weight == 1.0


class TestTokenBucket:
    def _adm(self, t, **quotas):
        return AdmissionController(quotas, clock=lambda: t[0])

    def test_charge_refill_retry_arithmetic(self):
        t = [0.0]
        adm = self._adm(t, a=TenantQuota(tokens_per_s=5.0, burst=20.0))
        adm.charge("a", 15)                     # level 20 -> 5
        with pytest.raises(QuotaExceededError) as ei:
            adm.charge("a", 10)
        e = ei.value
        assert e.tenant == "a"
        assert e.tokens_requested == 10
        assert e.tokens_available == pytest.approx(5.0)
        assert e.retry_after_s == pytest.approx(1.0)
        adm.charge("a", 5)                      # the reject took nothing
        t[0] += 2.0
        adm.charge("a", 10)

    def test_burst_caps_banking(self):
        t = [0.0]
        adm = self._adm(t, a=TenantQuota(tokens_per_s=5.0, burst=20.0))
        t[0] += 1e6
        with pytest.raises(QuotaExceededError):
            adm.charge("a", 21)
        adm.charge("a", 20)

    def test_unknown_tenant_gets_default_unmetered(self):
        t = [0.0]
        adm = self._adm(t)
        adm.charge("anyone", 10 ** 9)

    def test_stats_reports_live_level(self):
        t = [0.0]
        adm = self._adm(t, a=TenantQuota(tokens_per_s=5.0, burst=20.0))
        adm.charge("a", 15)
        t[0] += 1.0
        assert adm.stats()["a"]["tokens_available"] == pytest.approx(10.0)


# ------------------------------------------------- fairness and preemption
class TestFairOrder:
    def test_priority_strictly_dominates(self):
        adm = AdmissionController()
        reqs = [_req(1, priority=0), _req(2, priority=5),
                _req(3, priority=1)]
        assert [r.id for r in adm.order(reqs)] == [2, 3, 1]

    def test_vtime_orders_equal_priority(self):
        t = [0.0]
        adm = AdmissionController(
            {"heavy": TenantQuota(), "light": TenantQuota()},
            clock=lambda: t[0])
        adm.note_dispatch("heavy", 1000)
        reqs = [_req(1, tenant="heavy"), _req(2, tenant="light"),
                _req(3, tenant="heavy")]
        assert [r.id for r in adm.order(reqs)] == [2, 1, 3]

    def test_weight_scales_virtual_time(self):
        adm = AdmissionController(
            {"w2": TenantQuota(weight=2.0), "w1": TenantQuota()})
        adm.note_dispatch("w2", 100)
        adm.note_dispatch("w1", 100)
        reqs = [_req(1, tenant="w1"), _req(2, tenant="w2")]
        assert [r.id for r in adm.order(reqs)] == [2, 1]


class TestPreemptCandidate:
    def test_picks_lowest_class_most_recent(self):
        adm = AdmissionController()
        inflight = [_req(1, priority=0), _req(2, priority=0),
                    _req(3, priority=1)]
        assert adm.preempt_candidate(inflight, priority=2).id == 2

    def test_never_equalizes_priority(self):
        adm = AdmissionController()
        inflight = [_req(1, priority=1), _req(2, priority=2)]
        assert adm.preempt_candidate(inflight, priority=1) is None

    def test_skips_done(self):
        adm = AdmissionController()
        assert adm.preempt_candidate([_req(1, done=True)], 5) is None


def test_admission_controllers_answer_alike():
    """One script of charges, dispatch notes, orders and preemption
    questions through the JAX controller and the port's on one injected
    clock: the same admits and rejects (with the same retry-after), the
    same orders, the same victims, the same stats."""
    def script(mod):
        t = [0.0]
        adm = mod.AdmissionController(
            {"a": mod.TenantQuota(tokens_per_s=5.0, burst=20.0),
             "b": mod.TenantQuota(tokens_per_s=2.0, burst=8.0, weight=2.0),
             "c": mod.TenantQuota(weight=0.5)}, clock=lambda: t[0])
        log = []
        for step, (tenant, cost) in enumerate(
                [("a", 15), ("a", 10), ("b", 7), ("b", 3), ("c", 10 ** 6),
                 ("a", 5), ("b", 2), ("a", 12)]):
            t[0] += 0.7 * step
            try:
                adm.charge(tenant, cost)
                log.append(("ok", tenant))
                adm.note_dispatch(tenant, cost)
            except mod.QuotaExceededError as e:
                log.append(("rej", tenant, round(e.retry_after_s, 9),
                            round(e.tokens_available, 9)))
        reqs = [_req(i, tenant=tn, priority=p) for i, (tn, p) in enumerate(
            [("a", 0), ("b", 0), ("c", 1), ("a", 1), ("b", -1), ("c", 0)])]
        log.append([r.id for r in adm.order(reqs)])
        for prio in (-1, 0, 1, 2):
            v = adm.preempt_candidate(reqs, prio)
            log.append(None if v is None else v.id)
        log.append(adm.stats())
        return log
    assert script(tadm) == script(jadm)


# ------------------------------------------------------------- the WAL
class TestJournal:
    def _admit(self, j, rid, prompt=(1, 2, 3), n=4):
        j.record_admit(rid, list(prompt), n, 0.0, 0, None, "default", 0)

    def test_round_trip_and_next_id(self, tmp_path):
        j = RequestJournal(str(tmp_path))
        self._admit(j, 1)
        self._admit(j, 2)
        j.record_terminal(1, "length", tokens=4)
        j.close()
        j2 = RequestJournal(str(tmp_path))
        reps = j2.replayable()
        assert [r["id"] for r in reps] == [2]
        assert reps[0]["prompt"] == [1, 2, 3]
        assert reps[0]["max_new_tokens"] == 4
        assert j2.next_id == 3
        j2.close()

    def test_end_only_ids_never_replay(self, tmp_path):
        j = RequestJournal(str(tmp_path))
        j.record_terminal(7, "rejected", tokens=0)
        j.close()
        j2 = RequestJournal(str(tmp_path))
        assert j2.replayable() == []
        assert j2.next_id == 8
        j2.close()

    def test_torn_tail_truncated_to_intact_prefix(self, tmp_path):
        j = RequestJournal(str(tmp_path))
        self._admit(j, 1)
        self._admit(j, 2)
        j.close()
        path = os.path.join(str(tmp_path), WAL_NAME)
        intact = os.path.getsize(path)
        with open(path, "ab") as f:
            f.write(b"deadbeef {\"op\": \"adm")
        torn0 = monitor.counter("serving.journal.torn").value
        j2 = RequestJournal(str(tmp_path))
        assert [r["id"] for r in j2.replayable()] == [1, 2]
        assert os.path.getsize(path) == intact
        assert monitor.counter("serving.journal.torn").value > torn0
        j2.close()

    def test_corrupt_crc_stops_scan(self, tmp_path):
        j = RequestJournal(str(tmp_path))
        self._admit(j, 1)
        self._admit(j, 2)
        j.close()
        path = os.path.join(str(tmp_path), WAL_NAME)
        raw = open(path, "rb").read().splitlines(keepends=True)
        with open(path, "wb") as f:
            f.write(raw[0] + raw[1][:12] + b"X" + raw[1][13:])
        j2 = RequestJournal(str(tmp_path))
        assert [r["id"] for r in j2.replayable()] == [1]
        j2.close()


def _wal_events(j):
    j.record_admit(0, [5, 6, 7], 4, 0.0, 0, None, "default", 0)
    j.record_admit(1, [9, 1], 6, 0.8, 5, 3, "paying", 2)
    j.record_terminal(0, "length", tokens=4)
    j.record_terminal(2, "rejected", tokens=0)
    j.record_admit(3, [4] * 7, 2, 1.25, 0, None, "flood", -1)
    j.close()


def test_wal_bytes_equal_the_reference(tmp_path):
    """The same events through both journals write the same bytes."""
    _wal_events(RequestJournal(str(tmp_path / "port")))
    _wal_events(jjournal.RequestJournal(str(tmp_path / "jax")))
    a = open(tmp_path / "port" / WAL_NAME, "rb").read()
    b = open(tmp_path / "jax" / jjournal.WAL_NAME, "rb").read()
    assert a == b and a.count(b"\n") == 5


@pytest.mark.parametrize("tear", [1, 17, 60])
def test_torn_tail_recovers_the_same_prefix(tmp_path, tear):
    """`journal_torn@N` through each package's own faults.install: both
    recoveries keep the same intact prefix, replay the same records and
    leave the same bytes."""
    out = {}
    for name, mod, fmod in (("port", tjournal, faults),
                            ("jax", jjournal, jfaults)):
        d = tmp_path / name
        _wal_events(mod.RequestJournal(str(d)))
        fmod.install(f"journal_torn@{tear}",
                     once_dir=str(tmp_path / f"once_{name}"))
        try:
            j = mod.RequestJournal(str(d))
        finally:
            fmod.uninstall()
        out[name] = (j.torn_bytes, j.replayable(), j.next_id,
                     open(d / WAL_NAME, "rb").read())
        j.close()
    assert out["port"] == out["jax"]
    assert out["port"][3] != b""


def _journal_run(router, prompts, n):
    """Submit, then "crash": only the fsynced WAL is left."""
    for i, p in enumerate(prompts):
        router.submit(p, n, temperature=0.8 if i == 1 else 0.0,
                      top_k=5 if i == 1 else 0)
    router.close()


def _replay(router):
    streams = {}
    while router.has_work():
        for req, tok in router.step():
            streams.setdefault(req.id, []).append(int(tok))
    j = router.stats()["journal"]
    router.close()
    return streams, j


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_wal_crosses_packages(setup, tmp_path, direction):
    """A WAL written by one package's router (one request sampled)
    replays in the other's to the streams the writer's own replay
    gives, with every admit ending once."""
    prompts = _prompts([4, 6, 5], seed=43)
    write, other = ((_jrouter, _router) if direction == "jax_to_port"
                    else (_router, _jrouter))
    kw = dict(num_slots=3, max_top_k=8)
    _journal_run(write(setup, journal_dir=str(tmp_path / "a"), **kw),
                 prompts, 6)
    wal = open(tmp_path / "a" / WAL_NAME, "rb").read()
    os.makedirs(tmp_path / "b")
    with open(tmp_path / "b" / WAL_NAME, "wb") as f:
        f.write(wal)
    own, j_own = _replay(write(setup, journal_dir=str(tmp_path / "a"),
                               **kw))
    cross, j_cross = _replay(other(setup, journal_dir=str(tmp_path / "b"),
                                   **kw))
    assert sorted(cross) == [0, 1, 2] and cross == own
    assert j_cross == j_own
    assert j_cross["replayable"] == 0 and j_cross["ends"] == 3


# ---------------------------------------- router: replay, suspend, resume
class TestRouterReplay:
    def test_crash_replay_bit_identical(self, setup, tmp_path):
        prompts = _prompts([3, 5], seed=40)
        r1 = _router(setup, journal_dir=str(tmp_path))
        a = r1.submit(prompts[0], 6)
        b = r1.submit(prompts[1], 6)
        del r1
        replays0 = monitor.counter("serving.journal.replays").value
        r2 = _router(setup, journal_dir=str(tmp_path))
        assert r2.stats()["pending"] == 2
        assert monitor.counter("serving.journal.replays").value \
            - replays0 == 2
        r2.drain()
        j = r2.stats()["journal"]
        assert j["replayable"] == 0
        assert j["ends"] == j["admits"] == 2
        c = r2.submit(prompts[0], 2)
        assert c.id > max(a.id, b.id)
        r2.drain()
        r2.close()

    def test_replayed_streams_match_oracle(self, setup, want, tmp_path):
        prompts = _prompts([4, 6], seed=41)
        r1 = _router(setup, journal_dir=str(tmp_path))
        for p in prompts:
            r1.submit(p, 5)
        del r1
        r2 = _router(setup, journal_dir=str(tmp_path))
        streams, j = _replay(r2)
        assert sorted(streams) == [0, 1]
        for rid, p in zip((0, 1), prompts):
            np.testing.assert_array_equal(
                np.asarray(streams[rid], np.int32),
                want(p, 5)[:len(streams[rid])])
        assert j["replayable"] == 0


class TestSuspendResume:
    def test_zero_reprefill_and_bit_parity(self, setup, want, tmp_path):
        router = _router(setup, admission={}, journal_dir=str(tmp_path))
        prompts = _prompts([3, 4, 5], seed=42)
        low = [router.submit(p, 12, priority=0) for p in prompts[:2]]
        for _ in range(3):
            router.step()
        pre0 = monitor.counter("serving.prefills").value
        pmt0 = monitor.counter("serving.admission.preemptions").value
        hi = router.submit(prompts[2], 12, priority=5)
        assert router.stats()["suspended"] == 1
        assert monitor.counter(
            "serving.admission.preemptions").value - pmt0 == 1
        router.drain()
        # one new prefill: the high-priority request's; the resumed
        # victim re-prefilled nothing
        assert monitor.counter("serving.prefills").value == pre0 + 1
        for r, p in zip(low + [hi], prompts):
            assert r.done and r.finish_reason in ("length", "eos")
            assert r.requeues == 0
            np.testing.assert_array_equal(np.asarray(r.tokens, np.int32),
                                          want(p, 12)[:len(r.tokens)])
        assert router.stats()["suspended"] == 0
        router.close()


# ---------------------------------------------------------- the brownout
class _Obj:
    def __init__(self, name="ttft_p99"):
        self.name = name


class _FakeSLO:
    """BurnRateMonitor stand-in: pairs, objectives, burn_rate()."""

    def __init__(self):
        self.pairs = [(3600.0, 60.0)]
        self.objectives = [_Obj()]
        self.burn = 0.0

    def burn_rate(self, name, window, now=None):
        return self.burn


class _LeverRouter:
    """Records the brownout levers; _ticks for the flight note."""

    def __init__(self):
        self.calls = []
        self._ticks = 0
        self._clock = lambda: 0.0

    def set_spec_drafts(self, on):
        self.calls.append(("spec", bool(on)))
        return bool(on)

    def set_resume_hold(self, on):
        self.calls.append(("hold", bool(on)))

    def suspend_lowest_class(self):
        self.calls.append(("suspend", None))
        return 1

    def shed_oldest_pending(self, n=1):
        self.calls.append(("shed", n))
        return n


class TestBrownout:
    def _ctrl(self, slo, router=None, **cfg):
        cfg.setdefault("breach_ticks", 2)
        cfg.setdefault("recover_ticks", 2)
        cfg.setdefault("cooldown_s", 0.0)
        t = [0.0]
        ctrl = BrownoutController(router or _LeverRouter(), slo=slo,
                                  cfg=BrownoutConfig(**cfg),
                                  clock=lambda: t[0])
        return ctrl, t

    def test_full_ladder_up_and_down(self):
        slo = _FakeSLO()
        ctrl, t = self._ctrl(slo)
        r = ctrl.router
        slo.burn = 2.0
        moves = []
        for _ in range(8):
            t[0] += 1.0
            m = ctrl.tick()
            if m:
                moves.append((m, ctrl.level))
        assert moves == [("escalate", 1), ("escalate", 2),
                         ("escalate", 3)]
        assert ctrl.level == 3 == ctrl.cfg.max_level
        assert monitor.gauge("serving.brownout_level").value == 3
        assert ("spec", False) in r.calls
        assert ("hold", True) in r.calls and ("suspend", None) in r.calls
        assert [c for c in r.calls if c[0] == "shed"]
        r.calls.clear()
        slo.burn = 0.0
        moves = []
        for _ in range(8):
            t[0] += 1.0
            m = ctrl.tick()
            if m:
                moves.append((m, ctrl.level))
        assert moves == [("recover", 2), ("recover", 1), ("recover", 0)]
        assert ctrl.level == 0
        assert monitor.gauge("serving.brownout_level").value == 0
        assert ("hold", False) in r.calls and ("spec", True) in r.calls

    def test_hysteresis_needs_consecutive_breaches(self):
        slo = _FakeSLO()
        ctrl, t = self._ctrl(slo, breach_ticks=3)
        slo.burn = 2.0
        for _ in range(2):
            t[0] += 1.0
            assert ctrl.tick() is None
        slo.burn = 0.0
        t[0] += 1.0
        assert ctrl.tick() is None
        slo.burn = 2.0
        for _ in range(2):
            t[0] += 1.0
            assert ctrl.tick() is None
        t[0] += 1.0
        assert ctrl.tick() == "escalate"

    def test_cooldown_gates_transitions(self):
        slo = _FakeSLO()
        ctrl, t = self._ctrl(slo, cooldown_s=10.0)
        slo.burn = 2.0
        for _ in range(4):
            t[0] += 1.0
            ctrl.tick()
        assert ctrl.level == 1
        t[0] += 10.0
        for _ in range(2):
            ctrl.tick()
        assert ctrl.level == 2

    def test_without_slo_never_escalates(self):
        ctrl, t = self._ctrl(None)
        for _ in range(10):
            t[0] += 1.0
            assert ctrl.tick() is None
        assert ctrl.level == 0

    def test_max_level_validated(self):
        with pytest.raises(ValueError, match="max_level"):
            BrownoutConfig(max_level=9)


def _brownout_counters(mon):
    snap = mon.snapshot()
    return {k: mon.registry().get(k).value for k in snap
            if k.startswith("serving.brownout")}


def test_brownout_controllers_move_alike():
    """One burn trajectory through the JAX controller and the port's: the
    same transitions, levers, levels and serving.brownout.* deltas."""
    burns = [2.0] * 7 + [0.0, 2.0] + [0.0] * 9

    def run(mod, mon):
        slo = _FakeSLO()
        t = [0.0]
        lever = _LeverRouter()
        ctrl = mod.BrownoutController(
            lever, slo=slo, cfg=mod.BrownoutConfig(
                breach_ticks=2, recover_ticks=3, cooldown_s=1.5,
                shed_per_tick=3), clock=lambda: t[0])
        c0 = _brownout_counters(mon)
        moves = []
        for b in burns:
            slo.burn = b
            t[0] += 1.0
            moves.append((ctrl.tick(), ctrl.level))
        c1 = _brownout_counters(mon)
        return moves, lever.calls, {k: v - c0.get(k, 0)
                                    for k, v in c1.items()}
    assert run(jbrown, jmonitor) == run(tbrown, monitor)
    assert BROWNOUT_LEVELS == jbrown.BROWNOUT_LEVELS


class TestSpecDraftLever:
    def test_specless_engine_noop(self, setup):
        _, tc, params = setup
        eng = _engine(setup)
        span0 = eng._tick_span
        assert eng.set_spec_drafts(True) is False
        assert eng.set_spec_drafts(False) is False
        assert eng._tick_span == span0
        from paddle_tpu_torch.models import GPTModel
        from paddle_tpu_torch.models.convert import params_from_jax
        gm = GPTModel(tc, device="cpu", params=params_from_jax(params,
                                                                "cpu"))
        prompts = _prompts([4, 6], seed=25)
        outs = gm.generate(prompts, 8, num_slots=2, max_len=MAXLEN,
                           deadline_ticks=3, max_ticks=16)
        assert all(0 < len(o) == 5 < 8 for o in outs)
        eng = gm._engine
        gm.generate(prompts, 4, num_slots=2, max_len=MAXLEN)
        assert gm._engine is eng
        gm.generate(prompts, 4, num_slots=2, max_len=MAXLEN, max_queue=8)
        assert gm._engine is not eng
        assert gm._engine.max_queue == 8

    def test_spec_engine_flips_and_streams_hold(self, setup, want):
        """A spec engine's drafts off and on again mid-stream: the greedy
        streams are the JAX engine's throughout, and the tick span
        follows the flag."""
        eng = _engine(setup, num_slots=3, spec_decode="spec", gamma=2,
                      draft_layers=1)
        prompts = _prompts([5, 8, 6], seed=26)
        reqs = [eng.submit(p, 14) for p in prompts]
        spans = []
        for i in range(40):
            if not eng.has_work():
                break
            if i == 2:
                assert eng.set_spec_drafts(False) is False
            if i == 5:
                assert eng.set_spec_drafts(True) is True
            spans.append(eng._tick_span)
            eng.step()
        assert 1 in spans and 3 in spans
        for r, p in zip(reqs, prompts):
            np.testing.assert_array_equal(np.asarray(r.tokens, np.int32),
                                          want(p, 14))


# ------------------------------------- overload terminality (trace leaks)
class TestOverloadTraceLeak:
    """Every shed, suspended or quota-rejected request leaves exactly one
    terminal trace span and one journal terminal event, before any error
    reaches the caller (tests/test_serving_robustness.py:519-616)."""

    def _router(self, setup, **kw):
        kw.setdefault("tracing", True)
        return _router(setup, **kw)

    def _assert_no_leaks(self, router):
        tr = tracing.tracer()
        for tid in tr.trace_ids():
            assert len(tr.terminal_spans(tid)) == 1, tid
        j = router.stats().get("journal")
        if j is not None:
            assert j["replayable"] == 0

    def test_quota_reject_terminal_before_raise(self, setup, tmp_path):
        tracing.clear()
        router = self._router(
            setup, journal_dir=str(tmp_path),
            admission={"t": TenantQuota(tokens_per_s=1.0, burst=4.0)})
        with pytest.raises(QuotaExceededError) as ei:
            router.submit(_prompts([3], seed=30)[0], 8, tenant="t")
        assert ei.value.retry_after_s > 0
        tr = tracing.tracer()
        assert len(tr.trace_ids()) == 1
        terms = tr.terminal_spans(tr.trace_ids()[0])
        assert len(terms) == 1
        assert terms[0].attrs["reason"] == "rejected"
        j = router.stats()["journal"]
        assert j["admits"] == 0 and j["ends"] == 1
        assert j["replayable"] == 0
        router.close()

    def test_shed_terminal_once(self, setup, tmp_path):
        tracing.clear()
        eng = _engine(setup, num_slots=2, max_queue=1)
        router = EngineRouter([eng], tracing=True, admission={},
                              journal_dir=str(tmp_path))
        prompts = _prompts([3, 4, 5, 6], seed=31)
        reqs = [router.submit(p, 6) for p in prompts]
        assert router.stats()["pending"] >= 1
        assert router.shed_oldest_pending(1) == 1
        victim = [r for r in reqs if r.done][0]
        assert victim.finish_reason == "evicted"
        router.drain()
        _assert_resolved(reqs)
        self._assert_no_leaks(router)
        j = router.stats()["journal"]
        assert j["admits"] == len(reqs) and j["ends"] == len(reqs)
        router.close()

    def test_suspend_resume_terminal_once(self, setup, tmp_path):
        tracing.clear()
        router = self._router(setup, journal_dir=str(tmp_path),
                              admission={})
        prompts = _prompts([3, 4, 5], seed=32)
        low = [router.submit(p, 10, priority=0) for p in prompts[:2]]
        for _ in range(3):
            router.step()
        hi = router.submit(prompts[2], 10, priority=5)
        assert router.stats()["suspended"] == 1
        router.drain()
        _assert_resolved(low + [hi])
        tr = tracing.tracer()
        victim = [r for r in low if r.requeues == 0 and any(
            s.name == "suspend" for s in tr.spans(r.trace.trace_id))][0]
        names = [s.name for s in tr.spans(victim.trace.trace_id)]
        assert "suspend" in names and "resume" in names
        self._assert_no_leaks(router)
        router.close()
