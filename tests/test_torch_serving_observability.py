"""The serving engine's observability in the port against the JAX
package: the in-tick TICK_FIELDS row riding the one pull, its records
tick for tick on the dense, paged, spec and multi_tick=2 engines, the
env kill switch, request span trees, SLO burn rates, the Histogram kind
and tools/telemetry_report.py over a port engine's stream."""
import json
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.profiler import tracing as jtracing
from paddle_tpu.profiler import slo as jslo
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.profiler import flight_recorder, monitor, tracing
from paddle_tpu_torch.profiler.serving_telemetry import (
    TICK_FIELDS, pack_tick_fields, resolve_serving_telemetry)
from paddle_tpu_torch.profiler.slo import Alert, BurnRateMonitor, Objective
from paddle_tpu_torch.testing import faults

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

MAX_LEN = 64
GEN = 6
LENS = (5, 9, 13)
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
def _clean():
    tracing.clear()
    jtracing.clear()
    yield
    faults.uninstall()
    rec = flight_recorder.recorder()
    rec.clear()
    rec.set_dir(None)


@pytest.fixture(scope="module")
def setup():
    """The reference test's tiny GPT (tests/test_serving_observability.py:
    43-47), numpy weights at a std under which streams change."""
    jc = jgpt.GPTConfig(vocab_size=V, hidden_size=32, num_layers=2,
                        num_heads=2, ffn_hidden=64, max_seq_len=128,
                        sequence_parallel=False, remat=False,
                        dtype=jnp.float32)
    tc = tgpt.GPTConfig(vocab_size=V, hidden_size=32, num_layers=2,
                        num_heads=2, ffn_hidden=64, max_seq_len=128,
                        dtype=torch.float32)
    shapes = {k: v.shape for k, v in
              jgpt.init_gpt_params(jc, jax.random.PRNGKey(0)).items()}
    rng = np.random.RandomState(1)
    params = {}
    for k, shp in shapes.items():
        if k.endswith("_w") or k in ("wte", "wpe"):
            params[k] = rng.randn(*shp).astype(np.float32) * 0.3
        elif k.endswith("_scale"):
            params[k] = 1.0 + 0.1 * rng.randn(*shp).astype(np.float32)
        else:
            params[k] = 0.05 * rng.randn(*shp).astype(np.float32)
    return jc, tc, params


def _prompts(lens=LENS, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 60, n).astype(np.int32) for n in lens]


def _engine(setup, **kw):
    _, tc, params = setup
    kw.setdefault("num_slots", 3)
    return ServingEngine(params, tc, family="gpt", max_len=MAX_LEN,
                         device="cpu", **kw)


@pytest.fixture(scope="module")
def base_streams(setup):
    """The JAX engine's telemetry-off streams of the default prompts."""
    jc, _, params = setup
    eng = JaxEngine(params, jc, family="gpt", max_len=MAX_LEN, num_slots=3,
                    telemetry="off")
    return [list(map(int, o)) for o in eng.generate(_prompts(), GEN)]


def _count_pulls(eng):
    counts = [0]
    orig = eng._pull

    def counted(value, stall_s=0.0):
        counts[0] += 1
        return orig(value, stall_s)
    eng._pull = counted
    return counts


def _ticks(eng):
    return [r for r in eng.tick_records() if r["kind"] == "serving_tick"]


def _rows(eng):
    """Each serving_tick record's device fields and host fields."""
    return [(r["tick"],) + tuple(r[f] for f in TICK_FIELDS)
            + tuple(r.get(k) for k in ("queue_depth", "prefilling",
                                       "pages_in_use"))
            for r in _ticks(eng)]


# ------------------------------------------------------------- the field row
def test_pack_tick_fields_and_resolve(monkeypatch):
    row = pack_tick_fields(tokens=torch.tensor(3), active=torch.tensor(4),
                           spec_proposed=6)
    assert row.dtype == torch.int32
    assert row.tolist() == [3, 4, 0, 0, 6, 0]
    with pytest.raises(ValueError, match="unknown tick fields"):
        pack_tick_fields(tokens=torch.tensor(1), bogus=torch.tensor(1))
    assert resolve_serving_telemetry("auto") and \
        resolve_serving_telemetry("on")
    assert not resolve_serving_telemetry("off")
    with pytest.raises(ValueError):
        resolve_serving_telemetry("maybe")
    monkeypatch.setenv("PADDLE_TPU_SERVING_TELEMETRY", "on")
    assert not resolve_serving_telemetry("off")     # never re-enables
    monkeypatch.setenv("PADDLE_TPU_SERVING_TELEMETRY", "0")
    assert not resolve_serving_telemetry("on")      # the kill switch


ENGINES = {
    "dense": {},
    "paged": dict(kv_layout="paged", page_size=8, prefill_chunk=4),
    "spec": dict(spec_decode="spec", gamma=3, draft_layers=2),
    "mt2": dict(multi_tick=2),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_tick_records_equal_jax_engine(setup, base_streams, name):
    """Every serving_tick record's TICK_FIELDS and host fields equal the
    JAX engine's tick for tick (the K = 2 body eagerly on the CPU), the
    streams equal telemetry off, one pull a prefill and a dispatch."""
    jc, _, params = setup
    kw = ENGINES[name]
    je = JaxEngine(params, jc, family="gpt", max_len=MAX_LEN, num_slots=3,
                   **kw)
    je.generate(_prompts(), GEN)
    eng = _engine(setup, **kw)
    assert eng._tick_tele
    pulls = _count_pulls(eng)
    outs = eng.generate(_prompts(), GEN)
    assert [list(map(int, o)) for o in outs] == base_streams
    assert _rows(eng) == _rows(je)
    c = eng.counters
    assert pulls[0] == c["prefills"] + c["decode_ticks"]
    ticks = _ticks(eng)
    pre = [r for r in eng.tick_records() if r["kind"] == "serving_prefill"]
    # every token is a prefill's first or a tick's emission; a spec
    # block's row counts what the device advanced, beyond what a
    # mid-block finish drops from the stream
    emitted = sum(r["tokens"] for r in ticks) + c["prefills"]
    assert emitted >= len(LENS) * GEN if eng.spec else \
        emitted == len(LENS) * GEN
    assert len(pre) == c["prefill_chunks" if eng.paged else "prefills"]
    assert ticks[0]["attended"] > 0 and all(r["poisoned"] == 0
                                            for r in ticks)
    if name == "spec":
        prop = sum(r["spec_proposed"] for r in ticks)
        acc = sum(r["spec_accepted"] for r in ticks)
        assert prop > 0 and 0 <= acc <= prop
        assert (prop, acc) == (eng._spec_prop_total, eng._spec_acc_total)
    if name == "paged":
        assert any(r["pages_in_use"] > 0 for r in ticks)
        assert any(r["prefilling"] > 0 for r in ticks)


def test_telemetry_off_same_bits_same_pulls(setup, base_streams):
    eng = _engine(setup, telemetry="off")
    pulls = _count_pulls(eng)
    outs = eng.generate(_prompts(), GEN)
    assert [list(map(int, o)) for o in outs] == base_streams
    assert eng.tick_records() == []
    assert pulls[0] == eng.counters["prefills"] + \
        eng.counters["decode_ticks"]


def test_poisoned_field_counts_quarantine(setup):
    eng = _engine(setup)
    faults.install("nan_logits@2:1")
    reqs = [eng.submit(p, GEN) for p in _prompts()]
    eng.drain()
    faults.uninstall()
    assert [r.finish_reason for r in reqs].count("poisoned") == 1
    assert sum(r["poisoned"] for r in _ticks(eng)) == 1


def test_env_kill_switch(setup, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SERVING_TELEMETRY", "off")
    eng = _engine(setup, telemetry="on")
    assert not eng._tick_tele
    eng.generate(_prompts([5]), 3)
    assert eng.tick_records() == []


def test_jsonl_stream_and_report(setup, tmp_path):
    """tools/telemetry_report.py reads a port engine's telemetry_jsonl
    stream (serving_run, serving_tick, serving_prefill) and its
    export_slo_jsonl (serving_slo)."""
    from telemetry_report import summarize
    path = str(tmp_path / "serve.jsonl")
    eng = _engine(setup, telemetry_jsonl=path, telemetry_every=4)
    eng.generate(_prompts(), GEN)
    eng.flush_telemetry(timeout=10)
    monitor.registry().export_jsonl(path)
    eng.export_slo_jsonl(path)
    kinds = {json.loads(line)["kind"] for line in open(path)}
    assert {"serving_run", "serving_tick", "serving_prefill",
            "serving_slo"} <= kinds
    doc = summarize(path)
    blk = doc["serving_ticks"]
    assert blk["ticks"] == eng.counters["decode_ticks"]
    assert blk["tokens"] == len(LENS) * (GEN - 1)
    assert blk["dur_ms_p50"] <= blk["dur_ms_p95"]
    assert blk["prefills"] == len(LENS)
    assert blk["engine"]["layout"] == "dense"
    srv = doc["serving"]
    for section in ("ttft", "inter_token"):
        assert {"n", "p50_ms", "p95_ms", "p99_ms"} <= set(srv[section])
        assert srv[section]["p50_ms"] <= srv[section]["p99_ms"]
    assert srv["ttft"]["n"] == len(LENS)
    assert srv["inter_token"]["n"] == len(LENS) * (GEN - 1)
    # the export drains the rings: a second one adds no sample twice
    eng.export_slo_jsonl(path)
    assert summarize(path)["serving"]["ttft"]["n"] == len(LENS)


def test_slo_samples(setup):
    eng = _engine(setup)
    eng.generate(_prompts(), GEN)
    snap = eng.slo_snapshot()
    assert len(snap["ttft_ms"]) == len(LENS)
    assert len(snap["itl_ms"]) == len(LENS) * (GEN - 1)
    assert all(v >= 0 for v in snap["ttft_ms"] + snap["itl_ms"])


# ----------------------------------------------------------------- tracing
def _tree(tr, trace_id):
    """A trace as (name, kind, parent's name, reason) in emission order
    of span ids."""
    spans = sorted(tr.spans(trace_id), key=lambda s: s.span_id)
    names = {s.span_id: s.name for s in spans}
    return [(s.name, s.kind, names.get(s.parent_id),
             s.attrs.get("reason")) for s in spans]


def test_full_lifecycle_parented_chrome_trace(setup, tmp_path):
    """One request on the paged engine with chunked prefill: queue,
    prefill chunks and decode under the root, a decode.tick instant a
    token under the decode span, one terminal span, a chrome export that
    loads; the tree equals the JAX engine's."""
    jc, _, params = setup
    kw = dict(tracing=True, kv_layout="paged", page_size=8,
              prefill_chunk=4, prefix_sharing=False)
    eng = _engine(setup, **kw)
    req = eng.submit(_prompts([13])[0], GEN)
    eng.drain()
    assert req.done and req.finish_reason == "length"
    tr = tracing.tracer()
    spans = tr.spans(req.trace.trace_id)
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    root = by_name[f"request-{req.id}"][0]
    assert root.parent_id is None
    assert len(by_name["prefill"]) >= 2        # 13 tokens in 4-chunks
    for name in ("queue", "prefill", "decode"):
        for s in by_name[name]:
            assert s.parent_id == root.span_id
    decode_id = by_name["decode"][0].span_id
    ticks = [s for s in spans if s.name == "decode.tick"]
    assert len(ticks) == GEN
    assert all(s.parent_id == decode_id for s in ticks)
    terms = tr.terminal_spans(req.trace.trace_id)
    assert len(terms) == 1 and terms[0].attrs["reason"] == "length"
    path = str(tmp_path / "trace.json")
    tr.export_chrome_trace(path)
    evs = json.load(open(path))["traceEvents"]
    assert any(e.get("cat") == "terminal" for e in evs)
    assert any(e["ph"] == "X" and e["name"] == "prefill" for e in evs)
    je = JaxEngine(params, jc, family="gpt", max_len=MAX_LEN, num_slots=3,
                   **kw)
    jreq = je.submit(_prompts([13])[0], GEN)
    je.drain()
    assert _tree(tr, req.trace.trace_id) == \
        _tree(jtracing.tracer(), jreq.trace.trace_id)


def test_terminal_reasons_cancel_timeout(setup):
    """One terminal span a request whatever ends it, and the trees equal
    the JAX engine's under the same schedule."""
    jc, _, params = setup
    trees = {}
    for side, tr in (("torch", tracing.tracer()),
                     ("jax", jtracing.tracer())):
        eng = (_engine(setup, num_slots=1, tracing=True) if side == "torch"
               else JaxEngine(params, jc, family="gpt", max_len=MAX_LEN,
                              num_slots=1, tracing=True))
        ps = _prompts([5, 5, 5])
        r0 = eng.submit(ps[0], GEN)
        r1 = eng.submit(ps[1], GEN)
        r2 = eng.submit(ps[2], GEN, deadline_ticks=1)
        eng.step()
        r1.cancel()
        eng.drain()
        for req, want in ((r0, "length"), (r1, "cancelled"),
                          (r2, "timeout")):
            terms = tr.terminal_spans(req.trace.trace_id)
            assert len(terms) == 1, req
            assert terms[0].attrs["reason"] == want
        trees[side] = [_tree(tr, r.trace.trace_id) for r in (r0, r1, r2)]
    assert trees["torch"] == trees["jax"]


def test_sever_and_replay_link():
    """The fleet's replay seam: sever closes the open subtree without
    finishing, link_replay bumps the attempt, finish stays once-only."""
    t = tracing.tracer().trace("request-x")
    sp = t.begin("decode")
    t.sever("replica death")
    assert tracing.tracer()._open_of(t.trace_id) == []
    assert t.link_replay() is not None and t.attempt == 1
    assert t.finish("length") and not t.finish("evicted")
    names = [s.name for s in tracing.tracer().spans(t.trace_id)]
    assert {"severed", "replay", "finish"} <= set(names)
    closed = [s for s in tracing.tracer().spans(t.trace_id)
              if s.span_id == sp][0]
    assert closed.attrs["severed"]


# --------------------------------------------------------------- burn rates
class TestBurnRate:
    def _mon(self, clock, mod=None, **kw):
        mod = mod or sys.modules[BurnRateMonitor.__module__]
        kw.setdefault("pairs", ((300.0, 30.0),))
        kw.setdefault("cooldown_s", 0.0)
        return mod.BurnRateMonitor(
            [mod.Objective("ttft_p99", "ttft", "latency",
                           threshold_ms=100.0, budget=0.1),
             mod.Objective("errors", "errors", "event", budget=0.01)],
            clock=clock, **kw)

    def test_burn_rate_math(self):
        now = [1000.0]
        mon = self._mon(lambda: now[0])
        # 20 samples, 4 bad -> bad fraction 0.2, budget 0.1 -> 2x
        mon.observe_latency("ttft", [50.0] * 16 + [500.0] * 4)
        assert mon.burn_rate("ttft_p99", 300.0) == pytest.approx(2.0)
        now[0] += 60.0
        assert mon.burn_rate("ttft_p99", 30.0) == 0.0
        assert mon.burn_rate("ttft_p99", 300.0) == pytest.approx(2.0)

    def test_multiwindow_gating_and_cooldown(self):
        now = [1000.0]
        mon = self._mon(lambda: now[0], cooldown_s=120.0)
        mon.observe_latency("ttft", [500.0] * 10, t=now[0] - 60.0)
        assert mon.check(flight=False) == []      # short window clean
        mon.observe_latency("ttft", [500.0] * 10)
        alerts = mon.check(flight=False)
        assert len(alerts) == 1 and isinstance(alerts[0], Alert)
        assert alerts[0].objective == "ttft_p99"
        assert mon.check(flight=False) == []      # cooldown
        now[0] += 121.0
        mon.observe_latency("ttft", [500.0] * 10)
        assert len(mon.check(flight=False)) == 1

    def test_equal_to_reference_on_equal_inputs(self):
        """The same history through both packages' monitors: the same
        alerts, the same burn rates, the same summary."""
        got = {}
        for mod in (sys.modules[BurnRateMonitor.__module__], jslo):
            now = [1000.0]
            mon = self._mon(lambda: now[0], mod=mod, cooldown_s=50.0,
                            pairs=((300.0, 30.0), (60.0, 5.0)))
            log = []
            for i in range(12):
                mon.observe_latency("ttft", [40.0 + 20 * i] * 3)
                mon.observe_events("errors", bad=i % 3, total=10)
                log.append([a.to_dict() for a in mon.check(flight=False)])
                log.append(mon.burn_rates())
                now[0] += 7.0
            log.append(mon.summary())
            got[mod.__name__] = log
        a, b = got.values()
        assert a == b and any(a[0::2][:12])

    def test_event_objective_counters_and_flight(self, tmp_path):
        now = [1000.0]
        mon = self._mon(lambda: now[0])
        c0 = monitor.counter("slo.alerts").value
        mon.observe_events("errors", bad=5, total=10)    # 50x budget
        rec = flight_recorder.recorder()
        rec.set_dir(str(tmp_path))
        alerts = mon.check()
        assert len(alerts) == 1
        assert monitor.counter("slo.alerts").value == c0 + 1
        assert monitor.counter("slo.alerts.errors").value >= 1
        dumps = [f for f in os.listdir(tmp_path) if "slo_burn_alert" in f]
        doc = flight_recorder.load_dump(os.path.join(tmp_path, dumps[0]))
        assert doc["reason"] == "slo_burn_alert"
        assert doc["config"]["last_slo_alert"]["objective"] == "errors"

    def test_feeds_engine_slo_records(self, setup, tmp_path):
        eng = _engine(setup)
        eng.generate(_prompts(), GEN)
        path = str(tmp_path / "slo.jsonl")
        eng.export_slo_jsonl(path)
        mon = BurnRateMonitor(
            [Objective("itl", "itl", "latency", threshold_ms=0.0001,
                       budget=0.001)], pairs=((300.0, 30.0),))
        for line in open(path):
            rec = json.loads(line)
            if rec.get("kind") == "serving_slo":
                mon.feed_slo_record(rec)
        assert mon.check(flight=False)

    def test_validation(self):
        with pytest.raises(ValueError):
            Objective("x", "s", "nope")
        with pytest.raises(ValueError):
            Objective("x", "s", budget=0.0)
        with pytest.raises(ValueError):
            BurnRateMonitor([Objective("x", "s")], pairs=((5.0, 60.0),))
        mon = BurnRateMonitor([Objective("x", "s")])
        with pytest.raises(TypeError):
            mon.observe_events("s", 1, 2)         # a latency objective


# ------------------------------------------------------- the Histogram kind
class TestHistogram:
    def test_percentiles_exact_under_capacity(self):
        h = monitor.histogram("t.serving.hist.exact")
        h.reset()
        for v in range(1, 101):
            h.observe(v)
        snap = h.value
        assert snap["n"] == 100
        assert snap["min"] == 1.0 and snap["max"] == 100.0
        assert (snap["p50"], snap["p95"], snap["p99"]) == (50.0, 95.0, 99.0)
        assert abs(snap["mean"] - 50.5) < 1e-9

    def test_reservoir_bounds_memory_exact_minmax(self):
        h = monitor.Histogram("t.serving.hist.res", reservoir=64)
        for v in range(10_000):
            h.observe(v)
        assert len(h._samples) == 64
        snap = h.value
        assert snap["n"] == 10_000
        assert snap["min"] == 0.0 and snap["max"] == 9999.0
        assert 0 <= snap["p50"] <= 9999

    def test_report_handles_histogram_stats(self, tmp_path):
        from telemetry_report import summarize
        monitor.histogram("serving.queue_wait_ms").observe(12.0)
        monitor.counter("serving.tokens_emitted").add(5)
        path = str(tmp_path / "t.jsonl")
        monitor.registry().export_jsonl(path)
        monitor.counter("serving.tokens_emitted").add(5)
        monitor.registry().export_jsonl(path)
        doc = summarize(path)
        assert doc["serving"]["tokens_emitted"] == 5      # the delta
        assert doc["serving"]["queue_wait_ms"]["n"] >= 1
