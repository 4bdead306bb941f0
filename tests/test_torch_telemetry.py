"""The port's observability substrate (paddle_tpu_torch/profiler): the
monitor, the spans and their chrome trace, the Profiler over
torch.profiler, the device telemetry pipeline, the flight recorder, the
step timer and the MFU gauge, as tests/test_telemetry.py and
tests/test_train_observability.py hold the reference's; then the same
numpy weights and batches through the JAX package's
`instrument_train_step` and the port's, for GPT and Llama, every
recorded field compared (loss, grad_norm and param_norm within
rtol 2e-4 / atol 1e-6, the tolerance test_torch_plan3d.py holds the
two trajectories to; nonfinite, lr and tokens exactly), both streams
read by tools/telemetry_report.py.

"Zero extra host syncs between flushes" is held here by counting: the
`_host_pull` seam must fire exactly steps/every times plus the tail on
close, and the tensor methods that pull (`cpu`, `item`, `tolist`,
`__int__`, `__float__`, `__bool__`, `__index__`) must be called in an
instrumented loop exactly as often as in the plain loop, plus the one
`cpu` of each pull.
"""
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.profiler import (Profiler, RecordEvent,
                                       clear_profiler_spans,
                                       export_chrome_trace, monitor)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file runs (the suite runs several
    pytest-xdist workers side by side); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PULL_METHODS = ("cpu", "item", "tolist", "__int__", "__float__",
                 "__bool__", "__index__")


class _CountPulls:
    """Counts every call of a _PULL_METHODS method on a tensor while
    entered."""

    def __init__(self):
        self.n = 0

    def __enter__(self):
        self._saved = {m: getattr(torch.Tensor, m) for m in _PULL_METHODS}

        def counted(f):
            def call(t, *a, **kw):
                self.n += 1
                return f(t, *a, **kw)
            return call
        for m, f in self._saved.items():
            setattr(torch.Tensor, m, counted(f))
        return self

    def __exit__(self, *exc):
        for m, f in self._saved.items():
            setattr(torch.Tensor, m, f)
        return False


def _records(path, kind=None):
    recs = [json.loads(ln) for ln in open(path)]
    return [r for r in recs if kind is None or r.get("kind") == kind]


# ---------------------------------------------------------------- monitor
class TestMonitor:
    def test_counter_gauge_snapshot(self):
        reg = monitor.MonitorRegistry()
        c = reg.counter("a_count")
        c.add()
        c.add(4)
        g = reg.gauge("b_ms")
        g.set(12.5)
        assert reg.snapshot() == {"a_count": 5, "b_ms": 12.5}
        assert reg.counter("a_count") is c          # get-or-create
        reg.reset()
        assert reg.snapshot() == {"a_count": 0, "b_ms": 0.0}

    def test_kind_clash_raises(self):
        reg = monitor.MonitorRegistry()
        reg.counter("x")
        with pytest.raises(TypeError):
            reg.gauge("x")

    def test_concurrent_updates_exact(self):
        """N threads x M increments land exactly, under a short switch
        interval."""
        reg = monitor.MonitorRegistry()
        c = reg.counter("hammer")
        g = reg.gauge("hammer_g")
        h = reg.histogram("hammer_h")
        threads, per = 8, 2000

        def work():
            for i in range(per):
                c.add()
                g.add(1.0)
                h.observe(i)

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            ts = [threading.Thread(target=work) for _ in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in ts)
        assert c.value == threads * per
        assert g.value == float(threads * per)
        assert h.value["n"] == threads * per

    def test_jsonl_export(self, tmp_path):
        reg = monitor.MonitorRegistry()
        reg.counter("n").add(3)
        path = str(tmp_path / "mon.jsonl")
        reg.export_jsonl(path)
        reg.export_jsonl(path)
        lines = _records(path)
        assert len(lines) == 2
        assert lines[0]["kind"] == "monitor"
        assert lines[0]["stats"]["n"] == 3

    def test_global_registry_helpers(self):
        name = "test_torch_global_helper_stat"
        before = monitor.counter(name).value
        monitor.stat_add(name, 2)
        assert monitor.snapshot()[name] == before + 2

    def test_snapshot_shapes_match_the_reference(self):
        """The same observations give the reference registry's snapshot,
        histogram dict included."""
        from paddle_tpu.profiler import monitor as jmon
        regs = (monitor.MonitorRegistry(), jmon.MonitorRegistry())
        for reg in regs:
            reg.counter("c").add(3)
            reg.gauge("g").set(1.5)
            h = reg.histogram("lat_ms")
            for v in np.random.RandomState(0).rand(5000) * 100:
                h.observe(float(v))
        assert regs[0].snapshot() == regs[1].snapshot()


# ---------------------------------------------------------- chrome trace
class TestChromeTrace:
    def test_export_valid_json_with_nesting(self, tmp_path):
        clear_profiler_spans()
        with RecordEvent("outer"):
            with RecordEvent("inner"):
                time.sleep(0.002)
        path = export_chrome_trace(str(tmp_path / "trace.json"))
        with open(path) as f:
            doc = json.load(f)
        events = doc["traceEvents"]
        by = {e["name"]: e for e in events}
        assert set(by) >= {"outer", "inner"}
        for e in events:
            assert e["ph"] == "X"
            assert e["dur"] >= 0
            assert {"ts", "pid", "tid", "name"} <= set(e)
        o, i = by["outer"], by["inner"]
        assert o["tid"] == i["tid"]
        assert i["ts"] >= o["ts"]
        assert i["ts"] + i["dur"] <= o["ts"] + o["dur"] + 1e-3

    def test_export_after_profiled_block(self, tmp_path):
        clear_profiler_spans()
        with Profiler(timer_only=True) as p:
            with RecordEvent("step"):
                pass
            p.step()
        path = export_chrome_trace(str(tmp_path / "t.json"))
        assert json.load(open(path))["traceEvents"]

    def test_profiler_writes_the_torch_trace_with_the_spans(self, tmp_path):
        """A RECORD window runs torch.profiler: its chrome trace holds the
        span (a record_function annotation) and the op it wraps; the host
        spans land beside it; READY steps record nothing."""
        from paddle_tpu_torch.profiler import make_scheduler
        clear_profiler_spans()
        sched = make_scheduler(closed=1, ready=1, record=1, repeat=1)
        x = torch.randn(32, 32)
        with Profiler(scheduler=sched, trace_dir=str(tmp_path)) as p:
            for i in range(4):
                with RecordEvent(f"facade.step{i}"):
                    torch.mm(x, x)
                p.step()
        assert len(p.trace_paths) == 1
        names = {e.get("name") for e in json.load(
            open(p.trace_paths[0]))["traceEvents"]}
        assert "facade.step2" in names and "aten::mm" in names
        assert "facade.step0" not in names and "facade.step1" not in names
        host = json.load(open(tmp_path / f"host_trace.{os.getpid()}.json"))
        assert {e["name"] for e in host["traceEvents"]} >= {
            "facade.step0", "facade.step3"}
        assert "steps: 4" in p.summary()

    def test_cost_analysis_names_part_4(self):
        from paddle_tpu_torch import profiler
        with pytest.raises(NotImplementedError, match="A7 part 4"):
            profiler.cost_analysis(lambda x: x, torch.zeros(2))


# ------------------------------------------------------ telemetry pipeline
def _toy_step(params, opt_state, batch, lr=0.1):
    """Least squares with a first-moment update, returning new tensors."""
    x, y = batch
    w = params["w"].detach().requires_grad_(True)
    loss = torch.mean((x @ w - y) ** 2)
    (g,) = torch.autograd.grad(loss, w)
    new_m = 0.9 * opt_state["m"]["w"] + 0.1 * g
    return loss.detach(), {"w": params["w"] - lr * new_m}, {"m": {"w": new_m}}


def _toy_state():
    return ({"w": torch.ones(4, 2)}, {"m": {"w": torch.zeros(4, 2)}},
            (torch.ones(3, 4), torch.zeros(3, 2)))


class TestTelemetryPipeline:
    def _run(self, tmp_path, steps=8, every=4):
        from paddle_tpu_torch.profiler import telemetry
        path = str(tmp_path / "run.jsonl")
        tele = telemetry.TelemetryPipeline(path, every=every,
                                           meta={"samples_per_step": 3})
        params, opt, batch = _toy_state()
        step = telemetry.instrument_train_step(_toy_step, tele, lr=0.1,
                                               beta1=0.9)
        tstate = tele.device_init(device="cpu")
        pulls = []
        orig_pull = telemetry._host_pull

        def counting_pull(x):
            pulls.append(1)
            return orig_pull(x)

        telemetry._host_pull = counting_pull
        try:
            for i in range(steps):
                loss, params, opt, tstate = step(params, opt, batch, tstate)
                tstate = tele.tick(i, tstate)
        finally:
            telemetry._host_pull = orig_pull
        tele.close(tstate)
        return path, pulls

    def test_flush_cadence_one_pull_per_window(self, tmp_path):
        path, pulls = self._run(tmp_path, steps=8, every=4)
        assert len(pulls) == 2                     # 8 steps / every=4
        steps = _records(path, "step")
        assert [r["step"] for r in steps] == list(range(8))
        assert all(np.isfinite(r["loss"]) for r in steps)
        assert all(r["nonfinite"] == 0 for r in steps)
        assert steps[-1]["loss"] < steps[0]["loss"]
        flushes = _records(path, "flush")
        assert [f["step"] for f in flushes] == [3, 7]
        assert len(_records(path, "monitor")) == len(flushes)

    def test_partial_tail_flushes_once_on_close(self, tmp_path):
        path, pulls = self._run(tmp_path, steps=6, every=4)
        assert len(pulls) == 1           # the tail's pull comes on close
        assert [r["step"] for r in _records(path, "step")] == list(range(6))

    def test_grad_norm_matches_oracle(self, tmp_path):
        """The first-moment recovery is exact: the recorded grad_norm of
        step 0 is the gradient's global norm."""
        path, _ = self._run(tmp_path, steps=4, every=4)
        rec0 = _records(path, "step")[0]
        params, _, (x, y) = _toy_state()
        w = params["w"].requires_grad_(True)
        (g,) = torch.autograd.grad(torch.mean((x @ w - y) ** 2), w)
        assert rec0["grad_norm"] == pytest.approx(float(g.norm()), rel=1e-5)

    def test_resume_seeded_cursor_no_phantom_rows(self, tmp_path):
        from paddle_tpu_torch.profiler import telemetry
        path = str(tmp_path / "resume.jsonl")
        tele = telemetry.TelemetryPipeline(path, every=4)
        ts = tele.device_init(start=6, device="cpu")
        tele.device_record(ts, loss=torch.tensor(6.0))
        tele.device_record(ts, loss=7.0)
        tele.flush(ts)                         # cursor at 8, a boundary
        tele.close()
        steps = _records(path, "step")
        assert [r["step"] for r in steps] == [6, 7]
        assert [r["loss"] for r in steps] == [6.0, 7.0]

    def test_report_windows_split_at_restart(self, tmp_path):
        from telemetry_report import summarize
        path = str(tmp_path / "restart.jsonl")
        recs = [
            {"kind": "run", "t": 0.0, "every": 2, "fields": ["loss"]},
            {"kind": "step", "step": 0, "loss": 1.0},
            {"kind": "step", "step": 1, "loss": 1.0},
            {"kind": "flush", "t": 1.0, "step": 1, "n": 2},
            {"kind": "step", "step": 2, "loss": 1.0},
            {"kind": "step", "step": 3, "loss": 1.0},
            {"kind": "flush", "t": 1.02, "step": 3, "n": 2},
            {"kind": "run", "t": 101.0, "every": 2, "fields": ["loss"]},
            {"kind": "step", "step": 4, "loss": 1.0},
            {"kind": "step", "step": 5, "loss": 1.0},
            {"kind": "flush", "t": 102.0, "step": 5, "n": 2},
            {"kind": "step", "step": 6, "loss": 1.0},
            {"kind": "step", "step": 7, "loss": 1.0},
            {"kind": "flush", "t": 102.02, "step": 7, "n": 2},
        ]
        with open(path, "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
        doc = summarize(path)
        assert doc["runs"] == 2
        assert doc["step_time"]["windows"] == 2
        assert doc["step_time"]["max_ms"] < 100.0

    def test_unknown_field_raises(self, tmp_path):
        from paddle_tpu_torch.profiler import telemetry
        tele = telemetry.TelemetryPipeline(str(tmp_path / "x.jsonl"),
                                           every=2)
        with pytest.raises(ValueError):
            tele.device_record(tele.device_init(device="cpu"), bogus=1.0)
        tele.close()

    def test_device_init_wants_the_card_by_default(self, tmp_path):
        """No fallback hides the device: without CUDA an accumulator with
        no device= raises."""
        from paddle_tpu_torch.profiler import telemetry
        if torch.cuda.is_available():
            pytest.skip("a card is present: device_init(None) is its card")
        tele = telemetry.TelemetryPipeline(str(tmp_path / "x.jsonl"))
        with pytest.raises(RuntimeError, match="CUDA"):
            tele.device_init()
        tele.close()

    def test_report_reads_the_stream(self, tmp_path):
        from telemetry_report import summarize
        path, _ = self._run(tmp_path, steps=8, every=2)
        doc = summarize(path)
        assert doc["steps_recorded"] == 8
        assert doc["flushes"] == 4
        assert doc["step_time"]["steps"] == 6
        assert doc["step_time"]["ips"] > 0
        assert doc["bad_steps"] == []
        assert "hbm.bytes_in_use" in json.dumps(doc["monitor"])

    def test_write_error_is_counted_not_fatal(self, tmp_path):
        from paddle_tpu_torch.profiler import telemetry
        before = monitor.counter("telemetry_write_errors").value
        tele = telemetry.TelemetryPipeline(str(tmp_path / "w.jsonl"),
                                           every=1)
        tele.event("unserializable", t=object())
        tele.event("fine")
        tele.close()
        assert monitor.counter("telemetry_write_errors").value == before + 1
        assert [r["name"] for r in _records(str(tmp_path / "w.jsonl"),
                                            "event")] == ["fine"]


class TestSyncs:
    def test_no_pull_between_flushes(self, tmp_path):
        """The instrumented Llama step pulls exactly as often as the plain
        one, plus one `cpu` a flush: 6 steps at every=4 make one flush
        and the tail."""
        from paddle_tpu_torch.models import llama
        from paddle_tpu_torch.models.facade import make_train_step
        from paddle_tpu_torch.models.gpt import init_opt_state
        from paddle_tpu_torch.profiler import telemetry
        cfg = llama.LlamaConfig(vocab_size=128, hidden_size=32, num_layers=1,
                                num_heads=4, num_kv_heads=2, max_seq_len=32,
                                dtype=torch.float32)
        tokens = torch.from_numpy(np.random.RandomState(0).randint(
            0, 128, (2, 17)))
        counts = []
        for instrumented in (False, True):
            params = llama.init_llama_params(cfg, seed=0, device="cpu")
            opt = init_opt_state(params)
            tele = telemetry.TelemetryPipeline(
                str(tmp_path / f"s{instrumented}.jsonl"), every=4,
                fields=telemetry.MFU_FIELDS, flops_per_token=1.0)
            if instrumented:
                step = telemetry.instrument_train_step(
                    llama.train_step, tele, cfg=cfg, lr=1e-3)
                ts = tele.device_init(device="cpu")
            else:
                step = make_train_step(llama.train_step, cfg=cfg, lr=1e-3)
            pulls = []
            orig = telemetry._host_pull
            telemetry._host_pull = lambda x: (pulls.append(1), orig(x))[1]
            try:
                with _CountPulls() as c:
                    for i in range(6):
                        if instrumented:
                            step(params, opt, tokens, ts)
                            tele.tick(i, ts)
                        else:
                            step(params, opt, tokens)
                    if instrumented:
                        tele.close(ts)
            finally:
                telemetry._host_pull = orig
            if not instrumented:
                tele.close()
            counts.append((c.n, len(pulls)))
        (plain, _), (inst, pulls) = counts
        assert pulls == 2
        assert inst == plain + pulls


# -------------------------------------------------------- flight recorder
class TestFlightRecorder:
    def test_note_dump_roundtrip(self, tmp_path):
        from paddle_tpu_torch.profiler.flight_recorder import (FlightRecorder,
                                                               load_dump)
        fr = FlightRecorder(dir=str(tmp_path), n=4, autodump_every=0)
        fr.configure(job="unit-test", world=1)
        for i in range(7):
            fr.note(step=i, loss=float(i), ok=True)
        path = fr.dump("unit_test")
        doc = load_dump(path)
        assert doc["reason"] == "unit_test"
        assert doc["config"]["job"] == "unit-test"
        assert [r["step"] for r in doc["steps"]] == [3, 4, 5, 6]
        assert isinstance(doc["monitor"], dict)
        assert not [f for f in os.listdir(tmp_path) if ".tmp-" in f]

    def test_autodump_survives_abrupt_death(self, tmp_path):
        from paddle_tpu_torch.profiler.flight_recorder import (FlightRecorder,
                                                               load_dump)
        fr = FlightRecorder(dir=str(tmp_path), n=8, autodump_every=1)
        fr.note(step=0, loss=1.0, ok=True)
        files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
        assert len(files) == 1
        doc = load_dump(str(tmp_path / files[0]))
        assert doc["reason"] == "periodic"
        assert doc["steps"][0]["step"] == 0

    def test_env_configures_and_a_tensor_is_refused(self, tmp_path,
                                                    monkeypatch):
        from paddle_tpu_torch.profiler import flight_recorder as fr
        monkeypatch.setenv(fr.ENV_DIR, str(tmp_path))
        monkeypatch.setenv(fr.ENV_N, "2")
        monkeypatch.setenv(fr.ENV_AUTODUMP, "0")
        rec = fr.FlightRecorder()
        assert (rec.dir, rec.autodump_every) == (str(tmp_path), 0)
        with pytest.raises(TypeError, match="tensor"):
            rec.note(step=0, loss=torch.tensor(1.0))
        for i in range(3):
            rec.note(step=i)
        assert [r["step"] for r in rec.records()] == [1, 2]
        with pytest.raises(ValueError):
            path = tmp_path / "other.json"
            path.write_text(json.dumps({"kind": "monitor"}))
            fr.load_dump(str(path))

    def test_resilient_trainer_dumps_on_rollback(self, tmp_path):
        from paddle_tpu_torch.parallel import resilience
        from paddle_tpu_torch.parallel.checkpoint import CheckpointManager
        from paddle_tpu_torch.profiler import flight_recorder
        fr = flight_recorder.recorder()
        # the ring is process-global: an earlier test's notes (a serving
        # engine's fault records) would sit among the trainer's steps
        fr.clear()
        old_dir, old_every = fr.dir, fr.autodump_every
        fr.set_dir(str(tmp_path))
        fr.autodump_every = 0
        poisons = [3]

        def hook(step):
            if step >= 2 and poisons[0] > 0:
                poisons[0] -= 1
                return float("nan")
            return 1.0

        resilience._STEP_HOOK = hook
        try:
            params, opt, batch = _toy_state()
            params["w"] *= 0.3
            mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
            tr = resilience.ResilientTrainer(
                _toy_step, params, opt, manager=mgr,
                config=resilience.ResilienceConfig(checkpoint_every=1,
                                                   rollback_after=2))
            resilience.run_resilient(tr, lambda s: batch, 6)
        finally:
            resilience._STEP_HOOK = None
            fr.set_dir(old_dir)
            fr.autodump_every = old_every
        assert tr.rollbacks >= 1
        dumps = [f for f in os.listdir(tmp_path)
                 if f.startswith("flight-") and "rollback" in f]
        assert dumps, os.listdir(tmp_path)
        doc = flight_recorder.load_dump(str(tmp_path / dumps[0]))
        assert doc["reason"] == "rollback"
        assert any(not r["ok"] for r in doc["steps"])
        assert doc["monitor"]["resilience_rollback"] >= 1
        assert doc["monitor"]["resilience_skip_step"] >= 2


# -------------------------------------------------------------- timer p95
class TestTimerPercentiles:
    def test_summary_p95_and_samples(self):
        from paddle_tpu_torch.profiler.timer import Benchmark
        bm = Benchmark()
        bm.begin()

        def fake_step(dt, n):
            bm._costs.append(dt)
            bm._samples.append(n)

        for _ in range(19):
            fake_step(0.010, 4)
        fake_step(0.100, 4)
        s = bm.summary(skip=0)
        assert s["steps"] == 20
        assert s["samples"] == 80
        assert s["p50_batch_cost_s"] == pytest.approx(0.010)
        assert s["p95_batch_cost_s"] == pytest.approx(0.010)
        fake_step(0.100, 4)
        fake_step(0.100, 4)
        s = bm.summary(skip=0)
        assert s["p95_batch_cost_s"] == pytest.approx(0.100)
        assert s["ips"] > 0


# ------------------------------------------------------- memory gauges
def test_hbm_gauges_and_census_on_the_cpu():
    from paddle_tpu_torch.profiler import mem_audit
    mem_audit.publish_hbm_gauges()
    rss = mem_audit.host_rss_bytes()
    assert rss and monitor.gauge("hbm.bytes_in_use").value > 0
    assert monitor.gauge("hbm.peak_bytes").value >= \
        monitor.gauge("hbm.bytes_in_use").value
    w = torch.zeros(4, 8)
    cen = mem_audit.live_array_census(
        {"params": {"w": w, "b": torch.zeros(8)},
         "opt_state": {"m": {"w": torch.zeros(4, 8)}, "alias": w}})
    assert cen["total_bytes"] == 4 * 8 * 4 * 2 + 8 * 4
    row = cen["rows"]["(4, 8)/float32/None"]
    assert row["count"] == 3 and row["bytes"] == 256
    assert row["leaves"] == ["params/w", "opt_state/m/w", "opt_state/alias"]
    assert cen["other_bytes"] is None


# ----------------------------------------------------------- MFU gauge
B, S = 4, 16
GPT = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=32)
LLAMA = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=32)
LR = 1e-3


def _tokens(seed=0):
    return np.random.RandomState(seed).randint(0, 256, (B, S + 1)).astype(
        np.int64)


def _gpt_cfg():
    from paddle_tpu_torch.models import gpt
    return gpt.GPTConfig(**GPT, dtype=torch.float32, remat=False)


class TestMfuTelemetry:
    def _run_instrumented(self, tmp_path, every=2, steps=6):
        from paddle_tpu_torch.cost_model import train_flops_per_token
        from paddle_tpu_torch.models import gpt
        from paddle_tpu_torch.profiler.telemetry import (
            MFU_FIELDS, TelemetryPipeline, instrument_train_step)
        cfg = _gpt_cfg()
        params = gpt.init_gpt_params(cfg, seed=0, device="cpu")
        opt = gpt.init_opt_state(params)
        n = sum(p.numel() for p in params.values())
        path = str(tmp_path / "mfu.jsonl")
        tele = TelemetryPipeline(
            path, every=every, fields=MFU_FIELDS,
            flops_per_token=train_flops_per_token(
                n, cfg.num_layers, cfg.hidden_size, S))
        step = instrument_train_step(gpt.train_step, tele, cfg=cfg, lr=LR)
        toks = torch.from_numpy(_tokens())
        tstate = tele.device_init(device="cpu")
        losses = []
        for i in range(steps):
            loss, params, opt, tstate = step(params, opt, toks, tstate)
            losses.append(loss)
            tstate = tele.tick(i, tstate)
        tele.close()
        return path, losses, tele, (params, opt)

    def test_mfu_gauge_appears_after_flush(self, tmp_path):
        path, _losses, tele, _ = self._run_instrumented(tmp_path)
        assert tele.pulls == 3
        assert monitor.gauge("train.mfu").value > 0
        assert monitor.gauge("train.tokens_per_s").value > 0
        mons = _records(path, "monitor")
        assert mons[-1]["stats"]["train.mfu"] == \
            monitor.gauge("train.mfu").value
        assert all(r["tokens"] == B * S for r in _records(path, "step"))
        # an eager step compiles nothing: no train.compile.* gauge
        assert not [k for k in mons[-1]["stats"]
                    if k.startswith("train.compile.")]
        assert monitor.registry().get("train.compile.wall_ms") is None

    def test_flops_per_token_requires_tokens_field(self, tmp_path):
        from paddle_tpu_torch.profiler.telemetry import TelemetryPipeline
        with pytest.raises(ValueError, match="tokens"):
            TelemetryPipeline(str(tmp_path / "x.jsonl"), flops_per_token=1.0)

    def test_loss_and_state_bit_identical_to_telemetry_off(self, tmp_path):
        from paddle_tpu_torch.models import gpt
        from paddle_tpu_torch.models.facade import make_train_step
        _path, losses_on, _tele, (p_on, o_on) = self._run_instrumented(
            tmp_path, steps=4)
        cfg = _gpt_cfg()
        step = make_train_step(gpt.train_step, cfg=cfg, lr=LR)
        params = gpt.init_gpt_params(cfg, seed=0, device="cpu")
        opt = gpt.init_opt_state(params)
        toks = torch.from_numpy(_tokens())
        losses_off = []
        for _ in range(4):
            loss, params, opt = step(params, opt, toks)
            losses_off.append(loss)
        assert all(torch.equal(a, b) for a, b in zip(losses_on, losses_off))
        assert all(torch.equal(p_on[k], params[k]) for k in params)
        assert all(torch.equal(o_on[m][k], opt[m][k])
                   for m in ("m", "v") for k in params)

    def test_report_grows_mfu_block(self, tmp_path):
        from telemetry_report import summarize
        path, _losses, _tele, _ = self._run_instrumented(tmp_path)
        doc = summarize(path)
        assert doc["mfu"]["mfu"] > 0
        assert doc["mfu"]["tokens_per_s"] > 0
        assert "compile" not in doc["mfu"]


# --------------------------------------------- the JAX package beside it
def _jax_stream(family, tmp_path, steps, every):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.models import gpt as jg
    from paddle_tpu.models import llama as jl
    from paddle_tpu.profiler import telemetry as jt
    if family == "gpt":
        cfg = jg.GPTConfig(**GPT, dtype=jnp.float32, remat=False,
                           sequence_parallel=False)
        params = jg.init_gpt_params(cfg, jax.random.PRNGKey(0))
        fn = jg.train_step
    else:
        cfg = jl.LlamaConfig(**LLAMA, dtype=jnp.float32, remat=False)
        params = jl.init_llama_params(cfg, jax.random.PRNGKey(0))
        fn = jl.train_step
    init = jax.tree_util.tree_map(np.asarray, params)
    path = str(tmp_path / f"jax_{family}.jsonl")
    tele = jt.TelemetryPipeline(path, every=every, fields=jt.MFU_FIELDS)
    step = jt.instrument_train_step(fn, tele, cfg=cfg, lr=LR, donate=False)
    opt = jg.init_opt_state(params)
    ts = tele.device_init()
    for i in range(steps):
        _, params, opt, ts = step(params, opt, jnp.asarray(_tokens(i)), ts)
        ts = tele.tick(i, ts)
    tele.close(ts)
    return init, path


def _torch_stream(family, init, tmp_path, steps, every):
    from paddle_tpu_torch.models import gpt, llama
    from paddle_tpu_torch.models.convert import params_from_jax
    from paddle_tpu_torch.profiler import telemetry
    mod = gpt if family == "gpt" else llama
    cfg = _gpt_cfg() if family == "gpt" else llama.LlamaConfig(
        **LLAMA, dtype=torch.float32, remat=False)
    params = params_from_jax(init, device="cpu")
    opt = gpt.init_opt_state(params)
    path = str(tmp_path / f"torch_{family}.jsonl")
    tele = telemetry.TelemetryPipeline(path, every=every,
                                       fields=telemetry.MFU_FIELDS)
    step = telemetry.instrument_train_step(mod.train_step, tele, cfg=cfg,
                                           lr=LR)
    ts = tele.device_init(device="cpu")
    for i in range(steps):
        step(params, opt, torch.from_numpy(_tokens(i)), ts)
        tele.tick(i, ts)
    tele.close(ts)
    return path


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_recorded_fields_match_the_jax_package(family, tmp_path):
    from telemetry_report import summarize
    init, jpath = _jax_stream(family, tmp_path, steps=5, every=2)
    tpath = _torch_stream(family, init, tmp_path, steps=5, every=2)
    want, got = _records(jpath, "step"), _records(tpath, "step")
    assert [r["step"] for r in got] == [r["step"] for r in want] == \
        list(range(5))
    for w, g in zip(want, got):
        for f in ("loss", "grad_norm", "param_norm"):
            assert g[f] == pytest.approx(w[f], rel=2e-4, abs=1e-6), (f, g, w)
        for f in ("nonfinite", "lr", "tokens"):
            assert g[f] == w[f], (f, g, w)
    docs = [summarize(p) for p in (jpath, tpath)]
    for doc in docs:
        assert doc["steps_recorded"] == 5 and doc["flushes"] == 3
        assert doc["bad_steps"] == []
    assert set(docs[0]["fields"]) == set(docs[1]["fields"])
    for f in ("loss", "grad_norm", "param_norm"):
        assert docs[1]["fields"][f]["last"] == pytest.approx(
            docs[0]["fields"][f]["last"], rel=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
def test_nonfinite_count_is_isfinites(dtype):
    """The count from the f32 exponent bits (and isfinite elsewhere) is
    the number of elements isfinite calls non-finite: inf, -inf, nan,
    -nan, the largest finite values and denormals among normal values,
    on a strided view too."""
    from paddle_tpu_torch.profiler.telemetry import _count_nonfinite
    t = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    finfo = torch.finfo(dtype)
    special = [float("inf"), float("-inf"), float("nan"), -float("nan"),
               finfo.max, -finfo.max, finfo.tiny / 4, -0.0]
    t = t.to(dtype)
    for i, v in enumerate(special):
        t[17 * i + 3] = v
    for view in (t, t[1::3], t.reshape(64, 64).t()):
        assert int(_count_nonfinite(view)) == int(
            (~torch.isfinite(view)).sum()), (dtype, view.shape)
