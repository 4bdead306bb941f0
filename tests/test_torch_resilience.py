"""The port's resilient step (paddle_tpu_torch/parallel/resilience.py:
non-finite skip, rollback, watchdog) and the facade seams it rides
(models/facade.py `plan_step_cell`, `_ShardedTrainStep.rebuild`,
`adopt_shapes`), against the JAX package's, on the CPU.

In the test process:
- the counterparts of tests/test_fault_tolerance.py `TestResilientStep`
  and test_checkpoint_async.py `TestResilientTrainerAsync`: a skipped
  step leaves every param and moment equal to the pre-step one to the
  bit (a poisoned loss, and an update that overflows while the loss is
  finite), rollback re-runs bit-identically, rollback without a
  snapshot degrades to skips, the watchdog and its persistent puller,
  exit-on-hang's code, resume, periodic async snapshots;
- the port's ResilientTrainer against the JAX package's on a small GPT
  (f32): the same starting weights, batches, `nan@3:3` schedule and
  ResilienceConfig give the same `(loss, ok)` sequence (losses within
  2e-4, nan where JAX has nan), skips, rollbacks and step, and final
  state within 2e-4;
- a stall inside the step under a 0.5 s budget raises StepHungError
  (the budget covers the dispatch, not only the pull), counted and
  flight-dumped, and in a subprocess a wedged step with `exit_on_hang`
  exits with 101;
- the device telemetry of the guarded step (RESILIENT_FIELDS: the raw
  loss, update norm and non-finite count read before a restore, the
  kept params' norm, ok), and the trainer's monitor counters, flight
  dumps and the accumulator's cursor restarted at a rollback.
One world of 4 ranks over gloo, started once for the module:
- an inf in one rank's shard of one weight, and in one rank's shard of
  one moment (which the loss never reads), makes every rank skip, every
  rank's state bit-equal to its pre-step state;
- a rollback under a dp2×pp2 plan restores the stage-cut leaves from
  the manager: the re-run equals a clean run's to the bit;
- `rebuild_plan` from fsdp2×tp2 onto dp2×pp2, with the state
  reshard-restored from the manager, continues the JAX package's
  uninterrupted trajectory within 2e-4.

The rank processes import this module without jax.
"""
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from paddle_tpu_torch.parallel import checkpoint as ck
from paddle_tpu_torch.parallel import resilience
from paddle_tpu_torch.parallel.checkpoint import CheckpointManager
from paddle_tpu_torch.parallel.resilience import (
    ELASTIC_EXIT_CODE, ResilienceConfig, ResilientTrainer, StepHungError,
    WatchdogPuller, make_resilient_step, pull_with_watchdog, run_resilient)
from paddle_tpu_torch.testing import faults

B, S, LR = 8, 32, 1e-3
GPT = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
           max_seq_len=64)
LLAMA = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=64)
# the in-process trainer comparison's GPT
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            max_seq_len=16)
TINY_B, TINY_S, TINY_STEPS = 4, 8, 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tokens(seed, b=B, s=S, vocab=GPT["vocab_size"]):
    return np.random.RandomState(seed).randint(
        0, vocab, (b, s + 1)).astype(np.int64)


def _tiny_tokens(seed):
    return _tokens(1000 + seed, TINY_B, TINY_S, TINY["vocab_size"])


def _tcfg(model, **shape):
    from paddle_tpu_torch.models import gpt, llama
    if model == "gpt":
        return gpt.GPTConfig(**(shape or GPT), dtype=torch.float32,
                             remat=False, sequence_parallel=False)
    return llama.LlamaConfig(**LLAMA, dtype=torch.float32, remat=False)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _port_write_audit():
    ck._AUDIT.clear()
    yield
    paths, ck._AUDIT[:] = list(ck._AUDIT), []
    for p in paths:
        if os.path.isdir(p):
            ck.verify_checkpoint(p)


@pytest.fixture
def flight_dir(tmp_path):
    """The process's flight recorder pointed at a fresh directory, no
    autodumps; restored after."""
    from paddle_tpu_torch.profiler import flight_recorder
    rec = flight_recorder.recorder()
    saved = (rec.dir, rec.autodump_every)
    rec.set_dir(str(tmp_path / "flight"))
    rec.autodump_every = 0
    yield tmp_path / "flight"
    rec.set_dir(saved[0])
    rec.autodump_every = saved[1]


def _clone(tree):
    return {k: (_clone(v) if isinstance(v, dict) else v.detach().clone())
            for k, v in tree.items()}


def _bits_equal(a, b):
    """Every leaf of two trees equal to the bit."""
    for k, v in a.items():
        if isinstance(v, dict):
            if not _bits_equal(v, b[k]):
                return False
        elif not (v.dtype == b[k].dtype and v.shape == b[k].shape
                  and torch.equal(v.view(torch.int32) if v.dtype ==
                                  torch.float32 else v,
                                  b[k].view(torch.int32) if b[k].dtype ==
                                  torch.float32 else b[k])):
            return False
    return True


# ------------------------------------------------------------ rank side
def _inf_case(rank, init, where):
    """fsdp2×tp2 GPT: one clean step, then an inf in rank 1's shard of
    qkv_w (`where` "params") or of its Adam v ("v"), a step, the inf
    taken out, a step."""
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel import plan_train
    cfg = _tcfg("gpt")
    plan = plan_train(cfg, 4, B, dp=1, fsdp=2, tp=2)
    mesh = plan.build_mesh(device_type="cpu")
    params = {k: torch.from_numpy(v).clone() for k, v in init.items()}
    tr = ResilientTrainer(gpt.train_step, params, gpt.init_opt_state(params),
                          cfg=cfg, mesh=mesh, plan=plan, lr=LR)
    out = [tr.train_step(_tokens(0))]
    tree = tr.params if where == "params" else tr.opt_state["v"]
    if rank == 1:
        keep = tree["qkv_w"].view(-1)[5].clone()
        tree["qkv_w"].view(-1)[5] = float("inf")
    state = {"params": tr.params, "opt": tr.opt_state}
    before = _clone(state)
    out.append(tr.train_step(_tokens(1)))
    same = _bits_equal(before, {"params": tr.params, "opt": tr.opt_state})
    if rank == 1:
        tree["qkv_w"].view(-1)[5] = keep
    out.append(tr.train_step(_tokens(1)))
    return {"steps": out, "same": same, "skipped": tr.skipped,
            "step": tr.step,
            "local_finite": bool(all(torch.isfinite(t).all() for t in
                                     before["params"].values())
                                 and all(torch.isfinite(t).all() for t in
                                         before["opt"]["v"].values()))}


def _pp_rollback(rank, workdir):
    """Llama under dp2×pp2: a clean run and a run under nan@3:2 (two
    skips, a rollback to the step-2 snapshot), 6 steps each."""
    from paddle_tpu_torch.models import gpt, llama
    from paddle_tpu_torch.parallel import plan_train
    cfg = _tcfg("llama")
    plan = plan_train(cfg, 4, B, dp=2, fsdp=1, tp=1, pp=2)
    mesh = plan.build_mesh(device_type="cpu")
    init = llama.init_llama_params(cfg, 0, "cpu")

    def run(root, spec):
        params = _clone(init)
        tr = ResilientTrainer(
            llama.train_step, params, gpt.init_opt_state(params), cfg=cfg,
            mesh=mesh, plan=plan, lr=LR,
            manager=CheckpointManager(os.path.join(workdir, root),
                                      max_to_keep=2),
            config=ResilienceConfig(checkpoint_every=2, rollback_after=2))
        traj, shapes = {}, {}

        def on_step(s, loss, ok):
            traj.setdefault(s, []).append((loss, ok))
            shapes.setdefault(tr.step, tuple(tr.params["q_w"].shape))
        if spec:
            faults.install(spec)
        try:
            run_resilient(tr, _tokens, 6, on_step=on_step)
        finally:
            faults.uninstall()
        return tr, traj, shapes
    clean, a, _ = run("pp_clean", None)
    fault, b, shapes = run("pp_fault", "nan@3:2")
    return {"clean": a, "fault": b, "skipped": fault.skipped,
            "rollbacks": fault.rollbacks, "step": fault.step,
            "q_w_shapes": shapes,
            "final_same": _bits_equal(
                {"p": clean.params, "m": clean.opt_state["m"],
                 "v": clean.opt_state["v"]},
                {"p": fault.params, "m": fault.opt_state["m"],
                 "v": fault.opt_state["v"]}),
            "steps_saved": fault.manager.steps()}


def _rebuild(rank, workdir, init):
    """GPT: steps 0-1 under fsdp2×tp2 (a snapshot at step 2), the
    snapshot restored onto dp2×pp2 and the trainer rebuilt there, steps
    2-4."""
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel import plan_train
    from paddle_tpu_torch.parallel.resilience import plan_state_specs
    cfg = _tcfg("gpt")
    plan_a = plan_train(cfg, 4, B, dp=1, fsdp=2, tp=2)
    plan_b = plan_train(cfg, 4, B, dp=2, fsdp=1, tp=1, pp=2)
    mesh_a = plan_a.build_mesh(device_type="cpu")
    mesh_b = plan_b.build_mesh(device_type="cpu")
    params = {k: torch.from_numpy(v).clone() for k, v in init.items()}
    mgr = CheckpointManager(os.path.join(workdir, "rebuild"), max_to_keep=3)
    tr = ResilientTrainer(gpt.train_step, params, gpt.init_opt_state(params),
                          cfg=cfg, mesh=mesh_a, plan=plan_a, manager=mgr,
                          config=ResilienceConfig(checkpoint_every=2),
                          lr=LR)
    losses = [tr.train_step(_tokens(s))[0] for s in range(2)]
    before = tuple(tr.params["qkv_w"].shape)
    state, step = mgr.restore(mesh=mesh_b, specs=plan_state_specs(plan_b))
    tr.rebuild_plan(mesh_b, plan_b, params=state["params"],
                    opt_state=state["opt_state"], step=int(state["step"]))
    losses += [tr.train_step(_tokens(s))[0] for s in range(2, 5)]
    g = tr._guarded
    return {"losses": losses, "restored_step": step, "step": tr.step,
            "qkv_w_shapes": (before, tuple(tr.params["qkv_w"].shape)),
            "bubble": g.bubble_fraction, "plan": g.plan.name,
            "full": {k: v.numpy() for k, v in g.gather_full(tr.params).items()},
            "m": {k: v.numpy() for k, v in
                  g.gather_full(tr.opt_state["m"]).items()},
            "v": {k: v.numpy() for k, v in
                  g.gather_full(tr.opt_state["v"]).items()},
            "opt_step": float(tr.opt_state["step"]),
            "steps_saved": mgr.steps()}


def _rank_main(rank, world, workdir):
    torch.set_num_threads(1)
    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    os.environ["WORLD_SIZE"] = str(world)
    import torch.distributed as dist
    from paddle_tpu_torch.parallel import init_parallel_env
    init_parallel_env(backend="gloo", timeout_s=120,
                      init_method=f"file://{workdir}/store")
    init = torch.load(os.path.join(workdir, "init.pt"), weights_only=False)
    out = {}
    try:
        out["inf_weight"] = _inf_case(rank, init, "params")
        out["inf_moment"] = _inf_case(rank, init, "v")
        out["pp_rollback"] = _pp_rollback(rank, workdir)
        out["rebuild"] = _rebuild(rank, workdir, init)
    finally:
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
        dist.destroy_process_group()


def _spawn(world, init):
    import torch.multiprocessing as mp
    workdir = tempfile.mkdtemp(prefix="torch_resilience_")
    torch.save(init, os.path.join(workdir, "init.pt"))
    mp.spawn(_rank_main, args=(world, workdir), nprocs=world, join=True)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# ----------------------------------------------------------- test side
@pytest.fixture(scope="module")
def ref():
    """The JAX package's unsharded GPT step, 5 steps from PRNGKey(0)."""
    import functools
    import jax
    import jax.numpy as jnp
    from paddle_tpu.models import gpt as jg
    from paddle_tpu.models.facade import make_train_step as jmake
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    cfg = jg.GPTConfig(**GPT, dtype=jnp.float32, remat=False,
                       sequence_parallel=False)
    params = jg.init_gpt_params(cfg, jax.random.PRNGKey(0))
    init = as_np(params)
    step = jmake(jg.train_step, cfg=cfg, lr=LR, donate=False)
    opt = jg.init_opt_state(params)
    losses = []
    for s in range(5):
        loss, params, opt = step(params, opt, jnp.asarray(_tokens(s)))
        losses.append(float(loss))
    return {"init": init, "losses": losses, "final": as_np(params),
            "m": as_np(opt["m"]), "v": as_np(opt["v"]),
            "opt_step": float(opt["step"])}


@pytest.fixture(scope="module")
def world4(ref):
    return _spawn(4, ref["init"])


@pytest.mark.parametrize("where", ["inf_weight", "inf_moment"])
def test_one_rank_non_finite_shard_makes_every_rank_skip(where, world4):
    """An inf in rank 1's shard (of qkv_w, or of its Adam v, which the
    loss never reads, so only rank 1 sees it before the reduction):
    every rank's step is skipped, every rank's params and moments equal
    its pre-step ones to the bit, and with the inf gone the next step
    trains on every rank."""
    for rank, res in enumerate(world4):
        r = res[where]
        (l0, ok0), (l1, ok1), (l2, ok2) = r["steps"]
        assert ok0 and np.isfinite(l0)
        assert not ok1 and np.isnan(l1), (rank, r["steps"])
        assert r["same"], rank
        assert r["skipped"] == 1 and r["step"] == 3
        if where == "inf_moment":
            assert ok2 and np.isfinite(l2)
            # the other ranks held only finite state: their skip came
            # from the reduction
            assert r["local_finite"] == (rank != 1)
        assert l0 == world4[0][where]["steps"][0][0]


def test_rollback_under_pp_plan_restores_stage_cut_leaves(world4):
    """dp2×pp2, nan@3:2: steps 3 and 4 skipped, the rollback reloads the
    step-2 snapshot onto the plan (each rank its stage's layer of the
    stacked leaves), and the re-run of steps 2-5 and the final state
    equal a clean run's to the bit."""
    for res in world4:
        r = res["pp_rollback"]
        assert r["skipped"] == 2 and r["rollbacks"] == 1 and r["step"] == 6
        assert [ok for _, ok in r["fault"][3]] == [False, True]
        assert [ok for _, ok in r["fault"][4]] == [False, True]
        assert len(r["fault"][2]) == 2           # re-run after the rollback
        for s, runs in r["clean"].items():
            assert r["fault"][s][-1] == runs[-1], s
        assert r["final_same"]
        # the stacked leaves stayed cut over pp (2 layers / 2 stages)
        assert set(r["q_w_shapes"].values()) == {(1, 128, 128)}
        assert r["steps_saved"] == [4, 6]


def test_rebuild_plan_onto_pp_continues_jax_trajectory(ref, world4):
    """fsdp2×tp2 for steps 0-1 (a snapshot at step 2), then the snapshot
    reshard-restored onto dp2×pp2 and the trainer rebuilt there: steps
    2-4 continue the JAX package's uninterrupted trajectory within
    2e-4, and the final params and moments too."""
    for res in world4:
        r = res["rebuild"]
        assert r["restored_step"] == 2 and r["step"] == 5
        assert r["plan"] == "dp2_fsdp1_tp1_pp2"
        assert r["bubble"] is not None
        assert r["qkv_w_shapes"][0] != r["qkv_w_shapes"][1]
        assert r["qkv_w_shapes"][1][0] == 1      # a stage's one layer
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=2e-4,
                                   atol=2e-4)
        assert r["losses"] == world4[0]["rebuild"]["losses"]
        for leaf in ref["final"]:
            np.testing.assert_allclose(r["full"][leaf], ref["final"][leaf],
                                       rtol=2e-4, atol=2e-4,
                                       err_msg=f"final {leaf}")
        for tree, key in ((r["m"], "m"), (r["v"], "v")):
            for leaf in ref[key]:
                _assert_close_to_scale(tree[leaf], ref[key][leaf],
                                       f"{key} {leaf}")
        assert r["opt_step"] == 5.0
        assert r["steps_saved"] == [2, 4]


# ------------------------------------ in the test process: the guard
def _assert_close_to_scale(got, want, msg, rtol=2e-4):
    """`got` within rtol of `want`, elementwise, with the absolute floor
    scaled to the leaf's own magnitude (rtol × max|want|): Adam's moments
    sit far below a fixed atol (v ~ grad², 1e-8 here), which would pass
    anything."""
    want = np.asarray(want)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    assert scale > 0, msg
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=msg)


def _tiny():
    from paddle_tpu_torch.models import gpt
    cfg = _tcfg("gpt", **TINY)
    return gpt, cfg, gpt.init_gpt_params(cfg, 0, "cpu")


def test_skip_keeps_params_and_moments_bit_equal():
    gpt, cfg, params = _tiny()
    opt = gpt.init_opt_state(params)
    step = make_resilient_step(gpt.train_step, cfg=cfg, lr=LR)
    tokens = torch.from_numpy(_tiny_tokens(0))
    loss, p1, o1, ok = step(params, opt, tokens, 1.0)
    assert bool(ok) and np.isfinite(float(loss))
    before = _clone({"p": p1, "o": o1})
    loss, p2, o2, ok = step(p1, o1, tokens, float("nan"))
    assert not bool(ok) and np.isnan(float(loss))
    assert _bits_equal(before, {"p": p2, "o": o2})
    assert float(o2["step"]) == 1.0
    assert step.backup.nbytes == sum(
        t.numel() * 4 for t in list(p2.values()) + list(o2["m"].values())
        + list(o2["v"].values())) + 4


def test_overflowing_update_with_finite_loss_is_skipped_bit_equal():
    """An update that overflows (lr 1e39 is inf in f32) while the loss
    is finite: the new params are not finite, so the step is skipped and
    the in-place update undone to the bit."""
    gpt, cfg, params = _tiny()
    opt = gpt.init_opt_state(params)
    step = make_resilient_step(gpt.train_step, cfg=cfg, lr=1e39)
    before = _clone({"p": params, "o": opt})
    raw, _ = gpt.loss_and_grads(params, torch.from_numpy(_tiny_tokens(0)),
                                cfg)
    assert np.isfinite(float(raw))
    loss, p, o, ok = step(params, opt, torch.from_numpy(_tiny_tokens(0)))
    assert not bool(ok) and np.isnan(float(loss))
    assert _bits_equal(before, {"p": p, "o": o})


@pytest.mark.parametrize("bad", [None, float("inf"), float("-inf"),
                                 float("nan")])
@pytest.mark.parametrize("where", ["w", "step"])
def test_tree_finite_is_isfinite_all(bad, where):
    """The guard's one-pass check (each leaf's aminmax, NaN propagating)
    says what isfinite().all() over every floating leaf says; integer
    leaves are not read."""
    tree = {"w": torch.randn(7, 5), "m": {"w": torch.randn(3)},
            "step": torch.tensor(4.0), "ids": torch.arange(4)}
    if bad is not None:
        leaf = tree[where]
        leaf.view(-1)[leaf.numel() // 2] = bad
    want = all(bool(torch.isfinite(t).all()) for t in
               (tree["w"], tree["m"]["w"], tree["step"]))
    assert bool(resilience._tree_finite(tree)) == want == (bad is None)
    assert resilience._tree_finite({"ids": torch.arange(3)}) is None


def _pipeline(path, every=4):
    from paddle_tpu_torch.profiler.telemetry import TelemetryPipeline
    return TelemetryPipeline(str(path), every=every,
                             fields=resilience.RESILIENT_FIELDS)


def _steps(path):
    import json
    return [r for r in map(json.loads, open(path)) if r["kind"] == "step"]


def test_telemetry_waits_for_a7(tmp_path):
    """ROADMAP A7 part 1 is ported: the guarded step records
    RESILIENT_FIELDS. A good, a poisoned and a good step: the poisoned
    one records its raw (nan) loss, its raw update's norm and ok 0, and
    the param norm of the params the guard kept (the previous step's);
    each update norm is the norm of the params' change."""
    gpt, cfg, params = _tiny()
    opt = gpt.init_opt_state(params)
    tele = _pipeline(tmp_path / "g.jsonl")
    step = make_resilient_step(gpt.train_step, cfg=cfg, lr=LR,
                               telemetry=tele)
    ts = tele.device_init(device="cpu")
    tokens = torch.from_numpy(_tiny_tokens(0))
    norms, changes = [], []
    for poison in (1.0, float("nan"), 1.0):
        before = _clone(params)
        loss, params, opt, ok, ts = step(params, opt, tokens, poison, ts)
        changes.append(float(torch.sqrt(sum(
            torch.sum((params[k] - before[k]) ** 2) for k in params))))
        norms.append(float(torch.sqrt(sum(torch.sum(v ** 2)
                                          for v in params.values()))))
    tele.close(ts)
    recs = _steps(tmp_path / "g.jsonl")
    assert [r["ok"] for r in recs] == [1.0, 0.0, 1.0]
    assert recs[1]["loss"] is None and recs[0]["loss"] > 0
    assert [r["nonfinite"] for r in recs] == [0.0] * 3
    assert changes[1] == 0.0 and recs[1]["update_norm"] > 0
    for i in (0, 2):
        assert recs[i]["update_norm"] == pytest.approx(changes[i], rel=1e-4)
    for r, n in zip(recs, norms):
        assert r["param_norm"] == pytest.approx(n, rel=1e-5)
    assert recs[1]["param_norm"] == recs[0]["param_norm"]


def test_trainer_counts_dumps_and_restarts_the_cursor(tmp_path,
                                                      flight_dir):
    """nan@4:2 with rollback_after 2 and a snapshot a step: 2 skips, 1
    rollback to step 4 and the re-run; the monitor counts them, the
    rollback dump holds the bad streak, and the stream holds every
    attempted step once in order, the re-run under its ids again, ok 0
    on exactly the two skipped ones."""
    from paddle_tpu_torch.profiler import flight_recorder, monitor
    names = ("resilience_steps", "resilience_skip_step",
             "resilience_rollback", "checkpoint_restore")
    before = {n: monitor.counter(n).value for n in names}
    path = tmp_path / "t.jsonl"
    tele = _pipeline(path, every=3)
    faults.install("nan@4:2", once_dir=None)
    try:
        gpt, cfg, init = _tiny()
        params = _clone(init)
        tr = ResilientTrainer(
            gpt.train_step, params, gpt.init_opt_state(params), cfg=cfg,
            lr=LR, telemetry=tele,
            manager=CheckpointManager(str(tmp_path / "ck"), max_to_keep=3),
            config=ResilienceConfig(checkpoint_every=1, rollback_after=2))
        run_resilient(tr, _batch, 8)
    finally:
        faults.uninstall()
    tele.close(tr._tstate)
    got = {n: monitor.counter(n).value - before[n] for n in names}
    assert got == {"resilience_steps": 10, "resilience_skip_step": 2,
                   "resilience_rollback": 1, "checkpoint_restore": 1}
    assert monitor.gauge("resilience_step_ms").value > 0
    recs = _steps(path)
    assert [r["step"] for r in recs] == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7]
    assert [r["ok"] for r in recs] == [1.0] * 4 + [0.0, 0.0] + [1.0] * 4
    dump = flight_dir / f"flight-{os.getpid()}-rollback.json"
    doc = flight_recorder.load_dump(str(dump))
    assert [r["ok"] for r in doc["steps"][-2:]] == [False, False]
    assert doc["config"]["trainer"] == "ResilientTrainer"
    assert doc["monitor"]["resilience_rollback"] >= 1


def _trainer(root, params=None, **cfg_kw):
    gpt, cfg, init = _tiny()
    params = _clone(init if params is None else params)
    return ResilientTrainer(
        gpt.train_step, params, gpt.init_opt_state(params), cfg=cfg, lr=LR,
        manager=CheckpointManager(str(root), max_to_keep=3),
        config=ResilienceConfig(checkpoint_every=cfg_kw.pop(
            "checkpoint_every", 1), **cfg_kw))


def _batch(step):
    return torch.from_numpy(_tiny_tokens(step))


def test_rollback_trajectory_matches_clean_run(tmp_path):
    baseline = {}
    run_resilient(_trainer(tmp_path / "a"), _batch, 8,
                  on_step=lambda s, l, ok: baseline.setdefault(s, l))
    faults.install("nan@4:2", once_dir=None)
    try:
        tr = _trainer(tmp_path / "b", rollback_after=2)
        traj = {}
        run_resilient(tr, _batch, 8,
                      on_step=lambda s, l, ok: traj.__setitem__(s, l))
    finally:
        faults.uninstall()
    assert tr.skipped == 2 and tr.rollbacks == 1
    assert traj == baseline


def test_rollback_without_snapshot_degrades_to_skip(tmp_path):
    tr = _trainer(tmp_path / "empty", checkpoint_every=0, rollback_after=1)
    faults.install("nan@0:1", once_dir=None)
    try:
        loss, ok = tr.train_step(_batch(0))
    finally:
        faults.uninstall()
    assert not ok and tr._bad_streak == 0 and tr.rollbacks == 0
    loss, ok = tr.train_step(_batch(1))
    assert ok and np.isfinite(loss)


def test_resume_from_manager(tmp_path):
    tr = _trainer(tmp_path)
    run_resilient(tr, _batch, 5)
    tr2 = _trainer(tmp_path)
    assert tr2.maybe_resume()
    assert tr2.step == 5
    assert _bits_equal(tr.params, tr2.params)
    assert _bits_equal(tr.opt_state, tr2.opt_state)


def test_periodic_async_saves_and_resume(tmp_path):
    """async_checkpoint: the periodic snapshots go through save_async; a
    fresh trainer resumes from them bit for bit; a torn newest snapshot
    falls back to the one before."""
    tr = _trainer(tmp_path, checkpoint_every=2, async_checkpoint=True)
    run_resilient(tr, _batch, 6)
    tr.manager.wait()
    assert tr.manager.steps() == [2, 4, 6]
    tr2 = _trainer(tmp_path, checkpoint_every=2, async_checkpoint=True)
    assert tr2.maybe_resume() and tr2.step == 6
    assert _bits_equal(tr.params, tr2.params)
    faults.truncate_shard(str(tmp_path / "ckpt-6"))
    state, step = tr.manager.restore(mesh=None, device="cpu")
    assert step == 4


def test_rebuild_plan_needs_the_sharded_step(tmp_path):
    tr = _trainer(tmp_path)
    with pytest.raises(TypeError, match="sharded step"):
        tr.rebuild_plan(None, None)


def test_port_trainer_matches_jax_trainer(tmp_path):
    """Same starting weights, batches, fault schedule (nan@3:3) and
    config (checkpoint_every 2, rollback_after 3): the port's trainer
    and the JAX package's give the same (loss, ok) sequence, skips,
    rollbacks and step, and the same final state within 2e-4."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.models import gpt as jg
    from paddle_tpu.parallel import checkpoint as jck
    from paddle_tpu.parallel import resilience as jres
    from paddle_tpu.testing import faults as jfaults
    jcfg = jg.GPTConfig(**TINY, dtype=jnp.float32, remat=False,
                        sequence_parallel=False)
    jparams = jg.init_gpt_params(jcfg, jax.random.PRNGKey(3))
    init = {k: np.asarray(v) for k, v in jparams.items()}
    config = dict(checkpoint_every=2, rollback_after=3)

    def record(traj):
        return lambda s, loss, ok: traj.append((s, loss, ok))
    jtraj, ptraj = [], []
    jtr = jres.ResilientTrainer(
        jg.train_step, jparams, jg.init_opt_state(jparams), cfg=jcfg,
        manager=jck.CheckpointManager(str(tmp_path / "jax"), max_to_keep=2),
        config=jres.ResilienceConfig(**config), lr=LR)
    jfaults.install("nan@3:3", once_dir=None)
    try:
        jres.run_resilient(jtr, lambda s: jnp.asarray(_tiny_tokens(s)),
                           TINY_STEPS, on_step=record(jtraj))
    finally:
        jfaults.uninstall()
    gpt, cfg, _ = _tiny()
    params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    ptr = ResilientTrainer(
        gpt.train_step, params, gpt.init_opt_state(params), cfg=cfg,
        manager=CheckpointManager(str(tmp_path / "port"), max_to_keep=2),
        config=ResilienceConfig(**config), lr=LR)
    faults.install("nan@3:3", once_dir=None)
    try:
        run_resilient(ptr, _batch, TINY_STEPS, on_step=record(ptraj))
    finally:
        faults.uninstall()
    assert [(s, ok) for s, _, ok in ptraj] == [(s, ok) for s, _, ok in jtraj]
    assert [s for s, _, _ in ptraj] == [0, 1, 2, 3, 4, 5, 2, 3, 4, 5, 6, 7]
    pl = np.array([loss for _, loss, _ in ptraj])
    jl = np.array([loss for _, loss, _ in jtraj])
    assert np.array_equal(np.isnan(pl), np.isnan(jl))
    np.testing.assert_allclose(pl[~np.isnan(pl)], jl[~np.isnan(jl)],
                               rtol=2e-4, atol=2e-4)
    assert (ptr.skipped, ptr.rollbacks, ptr.step) == \
        (jtr.skipped, jtr.rollbacks, jtr.step) == (3, 1, TINY_STEPS)
    for k, v in ptr.params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jtr.params[k]),
                                   rtol=2e-4, atol=2e-4, err_msg=k)
        for mom in ("m", "v"):
            _assert_close_to_scale(ptr.opt_state[mom][k].numpy(),
                                   np.asarray(jtr.opt_state[mom][k]),
                                   f"{mom} {k}")


# ----------------------------------------------------------- watchdog
def test_watchdog_timeout_raises():
    class Slow:
        def __array__(self, dtype=None, copy=None):
            import time
            time.sleep(30)
            return np.zeros(())

    with pytest.raises(StepHungError, match="did not arrive"):
        pull_with_watchdog(Slow(), timeout=0.1, retries=1, backoff_base=0.1,
                           backoff_max=0.1)


def test_watchdog_passthrough():
    assert float(pull_with_watchdog(torch.tensor(3.0), timeout=5.0)) == 3.0
    assert float(pull_with_watchdog(lambda: torch.tensor(4.0),
                                    timeout=0)) == 4.0


def test_puller_stall_mid_tuple_then_recovers():
    """A pull whose second element stalls past the budget raises; its
    late result never reaches the next pull, which a fresh worker
    serves."""
    import threading
    import time as _time
    released = threading.Event()

    class StallsOnConvert:
        def __array__(self, dtype=None, copy=None):
            released.wait(30)
            return np.full((), 7.0)

    puller = WatchdogPuller(label="test")
    with pytest.raises(StepHungError, match="did not arrive"):
        puller.pull((torch.tensor(1.0), StallsOnConvert()), timeout=0.1,
                    retries=1, backoff_base=0.05, backoff_max=0.05)
    released.set()
    _time.sleep(0.2)
    a, b = puller.pull((torch.tensor(2.0), torch.tensor(3.0)), timeout=5.0)
    assert (float(a), float(b)) == (2.0, 3.0)


def test_puller_callable_deadline_and_retries():
    puller = WatchdogPuller(label="test2")
    seen = []

    def slow_pair():
        import time as _t
        _t.sleep(30)
        return (np.zeros(()), np.zeros(()))

    with pytest.raises(StepHungError):
        puller.pull(slow_pair, timeout=0.05, retries=2, backoff_base=0.05,
                    backoff_max=0.05, on_retry=seen.append)
    assert seen == [0, 1]
    got = puller.pull(lambda: (np.float32(1.5), np.int32(2)), timeout=5.0)
    assert (float(got[0]), int(got[1])) == (1.5, 2)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32


def test_stall_inside_the_step_raises_step_hung(tmp_path, monkeypatch,
                                                flight_dir):
    """The budget covers the whole guarded step: a 2 s stall inside it
    (the fault hook) under a 0.5 s budget with no retries raises,
    counted in resilience_watchdog_hang and dumped as 'watchdog_hang'."""
    import time as _time
    from paddle_tpu_torch.profiler import flight_recorder, monitor
    hangs = monitor.counter("resilience_watchdog_hang").value
    tr = _trainer(tmp_path, watchdog_timeout=0.5, retries=0)
    tr.train_step(_batch(0))
    monkeypatch.setattr(resilience, "_STEP_HOOK",
                        lambda step: (_time.sleep(2.0), 1.0)[1])
    t0 = _time.perf_counter()
    with pytest.raises(StepHungError):
        tr.train_step(_batch(1))
    assert _time.perf_counter() - t0 < 1.5
    assert monitor.counter("resilience_watchdog_hang").value == hangs + 1
    doc = flight_recorder.load_dump(str(
        flight_dir / f"flight-{os.getpid()}-watchdog_hang.json"))
    assert "did not arrive" in doc["config"]["last_error"]


def test_exit_on_hang_uses_elastic_code(tmp_path, monkeypatch):
    tr = _trainer(tmp_path, watchdog_timeout=0.1, retries=0,
                  exit_on_hang=True)

    def hang(*a, **k):
        raise StepHungError("synthetic")
    monkeypatch.setattr(tr._puller, "pull", hang)
    with pytest.raises(SystemExit) as ei:
        tr.train_step(_batch(0))
    assert ei.value.code == ELASTIC_EXIT_CODE == 101


def test_exit_on_hang_in_a_process_exits_101(tmp_path):
    """A worker whose step wedges (hb_stale: the heartbeat stops and the
    step hook sleeps) under a 0.5 s budget with exit_on_hang exits with
    the elastic code, after its first step ran clean."""
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from paddle_tpu_torch.parallel.resilience import (\n"
        "    ResilienceConfig, ResilientTrainer)\n"
        "from paddle_tpu_torch.testing import faults\n"
        "faults.install('hb_stale@1')\n"
        "def step_fn(params, opt, batch):\n"
        "    loss = ((params['w'] - batch) ** 2).mean()\n"
        "    params['w'].sub_(0.1 * (params['w'] - batch))\n"
        "    return loss, params, opt\n"
        "tr = ResilientTrainer(step_fn, {'w': torch.zeros(4)},\n"
        "    {'step': torch.zeros(())}, config=ResilienceConfig(\n"
        "        watchdog_timeout=0.5, retries=0, exit_on_hang=True))\n"
        "print('step', tr.train_step(torch.ones(4)), flush=True)\n"
        "tr.train_step(torch.ones(4))\n"
        "print('not reached', flush=True)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop(faults.ENV_SPEC, None)
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 101, res.stdout + res.stderr
    assert "step (" in res.stdout and "not reached" not in res.stdout
    assert "heartbeat stalled" in res.stderr
