"""The port's elastic controller (paddle_tpu_torch/parallel/elastic.py),
`degrade_plan` (parallel/planner.py), the elastic fault kinds
(testing/faults.py) and the launcher's degraded restart
(distributed/launch/main.py), against the JAX package's, on the CPU.

In the test process:
- `degrade_plan` equals the JAX function case by case on a grid of old
  plans and survivor counts, each NoFeasiblePlanError's text and
  constraint included;
- `DeviceLeases` in memory as tests/test_elastic.py covers them
  (wedging backdates, a pulse skips a wedged lease, reset re-keys, a
  zero timeout disables), and over a directory, where one process's
  wedge is every process's;
- the fault plan's elastic hook: one device_loss a consult, stalls only
  at "step".

Four worlds of 4 gloo ranks and the launcher's, started once for the
module, one at a time, each rank a process (ranks that leave exit with
the controller's code):
- dp2×tp2 under `device_loss@4:1` becomes dp1×tp2 on ranks 0-1 (rank 3
  declared lost exits 103, rank 2 left out exits 102); each loss within
  2e-4 of the JAX ElasticTrainer on the same config and plan (JAX on
  the conftest's virtual CPU devices), and after the restore the losses
  equal a clean port restore of ckpt-4 on the same plan, to the bit;
- a collective hang past the budget replans (a fresh trainer), a
  straggler within it (run first in the device-loss world) does not;
- a second loss at the restore boundary re-degrades onto ranks 0 and 2;
- exhausting the replans raises;
- the launcher runs 4 ranks whose workers exit 101 with the world spec
  {n_devices: 2}; it relaunches 2 ranks, which resume from ckpt-3 on
  dp1×tp2 and equal, to the bit, the in-process replan that restored
  ckpt-3 onto that plan after the hang.

The rank processes import this module without jax.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.parallel import elastic
from paddle_tpu_torch.parallel import planner as tplanner
from paddle_tpu_torch.parallel.elastic import (DECLARED_LOST_EXIT,
                                               LEFT_OUT_EXIT, DeviceLeases,
                                               ElasticConfig)
from paddle_tpu_torch.testing import faults

B, S, LR = 8, 8, 1e-3
GPT = dict(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
           max_seq_len=16)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batch(step, dtype=np.int64):
    return np.random.RandomState(777 + step).randint(
        0, 128, (B, S + 1)).astype(dtype)


def _tcfg():
    from paddle_tpu_torch.models import gpt
    return gpt.GPTConfig(**GPT, dtype=torch.float32, remat=False,
                         sequence_parallel=False)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ rank side
def _elastic_run(rank, workdir, spec, ecfg, steps, name):
    """dp2×tp2 GPT under the fault `spec`: an ElasticTrainer over a
    manager saving every step, driven to `steps`."""
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel import (CheckpointManager,
                                           ResilienceConfig, plan_train)
    from paddle_tpu_torch.parallel.elastic import ElasticTrainer, run_elastic
    cfg = _tcfg()
    init = torch.load(os.path.join(workdir, "init.pt"), weights_only=False)
    params = {k: torch.from_numpy(v).clone() for k, v in init.items()}
    root = os.path.join(workdir, name)
    mgr = CheckpointManager(os.path.join(root, "ckpt"), max_to_keep=0)
    plan = plan_train(cfg, 4, B, dp=2, fsdp=1, tp=2)
    faults.install(spec, once_dir=os.path.join(root, f"once{rank}"))
    try:
        et = ElasticTrainer(gpt.train_step, params,
                            gpt.init_opt_state(params), cfg=cfg,
                            global_batch=B, manager=mgr, plan=plan,
                            config=ecfg, device_type="cpu",
                            resilience=ResilienceConfig(checkpoint_every=1),
                            lr=LR)
        losses = {}
        run_elastic(et, _batch, steps,
                    on_step=lambda s, l, ok: losses.__setitem__(s, l))
    finally:
        faults.uninstall()
    return et, mgr, losses


def _summary(et, losses):
    import torch.distributed as dist
    return {"losses": losses, "replans": et.replans, "axes": et.plan.axes,
            "world": et.world, "step": et.step,
            "trace_count": et.trace_count,
            "restored": et.last_restore_step,
            "new_rank": dist.get_rank(), "world_size": dist.get_world_size(),
            "last_replan": et.last_replan}


def _clean_restore(et, mgr, start, steps):
    """A clean restore of ckpt-<start> on the trainer's plan and mesh and
    a fresh sharded step: its losses for steps start..steps-1."""
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.models.facade import make_train_step
    from paddle_tpu_torch.parallel.checkpoint import load_sharded
    from paddle_tpu_torch.parallel.resilience import plan_state_specs
    state = load_sharded(os.path.join(mgr.root, f"ckpt-{start}"),
                         mesh=et.mesh, specs=plan_state_specs(et.plan),
                         device="cpu")
    step = make_train_step(gpt.train_step, cfg=_tcfg(), mesh=et.mesh,
                           plan=et.plan, lr=LR)
    step.adopt_shapes(*et._trainer._shapes)
    p, o = state["params"], state["opt_state"]
    out = {}
    for s in range(start, steps):
        loss, p, o = step(p, o, _batch(s))
        out[s] = float(loss)
    return out


def _scenario_loss(rank, workdir):
    """A straggler within the step budget on the full world, then the
    device loss, in one world."""
    st, _, st_losses = _elastic_run(
        rank, workdir, "straggler@3:200",
        ElasticConfig(heartbeat_timeout=60.0, step_timeout=5.0), 5,
        "straggler")
    straggler = _summary(st, st_losses)
    del st
    et, mgr, losses = _elastic_run(rank, workdir, "device_loss@4:1",
                                   ElasticConfig(heartbeat_timeout=60.0),
                                   7, "loss")
    out = _summary(et, losses)
    out["straggler"] = straggler
    out["clean"] = _clean_restore(et, mgr, 4, 7)
    out["bytes"] = et.last_replan["reshard_bytes"]
    return out


def _scenario_hang(rank, workdir):
    et, _, losses = _elastic_run(
        rank, workdir, "collective_hang@3:2500",
        ElasticConfig(heartbeat_timeout=60.0, step_timeout=1.0,
                      hang_retries=0), 6, "hang")
    out = _summary(et, losses)
    out["fresh_trainer"] = et._trainer.manager is not None
    return out


def _scenario_mid_restore(rank, workdir):
    et, _, losses = _elastic_run(rank, workdir,
                                 "device_loss@4:1,device_loss@4:1",
                                 ElasticConfig(heartbeat_timeout=60.0),
                                 6, "mid")
    out = _summary(et, losses)
    out["fired"] = sorted(os.listdir(os.path.join(workdir, "mid",
                                                  f"once{rank}")))
    return out


def _scenario_exhausted(rank, workdir):
    try:
        _elastic_run(rank, workdir, ",".join(["device_loss@0:1"] * 4),
                     ElasticConfig(heartbeat_timeout=60.0, max_replans=2),
                     5, "exhausted")
    except RuntimeError as e:
        return {"raised": str(e)}
    return {"raised": None}


SCENARIOS = {"loss": _scenario_loss, "hang": _scenario_hang,
             "mid_restore": _scenario_mid_restore,
             "exhausted": _scenario_exhausted}


def _rank_main(scenario, rank, world, workdir):
    torch.set_num_threads(1)
    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    os.environ["WORLD_SIZE"] = str(world)
    import torch.distributed as dist
    from paddle_tpu_torch.parallel import init_parallel_env
    init_parallel_env(backend="gloo", timeout_s=120,
                      init_method=f"file://{workdir}/store.{scenario}")
    out, code = {}, 0
    try:
        out = SCENARIOS[scenario](rank, workdir)
    except elastic.ElasticDeparture as e:
        out, code = {"departed": e.code, "reason": e.reason}, e.code
    except BaseException as e:                  # recorded for the test
        out = {"error": repr(e)}
    finally:
        torch.save(out, os.path.join(workdir, f"{scenario}.rank{rank}.pt"))
        if dist.is_initialized():
            dist.destroy_process_group()
    sys.exit(code)


# the launcher's worker: every rank builds the ElasticTrainer; the first
# run loses a device at step 3 and exits 101, the relaunched ranks
# resume from LATEST
WORKER = r'''
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.environ["ELASTIC_TEST_DIR"])
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.parallel import (CheckpointManager, ResilienceConfig,
                                       init_parallel_env, plan_train)
from paddle_tpu_torch.parallel.elastic import (ElasticConfig,
                                               ElasticTrainer, run_elastic)
from paddle_tpu_torch.testing import faults
import torch.distributed as dist
workdir = sys.argv[1]
init_parallel_env(timeout_s=120)
cfg = gpt.GPTConfig(**json.load(open(os.path.join(workdir, "cfg.json"))),
                    dtype=torch.float32, remat=False,
                    sequence_parallel=False)
init = torch.load(os.path.join(workdir, "init.pt"), weights_only=False)
params = {k: torch.from_numpy(v).clone() for k, v in init.items()}
B, S = 8, 8
def batch(step):
    return np.random.RandomState(777 + step).randint(
        0, 128, (B, S + 1)).astype(np.int64)
faults.install("device_loss@3:1", once_dir=os.path.join(
    workdir, f"once{dist.get_rank()}"))
mgr = CheckpointManager(os.path.join(workdir, "ckpt"), max_to_keep=0)
plan = plan_train(cfg, 4, B, dp=2, fsdp=1, tp=2)
et = ElasticTrainer(gpt.train_step, params, gpt.init_opt_state(params),
                    cfg=cfg, global_batch=B, manager=mgr, plan=plan,
                    config=ElasticConfig(restart_on_loss=True),
                    resilience=ResilienceConfig(checkpoint_every=1),
                    device_type="cpu", lr=1e-3)
resumed = et.maybe_resume()
start = et.step
losses = {}
run_elastic(et, batch, 6, on_step=lambda s, l, ok: losses.__setitem__(s, l))
with open(os.path.join(workdir, f"out.{dist.get_rank()}.json"), "w") as f:
    json.dump({"resumed": resumed, "start": start, "losses": losses,
               "axes": et.plan.axes, "granted": et.granted,
               "world": dist.get_world_size()}, f)
dist.destroy_process_group()
'''


def _launcher_start(workdir):
    """The launcher over 4 host ranks of WORKER, in the background."""
    with open(os.path.join(workdir, "cfg.json"), "w") as f:
        json.dump(GPT, f)
    script = os.path.join(workdir, "worker.py")
    with open(script, "w") as f:
        f.write(WORKER)
    env = dict(os.environ, PYTHONPATH=REPO, ELASTIC_TEST_DIR=workdir,
               OMP_NUM_THREADS="1")
    env.pop("PADDLE_TPU_FAULTS", None)
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "4", "--devices", "cpu",
         "--max_elastic_restart", "2", "--log_dir",
         os.path.join(workdir, "logs"), script, workdir],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)


def _launcher_finish(proc, workdir):
    _, err = proc.communicate(timeout=240)
    outs = []
    for name in sorted(os.listdir(workdir)):
        if name.startswith("out."):
            with open(os.path.join(workdir, name)) as f:
                outs.append(json.load(f))
    return {"rc": proc.returncode, "stderr": err, "outs": outs,
            "spec_left": os.path.exists(os.path.join(
                workdir, "logs", "elastic_world.json"))}


def _start(scenario, workdir):
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(scenario, r, 4, workdir)) for r in range(4)]
    for p in procs:
        p.start()
    return procs


def _collect(scenario, procs, workdir):
    for p in procs:
        p.join(240)
        if p.is_alive():
            p.kill()
    return [dict(torch.load(os.path.join(workdir, f"{scenario}.rank{r}.pt"),
                            weights_only=False), exitcode=p.exitcode)
            for r, p in enumerate(procs)]


# ----------------------------------------------------------- test side
@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's ElasticTrainer on 4 virtual devices, dp2×tp2
    under device_loss@4:1, 7 steps, and its initial params."""
    import functools
    import jax
    import jax.numpy as jnp
    from paddle_tpu.models.gpt import (GPTConfig, init_gpt_params,
                                       init_opt_state, train_step)
    from paddle_tpu.parallel.checkpoint import CheckpointManager
    from paddle_tpu.parallel.elastic import (ElasticConfig as JCfg,
                                             ElasticTrainer, run_elastic)
    from paddle_tpu.parallel.planner import plan_train
    from paddle_tpu.parallel.resilience import ResilienceConfig
    from paddle_tpu.testing import faults as jfaults
    cfg = GPTConfig(**GPT, dtype=jnp.float32, remat=False,
                    sequence_parallel=False)
    params = init_gpt_params(cfg, jax.random.PRNGKey(0))
    init = jax.tree_util.tree_map(np.asarray, params)
    tmp = tempfile.mkdtemp(prefix="jax_elastic_")
    jfaults.install("device_loss@4:1", once_dir=os.path.join(tmp, "once"))
    try:
        et = ElasticTrainer(
            train_step, params, init_opt_state(params), cfg=cfg,
            global_batch=B,
            manager=CheckpointManager(os.path.join(tmp, "ckpt"),
                                      max_to_keep=0),
            plan=plan_train(cfg, 4, B, dp=2, fsdp=1, tp=2),
            devices=list(jax.devices())[:4],
            config=JCfg(heartbeat_timeout=60.0),
            resilience=ResilienceConfig(checkpoint_every=1), lr=LR)
        losses = {}
        run_elastic(et, functools.partial(_batch, dtype=np.int32), 7,
                    on_step=lambda s, l, ok: losses.__setitem__(s, l))
    finally:
        jfaults.uninstall()
    return {"init": init, "losses": losses, "axes": et.plan.axes}


@pytest.fixture(scope="module")
def worlds(jax_ref):
    """Every 4-rank world of the module, one at a time (the suite runs
    beside it), then the launcher's run."""
    workdir = tempfile.mkdtemp(prefix="torch_elastic_")
    torch.save(jax_ref["init"], os.path.join(workdir, "init.pt"))
    lwork = os.path.join(workdir, "launch")
    os.makedirs(lwork)
    torch.save(jax_ref["init"], os.path.join(lwork, "init.pt"))
    out = {s: _collect(s, _start(s, workdir), workdir) for s in SCENARIOS}
    out["launch"] = _launcher_finish(_launcher_start(lwork), lwork)
    return out


def _survivors(res, n):
    live = [r for r in res if "departed" not in r]
    for r in live:
        assert "error" not in r, r["error"]
    assert len(live) == n, res
    return live


def test_device_loss_degrades_dp_first_and_tracks_jax(jax_ref, worlds):
    """dp2×tp2 loses rank 3 at step 4: ranks 0-1 replan onto dp1×tp2
    (rank 2 left out, rank 3 declared lost, each exiting with its code),
    restore ckpt-4 and run steps 4-6; every loss within 2e-4 of the JAX
    ElasticTrainer's on the same plan."""
    res = worlds["loss"]
    assert res[2]["departed"] == LEFT_OUT_EXIT
    assert res[2]["exitcode"] == LEFT_OUT_EXIT
    assert res[3]["departed"] == DECLARED_LOST_EXIT
    assert res[3]["exitcode"] == DECLARED_LOST_EXIT
    assert jax_ref["axes"] == {"dp": 1, "fsdp": 1, "tp": 2}
    for r in _survivors(res, 2):
        assert r["exitcode"] == 0
        assert r["replans"] == 1 and r["restored"] == 4 and r["step"] == 7
        assert r["axes"] == jax_ref["axes"]
        assert r["world"] == ["rank0", "rank1"]
        assert r["world_size"] == 2 and r["trace_count"] == 1
        assert sorted(r["losses"]) == list(range(7))
        np.testing.assert_allclose(
            [r["losses"][s] for s in range(7)],
            [jax_ref["losses"][s] for s in range(7)], rtol=2e-4, atol=2e-4)
        assert r["bytes"] > 0
        assert set(r["last_replan"]) == {"detect_s", "settle_s",
                                         "reform_s", "restore_s",
                                         "reshard_bytes"}


def test_resumed_losses_equal_a_clean_restore_bit_for_bit(worlds):
    """After the replan, steps 4-6 equal a clean restore of ckpt-4 on the
    same degraded plan with a fresh step, to the bit."""
    for r in _survivors(worlds["loss"], 2):
        assert r["clean"] == {s: r["losses"][s] for s in range(4, 7)}


def test_collective_hang_replans_onto_a_fresh_trainer(worlds):
    """A stall past the step budget reads as a loss of the world's last
    rank: dp2×tp2 -> dp1×tp2, a fresh trainer (the orphan detached from
    the manager), every step run once."""
    res = worlds["hang"]
    assert res[3]["departed"] == DECLARED_LOST_EXIT
    assert res[2]["departed"] == LEFT_OUT_EXIT
    for r in _survivors(res, 2):
        assert r["replans"] == 1 and r["restored"] == 3
        assert r["axes"] == {"dp": 1, "fsdp": 1, "tp": 2}
        assert sorted(r["losses"]) == list(range(6))
        assert r["fresh_trainer"]
        assert r["trace_count"] == 1


def test_straggler_within_budget_does_not_replan(worlds):
    """A 200 ms stall within the 5 s budget on every rank of the world
    (before its device loss) replans nothing."""
    for r in _survivors(worlds["loss"], 2):
        st = r["straggler"]
        assert st["replans"] == 0 and st["world"] == [f"rank{i}"
                                                      for i in range(4)]
        assert sorted(st["losses"]) == list(range(5))


def test_device_loss_mid_restore_re_degrades(worlds):
    """A second loss queued at step 4 fires at the restore boundary:
    rank 1, the last of the first attempt's world, is lost too, and the
    survivors re-degrade onto ranks 0 and 2, renumbered 0 and 1."""
    res = worlds["mid_restore"]
    assert res[1]["departed"] == DECLARED_LOST_EXIT
    assert res[3]["departed"] == DECLARED_LOST_EXIT
    live = _survivors(res, 2)
    assert [r["new_rank"] for r in live] == [0, 1]
    for r in live:
        assert r["replans"] == 1
        assert r["world"] == ["rank0", "rank2"]
        assert sorted(r["losses"]) == list(range(6))
        assert len(r["fired"]) == 2
    assert live[0]["losses"] == live[1]["losses"]


def test_replans_exhausted_raises(worlds):
    res = worlds["exhausted"]
    assert [r.get("departed") for r in res[1:]] == [DECLARED_LOST_EXIT] * 3
    assert "replans exhausted" in (res[0].get("raised") or ""), res[0]


def test_launcher_restarts_four_ranks_into_two(worlds):
    """Under restart_on_loss the workers exit 101 with the world spec
    {n_devices: 2, axes: dp1×tp2}; the launcher relaunches 2 ranks, which
    read the spec, plan onto it, resume from ckpt-3 and finish: their
    losses equal, to the bit, those of the in-process replan after the
    hang, which restored ckpt-3 onto the same plan."""
    run = worlds["launch"]
    assert run["rc"] == 0, run["stderr"][-3000:]
    assert "DEGRADED world spec" in run["stderr"]
    assert not run["spec_left"]
    assert len(run["outs"]) == 2
    for o in run["outs"]:
        assert o["resumed"] and o["start"] == 3 and o["world"] == 2
        assert o["axes"] == {"dp": 1, "fsdp": 1, "tp": 2}
        assert o["granted"]["n_devices"] == 2
        assert o["granted"]["reason"] == "heartbeat_stale"
    hang = _survivors(worlds["hang"], 2)[0]["losses"]
    assert run["outs"][0]["losses"] == run["outs"][1]["losses"]
    got = {int(k): v for k, v in run["outs"][0]["losses"].items()}
    assert got == {s: hang[s] for s in (3, 4, 5)}


# ------------------------------------ in the test process: the planner
def _plans():
    from paddle_tpu.parallel import planner as rp
    chip = dataclasses.asdict(rp.ChipSpec())
    spec = dict(vocab_size=128, hidden_size=32, num_layers=4, num_heads=8,
                seq_len=16, ffn_hidden=128, sequence_parallel=False)
    return rp, chip, spec


OLD = [dict(dp=2, fsdp=2, tp=2), dict(dp=4, fsdp=1, tp=2),
       dict(dp=1, fsdp=1, tp=8), dict(dp=2, fsdp=4, tp=1),
       dict(dp=2, fsdp=1, tp=2, pp=2, microbatches=4),
       dict(dp=1, fsdp=2, tp=1, pp=4, microbatches=4)]


@pytest.mark.parametrize("old", range(len(OLD)))
def test_degrade_plan_equals_jax_case_by_case(old):
    rp, chip, spec = _plans()
    rs, ts = rp.ModelSpec(**spec), tplanner.ModelSpec(**spec)
    rc, tc = rp.ChipSpec(**chip), tplanner.ChipSpec(**chip)
    kw = OLD[old]
    ro = rp.plan_train(rs, 8, 16, chip=rc, **kw)
    to = tplanner.plan_train(ts, 8, 16, chip=tc, **kw)
    for n in range(0, 9):
        try:
            want = rp.degrade_plan(rs, ro, n, 16, chip=rc)
        except rp.NoFeasiblePlanError as e:
            with pytest.raises(tplanner.NoFeasiblePlanError) as got:
                tplanner.degrade_plan(ts, to, n, 16, chip=tc)
            assert str(got.value) == str(e)
            assert got.value.constraint == e.constraint
            continue
        got = tplanner.degrade_plan(ts, to, n, 16, chip=tc)
        assert got.axes == want.axes, (n, got.axes, want.axes)
        assert got.mapping == want.mapping
        for f in ("dp", "mp", "pp", "fsdp", "microbatches", "fits"):
            assert getattr(got.plan, f) == getattr(want.plan, f), f
        assert got.plan.step_s == pytest.approx(want.plan.step_s,
                                                rel=1e-12)
        assert got.plan.mem_bytes == pytest.approx(want.plan.mem_bytes,
                                                   rel=1e-12)


@pytest.mark.parametrize("case", ["hbm", "hbm_search", "zero"])
def test_degrade_plan_errors_name_the_constraint_as_jax(case):
    rp, chip, spec = _plans()
    rs, ts = rp.ModelSpec(**spec), tplanner.ModelSpec(**spec)
    over = {"hbm_bytes": 1e4} if case.startswith("hbm") else {}
    rc = rp.ChipSpec(**dict(chip, **over))
    tc = tplanner.ChipSpec(**dict(chip, **over))
    ro = rp.plan_train(rs, 8, 16, dp=2, fsdp=2, tp=2)
    to = tplanner.plan_train(ts, 8, 16, dp=2, fsdp=2, tp=2)
    # hbm_search: 1 survivor cannot hold tp2, so the held lattice is
    # empty and the full search finds only OOM plans
    n, gb = {"hbm": (7, 16), "hbm_search": (1, 16), "zero": (0, 16)}[case]
    with pytest.raises(rp.NoFeasiblePlanError) as want:
        rp.degrade_plan(rs, ro, n, gb, chip=rc)
    with pytest.raises(tplanner.NoFeasiblePlanError) as got:
        tplanner.degrade_plan(ts, to, n, gb, chip=tc)
    assert str(got.value) == str(want.value)
    assert got.value.constraint == want.value.constraint
    if case.startswith("hbm"):
        assert "hbm" in got.value.constraint and "GB" in str(got.value)


# ------------------------------------ in the test process: the leases
def test_leases_wedge_backdates_so_detection_is_immediate():
    keys = [f"rank{i}" for i in range(4)]
    leases = DeviceLeases(keys)
    assert leases.stale(60.0) == []
    leases.wedge(["rank3"])
    assert leases.stale(60.0) == ["rank3"]
    leases.pulse()                               # a pulse skips wedged
    assert leases.stale(60.0) == ["rank3"]
    leases.reset(keys[:-1])                      # the survivors re-keyed
    assert leases.stale(60.0) == []


def test_leases_zero_timeout_disables():
    leases = DeviceLeases(["rank0", "rank1"])
    leases.wedge(["rank0"])
    assert leases.stale(0.0) == []


def test_leases_over_a_directory_are_every_ranks(tmp_path):
    """Two ranks' leases over one directory: a wedge by either is seen
    by both, each pulses only its own lease, and a lease not pulsed
    within the timeout goes stale."""
    keys = ["rank0", "rank1"]
    a = DeviceLeases(keys, directory=str(tmp_path), own="rank0")
    b = DeviceLeases(keys, directory=str(tmp_path), own="rank1")
    assert a.stale(60.0) == [] and b.stale(60.0) == []
    b.wedge(["rank1"])
    assert a.stale(60.0) == ["rank1"] and b.stale(60.0) == ["rank1"]
    b.pulse()
    assert a.stale(60.0) == ["rank1"]
    a.reset(["rank0"])
    assert a.stale(60.0) == []
    time.sleep(1.2)
    a.pulse()
    c = DeviceLeases(["rank0", "rank9"], directory=str(tmp_path),
                     own="rank0")
    c._reset_wall -= 5.0                 # rank9 never beat since
    assert c.stale(1.0) == ["rank9"]


def test_elastic_config_has_the_reference_fields():
    from paddle_tpu.parallel.elastic import ElasticConfig as J
    ours = {f.name: f.default for f in dataclasses.fields(ElasticConfig)}
    for f in dataclasses.fields(J):
        assert ours[f.name] == f.default, f.name


# ------------------------------------ in the test process: the faults
def test_one_device_loss_a_consult_and_stalls_only_at_step():
    plan = faults.FaultPlan("device_loss@2:1,device_loss@2:2,"
                            "collective_hang@3:1500,straggler@3:200")
    assert plan.on_elastic("step", 1) == {}
    assert plan.on_elastic("step", 2) == {"lose": 1}
    assert plan.on_elastic("restore", 2) == {"lose": 2}
    assert plan.on_elastic("restore", 3) == {}
    assert plan.on_elastic("step", 3) == {"stall_s": 1.5}
    assert plan.on_elastic("step", 4) == {"stall_s": 0.2}
    assert plan.on_elastic("step", 5) == {}


def test_install_arms_the_elastic_hook():
    faults.install("device_loss@1")
    try:
        assert elastic._FAULT_HOOK is not None
        assert elastic._FAULT_HOOK("step", 1) == {"lose": 1}
    finally:
        faults.uninstall()
    assert elastic._FAULT_HOOK is None


def test_request_degraded_restart_writes_the_spec_and_exits_101(
        tmp_path, monkeypatch):
    from paddle_tpu_torch.distributed.launch import heartbeat
    path = tmp_path / "world.json"
    monkeypatch.setenv(heartbeat.ENV_WORLD_FILE, str(path))
    with pytest.raises(SystemExit) as e:
        elastic.request_degraded_restart({"n_devices": 2}, "device_loss")
    assert e.value.code == 101
    spec = heartbeat.read_world_spec(str(path))
    assert spec["n_devices"] == 2 and spec["reason"] == "device_loss"
    assert spec["t_exit"] <= time.time()


def test_in_process_replan_without_a_manager_names_the_route():
    """A world of several ranks and no CheckpointManager (no shared
    directory, no snapshot): the controller raises naming the manager
    and the exit-101 route instead of guessing."""
    et = elastic.ElasticTrainer.__new__(elastic.ElasticTrainer)
    et.world, et._run_dir = ["rank0", "rank1"], None
    with pytest.raises(RuntimeError, match="restart_on_loss"):
        et._check_route("heartbeat_stale")
    with pytest.raises(RuntimeError, match="CheckpointManager"):
        et._check_route("collective_hang")
