"""The port's sharded checkpoints (paddle_tpu_torch/parallel/checkpoint.py)
against the JAX package's (paddle_tpu/parallel/checkpoint.py), on the CPU.

The format is the reference's, so a checkpoint written by either package
loads in the other. One world of 4 ranks over gloo (a file store, one
torch thread a rank), started once for the module, runs:
- port -> JAX: GPT and a small Llama (vocab 512, hidden 128, 2 layers,
  f32) train 2 steps under fsdp2×tp2 and, separately, dp2×pp2, and
  save through a CheckpointManager, each rank its replica-0 blocks;
  the JAX package's verify_checkpoint passes, its load_sharded(mesh=
  None) equals the port's gather_full state bit for bit, and each
  manifest entry's shape, dtype, spec and set of windows equal what the
  JAX package writes for the same plan, every distinct window written
  once;
- JAX -> port: the JAX package trains 2 steps (its make_train_step)
  and save_train_states under a dp2×fsdp2×tp2 mesh; the port loads it
  whole (bit-equal to the JAX trees), and onto fsdp2×tp2 and tp2×pp2
  (each rank's block equal to the JAX array's window as plan.specs
  says, the stacked leaves cut over pp); steps 3-5 from it match the
  JAX uninterrupted trajectory and final state within 2e-4;
- an async save on the 4 ranks that a later in-place step cannot
  reach, the reference's mesh cases (true shards on disk, reshape onto
  another mesh, spec overrides, windows that straddle the saved ones,
  a re-save under another sharding leaving no residue), and last a
  `crash_shard` fault killing one rank mid-save: the previous snapshot
  and LATEST stay as they were.
In the test process: the counterparts of tests/test_checkpoint.py,
test_checkpoint_async.py, test_checkpoint_edges.py and the checkpoint,
fault-plan and heartbeat parts of test_fault_tolerance.py.

The rank processes import this module without jax: the JAX side is
imported in the fixtures and tests, in the test process only.
"""
import json
import os
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.parallel import checkpoint as ck
from paddle_tpu_torch.parallel.checkpoint import (
    AsyncSaveError, CheckpointCorruptError, CheckpointManager, Converter,
    HostSnapshot, is_intact, load_sharded, load_train_state, read_latest,
    save_sharded, save_train_state, verify_checkpoint)
from paddle_tpu_torch.testing import faults

B, S, LR = 8, 32, 1e-3
GPT = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
           max_seq_len=64)
LLAMA = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=64)
MODELS = ("gpt", "llama")
# the port saves under these; the JAX package's checkpoint loads onto
# these
SAVE_PLANS = {"fsdp2_tp2": dict(dp=1, fsdp=2, tp=2),
              "dp2_pp2": dict(dp=2, fsdp=1, tp=1, pp=2)}
LOAD_PLANS = {"fsdp2_tp2": dict(dp=1, fsdp=2, tp=2),
              "tp2_pp2": dict(dp=1, fsdp=1, tp=2, pp=2)}
JAX_PLAN = dict(dp=2, fsdp=2, tp=2)
SAVE_CASES = [(m, p) for m in MODELS for p in SAVE_PLANS]
LOAD_CASES = [(m, p) for m in MODELS for p in LOAD_PLANS]


def _tokens(seed):
    return np.random.RandomState(seed).randint(
        0, GPT["vocab_size"], (B, S + 1)).astype(np.int64)


def _tcfg(model):
    from paddle_tpu_torch.models import gpt, llama
    if model == "gpt":
        return gpt.GPTConfig(**GPT, dtype=torch.float32, remat=False,
                             sequence_parallel=False)
    return llama.LlamaConfig(**LLAMA, dtype=torch.float32, remat=False)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _port_write_audit():
    """Every checkpoint the port commits during a test must verify at
    teardown (the fault injectors exempt what they damage)."""
    ck._AUDIT.clear()
    yield
    paths, ck._AUDIT[:] = list(ck._AUDIT), []
    for p in paths:
        if os.path.isdir(p):
            verify_checkpoint(p)


# ------------------------------------------------------------ rank side
def _numpy_tree(tree):
    return {k: (_numpy_tree(v) if isinstance(v, dict) else v.numpy())
            for k, v in tree.items()}


def _port_saves(workdir, init):
    """Port -> JAX: 2 steps under each of SAVE_PLANS, saved through a
    manager; the gathered state beside it. The GPT fsdp2×tp2 case also
    saves asynchronously and steps in place before the barrier."""
    from paddle_tpu_torch.models import gpt, llama
    from paddle_tpu_torch.models.facade import make_train_step
    from paddle_tpu_torch.parallel import plan_train
    out = {}
    for model in MODELS:
        mod = gpt if model == "gpt" else llama
        cfg = _tcfg(model)
        for name, axes in SAVE_PLANS.items():
            plan = plan_train(cfg, 4, B, **axes)
            mesh = plan.build_mesh(device_type="cpu")
            step = make_train_step(mod.train_step, cfg=cfg, mesh=mesh,
                                   plan=plan, lr=LR)
            params = {k: torch.from_numpy(v) for k, v in init[model].items()}
            opt = gpt.init_opt_state(params)
            for s in range(2):
                _, params, opt = step(params, opt, _tokens(s))
            pins = {"params": step.in_pins[0], "opt_state": step.in_pins[1]}
            mgr = CheckpointManager(os.path.join(workdir,
                                                 f"port_{model}_{name}"))
            state = {"params": params, "opt_state": opt,
                     "step": np.int64(2)}
            mgr.save(state, 2, shardings=pins)
            res = {"plan": plan.name,
                   "full": _numpy_tree(step.gather_full(params)),
                   "m": _numpy_tree(step.gather_full(opt["m"])),
                   "v": _numpy_tree(step.gather_full(opt["v"])),
                   "opt_step": float(opt["step"]),
                   "path": mgr.latest_path()}
            if model == "gpt" and name == "fsdp2_tp2":
                want = res["full"]
                mgr.save_async(state, 3, shardings=pins)
                # the next step updates the same tensors in place
                _, params, opt = step(params, opt, _tokens(2))
                mgr.wait()
                got = load_sharded(mgr._path(3), mesh=None, device="cpu")
                after = _numpy_tree(step.gather_full(params))
                res["async"] = {
                    "equal": all(np.array_equal(got["params"][k].numpy(),
                                                want[k]) for k in want),
                    "stepped": any(not np.array_equal(after[k], want[k])
                                   for k in want),
                    "steps": mgr.steps()}
            out[(model, name)] = res
    return out


def _jax_loads(workdir, init):
    """JAX -> port: the JAX checkpoint onto each of LOAD_PLANS: this
    rank's blocks with their windows and specs, then steps 3-5."""
    from paddle_tpu_torch.models import gpt, llama
    from paddle_tpu_torch.models.facade import make_train_step
    from paddle_tpu_torch.parallel import plan_train
    from paddle_tpu_torch.parallel.mesh import sharding_for
    from paddle_tpu_torch.parallel.resilience import plan_state_specs
    out = {}
    for model in MODELS:
        mod = gpt if model == "gpt" else llama
        cfg = _tcfg(model)
        shapes = {k: tuple(v.shape) for k, v in init[model].items()}
        for name, axes in LOAD_PLANS.items():
            plan = plan_train(cfg, 4, B, **axes)
            mesh = plan.build_mesh(device_type="cpu")
            state = load_sharded(os.path.join(workdir, f"jax_{model}"),
                                 mesh=mesh, specs=plan_state_specs(plan))
            blocks = {}
            for k, full in shapes.items():
                sh = sharding_for(plan.specs[k], mesh, shape=full)
                blocks[k] = {
                    "spec": ck._spec_to_json(sh.spec),
                    "window": [[s.start, s.stop] for s in
                               ck._local_window(sh, full)],
                    # copies: the steps below update these in place
                    "params": state["params"][k].numpy().copy(),
                    "m": state["opt_state"]["m"][k].numpy().copy(),
                    "v": state["opt_state"]["v"][k].numpy().copy()}
            step = make_train_step(mod.train_step, cfg=cfg, mesh=mesh,
                                   plan=plan, lr=LR)
            step.adopt_shapes(shapes, {"m": shapes, "v": shapes,
                                       "step": ()})
            params, opt = state["params"], state["opt_state"]
            losses = []
            for s in range(2, 5):
                loss, params, opt = step(params, opt, _tokens(s))
                losses.append(float(loss))
            out[(model, name)] = {
                "blocks": blocks, "losses": losses,
                "restored_step": int(state["step"]),
                "restored_step_dtype": str(state["step"].dtype),
                "full": _numpy_tree(step.gather_full(params)),
                "m": _numpy_tree(step.gather_full(opt["m"])),
                "v": _numpy_tree(step.gather_full(opt["v"])),
                "opt_step": float(opt["step"])}
    return out


def _mesh_cases(workdir, rank):
    """The reference's mesh cases on the 4 ranks."""
    from paddle_tpu_torch.parallel.mesh import P, build_mesh, sharding_for
    out = {}
    x = torch.arange(64.0).reshape(8, 8)
    b = torch.arange(8.0) * 3
    mesh = build_mesh({"dp": 2, "tp": 2}, device_type="cpu")
    sw = sharding_for(P("dp", "tp"), mesh, shape=(8, 8))
    sb = sharding_for(P("tp"), mesh, shape=(8,))
    path = os.path.join(workdir, "mesh_ck")
    save_sharded({"w": sw.shard(x), "b": sb.shard(b), "step": np.int64(3)},
                 path, shardings={"w": sw, "b": sb})
    with open(os.path.join(path, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    out["saved"] = {
        "files": {f: list(np.load(os.path.join(path, f)).shape)
                  for f in os.listdir(path) if f.endswith(".npy")},
        "specs": {k: leaves[k]["spec"] for k in ("w", "b")},
        "windows": {k: sorted(s["window"] for s in leaves[k]["shards"])
                    for k in ("w", "b")}}
    # onto tp4 (the recorded spec, cleaned: dp absent) and dp4 with an
    # override (the Converter), and whole
    tp4 = build_mesh({"tp": 4}, device_type="cpu")
    got = load_sharded(path, mesh=tp4)
    out["tp4"] = (torch.equal(got["w"], sharding_for(
        P(None, "tp"), tp4, shape=(8, 8)).shard(x)), torch.equal(
        got["b"], sharding_for(P("tp"), tp4, shape=(8,)).shard(b)),
        int(got["step"]), str(got["step"].dtype))
    dp4 = build_mesh({"dp": 4}, device_type="cpu")
    got = Converter(path).convert(dp4, specs={"w": P(None, "dp")})
    out["dp4_override"] = torch.equal(got["w"], sharding_for(
        P(None, "dp"), dp4, shape=(8, 8)).shard(x))
    whole = load_sharded(path, mesh=None, device="cpu")
    out["whole"] = torch.equal(whole["w"], x) and torch.equal(whole["b"], b)
    # the JAX package's dp3 checkpoint (row windows 4+4+4) onto dp2×tp2
    # (6+6): every block straddles a saved boundary
    got = load_sharded(os.path.join(workdir, "jax_dp3"), mesh=mesh,
                       specs={"w": P("dp", "tp")})
    out["straddle"] = got["w"].numpy()
    out["straddle_window"] = [[s.start, s.stop] for s in ck._local_window(
        sharding_for(P("dp", "tp"), mesh, shape=(12, 8)), (12, 8))]
    # a re-save of the same path replicated: one file, no residue
    save_sharded({"w": x}, path)
    out["resave_files"] = sorted(f for f in os.listdir(path)
                                 if f.endswith(".npy"))
    return out


def _crash_case(workdir, rank):
    """A `crash_shard` fault kills rank 2 after its first shard file of
    the second save; the others see the save fail."""
    from paddle_tpu_torch.parallel.mesh import P, build_mesh, sharding_for
    mesh = build_mesh({"dp": 2, "tp": 2}, device_type="cpu")
    sw = sharding_for(P("dp", "tp"), mesh, shape=(8, 8))
    w = sw.shard(torch.arange(64.0).reshape(8, 8))
    mgr = CheckpointManager(os.path.join(workdir, "crash"))
    mgr.save({"w": w, "step": np.int64(1)}, 1, shardings={"w": sw})
    if rank == 2:
        faults.install("crash_shard@1:1").on_step(1)
    try:
        mgr.save({"w": w * 2, "step": np.int64(2)}, 2, shardings={"w": sw})
        return {"raised": None}
    except Exception as e:                      # noqa: BLE001
        return {"raised": type(e).__name__}


def _rank_main(rank, world, workdir):
    torch.set_num_threads(1)
    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    os.environ["WORLD_SIZE"] = str(world)
    from paddle_tpu_torch.parallel import init_parallel_env
    init_parallel_env(backend="gloo", timeout_s=120,
                      init_method=f"file://{workdir}/store")
    init = torch.load(os.path.join(workdir, "init.pt"), weights_only=False)
    out = {"port_saves": _port_saves(workdir, init),
           "jax_loads": _jax_loads(workdir, init),
           "mesh": _mesh_cases(workdir, rank)}
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    # last: one rank dies mid-save, which ends the world
    torch.save(_crash_case(workdir, rank),
               os.path.join(workdir, f"crash{rank}.pt"))


def _spawn(world, workdir):
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, workdir))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    res = []
    for r in range(world):
        path = os.path.join(workdir, f"rank{r}.pt")
        res.append(torch.load(path, weights_only=False)
                   if os.path.exists(path) else None)
    crash = [torch.load(os.path.join(workdir, f"crash{r}.pt"),
                        weights_only=False)
             if os.path.exists(os.path.join(workdir, f"crash{r}.pt"))
             else None for r in range(world)]
    return {"ranks": res, "codes": codes, "crash": crash,
            "workdir": workdir}


# ----------------------------------------------------------- test side
def _jcfg(model):
    import jax.numpy as jnp
    from paddle_tpu.models import gpt as jg
    from paddle_tpu.models import llama as jl
    if model == "gpt":
        return jg.GPTConfig(**GPT, dtype=jnp.float32, remat=False,
                            sequence_parallel=False)
    return jl.LlamaConfig(**LLAMA, dtype=jnp.float32, remat=False)


def _jax_state_on(state, jplan, jmesh):
    """A {"params", "opt_state", "step"} tree of numpy arrays placed as
    the JAX package's pinned step places it under `jplan`."""
    import jax
    from paddle_tpu.parallel.mesh import sharding_for as jsharding_for

    def put(tree):
        return {k: jax.device_put(v, jsharding_for(
            jplan.specs[k], jmesh, shape=v.shape)) for k, v in tree.items()}
    return {"params": put(state["params"]),
            "opt_state": {"m": put(state["opt_state"]["m"]),
                          "v": put(state["opt_state"]["v"]),
                          "step": state["opt_state"]["step"]},
            "step": state["step"]}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package: GPT and Llama from PRNGKey(0), 5 unsharded
    steps (its make_train_step) on tokens 0..4; the state after step 2
    saved under a dp2×fsdp2×tp2 mesh; and a dp3 checkpoint of a 12-row
    array (row windows 4+4+4)."""
    import functools
    import jax
    import jax.numpy as jnp
    from paddle_tpu.models import gpt as jg
    from paddle_tpu.models import llama as jl
    from paddle_tpu.models.facade import make_train_step as jmake
    from paddle_tpu.parallel import checkpoint as jck
    from paddle_tpu.parallel.mesh import P as JP
    from paddle_tpu.parallel.mesh import build_mesh as jbuild
    from paddle_tpu.parallel.mesh import shard_value
    from paddle_tpu.parallel.planner import plan_train as jplan_train
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    workdir = tempfile.mkdtemp(prefix="torch_ckpt_")
    out = {"workdir": workdir}
    for model in MODELS:
        cfg = _jcfg(model)
        if model == "gpt":
            params = jg.init_gpt_params(cfg, jax.random.PRNGKey(0))
            fn = jg.train_step
        else:
            params = jl.init_llama_params(cfg, jax.random.PRNGKey(0))
            fn = jl.train_step
        init = as_np(params)
        step = jmake(fn, cfg=cfg, lr=LR, donate=False)
        opt = jg.init_opt_state(params)
        losses = []
        for s in range(5):
            loss, params, opt = step(params, opt, jnp.asarray(_tokens(s)))
            losses.append(float(loss))
            if s == 1:
                at2 = {"params": as_np(params),
                       "opt_state": as_np(opt), "step": np.int64(2)}
                jplan = jplan_train(cfg, 8, B, **JAX_PLAN)
                placed = _jax_state_on(at2, jplan, jplan.build_mesh())
                jck.save_train_state(os.path.join(workdir, f"jax_{model}"),
                                     placed["params"], placed["opt_state"],
                                     step=np.int64(2))
        out[model] = {"init": init, "at2": at2, "losses": losses,
                      "final": as_np(params), "m": as_np(opt["m"]),
                      "v": as_np(opt["v"]), "opt_step": float(opt["step"])}
    w = np.random.RandomState(1).randn(12, 8).astype(np.float32)
    dp3 = jbuild({"dp": 3})
    jck.save_sharded({"w": shard_value(jnp.asarray(w), JP("dp", None), dp3)},
                     os.path.join(workdir, "jax_dp3"))
    out["dp3"] = w
    return out


@pytest.fixture(scope="module")
def world4(jax_side):
    workdir = jax_side["workdir"]
    torch.save({m: jax_side[m]["init"] for m in MODELS},
               os.path.join(workdir, "init.pt"))
    return _spawn(4, workdir)


def _ranks(world4):
    assert all(r is not None for r in world4["ranks"]), world4["codes"]
    return world4["ranks"]


# --------------------------------------------------------- JAX -> port
@pytest.mark.parametrize("model", MODELS)
def test_jax_checkpoint_loads_whole_bit_equal(model, jax_side):
    got = load_sharded(os.path.join(jax_side["workdir"], f"jax_{model}"),
                       mesh=None, device="cpu")
    want = jax_side[model]["at2"]
    for tree in ("params",):
        for k, v in want[tree].items():
            assert np.array_equal(got[tree][k].numpy(), v), k
    for mom in ("m", "v"):
        for k, v in want["opt_state"][mom].items():
            assert np.array_equal(got["opt_state"][mom][k].numpy(), v), k
    # scalars come back as 0-d tensors of the recorded dtype
    assert got["step"].dtype == torch.int64 and int(got["step"]) == 2
    assert got["opt_state"]["step"].dtype == torch.float32
    assert float(got["opt_state"]["step"]) == 2.0


@pytest.mark.parametrize("case", LOAD_CASES, ids=[f"{m}-{p}"
                                                  for m, p in LOAD_CASES])
def test_jax_checkpoint_loads_onto_plan_block_by_block(case, jax_side,
                                                       world4):
    """Each rank's block of every leaf (params and both moments) equals
    the JAX array's window bit for bit; the spec is the JAX package's
    own cleaned spec for the plan (stacked leaves cut over pp on the
    layer axis under tp2×pp2), and the 4 ranks' windows tile each leaf
    as it says."""
    from paddle_tpu.parallel.mesh import sharding_for as jsharding_for
    from paddle_tpu.parallel.planner import plan_train as jplan_train
    model, name = case
    want = jax_side[model]["at2"]
    jplan = jplan_train(_jcfg(model), 4, B, **LOAD_PLANS[name])
    jmesh = jplan.build_mesh()
    ranks = _ranks(world4)
    for k, full in want["params"].items():
        jspec = ck._spec_to_json(jsharding_for(
            jplan.specs[k], jmesh, shape=full.shape).spec)
        wins = set()
        for r, res in enumerate(ranks):
            blk = res["jax_loads"][case]["blocks"][k]
            assert blk["spec"] == jspec, (k, blk["spec"], jspec)
            sl = tuple(slice(a, b) for a, b in blk["window"])
            assert np.array_equal(blk["params"], full[sl]), (k, r)
            assert np.array_equal(blk["m"], want["opt_state"]["m"][k][sl])
            assert np.array_equal(blk["v"], want["opt_state"]["v"][k][sl])
            wins.add(tuple(map(tuple, blk["window"])))
        n = 1
        for e in jspec:
            for a in ([] if e is None else [e] if isinstance(e, str)
                      else e):
                n *= LOAD_PLANS[name].get(a, 1)
        assert len(wins) == n, (k, wins)
        assert sum(int(np.prod([b - a for a, b in w])) for w in wins) \
            == full.size
    if "pp2" in name:
        blk = ranks[0]["jax_loads"][case]["blocks"]
        stacked = "qkv_w" if model == "gpt" else "q_w"
        assert blk[stacked]["spec"][0] == "pp"
        assert blk[stacked]["params"].shape[0] == 1    # 2 layers / pp2


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


@pytest.mark.parametrize("case", LOAD_CASES, ids=[f"{m}-{p}"
                                                  for m, p in LOAD_CASES])
def test_resumed_trajectory_matches_jax_uninterrupted(case, jax_side,
                                                      world4):
    model, name = case
    want = jax_side[model]
    ranks = _ranks(world4)
    for res in ranks:
        got = res["jax_loads"][case]
        assert got["restored_step"] == 2
        assert got["restored_step_dtype"] == "torch.int64"
        np.testing.assert_allclose(got["losses"], want["losses"][2:],
                                   rtol=2e-4, atol=2e-4)
        assert got["losses"] == ranks[0]["jax_loads"][case]["losses"]
        for leaf in want["final"]:
            np.testing.assert_allclose(got["full"][leaf],
                                       want["final"][leaf], rtol=2e-4,
                                       atol=2e-4,
                                       err_msg=f"{case} final {leaf}")
        for tree, key in ((got["m"], "m"), (got["v"], "v")):
            for leaf in want[key]:
                _assert_close_to_scale(tree[leaf], want[key][leaf],
                                       f"{case} {key} {leaf}")
        assert got["opt_step"] == want["opt_step"] == 5.0


# --------------------------------------------------------- port -> JAX
@pytest.mark.parametrize("case", SAVE_CASES, ids=[f"{m}-{p}"
                                                  for m, p in SAVE_CASES])
def test_port_checkpoint_verifies_and_loads_in_jax(case, world4):
    from paddle_tpu.parallel import checkpoint as jck
    ranks = _ranks(world4)
    res = ranks[0]["port_saves"][case]
    assert res["path"].endswith("ckpt-2")
    jck.verify_checkpoint(res["path"])
    got = jck.load_sharded(res["path"], mesh=None)
    for k, v in res["full"].items():
        assert np.array_equal(np.asarray(got["params"][k]), v), k
        assert np.array_equal(np.asarray(got["opt_state"]["m"][k]),
                              res["m"][k]), k
        assert np.array_equal(np.asarray(got["opt_state"]["v"][k]),
                              res["v"][k]), k
    assert float(got["opt_state"]["step"]) == res["opt_step"] == 2.0
    assert got["step"] == 2 and got["step"].dtype == np.int64
    # every rank gathered the same state
    for other in ranks[1:]:
        for k, v in other["port_saves"][case]["full"].items():
            assert np.array_equal(v, res["full"][k])


@pytest.mark.parametrize("case", SAVE_CASES, ids=[f"{m}-{p}"
                                                  for m, p in SAVE_CASES])
def test_port_manifest_matches_jax_layout(case, world4, tmp_path):
    """Each manifest entry's shape, dtype, spec and set of windows equal
    what the JAX package writes for the same state under the same plan,
    and every distinct window is written once (each rank its replica-0
    blocks)."""
    from paddle_tpu.parallel import checkpoint as jck
    from paddle_tpu.parallel.planner import plan_train as jplan_train
    model, name = case
    res = _ranks(world4)[0]["port_saves"][case]
    jplan = jplan_train(_jcfg(model), 4, B, **SAVE_PLANS[name])
    state = jck.load_sharded(res["path"], mesh=None)
    state = {"params": {k: np.asarray(v) for k, v in
                        state["params"].items()},
             "opt_state": {"m": {k: np.asarray(v) for k, v in
                                 state["opt_state"]["m"].items()},
                           "v": {k: np.asarray(v) for k, v in
                                 state["opt_state"]["v"].items()},
                           "step": np.asarray(state["opt_state"]["step"])},
             "step": np.int64(2)}
    jpath = str(tmp_path / "jax_same_plan")
    jck.save_sharded(_jax_state_on(state, jplan, jplan.build_mesh()), jpath)
    with open(os.path.join(res["path"], "manifest.json")) as f:
        port = json.load(f)
    with open(os.path.join(jpath, "manifest.json")) as f:
        jax_m = json.load(f)
    assert port["format"] == jax_m["format"] == 2
    assert port["leaves"].keys() == jax_m["leaves"].keys()
    for key, pe in port["leaves"].items():
        je = jax_m["leaves"][key]
        assert pe["kind"] == je["kind"], key
        if pe["kind"] == "scalar":
            assert (pe["value"], pe["dtype"]) == (je["value"], je["dtype"])
            continue
        for field in ("shape", "dtype", "spec"):
            assert pe[field] == je[field], (key, field, pe[field],
                                            je[field])
        pw = [tuple(map(tuple, s["window"])) for s in pe["shards"]]
        jw = [tuple(map(tuple, s["window"])) for s in je["shards"]]
        assert len(pw) == len(set(pw)), (key, pw)     # each window once
        assert set(pw) == set(jw), (key, pw, jw)
        assert len({s["file"] for s in pe["shards"]}) == len(pw)
    if name == "dp2_pp2":
        stacked = "qkv_w" if model == "gpt" else "q_w"
        assert port["leaves"][f"params/{stacked}"]["spec"][0] == "pp"


def test_async_save_on_four_ranks_not_reached_by_later_step(world4):
    for res in _ranks(world4):
        a = res["port_saves"][("gpt", "fsdp2_tp2")]["async"]
        assert a["equal"] and a["stepped"], a
        assert a["steps"] == [2, 3]


# ------------------------------------------------------ mesh cases
def test_sharded_files_are_true_shards(world4):
    """dp2×tp2: the 2-D leaf lands as 4 files of [4, 4], the tp-split
    vector as 2 (its replicas over dp written once), every window and
    spec in the manifest; a re-save replicated leaves one file and no
    residue of the old layout."""
    saved = _ranks(world4)[0]["mesh"]["saved"]
    w_files = {f: s for f, s in saved["files"].items() if f.startswith("w.")}
    b_files = {f: s for f, s in saved["files"].items() if f.startswith("b.")}
    assert sorted(w_files) == [f"w.p0.s{r}.npy" for r in range(4)]
    assert all(s == [4, 4] for s in w_files.values())
    assert sorted(b_files) == ["b.p0.s0.npy", "b.p0.s1.npy"]
    assert saved["specs"] == {"w": ["dp", "tp"], "b": ["tp"]}
    assert saved["windows"]["w"] == [[[a, a + 4], [c, c + 4]]
                                     for a in (0, 4) for c in (0, 4)]
    assert saved["windows"]["b"] == [[[0, 4]], [[4, 8]]]
    assert world4["ranks"][0]["mesh"]["resave_files"] == ["w.p0.s0.npy"]
    from paddle_tpu.parallel import checkpoint as jck
    jck.verify_checkpoint(os.path.join(world4["workdir"], "mesh_ck"))


def test_reshape_onto_other_meshes_and_override(world4):
    for res in _ranks(world4):
        m = res["mesh"]
        assert m["tp4"] == (True, True, 3, "torch.int64")
        assert m["dp4_override"] and m["whole"]


def test_blocks_straddling_saved_windows(jax_side, world4):
    """The JAX package's dp3 save (row windows of 4) onto dp2×tp2 (row
    blocks of 6): each block assembles from parts of two saved
    windows."""
    w = jax_side["dp3"]
    for res in _ranks(world4):
        m = res["mesh"]
        sl = tuple(slice(a, b) for a, b in m["straddle_window"])
        assert m["straddle_window"][0][1] - m["straddle_window"][0][0] == 6
        assert np.array_equal(m["straddle"], w[sl])


def test_resave_replaces_previous_directory_whole(tmp_path):
    """A re-save onto a committed path swaps the old directory out whole:
    the leaves and files of the earlier save are gone, no `.old-` or
    staging directory is left, and LATEST names the path."""
    path = str(tmp_path / "ck")
    save_sharded({"w": torch.arange(8.0), "b": torch.ones(3)}, path)
    save_sharded({"w": torch.arange(8.0) * 3}, path)
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "ck"]
    assert all(f.startswith(("w.", "manifest")) for f in os.listdir(path))
    assert set(verify_checkpoint(path)["leaves"]) == {"w"}
    assert read_latest(str(tmp_path)) == path
    back = load_sharded(path, mesh=None, device="cpu")
    assert set(back) == {"w"}
    assert torch.equal(back["w"], torch.arange(8.0) * 3)


def test_crash_mid_save_on_four_ranks_keeps_previous(world4):
    """Rank 2 dies (exit 37) after its first shard file of the second
    save; the others' saves raise; ckpt-2 is never committed, ckpt-1
    verifies and LATEST still names it."""
    codes = world4["codes"]
    assert codes[2] == faults.KILL_EXIT, codes
    assert [c for r, c in enumerate(codes) if r != 2] == [0, 0, 0], codes
    for r, res in enumerate(world4["crash"]):
        if r != 2:
            assert res["raised"] is not None, (r, res)
    root = os.path.join(world4["workdir"], "crash")
    assert read_latest(root) == os.path.join(root, "ckpt-1")
    verify_checkpoint(os.path.join(root, "ckpt-1"))
    assert not os.path.exists(os.path.join(root, "ckpt-2"))
    assert any(".tmp-" in d for d in os.listdir(root))
    mgr = CheckpointManager(root)
    state, step = mgr.restore(mesh=None, device="cpu")
    assert step == 1 and int(state["step"]) == 1
    assert torch.equal(state["w"], torch.arange(64.0).reshape(8, 8))


# ------------------------------------ counterparts, in the test process
def _small_state(seed=0):
    w = np.random.RandomState(seed).rand(8, 16).astype(np.float32)
    b = np.random.RandomState(seed + 1).rand(16).astype(np.float32)
    return {"params": {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
            "step": np.int64(7)}


def test_roundtrip_unsharded(tmp_path):
    state = {"a": torch.arange(12.0).reshape(3, 4),
             "nested": {"b": torch.ones(5)},
             "step": torch.tensor(7.0),
             "lst": [torch.zeros(2), torch.full((2,), 3.0)]}
    save_sharded(state, str(tmp_path / "ck"))
    back = load_sharded(str(tmp_path / "ck"), mesh=None, device="cpu")
    assert torch.equal(back["a"], state["a"])
    assert torch.equal(back["nested"]["b"], torch.ones(5))
    assert float(back["step"]) == 7.0 and back["step"].dim() == 0
    assert torch.equal(back["lst"][1], torch.full((2,), 3.0))


def test_missing_data_raises(tmp_path):
    save_sharded({"w": torch.ones(4, 4)}, str(tmp_path / "ck"))
    faults.remove_shard(str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="missing data"):
        load_sharded(str(tmp_path / "ck"), mesh=None, device="cpu",
                     verify=False)


def test_bfloat16_leaf_refused_by_name(tmp_path):
    with pytest.raises(TypeError, match="'params/w'.*bfloat16"):
        save_sharded({"params": {"w": torch.ones(2, dtype=torch.bfloat16)}},
                     str(tmp_path / "ck"))
    with pytest.raises(TypeError, match="'w'"):
        HostSnapshot({"w": torch.ones(2, dtype=torch.bfloat16)})


def test_train_state_roundtrip_and_template(tmp_path):
    save_train_state(str(tmp_path / "ck"), {"w": torch.ones(2)},
                     step=np.int64(2 ** 55 + 1))
    state = load_train_state(str(tmp_path / "ck"), mesh=None, device="cpu")
    assert state["step"].dtype == torch.int64
    assert int(state["step"]) == 2 ** 55 + 1
    with pytest.raises(ValueError) as ei:
        load_sharded(str(tmp_path / "ck"), mesh=None, device="cpu",
                     template={"params": {"w": None, "w_extra": None}})
    assert "params/w_extra" in str(ei.value) and "step" in str(ei.value)


def test_scalar_dtypes_exact(tmp_path):
    path = str(tmp_path / "ck")
    save_sharded({"big": np.int64(2 ** 60 + 1), "lr": np.float32(3e-4),
                  "done": np.bool_(True), "t": torch.tensor(5, dtype=torch.int64)},
                 path)
    got = load_sharded(path, mesh=None, device="cpu")
    assert int(got["big"]) == 2 ** 60 + 1 and got["big"].dtype == torch.int64
    assert got["lr"].dtype == torch.float32
    assert float(got["lr"]) == float(np.float32(3e-4))
    assert got["done"].dtype == torch.bool and bool(got["done"])
    assert int(got["t"]) == 5


class TestAsync:
    def test_round_trip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
        state = _small_state()
        path = mgr.save_async(state, 1)
        mgr.wait()
        verify_checkpoint(path)
        assert mgr.latest_path() == path
        got = load_sharded(path, mesh=None, device="cpu")
        assert torch.equal(got["params"]["w"], state["params"]["w"])
        assert int(got["step"]) == 7 and got["step"].dtype == torch.int64

    def test_save_returns_before_write_completes(self, tmp_path,
                                                 monkeypatch):
        mgr = CheckpointManager(str(tmp_path))
        orig = ck._write_shard
        ev = {"writes": 0}

        def slow(path, arr):
            ev["writes"] += 1
            time.sleep(0.15)
            return orig(path, arr)
        monkeypatch.setattr(ck, "_write_shard", slow)
        t0 = time.perf_counter()
        mgr.save_async(_small_state(), 1)
        returned_in = time.perf_counter() - t0
        assert mgr.async_pending
        assert returned_in < 0.14, returned_in
        mgr.wait()
        assert not mgr.async_pending and ev["writes"] == 2
        verify_checkpoint(os.path.join(str(tmp_path), "ckpt-1"))

    def test_in_place_update_after_return_not_in_snapshot(self, tmp_path,
                                                          monkeypatch):
        """The step updates the same tensors in place: a mutation after
        save_async returns must not reach the written snapshot."""
        mgr = CheckpointManager(str(tmp_path))
        state = _small_state()
        want = state["params"]["w"].clone()
        orig = ck._write_shard
        monkeypatch.setattr(
            ck, "_write_shard",
            lambda path, arr: (time.sleep(0.05), orig(path, arr))[1])
        mgr.save_async(state, 1)
        state["params"]["w"].mul_(0.0).add_(5.0)
        mgr.wait()
        got = load_sharded(os.path.join(str(tmp_path), "ckpt-1"),
                           mesh=None, device="cpu")
        assert torch.equal(got["params"]["w"], want)

    def test_one_in_flight_and_buffers_reused(self, tmp_path, monkeypatch):
        """A second save_async waits out the first: the shard files of two
        saves (staging directories) are never written at once; the
        snapshot's host buffers are the first save's."""
        mgr = CheckpointManager(str(tmp_path), max_to_keep=5)
        state = _small_state()
        active = {"dirs": {}, "max": 0}
        lock = threading.Lock()
        orig = ck._write_shard

        def tracked(path, arr):
            d = os.path.dirname(path)
            with lock:
                active["dirs"][d] = active["dirs"].get(d, 0) + 1
                active["max"] = max(active["max"], len(active["dirs"]))
            time.sleep(0.05)
            out = orig(path, arr)
            with lock:
                active["dirs"][d] -= 1
                if not active["dirs"][d]:
                    del active["dirs"][d]
            return out
        monkeypatch.setattr(ck, "_write_shard", tracked)
        mgr.save_async(state, 1)
        bufs = {k: v.data_ptr() for k, v in mgr._pool.items()}
        mgr.save_async(state, 2)        # barriers on save 1
        mgr.wait()
        assert active["max"] == 1
        assert mgr.steps() == [1, 2]
        assert {k: v.data_ptr() for k, v in mgr._pool.items()} == bufs
        for s in (1, 2):
            verify_checkpoint(os.path.join(str(tmp_path), f"ckpt-{s}"))

    def test_writer_failure_surfaces_at_barrier(self, tmp_path,
                                                monkeypatch):
        mgr = CheckpointManager(str(tmp_path / "root"),
                                async_retry_backoff_s=0.01)
        monkeypatch.setattr(
            ck, "_write_shard",
            lambda path, arr: (_ for _ in ()).throw(OSError("disk full")))
        mgr.save_async(_small_state(), 1)
        with pytest.raises(AsyncSaveError, match="disk full"):
            mgr.wait()
        assert not mgr.async_pending
        mgr.wait()                        # consumed: the next barrier is clean

    def test_writer_retries_once_then_succeeds(self, tmp_path, monkeypatch):
        mgr = CheckpointManager(str(tmp_path / "root"),
                                async_retry_backoff_s=0.01)
        state = _small_state()
        calls = {"n": 0}
        orig = ck._write_shard

        def flaky(path, arr):
            calls["n"] += 1
            if calls["n"] == 1:
                raise OSError("transient blip")
            return orig(path, arr)
        monkeypatch.setattr(ck, "_write_shard", flaky)
        mgr.save_async(state, 1)
        mgr.wait()
        got = load_sharded(os.path.join(str(tmp_path / "root"), "ckpt-1"),
                           mesh=None, device="cpu")
        assert torch.equal(got["params"]["w"], state["params"]["w"])
        verify_checkpoint(os.path.join(str(tmp_path / "root"), "ckpt-1"))

    def test_sync_save_and_restore_take_the_barrier(self, tmp_path,
                                                    monkeypatch):
        mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
        orig = ck._write_shard
        monkeypatch.setattr(
            ck, "_write_shard",
            lambda path, arr: (time.sleep(0.05), orig(path, arr))[1])
        mgr.save_async(_small_state(3), 1)
        monkeypatch.setattr(ck, "_write_shard", orig)
        mgr.save(_small_state(4), 2)
        state, step = mgr.restore(mesh=None, device="cpu")
        assert step == 2
        for s in (3, 4, 5):
            mgr.save_async(_small_state(s), s)
        mgr.wait()
        assert mgr.steps() == [4, 5]

    def test_host_snapshot_is_savable_directly(self, tmp_path):
        state = _small_state()
        snap = HostSnapshot(state)
        assert snap.nbytes == (8 * 16 + 16) * 4 + 8
        path = str(tmp_path / "snap")
        save_sharded(snap, path)
        manifest = verify_checkpoint(path)
        assert manifest["leaves"]["params/w"]["spec"] == []
        got = load_sharded(path, mesh=None, device="cpu")
        assert torch.equal(got["params"]["w"], state["params"]["w"])


class TestAtomicSave:
    def test_crash_mid_save_leaves_previous_intact(self, tmp_path):
        path = str(tmp_path / "ck")
        save_sharded({"w": torch.arange(8.0)}, path)
        before = sorted(os.listdir(path))

        class Boom(RuntimeError):
            pass

        def hook(count):
            raise Boom()
        ck._SHARD_WRITE_HOOK = hook
        try:
            with pytest.raises(Boom):
                save_sharded({"w": torch.arange(8.0) * 2,
                              "extra": torch.ones(3)}, path)
        finally:
            ck._SHARD_WRITE_HOOK = None
        assert sorted(os.listdir(path)) == before
        verify_checkpoint(path)
        assert read_latest(str(tmp_path)) == path
        back = load_sharded(path, mesh=None, device="cpu")
        assert torch.equal(back["w"], torch.arange(8.0))
        assert [d for d in os.listdir(tmp_path) if ".tmp-" in d]

    def test_bare_path_recovers_from_resave_window(self, tmp_path):
        path = str(tmp_path / "ck")
        save_sharded({"w": torch.zeros(4)}, path)
        os.replace(path, path + ".old-7")
        save_sharded({"w": torch.ones(4)}, path)
        os.replace(path, path + ".tmp-7")
        back = load_sharded(path, mesh=None, device="cpu")
        assert torch.equal(back["w"], torch.ones(4))
        faults.truncate_shard(path + ".tmp-7")
        back = load_sharded(path, mesh=None, device="cpu")
        assert torch.equal(back["w"], torch.zeros(4))


class TestVerification:
    def _save(self, tmp_path):
        path = str(tmp_path / "ck")
        save_sharded({"w": torch.arange(32.0).reshape(4, 8),
                      "b": torch.ones(5)}, path)
        return path

    def test_verify_ok(self, tmp_path):
        verify_checkpoint(self._save(tmp_path))

    @pytest.mark.parametrize("damage,match", [
        (faults.truncate_shard, "truncated"),
        (faults.bitflip_shard, "checksum"),
        (faults.remove_shard, "missing")])
    def test_damage_detected(self, tmp_path, damage, match):
        path = self._save(tmp_path)
        damage(path, 0)
        with pytest.raises(CheckpointCorruptError, match=match):
            verify_checkpoint(path)
        assert not is_intact(path)
        with pytest.raises(CheckpointCorruptError, match=match):
            load_sharded(path, mesh=None, device="cpu")

    def test_uncommitted_dir_rejected(self, tmp_path):
        with pytest.raises(CheckpointCorruptError, match="manifest"):
            verify_checkpoint(str(tmp_path))

    def test_mesh_none_sentinel_and_device(self, tmp_path):
        """An explicit mesh=None gives full tensors on the asked device;
        with no device the entry point wants the card and raises here."""
        path = self._save(tmp_path)
        back = load_sharded(path, mesh=None, device="cpu")
        assert back["w"].shape == (4, 8) and back["w"].device.type == "cpu"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                load_sharded(path, mesh=None)


class TestCheckpointManager:
    def test_retention_and_latest(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
        for s in range(5):
            mgr.save({"w": torch.full((4,), float(s)),
                      "step": np.int64(s)}, s)
        assert mgr.steps() == [3, 4]
        assert mgr.latest_step() == 4
        state, step = mgr.restore(device="cpu")
        assert step == 4 and torch.equal(state["w"], torch.full((4,), 4.0))

    def test_zero_max_to_keep_keeps_all(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), max_to_keep=0)
        for s in range(4):
            mgr.save({"w": torch.full((2,), float(s))}, s)
        assert mgr.steps() == [0, 1, 2, 3]

    @pytest.mark.parametrize("prefix", ["ckpt", "snap"])
    def test_fallback_past_corrupt_newest(self, tmp_path, prefix):
        mgr = CheckpointManager(str(tmp_path), max_to_keep=3, prefix=prefix)
        for s in range(3):
            mgr.save({"w": torch.full((4,), float(s))}, s)
        faults.bitflip_shard(mgr.latest_path())
        assert mgr.latest_path().endswith(f"{prefix}-1")
        state, step = mgr.restore(device="cpu")
        assert step == 1 and torch.equal(state["w"], torch.full((4,), 1.0))

    def test_restore_empty(self, tmp_path):
        state, step = CheckpointManager(str(tmp_path)).restore(device="cpu")
        assert state is None and step is None

    def test_recovers_step_stranded_in_resave_window(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
        for s in range(2):
            mgr.save({"w": torch.full((4,), float(s)),
                      "step": np.int64(s)}, s)
        os.replace(tmp_path / "ckpt-1", tmp_path / "ckpt-1.old-999")
        state, step = mgr.restore(device="cpu")
        assert step == 1 and torch.equal(state["w"], torch.full((4,), 1.0))
        os.replace(tmp_path / "ckpt-1.old-999", tmp_path / "ckpt-1.tmp-999")
        os.remove(tmp_path / "ckpt-1.tmp-999" / "manifest.json")
        state, step = mgr.restore(device="cpu")
        assert step == 0

    def test_gc_sweeps_torn_staging_dirs(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
        os.makedirs(tmp_path / "ckpt-9.tmp-123")
        mgr.save({"w": torch.ones(2)}, 0)
        assert not (tmp_path / "ckpt-9.tmp-123").exists()

    def test_gc_never_deletes_dir_fallback_restore_is_reading(self,
                                                              tmp_path):
        """keep-K pruning against a fallback restore: while restore()
        reads ckpt-2 (the newest is corrupt) under the retain lock, a
        concurrent save's gc waits instead of deleting it."""
        mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
        state = {"w": torch.arange(8, dtype=torch.float32)}
        for s in (1, 2, 3):
            mgr.save(dict(state, step=np.int64(s)), s)
        faults.truncate_shard(str(tmp_path / "ckpt-3"), index=0)
        in_read, release = threading.Event(), threading.Event()
        orig_verify = ck.verify_checkpoint

        def slow_verify(path):
            out = orig_verify(path)
            if path.endswith("ckpt-2"):
                in_read.set()
                release.wait(10)
            return out
        ck.verify_checkpoint = slow_verify
        box = {}

        def do_restore():
            try:
                box["state"], box["step"] = mgr.restore(mesh=None,
                                                        device="cpu")
            except BaseException as e:
                box["err"] = e
        t = threading.Thread(target=do_restore)
        try:
            t.start()
            assert in_read.wait(10)
            gc_done = threading.Event()

            def do_save():
                mgr.save(dict(state, step=np.int64(4)), 4)
                gc_done.set()
            t2 = threading.Thread(target=do_save)
            t2.start()
            time.sleep(0.3)
            assert not gc_done.is_set()
            assert os.path.isdir(tmp_path / "ckpt-2")
            release.set()
            t.join(30)
            t2.join(30)
        finally:
            ck.verify_checkpoint = orig_verify
            release.set()
        assert "err" not in box, box.get("err")
        assert box["step"] == 2
        assert torch.equal(box["state"]["w"], state["w"])
        assert gc_done.is_set() and mgr.steps() in ([3, 4], [2, 3, 4])


# ------------------------------------------------------------ fault plan
class TestFaultPlan:
    def test_parse(self):
        plan = faults.FaultPlan("kill@3, crash_shard@5:2, nan@7:4")
        assert [(f.kind, f.step, f.arg) for f in plan.faults] == [
            ("kill", 3, 1), ("crash_shard", 5, 2), ("nan", 7, 4)]

    @pytest.mark.parametrize("token,step,arg", [
        ("migrate_raise@3", 3, 1), ("journal_torn@40", 40, 1),
        ("sigkill@5", 5, 1), ("quota_flood@2:6", 2, 6),
        ("replica_preempt@3:0", 3, 0)])
    def test_fleet_kinds_parse_as_the_reference(self, token, step, arg):
        """The fleet's kinds are ported: each parses to the step and
        argument the reference's plan gives it (replica_preempt's `:0`
        names replica 0; journal_torn's coordinate is a byte count)."""
        from paddle_tpu.testing import faults as jfaults
        kind = token.split("@")[0]
        assert kind in jfaults._KINDS          # the reference's kind
        got = [(f.kind, f.step, f.arg)
               for f in faults.FaultPlan(token).faults]
        ref = [(f.kind, f.step, f.arg)
               for f in jfaults.FaultPlan(token).faults]
        assert got == ref == [(kind, step, arg)]

    @pytest.mark.parametrize("token,arg", [
        ("nan_logits@2:1", 1), ("nan_logits@2", 0), ("draft_nan@2:3", 3),
        ("draft_nan@2", 0), ("tick_stall@2:400", 400),
        ("prefill_raise@0", 1), ("decode_raise@2", 1), ("cow_raise@0", 1),
        ("oom@2", 1)])
    def test_serving_kinds_parse(self, token, arg):
        """The serving kinds are ported (A7 part 2); the slot of a nan
        kind defaults to 0, as the reference's does."""
        from paddle_tpu.testing import faults as jfaults
        plan = faults.FaultPlan(token)
        want = jfaults.FaultPlan(token)
        assert [(f.kind, f.step, f.arg) for f in plan.faults] == [
            (f.kind, f.step, f.arg) for f in want.faults]
        assert plan.faults[0].arg == arg

    @pytest.mark.parametrize("kind", ["device_loss", "collective_hang",
                                      "straggler"])
    def test_elastic_kinds_parse(self, kind):
        plan = faults.FaultPlan(f"{kind}@3:2")
        assert [(f.kind, f.step, f.arg) for f in plan.faults] == [
            (kind, 3, 2)]

    def test_bad_spec_rejected(self):
        with pytest.raises(ValueError, match="unknown fault kind"):
            faults.FaultPlan("explode@3")
        with pytest.raises(ValueError, match="bad fault token"):
            faults.FaultPlan("kill@x")

    def test_nan_poison_count_limited(self):
        plan = faults.FaultPlan("nan@2:2")
        assert plan.on_step(1) == 1.0
        assert np.isnan(plan.on_step(2)) and np.isnan(plan.on_step(3))
        assert plan.on_step(4) == 1.0

    def test_once_markers_survive_restart(self, tmp_path):
        once = str(tmp_path / "once")
        plan = faults.FaultPlan("elastic_exit@2", once_dir=once)
        with pytest.raises(SystemExit) as ei:
            plan.on_step(2)
        assert ei.value.code == 101
        plan2 = faults.FaultPlan("elastic_exit@2", once_dir=once)
        assert plan2.faults[0].done and plan2.on_step(2) == 1.0

    def test_install_uninstall(self, monkeypatch):
        from paddle_tpu_torch.parallel import resilience
        monkeypatch.setenv(faults.ENV_SPEC, "nan@1:1")
        plan = faults.install()
        try:
            assert plan is not None and faults.active() is plan
            assert resilience._STEP_HOOK is not None
            assert ck._SHARD_WRITE_HOOK is not None
        finally:
            faults.uninstall()
        assert resilience._STEP_HOOK is None and ck._SHARD_WRITE_HOOK is None
        monkeypatch.delenv(faults.ENV_SPEC)
        assert faults.install() is None


# ------------------------------------------------------------- heartbeat
class TestHeartbeat:
    def test_step_mode_starts_no_thread(self, tmp_path, monkeypatch):
        from paddle_tpu_torch.distributed.launch import heartbeat
        lease = tmp_path / "hb"
        monkeypatch.setattr(heartbeat, "_thread", None)
        monkeypatch.setenv(heartbeat.ENV_FILE, str(lease))
        monkeypatch.setenv(heartbeat.ENV_STEP_MODE, "1")
        assert heartbeat.start_from_env()
        assert heartbeat._thread is None and lease.exists()
        t0 = lease.stat().st_mtime
        os.utime(lease, (t0 - 100, t0 - 100))
        heartbeat.pulse()
        assert lease.stat().st_mtime > t0 - 50

    def test_beat_thread_and_stop(self, tmp_path, monkeypatch):
        from paddle_tpu_torch.distributed.launch import heartbeat
        lease = tmp_path / "hb"
        monkeypatch.setattr(heartbeat, "_thread", None)
        monkeypatch.setenv(heartbeat.ENV_FILE, str(lease))
        monkeypatch.setenv(heartbeat.ENV_INTERVAL, "0.05")
        monkeypatch.delenv(heartbeat.ENV_STEP_MODE, raising=False)
        try:
            assert heartbeat.start_from_env()
            assert heartbeat._thread.is_alive()
            os.utime(lease, (1, 1))
            deadline = time.time() + 10
            while lease.stat().st_mtime < 100 and time.time() < deadline:
                time.sleep(0.05)
            assert lease.stat().st_mtime > 100
        finally:
            heartbeat.stop()
            heartbeat._thread.join(2)
        assert not heartbeat._thread.is_alive()
        heartbeat._stop.clear()

    def test_contract_names_are_the_reference_s(self, tmp_path, monkeypatch):
        from paddle_tpu.distributed.launch import heartbeat as jhb
        from paddle_tpu_torch.distributed.launch import heartbeat
        from paddle_tpu_torch.parallel.resilience import ELASTIC_EXIT_CODE
        assert heartbeat.ELASTIC_EXIT_CODE == jhb.ELASTIC_EXIT_CODE \
            == ELASTIC_EXIT_CODE == 101
        for name in ("ENV_FILE", "ENV_INTERVAL", "ENV_STEP_MODE",
                     "ENV_WORLD_FILE", "ENV_WORLD"):
            assert getattr(heartbeat, name) == getattr(jhb, name)
        # the world-spec handshake: written by one side, read by the other
        spec = {"n_devices": 2, "axes": {"fsdp": 2}, "reason": "loss"}
        path = str(tmp_path / "world.json")
        assert heartbeat.write_world_spec(spec, path) == path
        assert jhb.read_world_spec(path) == spec
        assert heartbeat.read_world_spec(str(tmp_path / "absent")) is None
        monkeypatch.setenv(heartbeat.ENV_WORLD, json.dumps(spec))
        assert heartbeat.degraded_world() == spec
        monkeypatch.delenv(heartbeat.ENV_WORLD_FILE, raising=False)
        assert heartbeat.write_world_spec(spec) is None


# ------------------------------------ observability (ROADMAP A7 part 1)
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


def _counts(names):
    from paddle_tpu_torch.profiler import monitor
    return {n: monitor.counter(n).value for n in names}


def test_spans_counters_and_gauges_of_a_managed_run(tmp_path):
    """save, save_async, verify, a restore that falls back past a torn
    snapshot: each counter moves by what ran, each path opens its span,
    and checkpoint_async_pending reads 0 once the writer is done."""
    from paddle_tpu_torch.profiler import (clear_profiler_spans,
                                           get_profiler_spans, monitor)
    names = ("checkpoint_save", "checkpoint_async_save", "checkpoint_verify",
             "checkpoint_load", "checkpoint_restore",
             "checkpoint_fallback_restore", "checkpoint_async_retry")
    before = _counts(names)
    clear_profiler_spans()
    mgr = CheckpointManager(str(tmp_path / "root"), max_to_keep=3)
    mgr.save(_small_state(0), 1)
    mgr.save_async(_small_state(1), 2)
    mgr.wait()
    assert monitor.gauge("checkpoint_async_pending").value == 0
    assert monitor.gauge("checkpoint_save_ms").value > 0
    verify_checkpoint(str(tmp_path / "root" / "ckpt-2"))
    faults.truncate_shard(str(tmp_path / "root" / "ckpt-2"))
    state, step = mgr.restore(mesh=None, device="cpu")
    assert step == 1
    got = {n: v - before[n] for n, v in _counts(names).items()}
    assert got == {"checkpoint_save": 2, "checkpoint_async_save": 1,
                   "checkpoint_verify": 2, "checkpoint_load": 1,
                   "checkpoint_restore": 1, "checkpoint_fallback_restore": 1,
                   "checkpoint_async_retry": 0}
    spans = {s[0] for s in get_profiler_spans()}
    assert {"checkpoint.save", "checkpoint.snapshot", "checkpoint.verify",
            "checkpoint.load"} <= spans


def test_async_retry_and_failure_are_counted_and_dumped(tmp_path,
                                                        monkeypatch,
                                                        flight_dir):
    """A writer that fails once: the retry is counted and dumped, the
    snapshot commits. One that fails twice: a second retry count, the
    'checkpoint_async_fail' dump naming the step, AsyncSaveError at the
    barrier, and the pending gauge back at 0."""
    from paddle_tpu_torch.profiler import flight_recorder, monitor
    retries = monitor.counter("checkpoint_async_retry").value
    mgr = CheckpointManager(str(tmp_path / "root"),
                            async_retry_backoff_s=0.01)
    orig = ck._write_shard
    calls = {"n": 0}

    def flaky(path, arr):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("transient blip")
        return orig(path, arr)
    monkeypatch.setattr(ck, "_write_shard", flaky)
    mgr.save_async(_small_state(), 1)
    mgr.wait()
    verify_checkpoint(str(tmp_path / "root" / "ckpt-1"))
    assert monitor.counter("checkpoint_async_retry").value == retries + 1
    doc = flight_recorder.load_dump(str(
        flight_dir / f"flight-{os.getpid()}-checkpoint_async_retry.json"))
    assert "transient blip" in doc["config"]["last_error"]
    monkeypatch.setattr(
        ck, "_write_shard",
        lambda path, arr: (_ for _ in ()).throw(OSError("disk full")))
    mgr.save_async(_small_state(), 2)
    with pytest.raises(AsyncSaveError, match="disk full"):
        mgr.wait()
    assert monitor.counter("checkpoint_async_retry").value == retries + 2
    assert monitor.gauge("checkpoint_async_pending").value == 0
    doc = flight_recorder.load_dump(str(
        flight_dir / f"flight-{os.getpid()}-checkpoint_async_fail.json"))
    assert "step 2 failed twice" in doc["config"]["last_error"]
