"""The port's planner-driven dp×fsdp×tp train step
(models/facade.py `_ShardedTrainStep`, parallel/{env,mesh,collective,
layout}.py) against the JAX package's unsharded step, on the CPU over
gloo, as tests/test_plan3d.py holds the reference's own sharded step.

A world of 4 ranks, started once for the module with spawn (rendezvous
through a file store, one torch thread a rank), runs every plan in turn
from the JAX step's starting weights (carried across with
params_from_jax):
- GPT at test_plan3d's shape (vocab 512, hidden 128, 2 layers, 4 heads,
  f32, no remat), batch 8 x 32, lr 1e-3, 5 steps: dp2×fsdp2, dp2×tp2
  with sequence parallelism on and off, fsdp4, fsdp2×tp2 and tp4;
- a small Llama (the same widths, 4 heads over 2 KV heads) at fsdp2×tp2
  and tp4, where tp does not divide the KV heads.
Each: the loss trajectory within rtol/atol 2e-4 of the JAX unsharded
step's; after step 5 the gathered params and both Adam moments within
2e-4 of the JAX trees; every local shard's shape and placement as
plan.specs says (opt["step"] replicated); the pins derived once, and a
sixth call on new tokens derives none. A world of one rank runs the
dp1×fsdp1×tp1 plan, which must equal the port's unsharded step to the
bit. The same 4-rank world checks parallel/collective.py on 2-rank
groups: each route against gloo's own collective, and the gradient of
each differentiable pair against a hand-computed sum.

The device telemetry (profiler/telemetry.py) rides the same worlds:
GPT under dp2×fsdp2 and dp2×tp2 through `instrument_train_step` for 3
steps, whose losses must equal the plain sharded step's to the bit and
whose recorded loss, grad_norm and param_norm (each rank's shards
summed over the mesh, every block once) must agree with the port's
unsharded instrumented step within 2e-4 on every rank; and on the world
of one, a sharded step whose inner step runs out of memory writes the
`oom_forensics` flight dump naming the leaves and re-raises, with no
`train.compile.*` gauge published.

The rank processes import this module without jax: the JAX side is
imported in the fixtures, in the test process only.
"""
import os
import tempfile

import numpy as np
import pytest
import torch

B, S, STEPS, LR = 8, 32, 5, 1e-3
GPT = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
           max_seq_len=64)
LLAMA = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=64)
# (case id, family, plan degrees, sequence_parallel)
CASES = [
    ("gpt-dp2_fsdp2", "gpt", dict(dp=2, fsdp=2, tp=1), False),
    ("gpt-dp2_tp2-sp", "gpt", dict(dp=2, fsdp=1, tp=2), True),
    ("gpt-dp2_tp2-nosp", "gpt", dict(dp=2, fsdp=1, tp=2), False),
    ("gpt-fsdp4", "gpt", dict(dp=1, fsdp=4, tp=1), False),
    ("gpt-fsdp2_tp2", "gpt", dict(dp=1, fsdp=2, tp=2), True),
    ("gpt-tp4", "gpt", dict(dp=1, fsdp=1, tp=4), False),
    ("llama-fsdp2_tp2", "llama", dict(dp=1, fsdp=2, tp=2), False),
    ("llama-tp4", "llama", dict(dp=1, fsdp=1, tp=4), False),
]
# leaf classes whose local shards are checked against plan.specs
LEAF_CLASSES = {"gpt": ("qkv_w", "mlp_up_w", "wte", "ln1_scale"),
                "llama": ("q_w", "k_w", "wte", "attn_norm")}


def _tokens(seed):
    return np.random.RandomState(seed).randint(
        0, GPT["vocab_size"], (B, S + 1)).astype(np.int64)


def _tcfg(family, sp=False):
    from paddle_tpu_torch.models import gpt, llama
    if family == "gpt":
        return gpt.GPTConfig(**GPT, dtype=torch.float32, remat=False,
                             sequence_parallel=sp)
    return llama.LlamaConfig(**LLAMA, dtype=torch.float32, remat=False)


# ------------------------------------------------------------ rank side
def _collective_checks(rank):
    """On 2-rank gloo groups ({0, 1} and {2, 3}): every route of
    parallel/collective.py against gloo's own collective, and each
    differentiable pair's gradient against the hand-computed sum."""
    import torch.distributed as dist
    from paddle_tpu_torch.parallel import collective as col
    groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    g = groups[rank // 2]
    r = rank % 2
    assert col.collective_route(g, "cpu") == "gloo"
    assert col.collective_route(g, "cuda") == "gloo_cuda_via_all_reduce"
    gen = torch.Generator().manual_seed(7)
    xs = [torch.randn(4, 6, generator=gen) for _ in range(2)]
    ws = [torch.randn(8, 6, generator=gen) for _ in range(2)]
    x = xs[r]
    out = {}
    for dim in (0, 1):
        native = col.all_gather(x, g, dim, route="gloo")
        forced = col.all_gather(x, g, dim, route="gloo_cuda_via_all_reduce")
        assert torch.equal(native, torch.cat(xs, dim))
        out[f"all_gather_bits_dim{dim}"] = torch.equal(
            native.view(torch.int32), forced.view(torch.int32))
        native = col.reduce_scatter(x, g, dim, route="gloo")
        forced = col.reduce_scatter(x, g, dim,
                                    route="gloo_cuda_via_all_reduce")
        ulps = (native.view(torch.int32).long()
                - forced.view(torch.int32).long()).abs().max()
        out[f"reduce_scatter_ulps_dim{dim}"] = int(ulps)
        want = (xs[0] + xs[1]).chunk(2, dim)[r]
        assert torch.allclose(native, want, rtol=1e-6, atol=0)
    assert torch.equal(col.all_reduce(x, g), xs[0] + xs[1])
    got = col.gather_from(x, g, 0, "sum", torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.cat(xs).bfloat16())
    xb = x.bfloat16()
    got = col.gather_from(xb, g, 0, "sum", out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.cat(xs).bfloat16().float())
    got = col.reduce_from(x, g, out_dtype=torch.bfloat16)
    assert torch.equal(got, (xs[0] + xs[1]).bfloat16())

    def grad(fn, xin, w):
        xin = xin.clone().requires_grad_()
        (fn(xin) * w).sum().backward()
        return xin.grad
    w8 = ws[r]
    checks = {
        # all-gather forward, reduce-scatter backward: the sum of every
        # rank's weight over this rank's rows
        "gather_sum": (grad(lambda t: col.gather_from(t, g, 0, "sum"), x,
                            w8), (ws[0] + ws[1])[4 * r:4 * r + 4]),
        # the same, the shard travelling in bf16 and its gradient
        # reduced in f32
        "gather_sum_bf16": (
            grad(lambda t: col.gather_from(t, g, 0, "sum",
                                           torch.bfloat16).float(), x, w8),
            sum(w.bfloat16().float() for w in ws)[4 * r:4 * r + 4]),
        # all-gather forward, this rank's slice backward
        "gather_split": (grad(lambda t: col.gather_from(t, g, 0, "split"),
                              x, w8), w8[4 * r:4 * r + 4]),
        # identity forward, all-reduce backward
        "copy_to": (grad(lambda t: col.copy_to(t, g), x, w8[:4]),
                    ws[0][:4] + ws[1][:4]),
        # all-reduce forward, identity backward
        "reduce_from": (grad(lambda t: col.reduce_from(t, g), x, w8[:4]),
                        w8[:4]),
        # reduce-scatter forward, all-gather backward
        "reduce_scatter_to": (grad(lambda t: col.reduce_scatter_to(t, g, 0),
                                   x, w8[:2]),
                              torch.cat([ws[0][:2], ws[1][:2]])),
        # a bf16 activation into an f32 region: the f32 gradients
        # all-reduced in f32, then rounded once
        "copy_to_f32_out": (
            grad(lambda t: col.copy_to(t, g, out_dtype=torch.float32), xb,
                 w8[:4]), (ws[0][:4] + ws[1][:4]).bfloat16()),
        # the same under sequence parallelism: gathered in bf16,
        # reduce-scattered in f32, then rounded
        "gather_from_f32_out": (
            grad(lambda t: col.gather_from(t, g, 0, "sum",
                                           out_dtype=torch.float32), xb,
                 w8), (ws[0] + ws[1])[4 * r:4 * r + 4].bfloat16()),
        # an f32 partial reduced in f32 and rounded once to bf16; its
        # bf16 gradient gathered in bf16
        "reduce_scatter_to_bf16_out": (
            grad(lambda t: col.reduce_scatter_to(
                t, g, 0, out_dtype=torch.bfloat16), x, w8[:2]),
            torch.cat([ws[0][:2], ws[1][:2]]).bfloat16().float()),
        "reduce_from_bf16_out": (
            grad(lambda t: col.reduce_from(t, g, out_dtype=torch.bfloat16),
                 x, w8[:4]), w8[:4].bfloat16().float()),
    }
    for name, (got, want) in checks.items():
        out[f"dtype_{name}"] = got.dtype == want.dtype
        out[f"grad_{name}"] = float((got.float() - want.float()).abs().max())

    # psum / pmean over named mesh axes, and shard_gpt_params on a mesh
    # that names the family table's own axes ('mp', 'fsdp')
    from paddle_tpu_torch.models.gpt import shard_gpt_params
    from paddle_tpu_torch.parallel import build_mesh, pmean, psum, use_mesh
    mesh = build_mesh({"mp": 2, "fsdp": 2}, device_type="cpu")
    one = torch.full((3,), float(rank))
    with use_mesh(mesh):
        out["psum_mp"] = psum(one, "mp").tolist()
        out["pmean_all"] = pmean(one, ("mp", "fsdp")).tolist()
    wte = torch.arange(32.0).reshape(8, 4)
    local = shard_gpt_params({"wte": wte, "ln_f_scale": wte[0]}, mesh)
    out["wte_block"] = local["wte"].tolist()
    out["ln_f_scale"] = local["ln_f_scale"].tolist()
    return out


def _run_case(case, params0):
    """One plan on this rank: 5 steps, then a sixth on new tokens.
    Returns what the test checks."""
    from paddle_tpu_torch.models import gpt, llama
    from paddle_tpu_torch.models.facade import make_train_step
    from paddle_tpu_torch.parallel import plan_train
    cid, family, axes, sp = case
    mod = gpt if family == "gpt" else llama
    cfg = _tcfg(family, sp)
    plan = plan_train(cfg, 4, B, **axes)
    mesh = plan.build_mesh(device_type="cpu")
    step = make_train_step(mod.train_step, cfg=cfg, mesh=mesh, plan=plan,
                           lr=LR)
    params = {k: torch.from_numpy(v) for k, v in params0.items()}
    opt = gpt.init_opt_state(params)
    tokens = _tokens(0)
    losses = []
    for _ in range(STEPS):
        loss, params, opt = step(params, opt, tokens)
        losses.append(float(loss))
    res = {"losses": losses, "plan": plan.name}
    res["full"] = {k: v.numpy() for k, v in step.gather_full(params).items()}
    for mom in ("m", "v"):
        res[mom] = {k: v.numpy() for k, v in
                    step.gather_full(opt[mom]).items()}
    res["step"] = float(opt["step"])
    pins = step.in_pins
    res["leaves"] = {}
    for name in LEAF_CLASSES[family]:
        pin = pins[0][name]
        full = tuple(params0[name].shape)
        res["leaves"][name] = {
            "spec": tuple(pin.spec), "plan_spec": tuple(plan.specs[name]),
            "placements": [repr(p) for p in pin.placements],
            "opt_pins": [tuple(pins[1][m][name].spec) for m in ("m", "v")],
            "full": full, "want_local": pin.local_shape(full),
            "local": [tuple(t[name].shape)
                      for t in (params, opt["m"], opt["v"])]}
    res["opt_step_spec"] = tuple(pins[1]["step"].spec)
    res["opt_step_placements"] = [repr(p) for p in pins[1]["step"].placements]
    res["trace_count_after_5"] = step.trace_count
    loss6, p6, _ = step(params, opt, _tokens(1))
    res["trace_count_after_6"] = step.trace_count
    res["same_objects"] = p6 is params
    res["loss6"] = float(loss6)
    res["activation_collectives"] = _activation_collectives(
        step, params, _tokens(1), B // (axes["dp"] * axes["fsdp"]),
        cfg.hidden_size)
    return res


def _activation_collectives(step, params, tokens, b_local, D):
    """The collectives one forward and backward run on activations
    ([b_local, S or S / tp, D]), by name, in order."""
    from paddle_tpu_torch.parallel import collective as col
    names = ("all_reduce", "reduce_scatter", "all_gather")
    saved = {n: getattr(col, n) for n in names}
    seen = []

    def counted(n):
        def fn(x, *args, **kw):
            if x.dim() == 3 and x.shape[0] == b_local and x.shape[2] == D:
                seen.append(n)
            return saved[n](x, *args, **kw)
        return fn
    for n in names:
        setattr(col, n, counted(n))
    try:
        step.loss_and_grads(params, tokens)
    finally:
        for n, fn in saved.items():
            setattr(col, n, fn)
    return seen


def _rank_main(rank, world, workdir):
    """One rank of the test world: joins it through the launch
    environment's names and a file store, runs the jobs, writes its
    results to workdir/rank{rank}.pt."""
    torch.set_num_threads(1)
    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    os.environ["WORLD_SIZE"] = str(world)
    import torch.distributed as dist
    from paddle_tpu_torch.parallel import init_parallel_env
    init_parallel_env(backend="gloo", timeout_s=120,
                      init_method=None if world == 1 else
                      f"file://{workdir}/store")
    assert dist.get_world_size() == world and dist.get_rank() == rank
    init = torch.load(os.path.join(workdir, "init.pt"), weights_only=False)
    out = {}
    try:
        if world == 1:
            out["one_rank"] = _one_rank(init)
            out["oom"] = _oom_forensics(init, workdir)
        else:
            out["collectives"] = _collective_checks(rank)
            for case in CASES:
                out[case[0]] = _run_case(case, init[case[1]])
            out["telemetry"] = _telemetry_run(init["gpt"], workdir, rank)
    finally:
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
        dist.destroy_process_group()


def _one_rank(init):
    """The dp1×fsdp1×tp1 plan on a world of one against the port's
    unsharded step: {family: every loss and leaf equal to the bit}."""
    from paddle_tpu_torch.models import gpt, llama
    from paddle_tpu_torch.models.facade import make_train_step
    from paddle_tpu_torch.parallel import plan_train
    res = {}
    for family, mod in (("gpt", gpt), ("llama", llama)):
        cfg = _tcfg(family, sp=True)
        runs = []
        for sharded in (False, True):
            params = {k: torch.from_numpy(v.copy())
                      for k, v in init[family].items()}
            opt = gpt.init_opt_state(params)
            if sharded:
                plan = plan_train(cfg, 1, B, dp=1, fsdp=1, tp=1)
                step = make_train_step(mod.train_step, cfg=cfg, lr=LR,
                                       mesh=plan.build_mesh(
                                           device_type="cpu"), plan=plan)
            else:
                step = make_train_step(mod.train_step, cfg=cfg, lr=LR)
            losses = []
            for _ in range(STEPS):
                loss, params, opt = step(params, opt,
                                         torch.from_numpy(_tokens(0)))
                losses.append(loss)
            runs.append((losses, params, opt))
        (l0, p0, o0), (l1, p1, o1) = runs
        res[family] = {
            "losses": all(torch.equal(a, b) for a, b in zip(l0, l1)),
            "params": all(torch.equal(p0[k], p1[k]) for k in p0),
            "moments": all(torch.equal(o0[m][k], o1[m][k])
                           for m in ("m", "v") for k in p0),
            "step": torch.equal(o0["step"], o1["step"])}
    return res


TELEMETRY_PLANS = {"dp2_fsdp2": dict(dp=2, fsdp=2, tp=1),
                   "dp2_tp2": dict(dp=2, fsdp=1, tp=2)}
TELEMETRY_STEPS = 3


def _instrumented_gpt(params0, path, mesh=None, plan=None):
    """GPT through instrument_train_step for TELEMETRY_STEPS steps on
    _tokens(0): (losses, the JSONL's step records)."""
    import json
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.profiler import telemetry
    cfg = _tcfg("gpt")
    tele = telemetry.TelemetryPipeline(path, every=TELEMETRY_STEPS,
                                       fields=telemetry.MFU_FIELDS)
    step = telemetry.instrument_train_step(gpt.train_step, tele, cfg=cfg,
                                           lr=LR, mesh=mesh, plan=plan)
    params = {k: torch.from_numpy(v.copy()) for k, v in params0.items()}
    opt = gpt.init_opt_state(params)
    ts = tele.device_init(device="cpu")
    losses = []
    for i in range(TELEMETRY_STEPS):
        loss, params, opt, ts = step(params, opt,
                                     torch.from_numpy(_tokens(0)), ts)
        losses.append(float(loss))
        tele.tick(i, ts)
    tele.close(ts)
    recs = [json.loads(ln) for ln in open(path)]
    return losses, [r for r in recs if r["kind"] == "step"]


def _telemetry_run(params0, workdir, rank):
    """Each TELEMETRY_PLANS plan, instrumented, on this rank."""
    from paddle_tpu_torch.parallel import plan_train
    out = {}
    for name, axes in TELEMETRY_PLANS.items():
        plan = plan_train(_tcfg("gpt"), 4, B, **axes)
        out[name] = _instrumented_gpt(
            params0, os.path.join(workdir, f"tele.{name}.{rank}.jsonl"),
            mesh=plan.build_mesh(device_type="cpu"), plan=plan)
    return out


def _oom_forensics(init, workdir):
    """A dp1×fsdp1×tp1 step whose inner step raises the allocator's
    error: what the flight dump and the monitor show."""
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.models.facade import make_train_step
    from paddle_tpu_torch.parallel import plan_train
    from paddle_tpu_torch.profiler import flight_recorder, monitor
    rec = flight_recorder.recorder()
    flight = os.path.join(workdir, "flight")
    rec.set_dir(flight)
    rec.autodump_every = 0

    def oom_step(params, opt_state, batch, **kw):
        raise torch.OutOfMemoryError("out of memory (in the test)")

    cfg = _tcfg("gpt")
    plan = plan_train(cfg, 1, B, dp=1, fsdp=1, tp=1)
    step = make_train_step(oom_step, cfg=cfg, lr=LR, plan=plan,
                           mesh=plan.build_mesh(device_type="cpu"))
    params = {k: torch.from_numpy(v.copy()) for k, v in init["gpt"].items()}
    before = monitor.counter("train.oom_forensics").value
    try:
        step(params, gpt.init_opt_state(params), _tokens(0))
        raised = None
    except torch.OutOfMemoryError as e:
        raised = str(e)
    dumps = sorted(f for f in os.listdir(flight) if "oom_forensics" in f)
    doc = flight_recorder.load_dump(os.path.join(flight, dumps[0]))
    return {"raised": raised, "dumps": dumps,
            "count": monitor.counter("train.oom_forensics").value - before,
            "forensics": doc["config"]["oom_forensics"],
            "noted": doc["steps"][-1],
            "compile_gauges": [k for k in monitor.snapshot()
                               if k.startswith("train.compile.")]}


def _spawn(world, init):
    import torch.multiprocessing as mp
    workdir = tempfile.mkdtemp(prefix="plan3d_")
    torch.save(init, os.path.join(workdir, "init.pt"))
    mp.spawn(_rank_main, args=(world, workdir), nprocs=world, join=True)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# ----------------------------------------------------------- test side
@pytest.fixture(scope="module")
def ref():
    """The JAX unsharded step, 5 steps of each family from PRNGKey(0):
    the starting params (numpy) and the losses and final trees."""
    import functools
    import jax
    import jax.numpy as jnp
    from paddle_tpu.models import gpt as jg
    from paddle_tpu.models import llama as jl
    from paddle_tpu.models.facade import make_train_step as jmake
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    out = {}
    for family in ("gpt", "llama"):
        if family == "gpt":
            cfg = jg.GPTConfig(**GPT, dtype=jnp.float32, remat=False,
                               sequence_parallel=False)
            params = jg.init_gpt_params(cfg, jax.random.PRNGKey(0))
            fn = jg.train_step
        else:
            cfg = jl.LlamaConfig(**LLAMA, dtype=jnp.float32, remat=False)
            params = jl.init_llama_params(cfg, jax.random.PRNGKey(0))
            fn = jl.train_step
        init = as_np(params)
        step = jmake(fn, cfg=cfg, lr=LR, donate=False)
        opt = jg.init_opt_state(params)
        losses = []
        for _ in range(STEPS):
            loss, params, opt = step(params, opt, jnp.asarray(_tokens(0)))
            losses.append(float(loss))
        out[family] = dict(init=init, losses=losses, final=as_np(params),
                           m=as_np(opt["m"]), v=as_np(opt["v"]),
                           step=float(opt["step"]))
    return out


@pytest.fixture(scope="module")
def world4(ref):
    return _spawn(4, {f: ref[f]["init"] for f in ref})


@pytest.fixture(scope="module")
def world1(ref):
    return _spawn(1, {f: ref[f]["init"] for f in ref})


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sharded_trajectory_matches_jax_unsharded(case, ref, world4):
    cid, family, axes, _ = case
    want = ref[family]
    for rank, res in enumerate(world4):
        got = res[cid]
        # every rank reports the same global-batch loss
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=2e-4, atol=2e-4)
        assert got["losses"] == world4[0][cid]["losses"], rank
    got = world4[0][cid]
    for tree, key in ((got["full"], "final"), (got["m"], "m"),
                      (got["v"], "v")):
        assert tree.keys() == want[key].keys()
        for leaf in tree:
            np.testing.assert_allclose(tree[leaf], want[key][leaf],
                                       rtol=2e-4, atol=2e-4,
                                       err_msg=f"{cid} {key} {leaf}")
    assert got["step"] == want["step"] == float(STEPS)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_local_shards_follow_the_plan_specs(case, world4):
    from paddle_tpu_torch.parallel.mesh import P
    cid, family, axes, _ = case
    names = ("dp", "fsdp", "tp")
    for res in world4:
        got = res[cid]
        assert got["plan"] == "_".join(f"{a}{axes[a]}" for a in names)
        for leaf, info in got["leaves"].items():
            spec = P(*info["spec"])
            assert spec == P(*info["plan_spec"]), (cid, leaf)
            assert all(P(*s) == spec for s in info["opt_pins"]), leaf
            want_pl = []
            for a in names:
                dims = [d for d, e in enumerate(spec)
                        if e == a or (isinstance(e, tuple) and a in e)]
                want_pl.append(f"Shard(dim={dims[0]})" if dims
                               else "Replicate()")
            assert info["placements"] == want_pl, (cid, leaf)
            want_local = tuple(info["want_local"])
            assert all(tuple(s) == want_local for s in info["local"]), leaf
            # each dim holds its share of the full leaf
            for d, e in enumerate(spec):
                n = int(np.prod([axes[a] for a in (
                    () if e is None else e if isinstance(e, tuple)
                    else (e,))]))
                assert want_local[d] * n == info["full"][d], (leaf, spec)
        assert got["opt_step_spec"] == ()
        assert got["opt_step_placements"] == ["Replicate()"] * 3


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_pins_derived_once(case, world4):
    for res in world4:
        got = res[case[0]]
        assert got["trace_count_after_5"] == 1
        assert got["trace_count_after_6"] == 1
        assert got["same_objects"]
        assert np.isfinite(got["loss6"])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tp_region_entered_once_per_block_half(case, world4):
    """Each block half enters the tensor-parallel region once and leaves
    it once: 2 collectives a half on activations (the exit's forward
    reduction, the entry's backward one), 4 under sequence parallelism
    (the entry's gather and the exit's gather backward too), whatever
    the number of column-parallel projections (Llama's q, k, v and
    gate, up); none without tp."""
    cid, family, axes, sp = case
    per_half = 0 if axes["tp"] == 1 else (4 if sp else 2)
    for res in world4:
        got = res[cid]["activation_collectives"]
        assert len(got) == 2 * per_half * GPT["num_layers"], got


def test_one_rank_plan_equals_the_unsharded_step_to_the_bit(world1):
    for family, res in world1[0]["one_rank"].items():
        assert res == {"losses": True, "params": True, "moments": True,
                       "step": True}, family


def test_telemetry_norms_of_sharded_plans_match_unsharded(ref, world4,
                                                         tmp_path):
    """fsdp2 and tp2 (each beside dp2): the instrumented losses equal
    the plain sharded step's to the bit, every rank records the same
    row, and each recorded loss, grad_norm and param_norm agrees with
    the unsharded instrumented step's within 2e-4 (the sharded
    trajectories' tolerance); nonfinite 0, lr and tokens (the global
    batch's B·S) exact."""
    _, want = _instrumented_gpt(ref["gpt"]["init"],
                                str(tmp_path / "unsharded.jsonl"))
    cases = {"dp2_fsdp2": "gpt-dp2_fsdp2", "dp2_tp2": "gpt-dp2_tp2-nosp"}
    for name, case in cases.items():
        rows = [res["telemetry"][name][1] for res in world4]
        for rank, res in enumerate(world4):
            losses, got = res["telemetry"][name]
            assert losses == res[case]["losses"][:TELEMETRY_STEPS], name
            assert got == rows[0], (name, rank)
        for g, w in zip(rows[0], want):
            assert g["step"] == w["step"]
            for f in ("loss", "grad_norm", "param_norm"):
                assert g[f] == pytest.approx(w[f], rel=2e-4), (name, f, g, w)
            assert (g["nonfinite"], g["lr"], g["tokens"]) == (
                0.0, w["lr"], float(B * S)), (name, g)


def test_oom_in_a_sharded_step_dumps_forensics_and_reraises(world1):
    got = world1[0]["oom"]
    assert got["raised"] == "out of memory (in the test)"
    assert got["count"] == 1 and len(got["dumps"]) == 1
    f = got["forensics"]
    leaves = {leaf for row in f["census"].values() for leaf in row["leaves"]}
    assert {"params/wte", "opt_state/m/qkv_w", "opt_state/v/wte",
            "batch"} <= leaves
    assert f["ledger"]["total"] > 0 and f["plan"] == "dp1_fsdp1_tp1"
    assert f["live_bytes"] > 0 and got["noted"]["oom_forensics"] == \
        "train_step"
    # an eager step compiles nothing: the reference's train.compile.*
    # gauges are not published
    assert got["compile_gauges"] == []


def test_collective_routes_and_pair_gradients(world4):
    for rank, res in enumerate(world4):
        got = res["collectives"]
        assert got["all_gather_bits_dim0"] and got["all_gather_bits_dim1"]
        assert got["reduce_scatter_ulps_dim0"] <= 1
        assert got["reduce_scatter_ulps_dim1"] <= 1
        for k, err in got.items():
            if k.startswith("grad_"):
                assert err <= 1e-6, (rank, k, err)
            if k.startswith("dtype_"):
                assert err, (rank, k)
        # mesh {'mp': 2, 'fsdp': 2}: rank = 2 * mp + fsdp
        mp, fsdp = divmod(rank, 2)
        assert got["psum_mp"] == [float(fsdp + (fsdp + 2))] * 3
        assert got["pmean_all"] == [1.5] * 3
        wte = np.arange(32.0).reshape(8, 4)
        assert got["wte_block"] == wte[4 * mp:4 * mp + 4,
                                       2 * fsdp:2 * fsdp + 2].tolist()
        assert got["ln_f_scale"] == wte[0].tolist()
