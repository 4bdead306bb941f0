"""The port's pipelined pp>1 train step (parallel/pipeline_train.py,
models/facade.py `_ShardedTrainStep` under pp, the 1F1B schedule of
parallel/pipeline.py and the stage handoffs of parallel/collective.py)
against the JAX package's unsharded step, on the CPU over gloo.

The JAX package's own pp tests (tests/test_plan4d.py) fail on this host,
so every case is held to the JAX unsharded step, as tests/test_plan4d.py
holds the reference's pipelined step. A world of 4 ranks, started once
for the module (rendezvous through a file store, one torch thread a
rank), runs every case from the JAX step's starting weights (numpy):
- GPT at tests/test_torch_plan3d.py's shape (vocab 512, hidden 128, 2
  layers, 4 heads, f32), batch 8 x 32, lr 1e-3, 5 steps: dp2×pp2,
  tp2×pp2 (the vocab-parallel embedding and cross entropy) and
  fsdp2×pp2 (with full remat: the ZeRO-3 gathers run again in the
  backward);
- GPT at 4 layers on pp4 with 8 microbatches;
- a small Llama (4 heads over 2 KV heads) at tp2×pp2 and fsdp2×pp2
  (with remat).
Each: step 1's gradients, gathered whole, against jax.grad of the
unsharded loss leaf by leaf (norm ratio within 1e-3, cosine 0.9999);
the loss trajectory within rtol/atol 2e-4 of the JAX unsharded
step's, every rank returning the same global loss; after step 5 the
gathered params and both Adam moments within 2e-4 of the JAX trees;
each local shard as plan.specs says, the stacked leaves cut over pp on
their layer axis; the step's bubble equal to (pp-1)/(m+pp-1). The
tp2×pp2 GPT case runs again with its handoffs forced onto the
all-reduce route the card uses ("gloo_cuda_via_all_reduce", here on CPU
tensors) and must equal the gloo route's result to the bit. The world
also holds `exchange` on both routes to gloo's own send/recv. The
refusals of `make_pp_step_fn` are the reference's, message for message.

The rank processes import this module without jax: the JAX side is
imported in the fixtures, in the test process only.
"""
import os
import tempfile
import types

import numpy as np
import pytest
import torch

B, S, STEPS, LR = 8, 32, 5, 1e-3
GPT = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
           max_seq_len=64)
GPT4 = dict(GPT, num_layers=4)
LLAMA = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=64)
SHAPES = {"gpt": GPT, "gpt4": GPT4, "llama": LLAMA}
# (case id, model, plan degrees, microbatches (None: the planner's),
# remat)
CASES = [
    ("gpt-dp2_pp2", "gpt", dict(dp=2, fsdp=1, tp=1, pp=2), None, False),
    ("gpt-tp2_pp2", "gpt", dict(dp=1, fsdp=1, tp=2, pp=2), None, False),
    ("gpt-fsdp2_pp2", "gpt", dict(dp=1, fsdp=2, tp=1, pp=2), None, True),
    ("gpt4-pp4", "gpt4", dict(dp=1, fsdp=1, tp=1, pp=4), 8, False),
    ("llama-tp2_pp2", "llama", dict(dp=1, fsdp=1, tp=2, pp=2), None,
     False),
    ("llama-fsdp2_pp2", "llama", dict(dp=1, fsdp=2, tp=1, pp=2), None,
     True),
]
FORCED = "gpt-tp2_pp2"
LEAF_CLASSES = {"gpt": ("qkv_w", "mlp_down_w", "wte", "wpe", "ln1_scale",
                        "ln_f_scale"),
                "llama": ("q_w", "k_w", "o_w", "wte", "attn_norm",
                          "norm_f")}


def _tokens(seed):
    return np.random.RandomState(seed).randint(
        0, GPT["vocab_size"], (B, S + 1)).astype(np.int64)


def _tcfg(model, remat=False):
    from paddle_tpu_torch.models import gpt, llama
    if model.startswith("gpt"):
        return gpt.GPTConfig(**SHAPES[model], dtype=torch.float32,
                             remat=remat, sequence_parallel=False)
    return llama.LlamaConfig(**LLAMA, dtype=torch.float32, remat=remat)


# ------------------------------------------------------------ rank side
def _exchange_checks(rank):
    """`exchange` on 2-rank groups ({0, 1} and {2, 3}) against gloo's own
    send/recv: one slot sending each way, on both CPU routes."""
    import torch.distributed as dist
    from paddle_tpu_torch.parallel import collective as col
    groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    g = groups[rank // 2]
    r = dist.get_rank(g)
    gen = torch.Generator().manual_seed(11 + rank // 2)
    xs = [torch.randn(3, 5, generator=gen) for _ in range(2)]
    # gloo's own: rank 0 sends first, rank 1 receives first
    peer = dist.get_global_rank(g, 1 - r)
    want = torch.empty(3, 5)
    if r == 0:
        dist.send(xs[0], peer)
        dist.recv(want, peer)
    else:
        dist.recv(want, peer)
        dist.send(xs[1], peer)
    out = {}
    slot = [(0, 1), (1, 0)]
    for route in ("gloo", "gloo_cuda_via_all_reduce"):
        for dtype in (torch.float32, torch.bfloat16):
            mine = {(r, 1 - r): xs[r]}
            got = col.exchange(slot, mine, g, (3, 5), dtype, "cpu", route)
            assert list(got) == [(1 - r, r)]
            t = got[(1 - r, r)]
            out[f"{route}_{dtype}"] = (t.dtype == dtype and torch.equal(
                t.view(torch.int16 if dtype == torch.bfloat16
                       else torch.int32),
                want.to(dtype).view(torch.int16 if dtype == torch.bfloat16
                                    else torch.int32)))
    # a slot whose transfer this rank neither sends nor receives: the
    # all-reduce route still joins it, and receives nothing
    got = col.exchange([(0, 1)], {(0, 1): xs[0]} if r == 0 else {}, g,
                       (3, 5), torch.float32, "cpu",
                       "gloo_cuda_via_all_reduce")
    out["one_way"] = (got == {} if r == 0
                      else torch.equal(got[(0, 1)], xs[0]))
    return out


def _run_case(case, params0, route=None):
    """One plan on this rank: 5 steps, then a sixth on new tokens."""
    from paddle_tpu_torch.models import gpt, llama
    from paddle_tpu_torch.models.facade import make_train_step
    from paddle_tpu_torch.parallel import plan_train
    cid, model, axes, m, remat = case
    mod = gpt if model.startswith("gpt") else llama
    cfg = _tcfg(model, remat)
    plan = plan_train(cfg, 4, B, microbatches=m, **axes)
    mesh = plan.build_mesh(device_type="cpu")
    step = make_train_step(mod.train_step, cfg=cfg, mesh=mesh, plan=plan,
                           lr=LR)
    params = {k: torch.from_numpy(v) for k, v in params0.items()}
    opt = gpt.init_opt_state(params)
    tokens = _tokens(0)
    # step 1's reduced gradients, from a step of their own, gathered whole
    gstep = make_train_step(mod.train_step, cfg=cfg, mesh=mesh, plan=plan,
                            lr=LR)
    gstep._fn.route = route
    local, _, _ = gstep.shard_args(params, opt, tokens)
    _, grads = gstep.loss_and_grads(local, tokens)
    grads1 = {k: v.numpy() for k, v in gstep.gather_full(grads).items()}
    del gstep, local, grads
    losses = []
    step._fn.route = route
    for _ in range(STEPS):
        loss, params, opt = step(params, opt, tokens)
        losses.append(float(loss))
    res = {"losses": losses, "grads1": grads1, "plan": plan.name,
           "microbatches": plan.microbatches,
           "bubble": step.bubble_fraction,
           "route": step._fn.route}
    res["full"] = {k: v.numpy() for k, v in step.gather_full(params).items()}
    for mom in ("m", "v"):
        res[mom] = {k: v.numpy() for k, v in
                    step.gather_full(opt[mom]).items()}
    res["step"] = float(opt["step"])
    pins = step.in_pins
    res["leaves"] = {}
    for name in LEAF_CLASSES["llama" if model == "llama" else "gpt"]:
        pin = pins[0][name]
        full = tuple(params0[name].shape)
        res["leaves"][name] = {
            "spec": tuple(pin.spec), "plan_spec": tuple(plan.specs[name]),
            "full": full, "want_local": pin.local_shape(full),
            "local": [tuple(t[name].shape)
                      for t in (params, opt["m"], opt["v"])]}
    res["trace_count"] = step.trace_count
    loss6, p6, _ = step(params, opt, _tokens(1))
    res["trace_count_after_6"] = step.trace_count
    res["same_objects"] = p6 is params
    res["loss6"] = float(loss6)
    # a per-shard batch the microbatches do not divide
    try:
        step._fn(params, opt, torch.from_numpy(_tokens(2))[:3])
        res["ragged"] = None
    except ValueError as e:
        res["ragged"] = str(e)
    # rebuilt on the same mesh and plan: pins and bubble start again,
    # and the first call takes full trees
    step.rebuild()
    res["rebuilt"] = (step.in_pins is None, step.bubble_fraction)
    p0 = {k: torch.from_numpy(v) for k, v in params0.items()}
    loss1, _, _ = step(p0, gpt.init_opt_state(p0), tokens)
    res["rebuilt_loss1"] = float(loss1)
    res["rebuilt_bubble"] = step.bubble_fraction
    return res


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
        out["exchange"] = _exchange_checks(rank)
        for case in CASES:
            out[case[0]] = _run_case(case, init[case[1]])
            if case[0] == FORCED:
                out["forced"] = _run_case(case, init[case[1]],
                                          route="gloo_cuda_via_all_reduce")
    finally:
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
        dist.destroy_process_group()


def _spawn(world, init):
    import torch.multiprocessing as mp
    workdir = tempfile.mkdtemp(prefix="plan4d_")
    torch.save(init, os.path.join(workdir, "init.pt"))
    mp.spawn(_rank_main, args=(world, workdir), nprocs=world, join=True)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# ----------------------------------------------------------- test side
@pytest.fixture(scope="module")
def ref():
    """The JAX unsharded step, 5 steps of each model from PRNGKey(0)."""
    import functools
    import jax
    import jax.numpy as jnp
    from paddle_tpu.models import gpt as jg
    from paddle_tpu.models import llama as jl
    from paddle_tpu.models.facade import make_train_step as jmake
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    out = {}
    for model in SHAPES:
        if model.startswith("gpt"):
            cfg = jg.GPTConfig(**SHAPES[model], dtype=jnp.float32,
                               remat=False, sequence_parallel=False)
            params = jg.init_gpt_params(cfg, jax.random.PRNGKey(0))
            fn, loss_fn = jg.train_step, jg.gpt_loss
        else:
            cfg = jl.LlamaConfig(**LLAMA, dtype=jnp.float32, remat=False)
            params = jl.init_llama_params(cfg, jax.random.PRNGKey(0))
            fn, loss_fn = jl.train_step, jl.llama_loss
        init = as_np(params)
        grads1 = as_np(jax.grad(lambda p: loss_fn(
            p, jnp.asarray(_tokens(0)), cfg))(params))
        step = jmake(fn, cfg=cfg, lr=LR, donate=False)
        opt = jg.init_opt_state(params)
        losses = []
        for _ in range(STEPS):
            loss, params, opt = step(params, opt, jnp.asarray(_tokens(0)))
            losses.append(float(loss))
        out[model] = dict(init=init, grads1=grads1, losses=losses,
                          final=as_np(params),
                          m=as_np(opt["m"]), v=as_np(opt["v"]),
                          step=float(opt["step"]))
    return out


@pytest.fixture(scope="module")
def world4(ref):
    return _spawn(4, {f: ref[f]["init"] for f in ref})


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_pipelined_trajectory_matches_jax_unsharded(case, ref, world4):
    cid, model = case[0], case[1]
    want = ref[model]
    for rank, res in enumerate(world4):
        got = res[cid]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=2e-4, atol=2e-4)
        assert got["losses"] == world4[0][cid]["losses"], rank
    for res in world4:
        got = res[cid]
        for tree, key in ((got["full"], "final"), (got["m"], "m"),
                          (got["v"], "v")):
            assert tree.keys() == want[key].keys()
            for leaf in tree:
                np.testing.assert_allclose(tree[leaf], want[key][leaf],
                                           rtol=2e-4, atol=2e-4,
                                           err_msg=f"{cid} {key} {leaf}")
        assert got["step"] == want["step"] == float(STEPS)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_step1_gradients_match_jax_leaf_by_leaf(case, ref, world4):
    """Step 1's reduced gradients, gathered whole on every rank, against
    jax.grad of the unsharded loss, leaf by leaf: the norm ratio within
    1e-3 of 1 and the cosine at least 0.9999. Adam's update, and so the
    trajectory and the moments above, does not change under a per-leaf
    gradient scale (v ~ g^2 is far below the 2e-4 atol); a leaf summed
    over pp twice reads a norm ratio of 2 here."""
    cid, model = case[0], case[1]
    want = ref[model]["grads1"]
    for rank, res in enumerate(world4):
        got = res[cid]["grads1"]
        assert got.keys() == want.keys()
        for leaf in got:
            g = got[leaf].astype(np.float64).ravel()
            w = want[leaf].astype(np.float64).ravel()
            ng, nw = np.linalg.norm(g), np.linalg.norm(w)
            assert nw > 0, (cid, leaf)
            assert abs(ng / nw - 1) <= 1e-3, (cid, rank, leaf, ng / nw)
            assert g @ w / (ng * nw) >= 0.9999, (cid, rank, leaf)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_local_shards_follow_the_plan_specs(case, world4):
    """Every local shard (params and both moments) is the plan's block:
    the stacked leaves cut over pp on the layer axis, wte over tp on
    the vocab and fsdp on the width."""
    from paddle_tpu_torch.parallel.mesh import P
    cid, _, axes = case[:3]
    for res in world4:
        got = res[cid]
        assert got["plan"] == "_".join(
            f"{a}{axes[a]}" for a in ("dp", "fsdp", "tp", "pp"))
        for leaf, info in got["leaves"].items():
            spec = P(*info["spec"])
            assert spec == P(*info["plan_spec"]), (cid, leaf)
            want_local = tuple(info["want_local"])
            assert all(tuple(s) == want_local for s in info["local"]), leaf
            for d, e in enumerate(spec):
                n = int(np.prod([axes[a] for a in (
                    () if e is None else e if isinstance(e, tuple)
                    else (e,))]))
                assert want_local[d] * n == info["full"][d], (leaf, spec)
            if info["full"][0] in (GPT["num_layers"], GPT4["num_layers"]) \
                    and len(spec) and spec[0] == "pp":
                assert want_local[0] == info["full"][0] // axes["pp"]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bubble_is_the_schedule_fraction(case, world4):
    from paddle_tpu_torch.parallel.pipeline import bubble_fraction
    pp = case[2]["pp"]
    for res in world4:
        got = res[case[0]]
        m = got["microbatches"]
        assert m >= 2 and (case[3] is None or m == case[3])
        assert got["bubble"] == (pp - 1) / (m + pp - 1)
        assert got["bubble"] == bubble_fraction(pp, m)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_pins_derived_once_and_ragged_batch_refused(case, world4):
    for res in world4:
        got = res[case[0]]
        assert got["rebuilt"] == (True, None)
        assert got["rebuilt_loss1"] == got["losses"][0]
        assert got["rebuilt_bubble"] == got["bubble"]
        assert got["trace_count"] == 1 and got["trace_count_after_6"] == 1
        assert got["same_objects"] and np.isfinite(got["loss6"])
        m = got["microbatches"]
        assert got["ragged"] == (
            f"per-shard batch 3 is not divisible by microbatches={m} "
            f"(plan {got['plan']})")


def test_all_reduce_handoffs_equal_gloos_to_the_bit(world4):
    """The card's handoff route (every handoff an all-reduce with -0.0
    from the ranks that do not send), forced on CPU tensors, gives the
    gloo route's trajectory and trees bit for bit."""
    for res in world4:
        a, b = res[FORCED], res["forced"]
        assert b["route"] == "gloo_cuda_via_all_reduce" and a["route"] is None
        assert a["losses"] == b["losses"] and a["loss6"] == b["loss6"]
        for key in ("full", "m", "v"):
            for leaf in a[key]:
                assert np.array_equal(a[key][leaf].view(np.int32),
                                      b[key][leaf].view(np.int32)), leaf


def test_exchange_equals_gloo_send_recv(world4):
    for rank, res in enumerate(world4):
        assert all(res["exchange"].values()), (rank, res["exchange"])


# ----------------------------------------------------------- refusals
def _meshes(names, shape):
    """A stand-in mesh for each side's axis checks: the reference reads
    `axis_names` and a {name: size} `shape`, the port a DeviceMesh's
    `mesh_dim_names` and its shape tuple."""
    return (types.SimpleNamespace(axis_names=tuple(names),
                                  shape=dict(zip(names, shape))),
            types.SimpleNamespace(mesh_dim_names=tuple(names),
                                  shape=tuple(shape)))


def _refusals():
    import dataclasses
    from paddle_tpu_torch.models import gpt, llama
    from paddle_tpu_torch.parallel import plan_train
    g, ll = _tcfg("gpt"), _tcfg("llama")
    full = (("dp", "fsdp", "tp", "pp"), (1, 1, 2, 2))
    pp2 = plan_train(g, 4, B, dp=1, fsdp=1, tp=2, pp=2)
    one = dataclasses.replace(pp2, plan=dataclasses.replace(
        pp2.plan, microbatches=1))
    moe = gpt.GPTConfig(**GPT, dtype=torch.float32)
    moe.num_experts = 4
    cp = gpt.GPTConfig(**GPT, dtype=torch.float32)
    cp.context_parallel = "ring"
    kv1 = llama.LlamaConfig(**dict(LLAMA, num_kv_heads=1),
                            dtype=torch.float32)
    return [
        ("pp<=1", g, plan_train(g, 4, B, dp=1, fsdp=1, tp=4), full),
        ("microbatches<2", g, one, full),
        ("mesh axes", g, pp2, (("dp", "tp", "pp"), (1, 2, 2))),
        ("moe", moe, pp2, full),
        ("context parallel", cp, pp2, full),
        ("tp does not divide KV", kv1,
         plan_train(kv1, 4, B, dp=1, fsdp=1, tp=2, pp=2), full),
    ]


@pytest.mark.parametrize("idx", range(6))
def test_refusals_are_the_references(idx):
    from paddle_tpu.parallel.pipeline_train import make_pp_step_fn as jmake
    from paddle_tpu_torch.parallel.pipeline_train import make_pp_step_fn
    name, cfg, plan, (names, shape) = _refusals()[idx]
    jmesh, tmesh = _meshes(names, shape)
    errors = []
    for fn, mesh in ((jmake, jmesh), (make_pp_step_fn, tmesh)):
        with pytest.raises((ValueError, NotImplementedError)) as e:
            fn(cfg, plan, mesh)
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1], name


def test_make_train_step_needs_a_mesh_for_pp():
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.models.facade import make_train_step
    from paddle_tpu_torch.parallel import plan_train
    plan = plan_train(_tcfg("gpt"), 2, 4, dp=1, fsdp=1, tp=1, pp=2)
    with pytest.raises(ValueError, match="pp>1 plan needs mesh="):
        make_train_step(gpt.train_step, cfg=_tcfg("gpt"), plan=plan)


def test_schedule_is_1f1b():
    """Warm-up forwards pp-1-s on stage s, then one forward and one
    backward, then the cool-down; 2(m+pp-1) slots; every forward after
    its predecessor stage's, every backward after its successor's."""
    from paddle_tpu_torch.parallel.pipeline import (one_f_one_b,
                                                    schedule_stats,
                                                    timeline)
    assert one_f_one_b(2, 4) == [
        [("F", 0), ("F", 1), ("B", 0), ("F", 2), ("B", 1), ("F", 3),
         ("B", 2), ("B", 3)],
        [("F", 0), ("B", 0), ("F", 1), ("B", 1), ("F", 2), ("B", 2),
         ("F", 3), ("B", 3)]]
    for pp, m in ((2, 4), (4, 8), (2, 2), (3, 5), (4, 2)):
        slots = timeline(pp, m)
        assert len(slots) == 2 * (m + pp - 1)
        when = {(s, w): t for t, slot in enumerate(slots)
                for s, w in slot.items()}
        assert len(when) == 2 * m * pp
        for (s, (kind, i)), t in when.items():
            if kind == "F" and s > 0:
                assert when[(s - 1, ("F", i))] < t
            if kind == "B":
                dep = (s + 1, ("B", i)) if s < pp - 1 else (s, ("F", i))
                assert when[dep] < t
        st = schedule_stats(pp, m)
        assert st == {"busy": 2.0 * m * pp, "ticks": 2.0 * (m + pp - 1),
                      "stages": float(pp)}
