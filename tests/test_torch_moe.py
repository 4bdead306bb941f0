"""The port's mixture of experts (parallel/moe.py, models/gpt.py with
num_experts > 0, parallel/dist_utils.py, the 'ep' axis of the sharded
step) against the JAX package's, on the same numpy inputs, at the
highest matmul precision (tests/conftest.py), f32 activations:

- compute_capacity; topk_gating for k 1 and 2, with and without drops
  (dispatch and combine exact, aux within 1e-6);
- moe_ffn for the naive, switch and gshard gates at a capacity factor
  that drops tokens and one that drops none: y, aux and the gradients
  of x and every weight against jax.grad (atol 2e-6, relative to the
  largest gradient 1e-5); MoELayer;
- GPT with 4 experts (vocab 256, hidden 32, 2 layers, 4 heads, S 16,
  B 4): gpt_loss and every gradient leaf (rtol 1e-4 / 1e-3), a 3-step
  train_step trajectory and final params (rtol 1e-4 / 1e-3),
  greedy_generate token for token, params_from_jax on the MoE tree;
- one spawned gloo world of 4 ranks (one torch thread a rank):
  dp2×ep2 against the JAX unsharded moe_ffn (y rows, aux, every
  gradient; tolerances as above) and the GPT step against the JAX
  unsharded step, on the plan-less mesh {dp 2, ep 2} and a hand-built
  TrainPlan on {fsdp 2, ep 2} (3 steps, losses rtol 2e-4, final params
  rtol/atol 2e-4), at a capacity factor of 0.5, where routing each
  rank's rows alone gives another loss (checked: the test would catch
  a rank-local routing); global_scatter / global_gather.

The rank processes import this module without jax: the JAX side runs
in the test process only.
"""
import functools
import os
import tempfile

import numpy as np
import pytest
import torch

E, D, FH = 4, 16, 32
GPT = dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=4,
           ffn_hidden=64, max_seq_len=64, num_experts=4)
B, S, STEPS, LR = 4, 16, 3, 1e-3
# a capacity factor that drops tokens: C = ceil(64 / 4 * 0.5) = 8 of the
# global batch's 64 tokens an expert, 4 of a dp2 rank's 32
DROP_CF = 0.5
GATE_SCALE = 20.0        # decisive routing: no near-tie between packages
EXPERT_SCALE = 10.0      # experts that move the loss: drops show in it


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(D, E).astype(np.float32) * 0.5,
            rng.randn(E, D, FH).astype(np.float32) * 0.1,
            rng.randn(E, FH).astype(np.float32) * 0.1,
            rng.randn(E, FH, D).astype(np.float32) * 0.1,
            rng.randn(E, D).astype(np.float32) * 0.1]


def _x(b=4, s=8, seed=1):
    return np.random.RandomState(seed).randn(b, s, D).astype(np.float32)


def _jax_moe(x, w, gate, cf, wt):
    """y, aux and the gradients of sum(y * wt) + aux over (x, *w)."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.parallel import moe as jm

    def loss(x, *w):
        y, aux = jm.moe_ffn(x, *w, gate=gate, capacity_factor=cf)
        return (y * wt).sum() + aux, (y, aux)
    (_, (y, aux)), grads = jax.value_and_grad(
        loss, argnums=tuple(range(6)), has_aux=True)(
            jnp.asarray(x), *[jnp.asarray(a) for a in w])
    return np.asarray(y), float(aux), [np.asarray(g) for g in grads]


def _close_grads(got, want, what):
    for i, (g, j) in enumerate(zip(got, want)):
        np.testing.assert_allclose(
            g, j, rtol=1e-4, atol=2e-6 + 1e-5 * float(np.abs(j).max()),
            err_msg=f"{what} grad {i}")


def _tcfg(**kw):
    from paddle_tpu_torch.models import gpt
    kw.setdefault("remat", False)
    return gpt.GPTConfig(**GPT, dtype=torch.float32, **kw)


def _tokens(seed=0, b=B):
    return np.random.RandomState(seed).randint(
        0, GPT["vocab_size"], (b, S + 1)).astype(np.int64)


# ------------------------------------------------------------ single rank
@pytest.mark.parametrize("T,E_,cf", [(64, 4, 1.0), (64, 4, 1.25),
                                     (8, 8, 1.0), (8192, 8, 1.25),
                                     (100, 3, 0.7)])
def test_compute_capacity_matches_jax(T, E_, cf):
    from paddle_tpu.parallel import moe as jm
    from paddle_tpu_torch.parallel import moe as tm
    assert tm.compute_capacity(T, E_, cf) == jm.compute_capacity(T, E_, cf)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("capacity", [3, 16])
def test_topk_gating_matches_jax(k, capacity):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.parallel import moe as jm
    from paddle_tpu_torch.parallel import moe as tm
    T = 16
    probs = np.asarray(jax.nn.softmax(jnp.asarray(
        np.random.RandomState(k).randn(T, E).astype(np.float32) * 2)))
    jd, jc, ja = jm.topk_gating(jnp.asarray(probs), k, capacity)
    td, tc, ta = tm.topk_gating(torch.tensor(probs), k, capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    kept = float(td.sum())
    assert kept < T * k if capacity == 3 else kept == T * k


@pytest.mark.parametrize("gate", ["naive", "switch", "gshard"])
@pytest.mark.parametrize("cf", [0.5, 4.0])
def test_moe_ffn_and_gradients_match_jax(gate, cf):
    from paddle_tpu_torch.parallel import moe as tm
    w = _weights()
    x = _x()
    wt = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    jy, jaux, jgrads = _jax_moe(x, w, gate, cf, wt)
    tx = torch.tensor(x, requires_grad=True)
    tw = [torch.tensor(a, requires_grad=True) for a in w]
    y, aux = tm.moe_ffn(tx, *tw, gate=gate, capacity_factor=cf)
    ((y * torch.from_numpy(wt)).sum() + aux).backward()
    assert y.shape == x.shape and aux.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux.detach()), jaux, rtol=1e-6)
    _close_grads([t.grad.numpy() for t in [tx] + tw], jgrads, gate)
    # the dropping factor drops for the capacity gates, the other none
    probs = torch.softmax(tx.detach().reshape(-1, D) @ tw[0].detach(), -1)
    r = tm.route_tokens(probs, tm.GATES[gate].top_k,
                        cf if tm.GATES[gate].use_capacity else None)
    dropped = int((~r.keep).sum())
    assert dropped > 0 if (cf < 1 and gate != "naive") else dropped == 0


def test_moe_layer_matches_moe_ffn_of_its_weights():
    from paddle_tpu_torch.parallel import moe as tm
    layer = tm.MoELayer(D, FH, E, gate="gshard", capacity_factor=0.5,
                        device="cpu")
    assert [n for n, _ in layer.named_parameters()] == [
        "gate_w", "up_w", "up_b", "down_w", "down_b"]
    x = torch.from_numpy(_x())
    wt = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    y = layer(x)
    assert layer.aux_loss is not None and float(layer.aux_loss.detach()) > 0
    w = [p.detach().numpy() for p in layer.parameters()]
    jy, jaux, jgrads = _jax_moe(x.numpy(), w, "gshard", 0.5, wt)
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(layer.aux_loss.detach()), jaux,
                               rtol=1e-6)
    ((y * torch.from_numpy(wt)).sum() + layer.aux_loss).backward()
    _close_grads([p.grad.numpy() for p in layer.parameters()], jgrads[1:],
                 "MoELayer")
    with pytest.raises(ValueError):
        tm.MoELayer(8, 16, 2, gate="nope", device="cpu")


def _jax_params(jcfg):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.models import gpt as jg
    params = jg.init_gpt_params(jcfg, jax.random.PRNGKey(0))
    params["gate_w"] = params["gate_w"] * GATE_SCALE
    for name in ("moe_up_w", "moe_down_w"):
        params[name] = params[name] * EXPERT_SCALE
    return params


@pytest.fixture(scope="module")
def ref():
    """The JAX side: the MoE GPT's params (gate_w scaled for decisive
    routing), loss and gradients for switch and gshard, a 3-step jitted
    trajectory on the dropping capacity factor, and a greedy stream."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.models import gpt as jg
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    out = {}
    tokens = _tokens()
    for gate in ("switch", "gshard"):
        jcfg = jg.GPTConfig(**GPT, dtype=jnp.float32, remat=False,
                            moe_gate=gate, expert_capacity_factor=DROP_CF,
                            sequence_parallel=False)
        params = _jax_params(jcfg)
        loss, grads = jax.jit(jax.value_and_grad(functools.partial(
            jg.gpt_loss, cfg=jcfg)))(params, jnp.asarray(tokens))
        _, aux = jax.jit(functools.partial(jg._gpt_forward_impl, cfg=jcfg))(
            params, jnp.asarray(tokens)[:, :-1])
        out[gate] = dict(params=as_np(params), loss=float(loss),
                         aux=float(aux), grads=as_np(grads))
    jcfg = jg.GPTConfig(**GPT, dtype=jnp.float32, remat=False,
                        expert_capacity_factor=DROP_CF,
                        sequence_parallel=False)
    params = _jax_params(jcfg)
    step = jax.jit(functools.partial(jg.train_step, cfg=jcfg, lr=LR))
    p, opt = params, jg.init_opt_state(params)
    losses = []
    for _ in range(STEPS):
        lo, p, opt = step(p, opt, jnp.asarray(tokens))
        losses.append(float(lo))
    out["train"] = dict(losses=losses, final=as_np(p))
    # routing each dp2 rank's rows alone gives another loss: the world's
    # test would catch it
    vg = jax.jit(jax.value_and_grad(functools.partial(jg.gpt_loss,
                                                      cfg=jcfg)))
    halves = [vg(params, jnp.asarray(t))
              for t in (tokens[:B // 2], tokens[B // 2:])]
    _, grads = vg(params, jnp.asarray(tokens))
    out["local_routing_gap"] = abs(
        np.mean([float(h[0]) for h in halves]) - losses[0])
    out["local_routing_grad_gap"] = max(
        float(np.abs(np.asarray(grads[k]) - (np.asarray(halves[0][1][k])
                                             + np.asarray(halves[1][1][k]))
                     / 2).max() / np.abs(np.asarray(grads[k])).max())
        for k in grads)
    prompt = np.random.RandomState(5).randint(0, GPT["vocab_size"], (2, 5))
    gen = jg.greedy_generate(params, jnp.asarray(prompt), jcfg, 8)
    out["greedy"] = dict(prompt=prompt, tokens=np.asarray(gen))
    out["init"] = as_np(params)
    out["tokens"] = tokens
    return out


@pytest.mark.parametrize("gate", ["switch", "gshard"])
def test_gpt_moe_loss_and_gradients_match_jax(ref, gate):
    from paddle_tpu_torch.models import gpt as tg
    from paddle_tpu_torch.models.convert import params_from_jax
    want = ref[gate]
    cfg = _tcfg(moe_gate=gate, expert_capacity_factor=DROP_CF)
    p = params_from_jax(want["params"], device="cpu")
    tokens = torch.from_numpy(ref["tokens"])
    _, aux = tg._gpt_forward_impl(p, tokens[:, :-1], cfg)
    np.testing.assert_allclose(float(aux.detach()), want["aux"], rtol=1e-5)
    loss, grads = tg.loss_and_grads(p, tokens, cfg)
    np.testing.assert_allclose(float(loss), want["loss"], rtol=1e-4)
    assert sorted(grads) == sorted(want["grads"])
    for name, g in grads.items():
        j = want["grads"][name]
        np.testing.assert_allclose(g.numpy(), j, rtol=1e-3,
                                   atol=1e-5 * float(np.abs(j).max()),
                                   err_msg=name)


def test_gpt_moe_train_step_matches_jitted_jax(ref):
    from paddle_tpu_torch.models import gpt as tg
    from paddle_tpu_torch.models.convert import params_from_jax
    from paddle_tpu_torch.models.facade import make_train_step
    cfg = _tcfg(expert_capacity_factor=DROP_CF, remat=True)
    step = make_train_step(tg.train_step, cfg=cfg, lr=LR)
    p = params_from_jax(ref["init"], device="cpu")
    opt = tg.init_opt_state(p)
    tokens = torch.from_numpy(ref["tokens"])
    losses = [float(step(p, opt, tokens)[0]) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, ref["train"]["losses"], rtol=1e-4)
    for name, v in p.items():
        np.testing.assert_allclose(v.numpy(), ref["train"]["final"][name],
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def test_gpt_moe_remat_policies_equal_no_remat(ref):
    """"all_but_mlp" puts no checkpoint around an MoE FFN; every policy
    gives the no-remat loss and gradients to the bit."""
    from paddle_tpu_torch.models import gpt as tg
    from paddle_tpu_torch.models.convert import params_from_jax
    tokens = torch.from_numpy(ref["tokens"])
    runs = [tg.loss_and_grads(params_from_jax(ref["init"], device="cpu"),
                              tokens, _tcfg(expert_capacity_factor=DROP_CF,
                                            remat=remat, remat_policy=pol))
            for remat, pol in [(False, "full"), (True, "full"),
                               (True, "all_but_mlp")]]
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for name, g in grads.items():
            assert torch.equal(g, runs[0][1][name]), name


def test_gpt_moe_greedy_stream_equals_jax(ref):
    from paddle_tpu_torch.models import gpt as tg
    from paddle_tpu_torch.models.convert import params_from_jax
    cfg = _tcfg(expert_capacity_factor=DROP_CF)
    p = params_from_jax(ref["init"], device="cpu")
    got = tg.greedy_generate(p, torch.from_numpy(ref["greedy"]["prompt"]),
                             cfg, 8)
    np.testing.assert_array_equal(got.numpy(), ref["greedy"]["tokens"])


def test_params_from_jax_carries_the_moe_tree(ref):
    """The port's init draws the reference's leaves and shapes, the MoE
    leaves in the mlp_* leaves' place, and params_from_jax carries a
    JAX MoE tree across unchanged."""
    from paddle_tpu_torch.models import gpt as tg
    from paddle_tpu_torch.models.convert import params_from_jax
    mine = tg.init_gpt_params(_tcfg(), seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: v.shape for k, v in ref["init"].items()}
    assert not any(k.startswith("mlp_") for k in mine)
    got = params_from_jax(ref["init"], device="cpu")
    for k, v in ref["init"].items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v)


# -------------------------------------------------------------- rank side
def _moe_rank(rank):
    """moe_ffn on mesh {dp 2, ep 2}: this rank's y rows, aux, x's
    gradient and the weights' gradients summed over dp (the experts'
    on this rank's experts only)."""
    from paddle_tpu_torch.parallel import build_mesh
    from paddle_tpu_torch.parallel import moe as tm
    from paddle_tpu_torch.parallel.collective import all_reduce
    from paddle_tpu_torch.parallel.layout import ShardLayout
    from paddle_tpu_torch.parallel.mesh import axis_group, axis_index
    mesh = build_mesh({"dp": 2, "ep": 2}, device_type="cpu")
    layout = ShardLayout(mesh, {}, False, batch_axes=("dp",))
    dp, ep = axis_index(mesh, "dp"), axis_index(mesh, "ep")
    w = _weights()
    x = _x()
    wt = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    rows = slice(2 * dp, 2 * dp + 2)
    experts = slice(2 * ep, 2 * ep + 2)
    tx = torch.tensor(x[rows], requires_grad=True)
    tw = [torch.tensor(w[0], requires_grad=True)] + [
        torch.tensor(a[experts], requires_grad=True) for a in w[1:]]
    out = {}
    for gate in ("switch", "gshard", "naive"):
        for t in [tx] + tw:
            t.grad = None
        y, aux = tm.moe_ffn(tx, *tw, gate=gate, capacity_factor=DROP_CF,
                            layout=layout)
        # the rank's share of sum(y * wt) + aux: its rows, aux over the
        # dp ranks that hold distinct rows
        ((y * torch.from_numpy(wt[rows])).sum() + aux / 2).backward()
        g_dp = axis_group(mesh, "dp")
        out[gate] = dict(
            y=y.detach().numpy(), aux=float(aux), x_grad=tx.grad.numpy(),
            w_grads=[all_reduce(t.grad, g_dp).numpy() for t in tw],
            rows=(rows.start, rows.stop), experts=(experts.start,
                                                   experts.stop))
    # global_scatter / global_gather: equal counts, the all-to-all pair
    from paddle_tpu_torch.parallel import global_gather, global_scatter
    g = axis_group(mesh, "ep")
    blocks = torch.arange(8.0).reshape(4, 2) + 100 * rank
    sent = global_scatter(blocks, [2, 2], [2, 2], group=g)
    out["scatter"] = sent.tolist()
    out["gather_back"] = global_gather(sent, [2, 2], [2, 2],
                                       group=g).tolist()
    with pytest.raises(NotImplementedError):
        global_scatter(blocks, [3, 1], [3, 1], group=g)
    return out


def _step_rank(case, init):
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.models.facade import make_train_step, mesh_plan
    from paddle_tpu_torch.parallel import build_mesh
    axes = {"dp": {"dp": 2, "ep": 2}, "fsdp": {"fsdp": 2, "ep": 2}}[case]
    cfg = _tcfg(expert_capacity_factor=DROP_CF, remat=True)
    mesh = build_mesh(axes, device_type="cpu")
    # the plan-less mesh, and a TrainPlan built by hand for fsdp
    plan = mesh_plan(cfg, mesh) if case == "fsdp" else None
    step = make_train_step(gpt.train_step, cfg=cfg, mesh=mesh, plan=plan,
                           lr=LR)
    first = step.plan
    params = {k: torch.from_numpy(v) for k, v in init.items()}
    opt = gpt.init_opt_state(params)
    tokens = _tokens()
    losses = []
    for _ in range(STEPS):
        loss, params, opt = step(params, opt, tokens)
        losses.append(float(loss))
    out = dict(losses=losses,
               full={k: v.numpy() for k, v in
                     step.gather_full(params).items()},
               local_experts=tuple(params["moe_up_w"].shape),
               up_spec=tuple(step.in_pins[0]["moe_up_w"].spec),
               plan_given=plan is not None, plan_axes=dict(first.axes),
               plan_batch_axes=tuple(first.batch_axes),
               plan_kept=step.plan is first)
    # a rebuild on the same mesh keeps a given plan and works the mesh's
    # own out again
    step.rebuild(mesh=mesh)
    out.update(rebuilt_is_given=step.plan is plan,
               rebuilt_axes=dict(step.plan.axes))
    return out


def _rank_main(rank, world, workdir):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from paddle_tpu_torch.parallel import init_parallel_env
    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    os.environ["WORLD_SIZE"] = str(world)
    init_parallel_env(backend="gloo", timeout_s=120,
                      init_method=f"file://{workdir}/store")
    init = torch.load(os.path.join(workdir, "init.pt"), weights_only=False)
    out = {}
    try:
        out["moe"] = _moe_rank(rank)
        for case in ("dp", "fsdp"):
            out[case] = _step_rank(case, init)
    finally:
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world4(ref):
    import torch.multiprocessing as mp
    workdir = tempfile.mkdtemp(prefix="moe_world_")
    torch.save(ref["init"], os.path.join(workdir, "init.pt"))
    mp.spawn(_rank_main, args=(4, workdir), nprocs=4, join=True)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(4)]


@pytest.mark.parametrize("gate", ["switch", "gshard", "naive"])
def test_dp2_ep2_moe_ffn_matches_jax_global_batch(world4, gate):
    w = _weights()
    x = _x()
    wt = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    jy, jaux, jgrads = _jax_moe(x, w, gate, DROP_CF, wt)
    for rank, res in enumerate(world4):
        got = res["moe"][gate]
        r0, r1 = got["rows"]
        e0, e1 = got["experts"]
        np.testing.assert_allclose(got["y"], jy[r0:r1], rtol=1e-5,
                                   atol=1e-6, err_msg=f"rank {rank}")
        np.testing.assert_allclose(got["aux"], jaux, rtol=1e-6)
        want = [jgrads[0][r0:r1], jgrads[1]] + [g[e0:e1]
                                                 for g in jgrads[2:]]
        _close_grads([got["x_grad"]] + got["w_grads"], want,
                     f"{gate} rank {rank}")


def test_global_scatter_and_gather_over_ep(world4):
    # mesh {dp 2, ep 2}: rank = 2 * dp + ep; the ep group is {2dp, 2dp+1}
    for rank, res in enumerate(world4):
        peer = rank ^ 1
        mine = np.arange(8.0).reshape(4, 2)
        ep = rank % 2
        blocks = {rank: mine + 100 * rank, peer: mine + 100 * peer}
        want = np.concatenate([blocks[r][2 * ep:2 * ep + 2]
                               for r in sorted(blocks)])
        assert res["moe"]["scatter"] == want.tolist()
        assert res["moe"]["gather_back"] == blocks[rank].tolist()


@pytest.mark.parametrize("case", ["dp", "fsdp"])
def test_hand_built_mesh_step_holds_one_plan(world4, case):
    # with no plan the step works the mesh's own out once (mesh_plan) and
    # keeps it across calls; a plan built by hand is the one it keeps
    axes = {"dp": {"dp": 2, "ep": 2}, "fsdp": {"fsdp": 2, "ep": 2}}[case]
    for res in world4:
        got = res[case]
        assert got["plan_given"] == (case == "fsdp")
        assert got["plan_axes"] == axes
        assert got["plan_batch_axes"] == (case,)
        assert got["plan_kept"]
        assert got["rebuilt_is_given"] == (case == "fsdp")
        assert got["rebuilt_axes"] == axes


@pytest.mark.parametrize("case", ["dp", "fsdp"])
def test_dp2_ep2_gpt_step_matches_jax_unsharded(ref, world4, case):
    want = ref["train"]
    # a rank-local routing would be off by this much at step 1
    assert ref["local_routing_gap"] > 10 * 2e-4 * abs(want["losses"][0])
    assert ref["local_routing_grad_gap"] > 0.1
    for res in world4:
        got = res[case]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=2e-4, atol=2e-4)
        assert got["losses"] == world4[0][case]["losses"]
        assert got["local_experts"][1] == GPT["num_experts"] // 2
        assert got["up_spec"] == (None, "ep", None, None)
    for leaf, v in world4[0][case]["full"].items():
        np.testing.assert_allclose(v, want["final"][leaf], rtol=2e-4,
                                   atol=2e-4, err_msg=f"{case} {leaf}")
