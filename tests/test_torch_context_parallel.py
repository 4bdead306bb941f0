"""The port's context parallelism (parallel/context_parallel.py, GPT's
`context_parallel` route over an 'sp' mesh axis) and its all-to-all
(parallel/collective.py) against the JAX package, on the same numpy
inputs, at the highest matmul precision (tests/conftest.py), f32:

- ring and Ulysses attention over sp4, causal and not, at S 32 and at
  S 30, which the ring size does not divide (padded and masked with
  kv_len): the output and the gradients of q, k and v against the JAX
  package's ring_attention / ulysses_attention on a 4-device mesh
  (atol 2e-6, 1e-5 of the largest gradient); Ulysses raises where the
  axis does not divide the heads;
- the GPT step (vocab 256, hidden 32, 2 layers, 4 heads, S 30, B 2,
  remat "full", 3 steps) with context_parallel "ring" and "ulysses" on
  the plan-less mesh {sp 4}, and "ring" on {dp 2, sp 2}, against the
  JAX context_parallel="none" unsharded step (losses rtol 2e-4, final
  params rtol/atol 2e-4); the mp fallback raises, naming ROADMAP A6e;
- all_to_all on the "gloo" route and the "gloo_cuda_via_all_reduce"
  route (forced on CPU tensors): each against the chunks every rank
  sent, the two routes bit for bit, and the backward the inverse
  all-to-all.

One spawned gloo world of 4 ranks (one torch thread a rank) runs the
port's side; the rank processes import this module without jax.
"""
import functools
import os
import tempfile

import numpy as np
import pytest
import torch

GPT = dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=64)
B, S, STEPS, LR = 2, 30, 3, 1e-3
ATTN = [(kind, causal, s) for kind in ("ring", "ulysses")
        for causal in (True, False) for s in (32, 30)]
STEP_CASES = [("ring", {"sp": 4}), ("ulysses", {"sp": 4}),
              ("ring", {"dp": 2, "sp": 2})]


def _case_id(case):
    kind, axes = case
    return kind + "-" + "_".join(f"{a}{n}" for a, n in axes.items())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(s, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, s, 4, 8).astype(np.float32) for _ in range(4)]


def _tokens(seed=0):
    return np.random.RandomState(seed).randint(
        0, GPT["vocab_size"], (B, S + 1)).astype(np.int64)


# -------------------------------------------------------------- rank side
def _attention_rank(rank):
    from paddle_tpu_torch.parallel import build_mesh
    from paddle_tpu_torch.parallel import context_parallel as cp
    mesh = build_mesh({"sp": 4}, device_type="cpu")
    out = {}
    for kind, causal, s in ATTN:
        q, k, v, wt = (torch.tensor(a) for a in _qkv(s))
        for t in (q, k, v):
            t.requires_grad_()
        fn = cp.ring_attention if kind == "ring" else cp.ulysses_attention
        y = fn(q, k, v, mesh, axis="sp", causal=causal)
        (y * wt).sum().backward()
        out[(kind, causal, s)] = dict(
            y=y.detach().numpy(), grads=[t.grad.numpy() for t in (q, k, v)])
    q = torch.zeros(2, 8, 6, 8)
    try:
        cp.ulysses_attention(q, q, q, mesh, axis="sp")
        out["ulysses_heads_raise"] = False
    except ValueError:
        out["ulysses_heads_raise"] = True
    return out


def _all_to_all_rank(rank):
    import torch.distributed as dist
    from paddle_tpu_torch.parallel import collective as col
    g = dist.new_group([0, 1, 2, 3])
    out = {}
    for route in ("gloo", "gloo_cuda_via_all_reduce"):
        x = (torch.arange(4 * 8 * 2, dtype=torch.float32).reshape(4, 8, 2)
             + 1000 * rank).requires_grad_()
        y = col.all_to_all(x, g, 1, 0, route=route)
        w = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape)
        (y * w).sum().backward()
        out[route] = dict(y=y.detach().numpy(), grad=x.grad.numpy(),
                          w=w.numpy())
    return out


def _step_rank(case, init):
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.models.facade import make_train_step
    from paddle_tpu_torch.parallel import build_mesh
    kind, axes = case
    cfg = gpt.GPTConfig(**GPT, dtype=torch.float32, remat=True,
                        context_parallel=kind)
    mesh = build_mesh(axes, device_type="cpu")
    step = make_train_step(gpt.train_step, cfg=cfg, mesh=mesh, lr=LR)
    params = {k: torch.from_numpy(v) for k, v in init.items()}
    opt = gpt.init_opt_state(params)
    losses = []
    for _ in range(STEPS):
        loss, params, opt = step(params, opt, _tokens())
        losses.append(float(loss))
    return dict(losses=losses,
                full={k: v.numpy() for k, v in
                      step.gather_full(params).items()})


def _mp_fallback_raises():
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel import build_mesh, use_mesh
    cfg = gpt.GPTConfig(**GPT, dtype=torch.float32, remat=False,
                        context_parallel="ring")
    params = gpt.init_gpt_params(cfg, device="cpu")
    with use_mesh(build_mesh({"mp": 4}, device_type="cpu")):
        try:
            gpt.gpt_loss(params, torch.from_numpy(_tokens()), cfg)
        except NotImplementedError as e:
            return "A6e" in str(e)
    return False


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
        out["attention"] = _attention_rank(rank)
        out["all_to_all"] = _all_to_all_rank(rank)
        for case in STEP_CASES:
            out[_case_id(case)] = _step_rank(case, init)
        out["mp_fallback_raises"] = _mp_fallback_raises()
    finally:
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
        dist.destroy_process_group()


# -------------------------------------------------------------- test side
@pytest.fixture(scope="module")
def ref():
    """The JAX side: ring and Ulysses on a 4-device mesh, and the
    unsharded GPT step."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.models import gpt as jg
    from paddle_tpu.parallel import context_parallel as jcp
    from paddle_tpu.parallel.mesh import build_mesh
    mesh = build_mesh({"sp": 4}, devices=jax.devices()[:4])
    out = {}
    for kind, causal, s in ATTN:
        q, k, v, wt = (jnp.asarray(a) for a in _qkv(s))
        fn = jcp.ring_attention if kind == "ring" else jcp.ulysses_attention

        def loss(q, k, v, fn=fn, causal=causal, wt=wt):
            y = fn(q, k, v, mesh, axis="sp", causal=causal)
            return (y * wt).sum(), y
        (_, y), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
        out[(kind, causal, s)] = dict(y=np.asarray(y),
                                      grads=[np.asarray(g) for g in grads])
    jcfg = jg.GPTConfig(**GPT, dtype=jnp.float32, remat=True,
                        sequence_parallel=False)
    params = jg.init_gpt_params(jcfg, jax.random.PRNGKey(0))
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    init = as_np(params)
    step = jax.jit(functools.partial(jg.train_step, cfg=jcfg, lr=LR))
    p, opt = params, jg.init_opt_state(params)
    losses = []
    for _ in range(STEPS):
        lo, p, opt = step(p, opt, jnp.asarray(_tokens()))
        losses.append(float(lo))
    out["train"] = dict(init=init, losses=losses, final=as_np(p))
    return out


@pytest.fixture(scope="module")
def world4(ref):
    import torch.multiprocessing as mp
    workdir = tempfile.mkdtemp(prefix="cp_world_")
    torch.save(ref["train"]["init"], os.path.join(workdir, "init.pt"))
    mp.spawn(_rank_main, args=(4, workdir), nprocs=4, join=True)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(4)]


@pytest.mark.parametrize("case", ATTN, ids=[
    f"{k}-{'causal' if c else 'full'}-S{s}" for k, c, s in ATTN])
def test_ring_and_ulysses_match_jax(ref, world4, case):
    want = ref[case]
    for rank, res in enumerate(world4):
        got = res["attention"][case]
        np.testing.assert_allclose(got["y"], want["y"], rtol=1e-5,
                                   atol=2e-6, err_msg=f"rank {rank}")
        for name, g, j in zip("qkv", got["grads"], want["grads"]):
            np.testing.assert_allclose(
                g, j, rtol=1e-4, atol=2e-6 + 1e-5 * float(np.abs(j).max()),
                err_msg=f"rank {rank} d{name}")


def test_ulysses_raises_where_the_axis_does_not_divide_the_heads(world4):
    assert all(res["attention"]["ulysses_heads_raise"] for res in world4)


@pytest.mark.parametrize("case", STEP_CASES, ids=[_case_id(c)
                                                  for c in STEP_CASES])
def test_cp_gpt_step_matches_jax_unsharded(ref, world4, case):
    want = ref["train"]
    cid = _case_id(case)
    for res in world4:
        np.testing.assert_allclose(res[cid]["losses"], want["losses"],
                                   rtol=2e-4, atol=2e-4)
        assert res[cid]["losses"] == world4[0][cid]["losses"]
    for leaf, v in world4[0][cid]["full"].items():
        np.testing.assert_allclose(v, want["final"][leaf], rtol=2e-4,
                                   atol=2e-4, err_msg=f"{cid} {leaf}")


def test_cp_on_the_mp_axis_raises_naming_the_roadmap(world4):
    assert all(res["mp_fallback_raises"] for res in world4)


@pytest.mark.parametrize("route", ["gloo", "gloo_cuda_via_all_reduce"])
def test_all_to_all_routes(world4, route):
    xs = [np.arange(64, dtype=np.float32).reshape(4, 8, 2) + 1000 * r
          for r in range(4)]
    for rank, res in enumerate(world4):
        got = res["all_to_all"][route]
        # chunk `rank` of every rank's dim 1, stacked along dim 0
        want = np.concatenate([np.split(x, 4, axis=1)[rank] for x in xs],
                              0)
        np.testing.assert_array_equal(got["y"], want)
        # the backward is the inverse all-to-all of each rank's weights
        ws = [world4[r]["all_to_all"][route]["w"] for r in range(4)]
        back = np.concatenate([np.split(w, 4, axis=0)[rank] for w in ws], 1)
        np.testing.assert_array_equal(got["grad"], back)
        other = res["all_to_all"]["gloo"]
        assert got["y"].tobytes() == other["y"].tobytes()
