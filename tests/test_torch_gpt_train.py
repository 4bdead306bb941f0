"""The port's GPT train step (models/gpt.py, models/facade.py) against the
JAX package's, from one params tree carried across with params_from_jax:
logits and loss, every gradient leaf, and a 5-step AdamW trajectory, at
vocab 512, hidden 64, 2 layers, 4 heads, S 64, B 2, f32 activations.
On the CPU the port runs the plain versions of its kernels, as the JAX
package runs its jax-level attention and loss there.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from paddle_tpu.models import gpt as jg
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import GPTModel
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.models.convert import opt_state_from_jax, params_from_jax
from paddle_tpu_torch.models.facade import make_train_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file runs (the suite runs several
    pytest-xdist workers side by side); restored after, so other files
    in the same worker keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPE = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
             max_seq_len=64)
B, S = 2, 64
STEPS = 5


def _tcfg(**kw):
    return tg.GPTConfig(**SHAPE, dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def ref():
    """The JAX side, computed once: params, tokens, logits, loss, grads
    and a 5-step jitted train_step trajectory."""
    jcfg = jg.GPTConfig(**SHAPE, dtype=jnp.float32, remat=False)
    params = jg.init_gpt_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(
        0, SHAPE["vocab_size"], size=(B, S + 1))
    jt = jnp.asarray(tokens)
    logits = jg.gpt_forward(params, jt[:, :-1], jcfg)
    loss, grads = jax.value_and_grad(
        lambda p: jg.gpt_loss(p, jt, jcfg))(params)
    step = jax.jit(functools.partial(jg.train_step, cfg=jcfg))
    p, opt = params, jg.init_opt_state(params)
    losses = []
    for _ in range(STEPS):
        lo, p, opt = step(p, opt, jt)
        losses.append(float(lo))
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return dict(params=as_np(params), tokens=tokens,
                logits=np.asarray(logits), loss=float(loss),
                grads=as_np(grads), losses=losses, final=as_np(p),
                opt0=as_np(jg.init_opt_state(params)))


def _params(ref):
    return params_from_jax(ref["params"], device="cpu")


def test_logits_and_loss_match_jax(ref):
    cfg = _tcfg(remat=False)
    p = _params(ref)
    tokens = torch.from_numpy(ref["tokens"])
    logits = tg.gpt_forward(p, tokens[:, :-1], cfg)
    assert logits.shape == (B, S, SHAPE["vocab_size"])
    np.testing.assert_allclose(logits.detach().numpy(), ref["logits"],
                               rtol=1e-4, atol=1e-5)
    loss = tg.gpt_loss(p, {"tokens": tokens}, cfg)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-4,
                               atol=1e-5)


def test_every_gradient_leaf_matches_jax(ref):
    loss, grads = tg.loss_and_grads(_params(ref),
                                    torch.from_numpy(ref["tokens"]),
                                    _tcfg(remat=False))
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-4)
    assert sorted(grads) == sorted(ref["grads"])
    for name, g in grads.items():
        jg_ = ref["grads"][name]
        assert g.shape == jg_.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(
            g.numpy(), jg_, rtol=1e-3,
            atol=1e-5 * float(np.abs(jg_).max()), err_msg=name)


def test_five_step_trajectory_matches_jitted_jax_train_step(ref):
    cfg = _tcfg(remat=True, remat_policy="dots")
    step = make_train_step(tg.train_step, cfg=cfg)
    p = _params(ref)
    opt = opt_state_from_jax(ref["opt0"], device="cpu")
    tokens = torch.from_numpy(ref["tokens"])
    losses = []
    for _ in range(STEPS):
        loss, p2, opt2 = step(p, opt, tokens)
        assert p2 is p and opt2 is opt          # updated in place
        losses.append(float(loss))
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4)
    assert float(opt["step"]) == STEPS
    for name, v in p.items():
        np.testing.assert_allclose(v.numpy(), ref["final"][name], rtol=1e-3,
                                   atol=1e-5, err_msg=name)


def test_remat_policies_give_identical_losses_and_gradients(ref):
    tokens = torch.from_numpy(ref["tokens"])
    runs = {}
    for remat, policy in [(False, "full"), (True, "full"), (True, "dots")]:
        runs[(remat, policy)] = tg.loss_and_grads(
            _params(ref), tokens, _tcfg(remat=remat, remat_policy=policy))
    base_loss, base_grads = runs[(False, "full")]
    for key, (loss, grads) in runs.items():
        torch.testing.assert_close(loss, base_loss, rtol=0, atol=0)
        for name, g in grads.items():
            torch.testing.assert_close(g, base_grads[name], rtol=0, atol=0,
                                       msg=f"{key} {name}")


NEW_POLICIES = ["dots_flash", "offload_dots", "all_but_mlp"]


@pytest.mark.parametrize("policy", NEW_POLICIES)
def test_policy_loss_and_gradients_equal_no_remat_bit_for_bit(ref, policy):
    """A remat policy trades memory for compute and nothing else: the
    loss and every gradient leaf are the no-remat step's bits."""
    tokens = torch.from_numpy(ref["tokens"])
    base_loss, base_grads = tg.loss_and_grads(_params(ref), tokens,
                                              _tcfg(remat=False))
    loss, grads = tg.loss_and_grads(
        _params(ref), tokens, _tcfg(remat=True, remat_policy=policy))
    torch.testing.assert_close(loss, base_loss, rtol=0, atol=0)
    assert sorted(grads) == sorted(base_grads)
    for name, g in grads.items():
        torch.testing.assert_close(g, base_grads[name], rtol=0, atol=0,
                                   msg=f"{policy} {name}")


def _one_step(train_step, params, opt, tokens, cfg):
    """(loss, sum of wte after the step) of one step at lr 1e-4, as
    tests/test_remat_policies.py reads the JAX step."""
    loss, params, _ = train_step(params, opt, tokens, cfg=cfg, lr=1e-4)
    return float(loss), float(np.sum(np.asarray(params["wte"],
                                                dtype=np.float64)))


@pytest.mark.parametrize("policy", NEW_POLICIES)
def test_policy_step_matches_the_jax_step_under_the_same_policy(ref,
                                                                policy):
    """One train step under `policy` against the JAX package's jitted
    train_step under the same policy, with the tolerances of
    tests/test_remat_policies.py (loss 1e-5 absolute, the updated wte's
    sum 1e-6 relative)."""
    jcfg = jg.GPTConfig(**SHAPE, dtype=jnp.float32, remat=True,
                        remat_policy=policy)
    jparams = jax.tree_util.tree_map(jnp.asarray, ref["params"])

    def jax_step(p, o, t, cfg, lr):
        return jax.jit(functools.partial(jg.train_step, cfg=cfg,
                                         lr=lr))(p, o, t)
    want = _one_step(jax_step, jparams, jg.init_opt_state(jparams),
                     jnp.asarray(ref["tokens"]), jcfg)
    p = _params(ref)
    got = _one_step(tg.train_step, p, tg.init_opt_state(p),
                    torch.from_numpy(ref["tokens"]),
                    _tcfg(remat=True, remat_policy=policy))
    assert got[0] == pytest.approx(want[0], abs=1e-5)
    assert got[1] == pytest.approx(want[1], rel=1e-6)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


def test_remat_recomputes_the_attention_forward_and_dots_saves_matmuls(
        ref, monkeypatch):
    """Attention forwards and matmuls a step runs under each policy. The
    flash forward is counted where the `paddle_tpu_torch::flash_fwd`
    op's CPU kernel runs the plain forward, so a policy that saves the
    op ("dots_flash") is seen to skip it. Under "full", "dots" and
    "offload_dots" every block's attention forward runs again in the
    backward (so the kernel's launch count a step is 2L); "dots_flash"
    and "all_but_mlp" (no block checkpoint) run it once (L)."""
    tokens = torch.from_numpy(ref["tokens"])
    L = SHAPE["num_layers"]
    calls = []

    def counting_ref(*a, **k):
        calls.append(1)
        return plain_fwd(*a, **k)
    plain_fwd = fa.mha_fwd_ref
    monkeypatch.setattr(fa, "mha_fwd_ref", counting_ref)
    fwd_calls, mm = {}, {}
    for remat, policy in [(False, "full"), (True, "full"), (True, "dots"),
                          (True, "dots_flash"), (True, "offload_dots"),
                          (True, "all_but_mlp")]:
        calls.clear()
        with _CountMM() as counter:
            tg.loss_and_grads(_params(ref), tokens,
                              _tcfg(remat=remat, remat_policy=policy))
        fwd_calls[(remat, policy)] = len(calls)
        mm[(remat, policy)] = counter.mm
    assert fwd_calls == {(False, "full"): L, (True, "full"): 2 * L,
                         (True, "dots"): 2 * L, (True, "dots_flash"): L,
                         (True, "offload_dots"): 2 * L,
                         (True, "all_but_mlp"): L}
    # Non-reentrant checkpoint stops its recompute once the last tensor
    # the backward saved is back: the inputs of the block's down
    # projection, packed before that matmul runs. So "full" reruns the
    # block's matmuls up to it (qkv, out and up: 3 a layer); "dots" and
    # "dots_flash" answer those three from their saved outputs and
    # "offload_dots" from its host copies, rerunning none; "all_but_mlp"
    # recomputes only its FFN checkpoint, up to the down projection: the
    # up matmul (1 a layer)
    base = mm[(False, "full")]
    assert mm[(True, "full")] == base + 3 * L
    assert mm[(True, "dots")] == base
    assert mm[(True, "dots_flash")] == base
    assert mm[(True, "offload_dots")] == base
    assert mm[(True, "all_but_mlp")] == base + L


def test_make_train_step_has_no_sharded_step_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        make_train_step(tg.train_step, cfg=_tcfg(), mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        make_train_step(tg.train_step, cfg=_tcfg(), plan=object())


def test_model_forward_and_loss_over_the_functional_core(ref):
    cfg = _tcfg(remat=False)
    model = GPTModel(cfg, device="cpu", params=_params(ref))
    tokens = torch.from_numpy(ref["tokens"])
    np.testing.assert_allclose(model(tokens[:, :-1]).detach().numpy(),
                               ref["logits"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(model.loss(tokens)), ref["loss"],
                               rtol=1e-4)
