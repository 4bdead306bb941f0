"""The port's Llama train step (models/llama.py) against the JAX
package's, from one params tree carried across with params_from_jax:
logits and loss, every gradient leaf, and a 5-step AdamW trajectory, at
vocab 1000, hidden 64, 2 layers, 4 heads over 2 KV heads (GQA), S 32,
B 2, f32 activations (SiLU * up runs in the activation dtype, so parity
is held in f32). On the CPU the port runs the plain versions of its
kernels, as the JAX package runs its jax-level attention and loss there.
The parts the block is made of, the GQA head mapping and the RoPE
rotation, are held against the reference's on their own.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as jg
from paddle_tpu.models import llama as jl
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import LlamaModel
from paddle_tpu_torch.models import llama as tl
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


SHAPE = dict(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=32)
B, S = 2, 32
STEPS = 5
# TinyLlama-1.1B (TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T
# config.json); the head is tied to wte, as every Llama of the repo
TINYLLAMA = dict(vocab_size=32000, hidden_size=2048, num_layers=22,
                 num_heads=32, num_kv_heads=4, max_seq_len=2048,
                 rope_theta=10000.0, rms_eps=1e-5)


def _tcfg(**kw):
    return tl.LlamaConfig(**SHAPE, dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def ref():
    """The JAX side, computed once: params, tokens, logits, loss, grads
    and a 5-step jitted train_step trajectory."""
    jcfg = jl.LlamaConfig(**SHAPE, dtype=jnp.float32, remat=False)
    params = jl.init_llama_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(
        0, SHAPE["vocab_size"], size=(B, S + 1))
    jt = jnp.asarray(tokens)
    logits = jl.llama_forward(params, jt[:, :-1], jcfg)
    loss, grads = jax.value_and_grad(
        lambda p: jl.llama_loss(p, jt, jcfg))(params)
    step = jax.jit(functools.partial(jl.train_step, cfg=jcfg))
    p, opt = params, jg.init_opt_state(params)
    losses = []
    for _ in range(STEPS):
        lo, p, opt = step(p, opt, jt)
        losses.append(float(lo))
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return dict(params=as_np(params), tokens=tokens,
                logits=np.asarray(logits), loss=float(loss),
                grads=as_np(grads), losses=losses, final=as_np(p),
                final_opt=as_np(opt), opt0=as_np(jg.init_opt_state(params)))


def _params(ref):
    return params_from_jax(ref["params"], device="cpu")


def test_logits_and_loss_match_jax(ref):
    cfg = _tcfg(remat=False)
    p = _params(ref)
    tokens = torch.from_numpy(ref["tokens"])
    logits = tl.llama_forward(p, tokens[:, :-1], cfg)
    assert logits.shape == (B, S, SHAPE["vocab_size"])
    np.testing.assert_allclose(logits.detach().numpy(), ref["logits"],
                               rtol=1e-4, atol=1e-5)
    loss = tl.llama_loss(p, {"tokens": tokens}, cfg)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-4,
                               atol=1e-5)


def test_every_gradient_leaf_matches_jax(ref):
    loss, grads = tl.loss_and_grads(_params(ref),
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
    cfg = _tcfg(remat=True)
    step = make_train_step(tl.train_step, cfg=cfg)
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


def test_opt_state_converts_from_jax_after_training(ref):
    """convert.py carries the Llama tree's trained AdamW state by leaf
    name, as it does GPT's."""
    opt = opt_state_from_jax(ref["final_opt"], device="cpu")
    assert float(opt["step"]) == STEPS
    assert sorted(opt["m"]) == sorted(ref["params"])
    for name, m in opt["m"].items():
        np.testing.assert_array_equal(m.numpy(), ref["final_opt"]["m"][name])
        assert opt["v"][name].dtype == torch.float32


def test_remat_gives_identical_loss_and_gradients(ref):
    tokens = torch.from_numpy(ref["tokens"])
    base_loss, base = tl.loss_and_grads(_params(ref), tokens,
                                        _tcfg(remat=False))
    loss, grads = tl.loss_and_grads(_params(ref), tokens, _tcfg(remat=True))
    torch.testing.assert_close(loss, base_loss, rtol=0, atol=0)
    for name, g in grads.items():
        torch.testing.assert_close(g, base[name], rtol=0, atol=0, msg=name)


def test_remat_recomputes_the_attention_forward(ref, monkeypatch):
    """Under remat every block's attention forward runs again in the
    backward, so the flash kernel launches 2L times a step (44 at 22
    layers), dq and dk/dv L times."""
    tokens = torch.from_numpy(ref["tokens"])
    L = SHAPE["num_layers"]
    counts = {}
    for remat in (False, True):
        calls = {"fwd": 0, "bwd": 0}

        def fwd(*a, **k):
            calls["fwd"] += 1
            return fa.mha_fwd_ref(*a, **k)

        def bwd(*a, **k):
            calls["bwd"] += 1
            return fa.mha_bwd_ref(*a, **k)
        monkeypatch.setattr(tl, "flash_attention_fn", functools.partial(
            fa.flash_attention_fn, fwd=fwd, bwd=bwd))
        tl.loss_and_grads(_params(ref), tokens, _tcfg(remat=remat))
        counts[remat] = dict(calls)
    assert counts == {False: {"fwd": L, "bwd": L},
                      True: {"fwd": 2 * L, "bwd": L}}


def test_gqa_head_mapping_matches_jnp_repeat():
    """repeat_interleave keeps jnp.repeat's order (KV head j serves query
    heads j*r .. j*r + r - 1); expand/repeat would tile it."""
    x = np.random.default_rng(1).standard_normal((2, 5, 4, 8),
                                                 dtype=np.float32)
    want = np.asarray(jnp.repeat(jnp.asarray(x), 8, axis=2))
    got = torch.from_numpy(x).repeat_interleave(8, dim=2).numpy()
    np.testing.assert_array_equal(got, want)
    tiled = torch.from_numpy(x).repeat(1, 1, 8, 1).numpy()
    assert not np.array_equal(tiled, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_apply_rope(dtype):
    """Interleaved pairs rotated in f32, against _rope_tables and
    _apply_rope of the reference; bf16 inputs round once on the way
    out."""
    S_, hd = 48, 16
    x = np.random.default_rng(2).standard_normal((2, S_, 3, hd),
                                                 dtype=np.float32)
    tx = torch.from_numpy(x)
    if dtype == "bfloat16":
        tx = tx.to(torch.bfloat16)
    jx = jnp.asarray(tx.float().numpy()).astype(
        jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    cos, sin = tl._rope_tables(S_, hd, 10000.0)
    jcos, jsin = jl._rope_tables(S_, hd, 10000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=1e-6,
                               atol=1e-6)
    got = tl._apply_rope(tx, cos, sin)
    want = np.asarray(jl._apply_rope(jx, jcos, jsin).astype(jnp.float32))
    assert got.dtype == tx.dtype
    step = 2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -20
    np.testing.assert_allclose(got.float().numpy(), want, rtol=step,
                               atol=1e-5)
    # pairs, not halves: position 0 leaves x unchanged, position 1
    # rotates (x0, x1) by one radian
    np.testing.assert_allclose(got[:, 0].float().numpy(),
                               tx[:, 0].float().numpy(), rtol=1e-6)
    a, b = x[0, 1, 0, 0], x[0, 1, 0, 1]
    if dtype == "float32":
        np.testing.assert_allclose(
            got[0, 1, 0, :2].numpy(),
            [a * np.cos(1) - b * np.sin(1), a * np.sin(1) + b * np.cos(1)],
            rtol=1e-5)


def test_rmsnorm_matches_reference():
    x = np.random.default_rng(3).standard_normal((2, 7, 64),
                                                 dtype=np.float32) * 3
    scale = np.random.default_rng(4).standard_normal(64, dtype=np.float32)
    got = tl._rmsnorm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)
    want = jl._rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_init_matches_the_reference_tree():
    """Leaf names, shapes and dtypes as the reference initializes them,
    norms at 1 and the output projections at 0.02 / sqrt(2L)."""
    cfg = _tcfg()
    jcfg = jl.LlamaConfig(**SHAPE, dtype=jnp.float32)
    jp = jax.eval_shape(lambda: jl.init_llama_params(
        jcfg, jax.random.PRNGKey(0)))
    p = tl.init_llama_params(cfg, seed=0, device="cpu")
    assert sorted(p) == sorted(jp)
    for name, v in p.items():
        assert tuple(v.shape) == jp[name].shape, name
        assert v.dtype == torch.float32
    assert bool((p["attn_norm"] == 1).all() and (p["norm_f"] == 1).all())
    L = SHAPE["num_layers"]
    assert float(p["o_w"].std()) == pytest.approx(0.02 / np.sqrt(2 * L),
                                                  rel=0.1)
    assert float(p["gate_w"].std()) == pytest.approx(0.02, rel=0.05)
    again = tl.init_llama_params(cfg, seed=0, device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_tinyllama_widths():
    """TinyLlama-1.1B's widths: the default FFN rule gives its 5632, and
    with the repo's tied head the tree holds 1,034,512,384 parameters
    (counted from the reference's own init, shapes only)."""
    cfg = tl.LlamaConfig(**TINYLLAMA)
    assert cfg.ffn_hidden == 5632 and cfg.head_dim == 64
    assert cfg.num_heads // cfg.num_kv_heads == 8
    jcfg = jl.LlamaConfig(**TINYLLAMA)
    shapes = jax.eval_shape(lambda: jl.init_llama_params(
        jcfg, jax.random.PRNGKey(0)))
    assert sum(int(np.prod(s.shape)) for s in shapes.values()) == \
        1_034_512_384


def test_model_forward_and_no_serving_yet(ref):
    cfg = _tcfg(remat=False)
    model = LlamaModel(cfg, device="cpu", params=_params(ref))
    tokens = torch.from_numpy(ref["tokens"])
    np.testing.assert_allclose(model(tokens[:, :-1]).detach().numpy(),
                               ref["logits"], rtol=1e-4, atol=1e-5)
    # serving is ported: generate gives greedy_generate's stream
    prompt = np.array([1, 2, 3])
    got = model.generate([prompt], 4, num_slots=1, max_len=32)[0]
    want = tl.greedy_generate(_params(ref), torch.from_numpy(prompt)[None],
                              cfg, 4, max_len=32)[0, 3:]
    np.testing.assert_array_equal(got, want.numpy())
