"""The port's fused AdamW (kernels/fused_update.py) against the JAX
package on the same numpy inputs: `leaf_update_ref` (what `leaf_update`
runs on CPU tensors) against the Pallas `_leaf_update` in interpret
mode, and the port's `fused_apply_adamw` against the reference's
`fused_apply_adamw(..., interpret=True)` over a params tree, for f32 and
bf16 parameters; then the consult in models/gpt.py `apply_adamw`.

Tolerances: both sides evaluate the same f32 expression in the same
order, but XLA's CPU code may fuse b * m + c * g into one multiply-add,
where PyTorch rounds each product. So m is held to 4 f32 steps of the
magnitude of its terms, |b1 m| + |(1 - b1) g| (the two can cancel), v
to 4 f32 steps of |v'| (its terms are positive), and p to 2 steps of its
dtype at |p'| plus the m error carried through lr / bc1 / den; over
several steps the bounds add up.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import pallas_update as jpu
from paddle_tpu_torch.kernels import fused_update as fu
from paddle_tpu_torch.kernels import registry
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.models.convert import opt_state_from_jax, params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file runs (the suite runs several
    pytest-xdist workers side by side); restored after, so other files
    in the same worker keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32_STEP = 2.0 ** -23
BF16_STEP = 2.0 ** -7
HYPER = dict(lr=3e-4, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1)


def _check(got, want, tol, what):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= tol).all(), (what, float((err / tol).max()))


class _Bounds:
    """Per-entry tolerances of (p, m, v) after one or more updates with
    hyperparameter vectors `hp`, from the magnitudes of the terms."""

    def __init__(self, m0):
        self.m_mag = np.abs(np.asarray(m0, np.float64))
        self.p_tol = 0.0

    def step(self, g, hp, p_new, v_new, p_step):
        lr, b1, b2, eps, _wd, bc1, bc2 = (float(x) for x in hp)
        g = np.asarray(g, np.float64)
        self.m_mag = b1 * self.m_mag + (1 - b1) * np.abs(g)
        den = np.sqrt(np.asarray(v_new, np.float64) / bc2) + eps
        self.p_tol = (self.p_tol + 2 * p_step * np.abs(np.asarray(
            p_new, np.float64)) + lr * 4 * F32_STEP * self.m_mag / bc1 / den)
        return (self.p_tol, 4 * F32_STEP * self.m_mag + 1e-30,
                4 * F32_STEP * np.abs(np.asarray(v_new, np.float64)) + 1e-30)


def _leaf(shape, seed, p_dtype):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(shape, dtype=np.float32) * 0.02
    g = rng.standard_normal(shape, dtype=np.float32) * 1e-3
    m = rng.standard_normal(shape, dtype=np.float32) * 1e-4
    v = np.abs(rng.standard_normal(shape, dtype=np.float32)) * 1e-7
    if p_dtype == "bfloat16":
        p = torch.from_numpy(p).to(torch.bfloat16).float().numpy()
    return p, g, m, v


def _hp(step):
    b1, b2 = HYPER["beta1"], HYPER["beta2"]
    return np.array([HYPER["lr"], b1, b2, HYPER["eps"],
                     HYPER["weight_decay"], 1 - b1 ** step, 1 - b2 ** step],
                    np.float32)


def _torch(a, dtype):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _jax(a, dtype):
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16"
                                 else jnp.float32)


@pytest.mark.parametrize("shape", [(37, 53), (256, 128), (5,)])
@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
def test_leaf_update_ref_matches_pallas_leaf_update(shape, p_dtype):
    p, g, m, v = _leaf(shape, sum(shape), p_dtype)
    hp = _hp(3)
    new = fu.leaf_update_ref(_torch(p, p_dtype), torch.from_numpy(g),
                             torch.from_numpy(m), torch.from_numpy(v),
                             torch.from_numpy(hp))
    j_new = jpu._leaf_update(_jax(p, p_dtype), jnp.asarray(g),
                             jnp.asarray(m), jnp.asarray(v),
                             jnp.asarray(hp), interpret=True)
    assert new[0].dtype == _torch(p, p_dtype).dtype
    assert new[1].dtype == new[2].dtype == torch.float32
    p_step = BF16_STEP if p_dtype == "bfloat16" else F32_STEP
    j_p, j_m, j_v = (np.asarray(a.astype(jnp.float32)) for a in j_new)
    tol_p, tol_m, tol_v = _Bounds(m).step(g, hp, j_p, j_v, p_step)
    _check(new[0].float(), j_p, tol_p, "p")
    _check(new[1], j_m, tol_m, "m")
    _check(new[2], j_v, tol_v, "v")


def test_leaf_update_is_in_place_and_takes_bf16_gradients():
    p, g, m, v = _leaf((64, 3), 1, "float32")
    hp = torch.from_numpy(_hp(1))
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    tg16 = torch.from_numpy(g).to(torch.bfloat16)
    want = fu.leaf_update_ref(tp.clone(), tg16, tm.clone(), tv.clone(), hp)
    out = fu.leaf_update(tp, tg16, tm, tv, hp)
    assert out[0] is tp and out[1] is tm and out[2] is tv
    for got, ref in zip(out, want):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_leaf_update_rejects_other_devices():
    t = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fu.leaf_update(t, t, t, t, torch.zeros(7, device="meta"))


def _tree(p_dtype, seed=0):
    shapes = {"wte": (50, 16), "norm_f": (16,), "q_w": (2, 16, 16),
              "down_w": (2, 40, 16)}
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s, dtype=np.float32) * 0.02
              for k, s in shapes.items()}
    if p_dtype == "bfloat16":
        params = {k: np.asarray(jnp.asarray(a).astype(jnp.bfloat16))
                  for k, a in params.items()}
    grads = [{k: rng.standard_normal(s, dtype=np.float32) * 1e-3
              for k, s in shapes.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
def test_fused_apply_adamw_matches_reference_over_three_steps(p_dtype):
    params, grads = _tree(p_dtype)
    jp = {k: jnp.asarray(a) for k, a in params.items()}
    jopt = {"m": {k: jnp.zeros(a.shape, jnp.float32) for k, a in jp.items()},
            "v": {k: jnp.zeros(a.shape, jnp.float32) for k, a in jp.items()},
            "step": jnp.zeros((), jnp.float32)}
    tp = params_from_jax(params, device="cpu")
    topt = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jopt),
                              device="cpu")
    p_step = BF16_STEP if p_dtype == "bfloat16" else F32_STEP
    bounds = {k: _Bounds(np.zeros(a.shape)) for k, a in params.items()}
    for step, g in enumerate(grads, 1):
        jp, jopt = jpu.fused_apply_adamw(
            {k: jnp.asarray(a) for k, a in g.items()}, jp, jopt,
            interpret=True, **HYPER)
        out = fu.fused_apply_adamw(params_from_jax(g, device="cpu"), tp,
                                   topt, **HYPER)
        assert out[0] is tp and out[1] is topt      # in place
        tols = {k: bounds[k].step(g[k], _hp(step),
                                  np.asarray(jp[k].astype(jnp.float32)),
                                  np.asarray(jopt["v"][k]), p_step)
                for k in params}
    assert float(topt["step"]) == float(jopt["step"]) == 3.0
    for k in params:
        assert tp[k].dtype == (torch.bfloat16 if p_dtype == "bfloat16"
                               else torch.float32)
        tol_p, tol_m, tol_v = tols[k]
        _check(tp[k].float(), jp[k].astype(jnp.float32), tol_p, k)
        _check(topt["m"][k], jopt["m"][k], tol_m, k)
        _check(topt["v"][k], jopt["v"][k], tol_v, k)


def test_fused_and_plain_adamw_agree():
    """The fused route against the port's plain per-leaf update, which
    forms 1 - lr * wd in double and adds alpha * g in one step: held to
    the same bounds."""
    params, grads = _tree("float32", seed=4)
    a = params_from_jax(params, device="cpu")
    b = params_from_jax(params, device="cpu")
    oa, ob = tg.init_opt_state(a), tg.init_opt_state(b)
    bounds = {k: _Bounds(np.zeros(x.shape)) for k, x in params.items()}
    for step, g in enumerate(grads, 1):
        fu.fused_apply_adamw(params_from_jax(g, device="cpu"), a, oa,
                             **HYPER)
        tg.apply_adamw(params_from_jax(g, device="cpu"), b, ob, **HYPER)
        tols = {k: bounds[k].step(g[k], _hp(step), b[k], ob["v"][k],
                                  F32_STEP) for k in params}
    for k in a:
        _check(a[k], b[k], tols[k][0], k)
        _check(oa["m"][k], ob["m"][k], tols[k][1], k)


@pytest.fixture
def forced(monkeypatch):
    table = {}
    orig = registry.winner

    def winner(kernel, backend=None, bucket="*", path=None):
        return table.get(kernel) or orig(kernel, backend=backend,
                                         bucket=bucket, path=path)
    monkeypatch.setattr(registry, "winner", winner)
    monkeypatch.setattr(registry, "REGISTRY_PATH", "/nonexistent/none.json")
    registry._reset()
    yield table
    registry._reset()


@pytest.mark.parametrize("impl", [None, "jax", "pallas"])
def test_fused_update_enabled_needs_the_card_and_the_registry(forced, impl):
    if impl is not None:
        forced["fused_update"] = impl
    assert fu.fused_update_enabled(torch.device("cuda", 0)) == (
        impl == "pallas")
    assert not fu.fused_update_enabled(torch.device("cpu"))


@pytest.mark.parametrize("enabled", [False, True])
def test_apply_adamw_consults_the_fused_update(monkeypatch, enabled):
    calls = []

    def counting(*a, **k):
        calls.append(1)
        return fu.fused_apply_adamw(*a, **k)
    monkeypatch.setattr(tg, "fused_update_enabled", lambda device: enabled)
    monkeypatch.setattr(tg, "fused_apply_adamw", counting)
    params, grads = _tree("float32", seed=5)
    p = params_from_jax(params, device="cpu")
    opt = tg.init_opt_state(p)
    out = tg.apply_adamw(params_from_jax(grads[0], device="cpu"), p, opt,
                         **HYPER)
    assert out[0] is p and out[1] is opt
    assert len(calls) == int(enabled) and float(opt["step"]) == 1.0
