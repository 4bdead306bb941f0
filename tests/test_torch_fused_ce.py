"""The port's one-pass cross entropy (kernels/fused_ce.py, models/losses.py)
against the JAX package on the same numpy inputs: `ce_fused_ref` (what
`ce_fused` runs on CPU tensors) against the Pallas `_ce_fused` in
interpret mode, `ce_fused_train`'s gradient against the reference's
custom VJP, and `fused_softmax_ce` against JAX `losses.fused_softmax_ce`,
values and gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import pallas_ce as jce
from paddle_tpu.models import losses as jlosses
from paddle_tpu_torch.kernels import fused_ce as fce
from paddle_tpu_torch.models.losses import fused_softmax_ce


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file runs (the suite runs several
    pytest-xdist workers side by side); restored after, so other files
    in the same worker keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BF16_STEP = 2.0 ** -7


def _data(T, V, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, V), dtype=np.float32) * scale)
    t = rng.integers(0, V, size=T)
    return x, t


def _bf16(x):
    """The bf16 value of an f32 numpy array, as f32, and the bf16 arrays
    both frameworks take."""
    tx = torch.from_numpy(x).to(torch.bfloat16)
    return tx, jnp.asarray(tx.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("V", [600, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ce_fused_ref_matches_pallas_fused_kernel(V, dtype):
    x, t = _data(100, V, seed=V)
    if dtype == "float32":
        tx, jx = torch.from_numpy(x), jnp.asarray(x)
    else:
        tx, jx = _bf16(x)
    loss, dx = fce.ce_fused(tx, torch.from_numpy(t))
    assert loss.dtype == torch.float32 and dx.dtype == tx.dtype
    assert loss.shape == (100,) and dx.shape == (100, V)
    j_loss, j_dx = jce._ce_fused(jx, jnp.asarray(t, jnp.int32),
                                 interpret=True)
    j_dx = np.asarray(j_dx.astype(jnp.float32))
    np.testing.assert_allclose(loss.numpy(), np.asarray(j_loss), rtol=1e-5,
                               atol=1e-5)
    if dtype == "float32":
        np.testing.assert_allclose(dx.numpy(), j_dx, rtol=1e-5, atol=1e-7)
    else:
        # both round the same f32 value to bf16 once: one bf16 step apart
        # at most where the f32 values straddle a rounding boundary
        np.testing.assert_allclose(dx.float().numpy(), j_dx,
                                   rtol=BF16_STEP, atol=1e-6)


def test_out_of_range_target_gathers_nothing():
    x, t = _data(8, 40, seed=5)
    t[2], t[5] = -1, 40
    loss, dx = fce.ce_fused_ref(torch.from_numpy(x), torch.from_numpy(t))
    lse = torch.logsumexp(torch.from_numpy(x), -1)
    torch.testing.assert_close(loss[[2, 5]], lse[[2, 5]])
    torch.testing.assert_close(dx[[2, 5]],
                               torch.softmax(torch.from_numpy(x[[2, 5]]), -1))
    assert float(dx[0, t[0]]) < 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ce_fused_train_vjp_matches_reference(dtype):
    """The backward is (dx.float() * g[:, None]).to(dx.dtype): d_logits
    rounded before the cotangent scale, as pallas_ce.py:295-296."""
    x, t = _data(100, 600, seed=7)
    g = np.random.default_rng(8).standard_normal(100).astype(np.float32)
    if dtype == "float32":
        tx, jx = torch.from_numpy(x), jnp.asarray(x)
    else:
        tx, jx = _bf16(x)
    tx = tx.clone().requires_grad_()
    loss = fce.ce_fused_train(tx, torch.from_numpy(t))
    (dx,) = torch.autograd.grad(loss, tx, torch.from_numpy(g))
    j_loss, vjp = jax.vjp(
        lambda a: jce.ce_fused_train(a, jnp.asarray(t, jnp.int32), True), jx)
    (j_dx,) = vjp(jnp.asarray(g))
    assert dx.dtype == tx.dtype
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(j_loss),
                               rtol=1e-5, atol=1e-5)
    tol = dict(rtol=1e-5, atol=1e-7) if dtype == "float32" else dict(
        rtol=2 * BF16_STEP, atol=1e-6)
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(j_dx.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("masked", [False, True])
def test_fused_softmax_ce_matches_jax(masked):
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((2, 12, 600), dtype=np.float32) * 2
    tgt = rng.integers(0, 600, size=(2, 12))
    mask = rng.random((2, 12)) < 0.6 if masked else None
    tl = torch.from_numpy(logits).requires_grad_()
    loss = fused_softmax_ce(tl, torch.from_numpy(tgt),
                            None if mask is None else torch.from_numpy(mask))
    (g,) = torch.autograd.grad(loss, tl)

    def jloss(a):
        return jlosses.fused_softmax_ce(
            a, jnp.asarray(tgt), None if mask is None else jnp.asarray(mask))
    j_loss, j_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(j_g), rtol=1e-4,
                               atol=1e-8)


def test_ce_fused_rejects_other_devices():
    x = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fce.ce_fused(x, torch.zeros(4, dtype=torch.int64, device="meta"))
