"""The port's two-pass cross entropy (kernels/fused_ce.py: ce_fwd,
ce_bwd, ce_with_logits), the route `models/losses.py::fused_softmax_ce`
takes, and the port's kernel registry (kernels/registry.py), against
the JAX package on the same numpy inputs.

- `ce_fwd_ref` against the Pallas `_ce_fwd` and `ce_bwd_ref` against
  `_ce_bwd`, both in interpret mode, in f32 and bf16, at V 1000 (the
  Pallas kernels pad it to two 512-column tiles and mask the rest) and
  V 512;
- `ce_with_logits`'s gradient against `jax.vjp` of the reference's
  `ce_with_logits`;
- the route: CPU logits always take the plain f32 form; on the card no
  registry entry (or "pallas") gives `ce_with_logits`, "pallas_fused"
  gives `ce_fused_train` and "jax" the plain form;
- the registry: validation, precedence, the plausibility gate at the
  H100's anchors, and adopt.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import pallas_ce as jce
from paddle_tpu.kernels import registry as jreg
from paddle_tpu.models import losses as jlosses
from paddle_tpu_torch.kernels import fused_ce as fce
from paddle_tpu_torch.kernels import registry
from paddle_tpu_torch.models import losses


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
T = 96


def _data(T_, V, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T_, V), dtype=np.float32) * scale
    t = rng.integers(0, V, size=T_)
    return x, t


def _pair(x, dtype):
    """The same logits for both frameworks: f32 as given, or the bf16
    value of x."""
    if dtype == "float32":
        return torch.from_numpy(x), jnp.asarray(x)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    return tx, jnp.asarray(tx.float().numpy()).astype(jnp.bfloat16)


def _dx_tol(ref, g, dtype):
    """d_logits tolerance that scales with the cotangent: one rounding
    step of the dtype relative to the entry, plus 1e-6 of the row's |g|
    (f32 exps in another order). A fixed absolute term would pass any
    answer at g = 1/T, where every entry is ~1e-9."""
    step = BF16_STEP if dtype == "bfloat16" else 2.0 ** -20
    return step * np.abs(ref) + 1e-6 * np.abs(g)[:, None]


@pytest.mark.parametrize("V", [1000, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ce_fwd_ref_matches_pallas_fwd_kernel(V, dtype):
    x, t = _data(T, V, seed=V)
    tx, jx = _pair(x, dtype)
    loss, lse = fce.ce_fwd(tx, torch.from_numpy(t))
    assert loss.dtype == lse.dtype == torch.float32
    assert loss.shape == lse.shape == (T,)
    j_loss, j_lse = jce._ce_fwd(jx, jnp.asarray(t, jnp.int32),
                                interpret=True)
    # f32 sums of exps in another order: a few f32 steps of |loss| ~ 10
    np.testing.assert_allclose(loss.numpy(), np.asarray(j_loss), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("g_scale", ["one", "mean"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ce_bwd_ref_matches_pallas_bwd_kernel(dtype, g_scale):
    V = 1000
    x, t = _data(T, V, seed=3)
    tx, jx = _pair(x, dtype)
    g = (np.ones(T, np.float32) if g_scale == "one"
         else np.full(T, 1.0 / T, np.float32))
    g[::7] *= -2.5                               # rows differ in g
    _, lse = fce.ce_fwd_ref(tx, torch.from_numpy(t))
    dx = fce.ce_bwd(tx, torch.from_numpy(t), lse, torch.from_numpy(g))
    assert dx.dtype == tx.dtype and dx.shape == (T, V)
    j_dx = jce._ce_bwd(jx, jnp.asarray(t, jnp.int32),
                       jnp.asarray(lse.numpy()), jnp.asarray(g),
                       interpret=True)
    j_dx = np.asarray(j_dx.astype(jnp.float32))
    err = np.abs(dx.float().numpy() - j_dx)
    assert (err <= _dx_tol(j_dx, g, dtype)).all(), float(err.max())


def test_dx_tolerance_fails_a_wrong_gradient_at_mean_cotangent():
    """At g = 1/T the bound is ~1e-9 an entry: dropping the one-hot (an
    error of g in one entry a row) fails it in every row."""
    x, t = _data(T, 1000, seed=4)
    tx = torch.from_numpy(x)
    g = np.full(T, 1.0 / T, np.float32)
    _, lse = fce.ce_fwd_ref(tx, torch.from_numpy(t))
    ref = fce.ce_bwd_ref(tx, torch.from_numpy(t), lse,
                         torch.from_numpy(g)).numpy()
    wrong = fce.ce_bwd_ref(tx, torch.full((T,), -1), lse,
                           torch.from_numpy(g)).numpy()
    bad = np.abs(wrong - ref) > _dx_tol(ref, g, "float32")
    assert bad.any(1).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ce_with_logits_vjp_matches_reference(dtype):
    x, t = _data(T, 1000, seed=7)
    g = np.random.default_rng(8).standard_normal(T).astype(np.float32)
    tx, jx = _pair(x, dtype)
    tx = tx.clone().requires_grad_()
    loss = fce.ce_with_logits(tx, torch.from_numpy(t))
    (dx,) = torch.autograd.grad(loss, tx, torch.from_numpy(g))
    j_loss, vjp = jax.vjp(
        lambda a: jce.ce_with_logits(a, jnp.asarray(t, jnp.int32), True),
        jx)
    (j_dx,) = vjp(jnp.asarray(g))
    j_dx = np.asarray(j_dx.astype(jnp.float32))
    assert dx.dtype == tx.dtype
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(j_loss),
                               rtol=1e-5, atol=1e-5)
    err = np.abs(dx.float().numpy() - j_dx)
    assert (err <= _dx_tol(j_dx, g, dtype)).all(), float(err.max())


def test_two_pass_rounds_once_where_the_fused_route_rounds_twice():
    """bf16, g = 1/3: the two-pass backward rounds (p - onehot) * g once,
    so every entry is within half a bf16 step (2^-8 relative) of the f32
    value; the one-pass route rounds p - onehot, scales, and rounds
    again, as pallas_ce.py:295-296 does, and strays further."""
    x, t = _data(T, 1000, seed=9)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tt = torch.from_numpy(t)
    g = torch.full((T,), 1.0 / 3.0)
    (two,) = torch.autograd.grad(fce.ce_with_logits(tx, tt), tx, g)
    (one,) = torch.autograd.grad(fce.ce_fused_train(tx, tt), tx, g)
    s = tx.detach().double()
    exact = ((torch.softmax(s, -1)
              - torch.nn.functional.one_hot(tt, 1000)) * g[:, None]).abs()
    half_step = (2.0 ** -8 + 1e-6) * exact
    two_err = (two.double() - exact * torch.sign(two.double())).abs()
    one_err = (one.double() - exact * torch.sign(one.double())).abs()
    assert bool((two_err <= half_step).all())
    assert bool((one_err > half_step).any())


class _Counting:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a):
        self.calls += 1
        return self.fn(*a)


def test_no_grad_runs_the_forward_alone():
    x, t = _data(T, 600, seed=10)
    fwd, bwd = _Counting(fce.ce_fwd_ref), _Counting(fce.ce_bwd_ref)
    tx = torch.from_numpy(x).requires_grad_()
    with torch.no_grad():
        loss = fce.ce_with_logits(tx, torch.from_numpy(t), fwd, bwd)
    assert (fwd.calls, bwd.calls) == (1, 0) and not loss.requires_grad
    loss = fce.ce_with_logits(tx, torch.from_numpy(t), fwd, bwd)
    loss.sum().backward()
    assert (fwd.calls, bwd.calls) == (2, 1)


def test_out_of_range_target_gathers_nothing():
    x, t = _data(8, 40, seed=5)
    t[2], t[5] = -1, 40
    tx, tt = torch.from_numpy(x), torch.from_numpy(t)
    loss, lse = fce.ce_fwd_ref(tx, tt)
    torch.testing.assert_close(loss[[2, 5]], lse[[2, 5]])
    dx = fce.ce_bwd_ref(tx, tt, lse, torch.ones(8))
    torch.testing.assert_close(dx[[2, 5]], torch.softmax(tx[[2, 5]], -1))
    assert float(dx[0, t[0]]) < 0


def test_wrappers_reject_other_devices():
    x = torch.zeros(4, 8, device="meta")
    t = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fce.ce_fwd(x, t)
    with pytest.raises(ValueError, match="unsupported device"):
        fce.ce_bwd(x, t, torch.zeros(4, device="meta"),
                   torch.zeros(4, device="meta"))


# ---------------------------------------------------------------- route
@pytest.fixture
def forced(monkeypatch):
    """Force the registry's answer for a kernel, as chip_smoke.py does
    through the same `registry.winner` seam."""
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


@pytest.mark.parametrize("impl,route", [(None, "pallas"),
                                        ("pallas", "pallas"),
                                        ("pallas_fused", "pallas_fused"),
                                        ("jax", "jax")])
def test_ce_route_on_the_card_follows_the_registry(forced, impl, route):
    if impl is not None:
        forced["ce"] = impl
    cuda_like = type("Logits", (), {"device": torch.device("cuda", 0)})()
    assert losses.ce_route(cuda_like) == route
    # the CPU always runs the plain f32 form
    assert losses.ce_route(torch.zeros(2, 3)) == "jax"


@pytest.mark.parametrize("route", ["pallas", "pallas_fused", "jax"])
def test_each_route_reaches_its_function_and_agrees_with_jax(monkeypatch,
                                                             route):
    """Each route of fused_softmax_ce, driven on the CPU through the
    plain versions of its kernels: "pallas" calls ce_with_logits (fwd,
    then bwd), "pallas_fused" ce_fused_train, "jax" neither; all three
    give JAX's loss and gradient."""
    monkeypatch.setattr(losses, "ce_route", lambda logits: route)
    fwd, bwd = _Counting(fce.ce_fwd_ref), _Counting(fce.ce_bwd_ref)
    fused = _Counting(fce.ce_fused_ref)
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((2, 12, 600), dtype=np.float32) * 2
    tgt = rng.integers(0, 600, size=(2, 12))
    tl = torch.from_numpy(logits).requires_grad_()
    loss = losses.fused_softmax_ce(tl, torch.from_numpy(tgt), fused=fused,
                                   fwd=fwd, bwd=bwd)
    (g,) = torch.autograd.grad(loss, tl)
    want = {"pallas": (1, 1, 0), "pallas_fused": (0, 0, 1),
            "jax": (0, 0, 0)}[route]
    assert (fwd.calls, bwd.calls, fused.calls) == want
    j_loss, j_g = jax.value_and_grad(
        lambda a: jlosses.fused_softmax_ce(a, jnp.asarray(tgt)))(
            jnp.asarray(logits))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(j_g), rtol=1e-4,
                               atol=1e-8)


# ------------------------------------------------------------- registry
def _measured(impl, ms, **kw):
    return dict({"impl": impl, "kind": "measured", "ms": ms,
                 "bytes_moved": 5.24e8}, **kw)


def test_registry_validation_rules():
    doc = {"entries": {
        "ce::cuda::*": _measured("pallas_fused", 0.6),
        "ce::tpu::*": _measured("pallas", 0.6),
        "ce::cuda::S1024": _measured("bogus", 0.6),
        "fused_update::cuda::*": {"impl": "pallas", "kind": "policy"},
        "attention::cuda::*": {"impl": "xla", "kind": "measured",
                               "ms": 1.0},
        "quant_matmul::cuda::*": _measured("pallas", 1e-4),
        "multi_tick::cuda::*": _measured("scan", 1e6),
        "decode_attention::cpu::*": {"impl": "dense", "kind": "policy",
                                     "reason": "parity"},
        "bad-key": _measured("pallas", 0.6),
    }}
    problems = registry.validate(doc)
    text = "\n".join(problems)
    assert len(problems) == 7, problems
    assert "unknown backend class 'tpu'" in text
    assert "impl 'bogus'" in text
    assert "policy entry with no reason" in text
    assert "no arithmetic/memory volume" in text
    assert "implausibly fast" in text and "implausibly slow" in text
    assert "not kernel::backend::bucket" in text


def test_registry_precedence_and_absent_table(tmp_path):
    path = str(tmp_path / "reg.json")
    assert registry.winner("ce", backend="cuda", path=path) is None
    registry._reset()
    doc = {"entries": {
        "ce::cuda::*": _measured("pallas_fused", 0.6),
        "ce::cuda::S8192": _measured("jax", 0.9),
        "ce::cuda::S4096": _measured("bogus", 0.9),
        "ce::cpu::*": {"impl": "jax", "kind": "policy", "reason": "oracle"},
    }}
    with open(path, "w") as f:
        json.dump(doc, f)
    try:
        # the exact bucket wins, an invalid exact row falls back to '*'
        assert registry.winner("ce", "cuda", "S8192", path=path) == "jax"
        assert registry.winner("ce", "cuda", "S4096", path=path) == \
            "pallas_fused"
        assert registry.winner("ce", "cuda", path=path) == "pallas_fused"
        assert registry.winner("ce", "cpu", path=path) == "jax"
        assert registry.winner("fused_update", "cuda", path=path) is None
        assert registry.entry("ce", "cuda", "S4096", path=path)["impl"] == \
            "bogus"
    finally:
        registry._reset()


def test_gate_uses_the_h100_anchors():
    # bf16 logits [8192, 32000] read once: 0.1565 ms at 3.35 TB/s
    nbytes = 8192 * 32000 * 2
    lo, hi = registry.plausible_ms(bytes_moved=nbytes)
    assert lo == pytest.approx(nbytes / 3.35e12 / 2 * 1e3)
    assert hi == pytest.approx(nbytes / 20e9 * 1e3)
    lo, _ = registry.plausible_ms(flops=989e12)
    assert lo == pytest.approx(500.0)
    assert registry.gate_ms(0.2, bytes_moved=nbytes) is None
    assert "fast" in registry.gate_ms(0.05, bytes_moved=nbytes)
    assert "slow" in registry.gate_ms(30.0, bytes_moved=nbytes)


def test_adopt_refuses_implausible_rows_and_writes_plausible_ones(tmp_path):
    path = str(tmp_path / "sub" / "reg.json")
    try:
        why = registry.adopt("ce", "pallas_fused", 0.01, bytes_moved=5e8,
                             backend="cuda", path=path)
        assert "implausibly fast" in why
        assert registry.winner("ce", "cuda", path=path) is None
        assert registry.adopt("ce", "pallas_fused", 0.65, bytes_moved=1e9,
                              backend="cuda", path=path) is None
        registry._reset()
        assert registry.winner("ce", "cuda", path=path) == "pallas_fused"
        assert registry.validate(path=path) == []
        assert "unknown backend" in registry.adopt(
            "ce", "pallas", 0.65, bytes_moved=1e9, backend="tpu", path=path)
    finally:
        registry._reset()


def test_registry_keeps_the_reference_contract():
    """The port's tables name the same kernels and impls, and bucket
    sequence sizes alike."""
    assert registry.KNOWN_IMPLS == jreg.KNOWN_IMPLS
    for n in (1, 2, 3, 1000, 1024, 2049, 32000):
        assert registry.seq_bucket(n) == jreg.seq_bucket(n)
    assert registry.backend_class(torch.device("cuda", 0)) == "cuda"
    assert registry.backend_class("cpu") == "cpu"
    assert registry.REGISTRY_PATH != jreg.REGISTRY_PATH
