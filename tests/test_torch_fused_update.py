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
import bisect

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


# ---------------------------------------------------- the table of leaves
def _chunk_spans(table, sizes, vec):
    """What each chunk of a launch updates, as csrc/fused_update.cu's
    blocks map a chunk to its leaf (a binary search over the table's
    first chunks): [(leaf, start, vec_stop, stop)], elements [start,
    vec_stop) of the leaf in 4-element vectors, [vec_stop, stop) one at
    a time (`vec[i]`: leaf i starts on a 16-byte boundary in all four
    operands)."""
    spans = []
    for c in range(table["chunks"]):
        k = bisect.bisect_right(table["chunk0"], c) - 1
        leaf = table["leaves"][k]
        start = (c - table["chunk0"][k]) * fu.CHUNK
        stop = min(start + fu.CHUNK, sizes[leaf])
        vec_stop = start + ((stop - start) & ~3) if vec[leaf] else start
        spans.append((leaf, start, vec_stop, stop))
    return spans


def _spans_cover(sizes, vec):
    """Every element of every leaf, as the kernel's chunks of each launch
    map them: counted once, vectors on 4-element boundaries."""
    tables = fu._plan_tables(sizes)
    seen = [np.zeros(n, np.int64) for n in sizes]
    for tab in tables:
        assert 1 <= len(tab["leaves"]) <= fu.TABLE_LEAVES
        for leaf, start, vec_stop, stop in _chunk_spans(tab, sizes, vec):
            assert start % 4 == 0 and (vec_stop - start) % 4 == 0
            assert stop - start <= fu.CHUNK
            if vec[leaf]:
                assert stop - vec_stop < 4      # only the last n % 4
            else:
                assert vec_stop == start        # element by element
            seen[leaf][start:stop] += 1
    assert all((s == 1).all() for s in seen)
    return tables


@pytest.mark.parametrize("sizes", [
    [1], [4096], [4097, 3, 1, 8192, 5], [65536000, 2048, 45056, 92274688],
    [1 + i % 7 for i in range(40)]])
def test_plan_tables_cover_every_element_once(sizes):
    vec = [i % 3 != 1 for i in range(len(sizes))]
    tables = _spans_cover(sizes, vec)
    assert len(tables) == 1
    # a leaf's chunks follow the previous leaf's
    assert tables[0]["chunk0"] == list(np.cumsum(
        [0] + [-(-n // fu.CHUNK) for n in sizes[:-1]]))


def test_plan_tables_split_past_a_table():
    """More leaves than a table holds go in several launches, in order,
    each full but the last."""
    sizes = [1 + (i * 37) % 9000 for i in range(2 * fu.TABLE_LEAVES + 3)]
    tables = _spans_cover(sizes, [True] * len(sizes))
    assert [len(t["leaves"]) for t in tables] == [fu.TABLE_LEAVES,
                                                  fu.TABLE_LEAVES, 3]
    assert sum((t["leaves"] for t in tables), []) == list(range(len(sizes)))
    with pytest.raises(ValueError, match="0 elements"):
        fu._plan_tables([3, 0])


def _mixed_tree(seed=9):
    """Odd sizes, 1-element leaves, a bf16 p and a bf16 g: (params,
    grads over two steps, {leaf: (p dtype, g dtype)})."""
    dtypes = {"wte": ("float32", "float32"), "norm": ("float32", "bfloat16"),
              "one": ("float32", "float32"), "q_w": ("bfloat16", "float32"),
              "odd": ("bfloat16", "bfloat16"), "scalar": ("float32",
                                                          "bfloat16")}
    shapes = {"wte": (37, 16), "norm": (7,), "one": (1,), "q_w": (3, 16, 5),
              "odd": (1031,), "scalar": ()}
    rng = np.random.default_rng(seed)

    def cast(a, dtype):
        return np.asarray(jnp.asarray(a).astype(
            jnp.bfloat16 if dtype == "bfloat16" else jnp.float32))
    params = {k: cast(rng.standard_normal(s, dtype=np.float32) * 0.02,
                      dtypes[k][0]) for k, s in shapes.items()}
    grads = [{k: cast(rng.standard_normal(s, dtype=np.float32) * 1e-3,
                      dtypes[k][1]) for k, s in shapes.items()}
             for _ in range(2)]
    return params, grads, dtypes


def test_leaves_update_on_a_mixed_tree_matches_reference():
    """One leaves_update over a tree that mixes dtype pairs and sizes (on
    the CPU the plain version leaf by leaf) against the reference's
    fused_apply_adamw with the Pallas kernel in interpret mode, over two
    steps: each leaf to the bit against leaf_update_ref on the same hp;
    against the reference within _Bounds, not to the bit, since XLA's CPU
    code contracts b * m + c * g into one multiply-add where PyTorch
    rounds each product."""
    params, grads, dtypes = _mixed_tree()
    jp = {k: jnp.asarray(a) for k, a in params.items()}
    jopt = {"m": {k: jnp.zeros(a.shape, jnp.float32) for k, a in jp.items()},
            "v": {k: jnp.zeros(a.shape, jnp.float32) for k, a in jp.items()},
            "step": jnp.zeros((), jnp.float32)}
    tp = params_from_jax(params, device="cpu")
    tm = {k: torch.zeros(p.shape) for k, p in tp.items()}
    tv = {k: torch.zeros(p.shape) for k, p in tp.items()}
    keys = list(tp)
    bounds = {k: _Bounds(np.zeros(a.shape)) for k, a in params.items()}
    for step, g in enumerate(grads, 1):
        tg_ = params_from_jax(g, device="cpu")
        hp = torch.from_numpy(_hp(step))
        want = {k: fu.leaf_update_ref(tp[k], tg_[k], tm[k], tv[k], hp)
                for k in keys}
        out = fu.leaves_update([tp[k] for k in keys], [tg_[k] for k in keys],
                               [tm[k] for k in keys], [tv[k] for k in keys],
                               hp)
        assert out[0][0] is tp[keys[0]]                     # in place
        for k in keys:
            for got, ref in zip((tp[k], tm[k], tv[k]), want[k]):
                torch.testing.assert_close(got, ref, rtol=0, atol=0)
        jp, jopt = jpu.fused_apply_adamw(
            {k: jnp.asarray(a) for k, a in g.items()}, jp, jopt,
            interpret=True, **HYPER)
        tols = {k: bounds[k].step(
            g[k].astype(np.float32), _hp(step),
            np.asarray(jp[k].astype(jnp.float32)), np.asarray(jopt["v"][k]),
            BF16_STEP if dtypes[k][0] == "bfloat16" else F32_STEP)
            for k in keys}
    for k in keys:
        assert str(tp[k].dtype).endswith(dtypes[k][0])
        tol_p, tol_m, tol_v = tols[k]
        _check(tp[k].float(), jp[k].astype(jnp.float32), tol_p, k)
        _check(tm[k], jopt["m"][k], tol_m, k)
        _check(tv[k], jopt["v"][k], tol_v, k)


def test_leaves_update_rejects_other_devices():
    t = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fu.leaves_update([t], [t], [t], [t], torch.zeros(7, device="meta"))
