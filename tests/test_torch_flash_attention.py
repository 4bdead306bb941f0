"""The port's flash attention (kernels/flash_attention.py) against the JAX
package: the plain forward and backward that `mha_fwd` / `mha_bwd` run on
CPU tensors, held against the Pallas kernels in interpret mode
(pallas_attention.mha_fwd / mha_bwd) and against the reference's
jax-level versions (_blockwise_attention_lse / _flash_bwd), on the same
numpy inputs, in f32. Tolerances as tests/test_kernels.py: forward rtol
1e-4 / atol 1e-5, gradients rtol 1e-3 / atol 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.kernels import pallas_attention as jpa
from paddle_tpu_torch.kernels import flash_attention as fa


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file runs (the suite runs several
    pytest-xdist workers side by side); restored after, so other files
    in the same worker keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (B, Sq, Skv, H, D, causal, kv_len): aligned and unaligned S, Sq != Skv,
# a kv_len bound, head widths 64 and 80
CASES = [
    (1, 128, 128, 2, 64, True, None),
    (1, 128, 128, 2, 64, False, None),
    (1, 100, 100, 2, 64, True, None),
    (2, 64, 128, 2, 64, True, None),
    (1, 128, 128, 2, 64, False, 90),
    (1, 128, 128, 2, 64, True, 70),
    (1, 128, 128, 2, 80, True, None),
    (1, 100, 128, 2, 80, False, 100),
]
IDS = [f"B{c[0]}-Sq{c[1]}-Skv{c[2]}-D{c[4]}-{'causal' if c[5] else 'full'}"
       f"-kv{c[6]}" for c in CASES]

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


def _inputs(B, Sq, Skv, H, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D), dtype=np.float32)
    k = rng.standard_normal((B, Skv, H, D), dtype=np.float32)
    v = rng.standard_normal((B, Skv, H, D), dtype=np.float32)
    do = rng.standard_normal((B, Sq, H, D), dtype=np.float32)
    return q, k, v, do


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _close(actual, expected, **tol):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               **tol)


@pytest.mark.parametrize("B,Sq,Skv,H,D,causal,kv_len", CASES, ids=IDS)
def test_forward_matches_pallas_and_blockwise(B, Sq, Skv, H, D, causal,
                                              kv_len):
    q, k, v, _ = _inputs(B, Sq, Skv, H, D)
    out, lse = fa.mha_fwd(*_t(q, k, v), causal=causal, kv_len=kv_len)
    assert out.shape == (B, Sq, H, D) and lse.shape == (B, H, Sq)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    p_out, p_lse = jpa.mha_fwd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal,
                               interpret=True, kv_len=kv_len)
    _close(out, p_out, **FWD_TOL)
    _close(lse, p_lse, **FWD_TOL)
    b_out, b_lse = jfa._blockwise_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, kv_len)
    _close(out, b_out, **FWD_TOL)
    _close(lse, b_lse, **FWD_TOL)


@pytest.mark.parametrize("B,Sq,Skv,H,D,causal,kv_len", CASES, ids=IDS)
def test_backward_matches_pallas_and_flash_bwd(B, Sq, Skv, H, D, causal,
                                               kv_len):
    q, k, v, do = _inputs(B, Sq, Skv, H, D, seed=1)
    out, lse = fa.mha_fwd(*_t(q, k, v), causal=causal, kv_len=kv_len)
    grads = fa.mha_bwd(*_t(q, k, v), out, lse, torch.from_numpy(do),
                       causal=causal, kv_len=kv_len)
    jargs = [jnp.asarray(a) for a in (q, k, v, out.numpy(), lse.numpy(),
                                      do)]
    pallas = jpa.mha_bwd(*jargs, causal=causal, interpret=True,
                         kv_len=kv_len)
    ref = jfa._flash_bwd(*jargs, causal, kv_len)
    for g, pg, rg in zip(grads, pallas, ref):
        assert g.dtype == torch.float32
        _close(g, pg, **GRAD_TOL)
        _close(g, rg, **GRAD_TOL)


@pytest.mark.parametrize("causal,kv_len", [(True, None), (False, 50)])
def test_autograd_function_matches_dense_autograd(causal, kv_len):
    """FlashMHA's gradients (forward mha_fwd, backward mha_bwd) against
    torch autograd through the dense O(S^2) plain version."""
    q, k, v, do = _inputs(2, 96, 96, 2, 32, seed=2)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention_fn(tq, tk, tv, causal=causal, kv_len=kv_len)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    dq_, dk_, dv_ = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    dense, _ = fa._dense_attention_lse(dq_, dk_, dv_, causal, kv_len)
    torch.testing.assert_close(out, dense, **FWD_TOL)
    dense_grads = torch.autograd.grad(dense, (dq_, dk_, dv_),
                                      torch.from_numpy(do))
    for g, dg in zip(grads, dense_grads):
        torch.testing.assert_close(g, dg, **GRAD_TOL)


def test_bf16_plain_version_matches_blockwise_in_bf16():
    """The plain version rounds where the reference's blockwise forward
    and jax-level backward round (p before p.v, ds before its products):
    in bf16 the two agree to a bf16 step."""
    q, k, v, do = _inputs(1, 128, 128, 2, 64, seed=3)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do)]
    out, lse = fa.mha_fwd(*bf[:3], causal=True)
    grads = fa.mha_bwd(*bf[:3], out, lse, bf[3], causal=True)
    jb = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in bf]
    j_out, j_lse = jfa._blockwise_attention_lse(*jb[:3], True)
    j_grads = jfa._flash_bwd(*jb[:3], j_out, j_lse, jb[3], True)
    assert out.dtype == torch.bfloat16 and grads[0].dtype == torch.bfloat16
    step = 2.0 ** -7
    _close(out.float(), np.asarray(j_out.astype(jnp.float32)),
           rtol=2 * step, atol=2 * step)
    _close(lse, j_lse, rtol=1e-5, atol=1e-5)
    for g, jgr in zip(grads, j_grads):
        jgf = np.asarray(jgr.astype(jnp.float32))
        _close(g.float(), jgf, rtol=4 * step,
               atol=4 * step * float(np.abs(jgf).max()))


def test_wrappers_reject_other_devices_and_bad_kv_len():
    q = torch.zeros(1, 4, 1, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.mha_fwd(q, q, q)
    with pytest.raises(ValueError, match="no key"):
        fa._clamp_kv_len(0, 8)
    assert fa._clamp_kv_len(None, 8) == 8 and fa._clamp_kv_len(20, 8) == 8


def test_primitives_copy_matches_the_reference():
    """kernels/primitives.py copies the reference's log-normalizer with its
    1e-30 floor; the CUDA sources carry the rest the reference's Pallas
    kernels use: the masked-score fill and the same floor."""
    import pathlib
    import re
    from paddle_tpu.kernels import primitives as jprim
    from paddle_tpu_torch.kernels import primitives as prim
    rng = np.random.default_rng(4)
    m = rng.standard_normal((5, 1)).astype(np.float32)
    l = np.array([[0.0], [1e-40], [0.5], [3.0], [1e-30]], np.float32)
    _close(prim.logsumexp_finalize(torch.from_numpy(m), torch.from_numpy(l)),
           jprim.logsumexp_finalize(jnp.asarray(m), jnp.asarray(l)),
           rtol=1e-6, atol=1e-6)
    csrc = pathlib.Path(fa.__file__).parent / "csrc"
    for name in ("flash_attention.cu", "fused_ce.cu"):
        text = (csrc / name).read_text()
        fill = re.search(r"constexpr float NEG_INF = (\S+)f;", text)
        assert fill and float(fill.group(1)) == jprim.NEG_INF, name
        assert "fmaxf(l" in text and "1e-30f" in text, name


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_card_tolerance_fails_an_error_of_typical_size():
    """chip_smoke.flash_tol, the per-entry bound the card holds the bf16
    flash kernels to: an f32 attention rounded once to bf16 passes it
    against the plain bf16 forward, while an error the size of a typical
    entry, added to the later half of the rows of out, dq, dk or dv,
    fails it in every one of those rows."""
    tol = _chip_smoke().flash_tol
    rng = np.random.default_rng(7)
    B, S, H, D = 1, 512, 2, 64
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (B, S, H, D), dtype=np.float32)).bfloat16() for _ in range(4))
    out, lse = fa.mha_fwd_ref(q, k, v, True)
    grads = fa.mha_bwd_ref(q, k, v, out, lse, do, True)
    f32 = fa._dense_attention_lse(q.float(), k.float(), v.float(), True)[0]
    assert bool(((f32.bfloat16().float() - out.float()).abs()
                 <= tol(out)).all())
    for ref in (out,) + tuple(grads):
        r = ref.float()
        bad = r.clone()
        bad[:, S // 2:] += r[:, S // 2:].abs().mean()
        fails = (bad - r).abs() > tol(ref)
        assert bool(fails[:, S // 2:].any(-1).all())
        assert not bool(fails[:, :S // 2].any())


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


def _aligned_views():
    """bf16 [B, S, H, D] operands the tensor-core backward takes: fresh
    tensors, GPT's q/k/v as views of one fused qkv, a row slice of a
    larger batch, and a head slice of a wider tensor."""
    B, S, H, D = 2, 32, 3, 48
    fresh = [_bf16(B, S, H, D) for _ in range(3)]
    qkv = list(_bf16(B, S, 3, H, D).unbind(2))
    rows = [_bf16(B, S + 8, H, D)[:, 8:] for _ in range(3)]
    heads = [_bf16(B, S, H + 1, D)[:, :, 1:] for _ in range(3)]
    return {"fresh": fresh, "qkv_unbind": qkv, "seq_slice": rows,
            "head_slice": heads}


@pytest.mark.parametrize("kind", ["fresh", "qkv_unbind", "seq_slice",
                                  "head_slice"])
def test_check_operands_takes_aligned_bf16_views(kind):
    q, k, v = _aligned_views()[kind]
    fa._check_operands("mha_fwd", q, k, v)
    fa._check_operands("mha_bwd", q, k, v, q, q)


def _misaligned(kind):
    B, S, H, D = 1, 16, 2, 64
    n = B * S * H * D
    if kind == "offset_2_bytes":
        return _bf16(n + 8)[1:1 + n].view(B, S, H, D)
    if kind == "offset_8_bytes":
        return _bf16(n + 8)[4:4 + n].view(B, S, H, D)
    if kind == "row_stride_68":
        return _bf16(B, S, H, D + 4)[..., :D]
    return _bf16(B, S, H, D + 8)[..., 4:4 + D]          # "head_dim_slice"


@pytest.mark.parametrize("kind", ["offset_2_bytes", "offset_8_bytes",
                                  "row_stride_68", "head_dim_slice"])
@pytest.mark.parametrize("slot", ["q", "k", "v", "out", "do"])
def test_check_operands_raises_on_misaligned_bf16(kind, slot):
    """The bf16 kernels copy rows by 16-byte cp.async: an operand whose
    start or (batch, seq, head) strides leave a row off a 16-byte
    boundary raises, in any operand slot."""
    ops = {n: _bf16(1, 16, 2, 64) for n in ("q", "k", "v", "out", "do")}
    ops[slot] = _misaligned(kind)
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa._check_operands("mha_bwd", ops["q"], ops["k"], ops["v"],
                           ops["out"], ops["do"])


def test_check_operands_leaves_f32_alignment_alone():
    """f32 operands run on the CUDA-core kernels, which read element by
    element: an f32 view off a 16-byte boundary passes."""
    n = 16 * 2 * 64
    q = torch.zeros(n + 4)[1:1 + n].view(1, 16, 2, 64)
    k = torch.zeros(1, 16, 2, 64)
    fa._check_operands("mha_bwd", q, k, k, q, q)


def test_flash_autograd_copies_a_misaligned_bf16_cotangent():
    """A bf16 cotangent off 16 bytes (contiguous, so .contiguous() would
    keep it) reaches the backward as a fresh copy that meets the
    kernels' rule, and the gradients are those of an aligned one."""
    B, S, H, D = 1, 32, 2, 64
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, S, H, D),
                                                        dtype=np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    n = B * S * H * D
    shifted = torch.empty(n + 8, dtype=torch.bfloat16)[1:1 + n] \
        .view(B, S, H, D).copy_(do)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16

    def bwd(q, k, v, out, lse, do, causal, kv_len):
        fa._check_operands("mha_bwd", q, k, v, out, do)
        return fa.mha_bwd_ref(q, k, v, out, lse, do, causal, kv_len)

    grads = []
    for g in (do, shifted):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fa.flash_attention_fn(*leaves, causal=True, fwd=fa.mha_fwd_ref,
                              bwd=bwd).backward(g)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
