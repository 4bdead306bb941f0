"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card: the int8 dequant-matmul, the flash-attention
forward and its two backward passes, the one-pass cross entropy and the
two-pass pair (forward, backward), and the fused AdamW leaf update; then
the launches of each kernel in a GPT and a Llama train step.
Run them where there is one (the card's machine has no JAX, hence
--noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Without a card every test here skips (decided inside the `cuda_device`
fixture, never at import or collection time, so every pytest-xdist
worker collects the same tests).
"""
import importlib.util
import pathlib

import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import fused_ce as fce
from paddle_tpu_torch.kernels import fused_update as fu
from paddle_tpu_torch.kernels import quant_matmul as qm
from paddle_tpu_torch.kernels import registry

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file runs (the suite runs several
    pytest-xdist workers side by side); restored after, so other files
    in the same worker keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the GPT serving path's shapes: M = 8 slots at decode, bucketed prefill
# lengths; (K, N) of qkv, attention-out, MLP-up, MLP-down and the head,
# plus ragged edges the kernel masks itself
SHAPES = [(8, 1024, 3072), (8, 1024, 1024), (8, 1024, 4096),
          (8, 4096, 1024), (8, 1024, 32768), (512, 1024, 4096),
          (1, 64, 128), (33, 256, 96), (5, 200, 130), (17, 70, 40),
          (16, 512, 384), (128, 4096, 1024)]


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


# the (K, N) of a decode tick's M = 8 leaves (qkv, attention-out, MLP-up,
# MLP-down, head), as chip_smoke.py drives them: each splits K over
# blocks but the head
DECODE_KN = list(_chip_smoke().LEAF_KN.values())
# Llama's at TinyLlama widths (q/o, k/v, gate/up, down, head)
LLAMA_KN = list(_chip_smoke().LLAMA_LEAF_KN.values())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _operands(M, K, N, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(M, K, generator=g, device=dev).to(dtype)
    w = torch.randint(-127, 128, (K, N), generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand(N, generator=g, device=dev) * 1e-2 + 1e-4
    return x, w, s


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_kernel_matches_plain_version(cuda_device, M, K, N, dtype):
    x, w, s = _operands(M, K, N, dtype, cuda_device)
    before = qm.launches
    y = qm.quant_matmul(x, w, s)
    assert qm.launches == before + 1
    ref = qm.quant_matmul_ref(x, w, s)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == (M, N)
    # one output rounding apart at most (2^-7 relative in bf16, 2^-23 in
    # f32), plus the f32 summation-order difference over K
    step = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -23
    absprod = (x.float().abs() @ w.float().abs()) * s
    tol = step * ref.float().abs() + K * 2.0 ** -24 * absprod
    assert bool(((y.float() - ref.float()).abs() <= tol).all())


def test_kernel_batched_leading_dims(cuda_device):
    x, w, s = _operands(24, 128, 256, torch.bfloat16, cuda_device)
    y = qm.quant_matmul(x.reshape(2, 12, 128), w, s)
    assert y.shape == (2, 12, 256)
    torch.testing.assert_close(y.reshape(24, 256), qm.quant_matmul(x, w, s),
                               rtol=0, atol=0)


def _qmm_tol(x, w, s, ref):
    # one bf16 output rounding apart at most, plus the f32 summation-order
    # difference over K
    absprod = (x.float().abs() @ w.float().abs()) * s
    return 2.0 ** -7 * ref.float().abs() + x.shape[1] * 2.0 ** -24 * absprod


@pytest.mark.parametrize("M,K,N", [(8, 1024, 1024), (5, 200, 130),
                                   (67, 96, 48), (16, 70, 40)])
def test_kernel_masked_path_on_unaligned_operands(cuda_device, M, K, N):
    """A weight or an x whose rows are off 16 bytes takes the kernel's
    masked loads (still the kernel, one launch), within tolerance."""
    x, w, s = _operands(M, K, N, torch.bfloat16, cuda_device, seed=4)
    wbuf = torch.empty(K * N + 16, dtype=torch.int8, device=cuda_device)
    w_off = wbuf[1:1 + K * N].view(K, N)
    w_off.copy_(w)
    xbuf = torch.empty(M * K + 8, dtype=torch.bfloat16, device=cuda_device)
    x_off = xbuf[1:1 + M * K].view(M, K)
    x_off.copy_(x)
    assert w_off.data_ptr() % 16 and x_off.data_ptr() % 16
    ref = qm.quant_matmul_ref(x, w, s)
    for xi, wi in ((x, w_off), (x_off, w), (x_off, w_off)):
        before = qm.launches
        y = qm.quant_matmul(xi, wi, s)
        assert qm.launches == before + 1
        torch.cuda.synchronize()
        assert bool(((y.float() - ref.float()).abs()
                     <= _qmm_tol(x, w, s, ref)).all())


@pytest.mark.parametrize("K,N", DECODE_KN)
def test_kernel_same_bits_twice_at_decode(cuda_device, K, N):
    """Split-K with a fixed reduction order: two calls give the same bits;
    two calls back to back on one stream share the tile counters (the
    last block of each tile resets its counter), so a second input right
    behind the first gets its own right answer."""
    x, w, s = _operands(8, K, N, torch.bfloat16, cuda_device, seed=5)
    x2 = torch.randn_like(x.float()).to(torch.bfloat16)
    first = qm.quant_matmul(x, w, s)
    other = qm.quant_matmul(x2, w, s)
    second = qm.quant_matmul(x, w, s)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))
    for xi, y in ((x, first), (x2, other)):
        ref = qm.quant_matmul_ref(xi, w, s)
        assert bool(((y.float() - ref.float()).abs()
                     <= _qmm_tol(xi, w, s, ref)).all())
    for _, ctr in qm._SPLIT_BUFS.values():
        assert int(ctr.abs().sum()) == 0


@pytest.mark.parametrize("M", [8, 16, 128, 1024])
@pytest.mark.parametrize("K,N", LLAMA_KN)
def test_kernel_matches_plain_version_at_llama_leaves(cuda_device, M, K, N):
    x, w, s = _operands(M, K, N, torch.bfloat16, cuda_device, seed=6)
    before = qm.launches
    y = qm.quant_matmul(x, w, s)
    assert qm.launches == before + 1
    ref = qm.quant_matmul_ref(x, w, s)
    torch.cuda.synchronize()
    assert y.shape == (M, N)
    assert bool(((y.float() - ref.float()).abs()
                 <= _qmm_tol(x, w, s, ref)).all())


@pytest.mark.parametrize("M,K,N", [
    (M, K, N) for M in (8, 16, 128, 512) for K, N in DECODE_KN + LLAMA_KN
] + [(1024, K, N) for K, N in LLAMA_KN])
def test_kernel_within_the_f64_bound(cuda_device, M, K, N):
    """Every element within one bf16 rounding of the f64 value of the
    same inputs, plus the error of an f32 sum of K products (chip_smoke's
    f64_oracle), on `_plan`'s plan and, where that splits K, unsplit; at
    M 1024 (the Llama path's largest prefill bucket) on Llama's leaves."""
    cs = _chip_smoke()
    x, w, s = _operands(M, K, N, torch.bfloat16, cuda_device, seed=7)
    oracle = cs.f64_oracle(torch, x, w, s)
    sm = qm._sm_count(cuda_device)
    plans = [qm._plan(M, K, N, sm), qm._plan(M, K, N, sm, max_splits=1)]
    for plan in plans:
        verdict = cs.f64_verdict(torch, qm._launch(x, w, s, plan=plan),
                                 oracle)
        assert verdict["ok"], (plan, verdict)


def test_wrapper_raises_on_bad_operands(cuda_device):
    x, w, s = _operands(8, 128, 256, torch.bfloat16, cuda_device)
    before = qm.launches
    with pytest.raises(ValueError, match="contiguous"):
        qm.quant_matmul(x, w.t().contiguous().t(), s)
    with pytest.raises(ValueError, match="contiguous"):
        qm.quant_matmul(torch.cat([x, x], 1)[:, ::2], w, s)
    with pytest.raises(TypeError):
        qm.quant_matmul(x.half(), w, s)
    with pytest.raises(TypeError):
        qm.quant_matmul(x, w.float(), s)
    with pytest.raises(ValueError, match="shapes"):
        qm.quant_matmul(x[:, :64].contiguous(), w, s)
    with pytest.raises(ValueError):
        qm.quant_matmul(x, w.cpu(), s)
    assert qm.launches == before


# ---------------------------------------------------------- flash attention
# (B, Sq, Skv, H, D, causal, kv_len): GPT's training shape at a smaller
# batch, the Llama step's widths at a smaller batch, ragged S with kv_len,
# Sq != Skv both ways, and head widths 16 to 128; q/k/v are strided views
# of one [B, S, 3, H, D] tensor where Sq == Skv, as the GPT block makes
# them
FLASH_SHAPES = [
    (2, 1024, 1024, 4, 64, True, None),
    (1, 2048, 2048, 8, 64, True, None),
    (2, 256, 256, 4, 64, False, None),
    (1, 1000, 1000, 2, 64, True, 900),
    (1, 100, 200, 2, 80, False, 150),
    (1, 200, 100, 2, 16, True, None),
    (1, 256, 256, 2, 128, True, None),
    (1, 77, 77, 3, 48, True, None),
    (1, 130, 130, 2, 96, False, None),
    (1, 64, 64, 1, 112, True, None),
    (1, 64, 64, 1, 32, True, 40),
]


def _flash_operands(B, Sq, Skv, H, D, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    if Sq == Skv:
        qkv = torch.randn(B, Sq, 3, H, D, generator=g, device=dev).to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(dtype)
        k = torch.randn(B, Skv, H, D, generator=g, device=dev).to(dtype)
        v = torch.randn(B, Skv, H, D, generator=g, device=dev).to(dtype)
    do = torch.randn(B, Sq, H, D, generator=g, device=dev).to(dtype)
    return q, k, v, do


def _close_to_plain(got, ref, dtype):
    # per entry, |err| <= a*(|ref| + rms of its row over D) + c*rms(ref),
    # so an error of an entry's typical size fails; the rms is per row
    # because a causal row attends to 1 to S keys and rows differ in
    # scale by 10x and more, and c covers rows that are zero but for f32
    # rounding noise (dq of the first causal row). f32: the same f32
    # arithmetic summed in another order, a = 2^-16, c = 2^-15. bf16:
    # each side rounds its result once, and p and ds once before their
    # products, at places that differ by the scale (the kernel scales dq
    # and dk at the end, the plain version scales ds): a = 2^-6, 2 to 4
    # bf16 steps, c = 2^-10
    a, c = (2.0 ** -16, 2.0 ** -15) if dtype == torch.float32 else (
        2.0 ** -6, 2.0 ** -10)
    r = ref.float()
    row = r.square().mean(-1, keepdim=True).sqrt()
    tol = a * (r.abs() + row) + c * r.square().mean().sqrt()
    return bool(((got.float() - r).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Skv,H,D,causal,kv_len", FLASH_SHAPES)
def test_flash_kernels_match_plain_versions(cuda_device, B, Sq, Skv, H, D,
                                            causal, kv_len, dtype):
    q, k, v, do = _flash_operands(B, Sq, Skv, H, D, dtype, cuda_device)
    before = dict(fa.launches)
    out, lse = fa.mha_fwd(q, k, v, causal=causal, kv_len=kv_len)
    dq, dk, dv = fa.mha_bwd(q, k, v, out, lse, do, causal=causal,
                            kv_len=kv_len)
    assert fa.launches == {n: c + 1 for n, c in before.items()}
    r_out, r_lse = fa.mha_fwd_ref(q, k, v, causal, kv_len)
    grads_ref = fa.mha_bwd_ref(q, k, v, out, lse, do, causal, kv_len)
    torch.cuda.synchronize()
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert _close_to_plain(out, r_out, dtype)
    assert (lse - r_lse).abs().max() <= 1e-3
    for g, r in zip((dq, dk, dv), grads_ref):
        assert g.shape == r.shape and g.dtype == dtype
        assert bool(torch.isfinite(g).all())
        assert _close_to_plain(g, r, dtype)


@pytest.mark.parametrize("causal,kv_len", [(True, None), (False, None),
                                           (True, 100), (False, 70)])
@pytest.mark.parametrize("D", [16, 32, 48, 64, 80, 96, 112, 128])
def test_flash_forward_bf16_at_every_head_dim(cuda_device, D, causal,
                                              kv_len):
    """The tensor-core forward at each instantiated head width, on GPT's
    strided q/k/v views, a ragged Sq (131 rows: two 128-row q tiles up to
    D = 64, three 64-row tiles above, the last mostly padding), with and
    without the causal mask and kv_len."""
    q, k, v, _ = _flash_operands(2, 131, 131, 3, D, torch.bfloat16,
                                 cuda_device, seed=D)
    assert q.stride(1) == 3 * 3 * D                # a view of one qkv
    before = fa.launches["flash_fwd"]
    out, lse = fa.mha_fwd(q, k, v, causal=causal, kv_len=kv_len)
    assert fa.launches["flash_fwd"] == before + 1
    r_out, r_lse = fa.mha_fwd_ref(q, k, v, causal, kv_len)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.is_contiguous()
    assert bool(torch.isfinite(out).all())
    assert _close_to_plain(out, r_out, torch.bfloat16)
    assert (lse - r_lse).abs().max() <= 1e-3


def test_flash_forward_is_deterministic(cuda_device):
    """Each output row is written once by one block: the same bits twice."""
    q, k, v, _ = _flash_operands(2, 1000, 1000, 4, 64, torch.bfloat16,
                                 cuda_device, seed=6)
    first = fa.mha_fwd(q, k, v, causal=True, kv_len=900)
    second = fa.mha_fwd(q, k, v, causal=True, kv_len=900)
    torch.cuda.synchronize()
    assert torch.equal(first[0].view(torch.int16),
                       second[0].view(torch.int16))
    assert torch.equal(first[1], second[1])


def test_flash_autograd_function_launches_the_kernels(cuda_device):
    q, k, v, do = _flash_operands(2, 128, 128, 2, 64, torch.bfloat16,
                                  cuda_device, seed=1)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    before = dict(fa.launches)
    out = fa.flash_attention_fn(*leaves, causal=True)
    grads = torch.autograd.grad(out, leaves, do)
    assert fa.launches == {n: c + 1 for n, c in before.items()}
    plain = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    r_out = fa.flash_attention_fn(*plain, causal=True, fwd=fa.mha_fwd_ref,
                                  bwd=fa.mha_bwd_ref)
    r_grads = torch.autograd.grad(r_out, plain, do)
    assert fa.launches == {n: c + 1 for n, c in before.items()}
    for g, r in zip(grads, r_grads):
        assert _close_to_plain(g, r, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_backward_is_deterministic(cuda_device, dtype):
    """Two passes without atomics: each gradient entry is written once by
    one block, so two runs on the same inputs agree to the bit."""
    q, k, v, do = _flash_operands(2, 1000, 1000, 4, 64, dtype, cuda_device,
                                  seed=2)
    out, lse = fa.mha_fwd(q, k, v, causal=True, kv_len=900)
    first = fa.mha_bwd(q, k, v, out, lse, do, causal=True, kv_len=900)
    second = fa.mha_bwd(q, k, v, out, lse, do, causal=True, kv_len=900)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32),
                           b.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32))


def test_flash_bf16_operand_off_16_bytes_raises(cuda_device):
    """The tensor-core kernels copy rows in 16-byte pieces: a bf16 operand
    that starts 2 bytes off a 16-byte boundary, or whose row stride is no
    multiple of 8 elements, raises before any launch."""
    B, S, H, D = 1, 64, 2, 64
    q, k, v, do = _flash_operands(B, S, S, H, D, torch.bfloat16,
                                  cuda_device)
    buf = torch.randn(B * S * H * D + 8, device=cuda_device).to(
        torch.bfloat16)
    shifted = buf[1:1 + B * S * H * D].view(B, S, H, D)
    wide = torch.randn(B, S, H, D + 4, device=cuda_device).to(
        torch.bfloat16)[..., :D]
    out, lse = fa.mha_fwd_ref(q, k, v, True)
    before = dict(fa.launches)
    for bad in (shifted, wide):
        with pytest.raises(ValueError, match="16-byte"):
            fa.mha_fwd(q, bad, v, causal=True)
        with pytest.raises(ValueError, match="16-byte"):
            fa.mha_bwd(q, k, v, out, lse, bad, causal=True)
        with pytest.raises(ValueError, match="16-byte"):
            fa.mha_bwd(bad, k, v, out, lse, do, causal=True)
    assert fa.launches == before


def test_flash_autograd_copies_a_misaligned_cotangent(cuda_device):
    """FlashMHA.backward hands the kernels a fresh copy of a bf16
    cotangent off 16 bytes (a contiguous view that the forward never
    saw), so the backward launches both kernels and gives the bits an
    aligned cotangent gives."""
    B, S, H, D = 1, 128, 2, 64
    q, k, v, do = _flash_operands(B, S, S, H, D, torch.bfloat16,
                                  cuda_device, seed=3)
    n = B * S * H * D
    shifted = torch.empty(n + 8, dtype=torch.bfloat16,
                          device=cuda_device)[1:1 + n].view(B, S, H, D)
    shifted.copy_(do)
    grads = []
    for g in (do, shifted):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention_fn(*leaves, causal=True)
        before = dict(fa.launches)
        out.backward(g)
        assert fa.launches["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
        assert fa.launches["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    for a, b in zip(*grads):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_spill_check_reads_a_prebuilt_library(cuda_device, monkeypatch):
    """chip_smoke.py's spill check holds when an earlier process built
    the attention library: the ptxas report is read back from beside the
    cached library, and the D = 64 backward pair shows no spills."""
    from paddle_tpu_torch.kernels import _build
    cs = _chip_smoke()
    _build.build("flash_attention")
    monkeypatch.setattr(_build, "build_logs", {})
    _build.build("flash_attention")
    rec = _build.build_logs["flash_attention"]
    assert rec["cached"]
    cs.check_no_spills(rec["ptxas"])
    assert any("flash_bwd_dq_kernel" in line
               for line in cs.ptxas_summary(rec["ptxas"]))


def test_flash_wrappers_raise_on_bad_operands(cuda_device):
    q, k, v, do = _flash_operands(1, 64, 64, 2, 64, torch.bfloat16,
                                  cuda_device)
    before = dict(fa.launches)
    with pytest.raises(TypeError):
        fa.mha_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head dim"):
        fa.mha_fwd(q[..., :40], k[..., :40], v[..., :40])
    with pytest.raises(ValueError, match="unit last stride"):
        fa.mha_fwd(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3))
    with pytest.raises(ValueError, match="shapes"):
        fa.mha_fwd(q, k[:, :, :1], v)
    with pytest.raises(ValueError):
        fa.mha_fwd(q, k.cpu(), v)
    out, lse = fa.mha_fwd_ref(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        fa.mha_bwd(q, k, v, out, lse[:, :1], do)
    assert fa.launches == before


# ------------------------------------------------------------ fused CE
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,V", [(300, 32768), (64, 50304), (33, 600),
                                 (5, 1)])
def test_fused_ce_kernel_matches_plain_version(cuda_device, T, V, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(T + V)
    x = (torch.randn(T, V, generator=g, device=cuda_device) * 3).to(dtype)
    t = torch.randint(0, V, (T,), generator=g, device=cuda_device)
    t[0] = -1                                   # gathers nothing
    before = fce.launches["fused_ce"]
    loss, dx = fce.ce_fused(x, t)
    assert fce.launches["fused_ce"] == before + 1
    r_loss, r_dx = fce.ce_fused_ref(x, t)
    torch.cuda.synchronize()
    assert loss.dtype == torch.float32 and dx.dtype == dtype
    # f32 sums of exps in another order; d_logits rounded once to the
    # dtype from f32 values that differ by ~1e-6 relative: one step
    assert (loss - r_loss).abs().max() <= 1e-4
    step = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    err = (dx.float() - r_dx.float()).abs()
    assert bool((err <= step * r_dx.float().abs() + 1e-6).all())


def test_fused_ce_train_launches_once_per_step(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(64, 1000, generator=g, device=cuda_device).to(
        torch.bfloat16).requires_grad_()
    t = torch.randint(0, 1000, (64,), generator=g, device=cuda_device)
    before = fce.launches["fused_ce"]
    loss = fce.ce_fused_train(x, t)
    (dx,) = torch.autograd.grad(loss.sum(), x)
    assert fce.launches["fused_ce"] == before + 1
    r_loss, r_dx = fce.ce_fused_ref(x.detach(), t)
    torch.testing.assert_close(loss.detach(), r_loss, rtol=0, atol=1e-4)
    assert (dx.float() - r_dx.float()).abs().max() <= 2.0 ** -7


def test_fused_ce_raises_on_bad_operands(cuda_device):
    x = torch.zeros(4, 8, device=cuda_device, dtype=torch.bfloat16)
    t = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    before = dict(fce.launches)
    with pytest.raises(TypeError):
        fce.ce_fused(x.half(), t)
    with pytest.raises(ValueError, match="contiguous"):
        fce.ce_fused(torch.zeros(8, 4, device=cuda_device,
                                 dtype=torch.bfloat16).t(), t)
    with pytest.raises(ValueError, match="shapes"):
        fce.ce_fused(x, t[:3])
    with pytest.raises(ValueError):
        fce.ce_fused(x, t.cpu())
    assert fce.launches == before


# ------------------------------------------- two-pass cross entropy
def _ce_inputs(T, V, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + T + V)
    x = (torch.randn(T, V, generator=g, device=dev) * 3).to(dtype)
    t = torch.randint(0, V, (T,), generator=g, device=dev)
    t[0] = -1                                   # gathers nothing
    return x, t


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,V", [(256, 32000), (64, 50257), (33, 600),
                                 (5, 1), (3, 7)])
def test_ce_fwd_kernel_matches_plain_version(cuda_device, T, V, dtype):
    """V 50257 in bf16 starts most rows off a 16-byte boundary, so the
    kernel's scalar head and tail carry part of every row."""
    x, t = _ce_inputs(T, V, dtype, cuda_device)
    before = fce.launches["ce_fwd"]
    loss, lse = fce.ce_fwd(x, t)
    assert fce.launches["ce_fwd"] == before + 1
    r_loss, r_lse = fce.ce_fwd_ref(x, t)
    torch.cuda.synchronize()
    assert loss.dtype == lse.dtype == torch.float32
    # f32 sums of exps in another order
    assert (loss - r_loss).abs().max() <= 1e-4
    assert (lse - r_lse).abs().max() <= 1e-4


@pytest.mark.parametrize("g_scale", ["one", "mean"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,V", [(256, 32000), (64, 50257), (33, 600),
                                 (3, 7)])
def test_ce_bwd_kernel_matches_plain_version(cuda_device, T, V, dtype,
                                             g_scale):
    """dx within one rounding step of the dtype at the entry, plus 1e-6
    of the row's |g| (exps in another order): the bound scales with g,
    so it holds at g = 1/T, where every entry is ~1e-9, as well."""
    x, t = _ce_inputs(T, V, dtype, cuda_device)
    _, lse = fce.ce_fwd_ref(x, t)
    g = torch.full((T,), 1.0 if g_scale == "one" else 1.0 / T,
                   device=cuda_device)
    g[::5] *= -3.0
    before = fce.launches["ce_bwd"]
    dx = fce.ce_bwd(x, t, lse, g)
    assert fce.launches["ce_bwd"] == before + 1
    ref = fce.ce_bwd_ref(x, t, lse, g)
    torch.cuda.synchronize()
    assert dx.dtype == dtype and dx.shape == (T, V)
    step = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -20
    tol = step * ref.float().abs() + 1e-6 * g.abs()[:, None]
    assert bool(((dx.float() - ref.float()).abs() <= tol).all())


def test_ce_with_logits_launches_forward_and_backward_once(cuda_device):
    x, t = _ce_inputs(64, 1000, torch.bfloat16, cuda_device)
    x.requires_grad_()
    before = dict(fce.launches)
    loss = fce.ce_with_logits(x, t)
    (dx,) = torch.autograd.grad(loss.mean(), x)
    assert {k: fce.launches[k] - before[k] for k in before} == {
        "ce_fwd": 1, "ce_bwd": 1, "fused_ce": 0}
    with torch.no_grad():
        fce.ce_with_logits(x, t)
    assert {k: fce.launches[k] - before[k] for k in before} == {
        "ce_fwd": 2, "ce_bwd": 1, "fused_ce": 0}
    r_loss, lse = fce.ce_fwd_ref(x.detach(), t)
    torch.testing.assert_close(loss.detach(), r_loss, rtol=0, atol=1e-4)
    ref = fce.ce_bwd_ref(x.detach(), t, lse, torch.full((64,), 1 / 64,
                                                        device=cuda_device))
    assert bool(((dx.float() - ref.float()).abs()
                 <= 2.0 ** -7 * ref.float().abs() + 1e-6 / 64).all())


def test_ce_pair_raises_on_bad_operands(cuda_device):
    x = torch.zeros(4, 8, device=cuda_device, dtype=torch.bfloat16)
    t = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    row = torch.zeros(4, device=cuda_device)
    before = dict(fce.launches)
    with pytest.raises(TypeError):
        fce.ce_fwd(x.half(), t)
    with pytest.raises(ValueError, match="contiguous"):
        fce.ce_fwd(torch.zeros(8, 4, device=cuda_device,
                               dtype=torch.bfloat16).t(), t)
    with pytest.raises(ValueError, match="shapes"):
        fce.ce_fwd(x, t[:3])
    with pytest.raises(ValueError, match="row operand"):
        fce.ce_bwd(x, t, row[:3], row)
    with pytest.raises(ValueError, match="row operand"):
        fce.ce_bwd(x, t, row, row.double())
    with pytest.raises(ValueError, match="row operand"):
        fce.ce_bwd(x, t, row.cpu(), row)
    assert fce.launches == before


# ---------------------------------------------------------- fused AdamW
def _leaf(n_shape, p_dtype, g_dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    p = (torch.randn(n_shape, generator=g, device=dev) * 0.02).to(p_dtype)
    gr = (torch.randn(n_shape, generator=g, device=dev) * 1e-3).to(g_dtype)
    m = torch.randn(n_shape, generator=g, device=dev) * 1e-4
    v = torch.rand(n_shape, generator=g, device=dev) * 1e-7
    return p, gr, m, v


def _hp(dev, step=3.0):
    b1, b2 = 0.9, 0.95
    return torch.tensor([3e-4, b1, b2, 1e-8, 0.1, 1 - b1 ** step,
                         1 - b2 ** step], device=dev)


@pytest.mark.parametrize("p_dtype,g_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("shape", [(2048, 2048), (22, 2048), (1,), (1031,),
                                   (7, 5, 3)])
def test_leaf_update_kernel_matches_plain_version(cuda_device, shape,
                                                  p_dtype, g_dtype):
    """Both round every operation on its own in the same order, and the
    card's division and square root are correctly rounded: p, m and v
    agree exactly (0 ulps)."""
    p, g, m, v = _leaf(shape, p_dtype, g_dtype, cuda_device)
    hp = _hp(cuda_device)
    want = fu.leaf_update_ref(p, g, m, v, hp)
    before = fu.launches["leaf_update"]
    out = fu.leaf_update(p, g, m, v, hp)
    assert fu.launches["leaf_update"] == before + 1
    torch.cuda.synchronize()
    assert out[0] is p and out[1] is m and out[2] is v
    for got, ref in zip(out, want):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_leaf_update_unaligned_views(cuda_device):
    """Leaves that start off a 16-byte boundary take the scalar loop."""
    p, g, m, v = _leaf((1001,), torch.float32, torch.float32, cuda_device)
    views = [t[1:] for t in (p, g, m, v)]
    hp = _hp(cuda_device)
    want = fu.leaf_update_ref(*views, hp)
    fu.leaf_update(*views, hp)
    for got, ref in zip((views[0], views[2], views[3]), want):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_leaf_update_raises_on_bad_operands(cuda_device):
    p, g, m, v = _leaf((64, 8), torch.float32, torch.float32, cuda_device)
    hp = _hp(cuda_device)
    before = fu.launches["leaf_update"]
    with pytest.raises(TypeError):
        fu.leaf_update(p.half(), g, m, v, hp)
    with pytest.raises(TypeError):
        fu.leaf_update(p, g, m.bfloat16(), v, hp)
    with pytest.raises(ValueError, match="contiguous"):
        fu.leaf_update(p.t(), g.t(), m.t(), v.t(), hp)
    with pytest.raises(ValueError, match="shapes"):
        fu.leaf_update(p, g[:3], m, v, hp)
    with pytest.raises(ValueError, match="hp"):
        fu.leaf_update(p, g, m, v, hp[:6])
    with pytest.raises(ValueError):
        fu.leaf_update(p, g, m, v, hp.cpu())
    assert fu.launches["leaf_update"] == before


def test_fused_apply_adamw_never_waits_on_the_card(cuda_device):
    """The hyperparameter vector is formed on the device from the step
    count: no host synchronisation in a step (the sync debug mode raises
    on one)."""
    from paddle_tpu_torch.models.gpt import init_opt_state
    params = {k: _leaf(s, torch.float32, torch.float32, cuda_device, i)[0]
              for i, (k, s) in enumerate({"a": (300, 7), "b": (5,)}.items())}
    opt = init_opt_state(params)
    grads = {k: torch.randn_like(p) * 1e-3 for k, p in params.items()}
    torch.cuda.synchronize()
    before = fu.launches["leaf_update"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            fu.fused_apply_adamw(grads, params, opt, 3e-4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fu.launches["leaf_update"] == before + 6
    assert float(opt["step"]) == 3.0


@pytest.fixture
def forced(monkeypatch):
    """Force registry answers in-process, as chip_smoke.py does."""
    table = {}
    orig = registry.winner
    monkeypatch.setattr(registry, "winner",
                        lambda kernel, backend=None, bucket="*", path=None:
                        table.get(kernel) or orig(kernel, backend=backend,
                                                  bucket=bucket, path=path))
    return table


# ------------------------------------------------------ train steps
def _launch_counts():
    return dict(fa.launches, **fce.launches, **fu.launches)


@pytest.mark.parametrize("remat,policy", [(False, "full"), (True, "full"),
                                          (True, "dots")])
def test_gpt_train_step_launches_each_kernel(cuda_device, monkeypatch, remat,
                                            policy):
    """A 2-layer bf16 GPT step on the card with no registry entry: the
    flash forward launches once per layer, twice under remat (the
    recompute), dq and dk/dv once per layer, the two-pass cross entropy
    once each way (the reference's default route); the loss agrees with
    the same step on the plain versions."""
    import functools
    from paddle_tpu_torch.models import gpt as tg
    from paddle_tpu_torch.models.gpt import (GPTConfig, init_gpt_params,
                                             loss_and_grads)
    from paddle_tpu_torch.models.losses import fused_softmax_ce
    cfg = GPTConfig(vocab_size=1000, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=128, remat=remat,
                    remat_policy=policy)
    params = init_gpt_params(cfg, seed=0, device=cuda_device)
    tokens = torch.randint(0, 1000, (2, 129), device=cuda_device,
                           generator=torch.Generator(
                               device=cuda_device).manual_seed(0))
    before = _launch_counts()
    loss, grads = loss_and_grads(params, tokens, cfg)
    after = _launch_counts()
    L = cfg.num_layers
    assert {k: after[k] - before[k] for k in after} == {
        "flash_fwd": 2 * L if remat else L, "flash_bwd_dq": L,
        "flash_bwd_dkv": L, "ce_fwd": 1, "ce_bwd": 1, "fused_ce": 0,
        "leaf_update": 0}
    # the same step on the plain versions: the model looks both names up
    # at each call
    monkeypatch.setattr(tg, "flash_attention_fn", functools.partial(
        fa.flash_attention_fn, fwd=fa.mha_fwd_ref, bwd=fa.mha_bwd_ref))
    monkeypatch.setattr(tg, "fused_softmax_ce", functools.partial(
        fused_softmax_ce, fwd=fce.ce_fwd_ref, bwd=fce.ce_bwd_ref,
        fused=fce.ce_fused_ref))
    p_loss, p_grads = loss_and_grads(params, tokens, cfg)
    assert _launch_counts() == after
    assert abs(float(loss) - float(p_loss)) <= 2e-3 * abs(float(p_loss))
    for name, g in grads.items():
        cos = torch.nn.functional.cosine_similarity(
            g.double().flatten(), p_grads[name].double().flatten(), dim=0)
        assert float(cos) >= 0.999, name


def _small_gpt(dev, **kw):
    from paddle_tpu_torch.models.gpt import GPTConfig, init_gpt_params
    cfg = GPTConfig(**{**dict(vocab_size=1000, hidden_size=128,
                              num_layers=2, num_heads=2, max_seq_len=128),
                       **kw})
    params = init_gpt_params(cfg, seed=0, device=dev)
    T = cfg.max_seq_len
    tokens = torch.randint(0, cfg.vocab_size, (2, T + 1), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(0))
    return cfg, params, tokens


@pytest.mark.parametrize("policy,fwd_per_layer", [("dots_flash", 1),
                                                  ("all_but_mlp", 1),
                                                  ("offload_dots", 2)])
def test_gpt_step_launches_under_the_new_remat_policies(cuda_device, policy,
                                                        fwd_per_layer):
    """"dots_flash" saves the flash forward's outputs and "all_but_mlp"
    checkpoints the FFN alone, so the forward launches once a layer;
    "offload_dots" recomputes it (twice a layer). The loss and gradients
    are the no-remat step's bits."""
    import dataclasses
    from paddle_tpu_torch.models.gpt import loss_and_grads
    cfg, params, tokens = _small_gpt(cuda_device, remat=False)
    base_loss, base_grads = loss_and_grads(params, tokens, cfg)
    cfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)
    before = _launch_counts()
    loss, grads = loss_and_grads(params, tokens, cfg)
    after = _launch_counts()
    L = cfg.num_layers
    assert {k: after[k] - before[k] for k in after} == {
        "flash_fwd": fwd_per_layer * L, "flash_bwd_dq": L,
        "flash_bwd_dkv": L, "ce_fwd": 1, "ce_bwd": 1, "fused_ce": 0,
        "leaf_update": 0}
    assert torch.equal(loss, base_loss)
    for name, g in grads.items():
        assert torch.equal(g, base_grads[name]), name


def test_offload_dots_keeps_the_dots_off_the_device(cuda_device):
    """At the same batch, "offload_dots" peaks below "dots" on the card:
    what "dots" keeps on the device waits in pinned host buffers, which
    the pool keeps from one step to the next."""
    import dataclasses
    from paddle_tpu_torch.models.gpt import loss_and_grads
    from paddle_tpu_torch.models.remat import HOST_POOL
    cfg, params, tokens = _small_gpt(cuda_device, hidden_size=256,
                                     num_layers=4, num_heads=4,
                                     max_seq_len=512)
    tokens = tokens.repeat(4, 1)                        # batch 8
    peaks, losses = {}, {}
    HOST_POOL.clear()
    for policy in ("dots", "offload_dots", "offload_dots"):
        c = dataclasses.replace(cfg, remat=True, remat_policy=policy)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, grads = loss_and_grads(params, tokens, c)
        torch.cuda.synchronize()
        peaks.setdefault(policy, []).append(
            torch.cuda.max_memory_allocated() - base)
        losses.setdefault(policy, []).append(loss)
        del grads
    pinned = HOST_POOL.pinned_bytes
    # the block's four matmul outputs, bf16: qkv, out, up, down
    B, S, D = 8, 512, 256
    dots = cfg.num_layers * B * S * (3 * D + D + 4 * D + D) * 2
    assert pinned == dots                 # sized by the first step alone
    assert max(peaks["offload_dots"]) < peaks["dots"][0]
    assert all(torch.equal(x, losses["dots"][0])
               for x in losses["offload_dots"])
    HOST_POOL.clear()


@pytest.mark.parametrize("env,attn,bwd,ce", [
    ({"PADDLE_TPU_DISABLE_PALLAS": "1"}, False, False, False),
    ({"PADDLE_TPU_DISABLE_PALLAS_ATTN": "1"}, False, False, True),
    ({"PADDLE_TPU_ATTN_IMPL": "xla"}, False, False, True),
    ({"PADDLE_TPU_DISABLE_PALLAS_BWD": "1"}, True, False, True),
    ({"PADDLE_TPU_DISABLE_PALLAS_CE": "1"}, True, True, False),
    ({"PADDLE_TPU_ATTN_IMPL": "splash"}, True, True, True),
    ({"PADDLE_TPU_ATTN_IMPL": "jax_flash"}, True, True, True),
])
def test_kill_switches_and_impls_on_the_card(cuda_device, monkeypatch, env,
                                             attn, bwd, ce):
    """A kill switch launches none of the kernels it covers; "splash" and
    "jax_flash" launch the hand kernels; the loss stays within the
    kernel-vs-plain tolerance of the default step's."""
    from paddle_tpu_torch.models.gpt import loss_and_grads
    cfg, params, tokens = _small_gpt(cuda_device, remat=False)
    want_loss = float(loss_and_grads(params, tokens, cfg)[0])
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    before = _launch_counts()
    loss = float(loss_and_grads(params, tokens, cfg)[0])
    after = _launch_counts()
    L = cfg.num_layers
    assert {k: after[k] - before[k] for k in after} == {
        "flash_fwd": L if attn else 0, "flash_bwd_dq": L if bwd else 0,
        "flash_bwd_dkv": L if bwd else 0, "ce_fwd": int(ce),
        "ce_bwd": int(ce), "fused_ce": 0, "leaf_update": 0}
    assert abs(loss - want_loss) <= 2e-3 * abs(want_loss)


@pytest.mark.parametrize("D,causal,kv_len", [(64, True, None),
                                             (64, True, 900),
                                             (64, False, None),
                                             (32, True, None),
                                             (16, False, 700)])
def test_flash_forward_tiles_agree(cuda_device, D, causal, kv_len):
    """The bf16 forward at block_q 128 and 64: each against the plain
    version, and the two the same bits (each q row walks the same kv
    tiles in the same order)."""
    q, k, v, _ = _flash_operands(2, 1000, 1000, 3, D, torch.bfloat16,
                                 cuda_device, seed=D)
    cands = fa.flash_block_candidates(D, torch.bfloat16)
    assert cands == [(128, 64), (64, 64)]
    r_out, r_lse = fa.mha_fwd_ref(q, k, v, causal, kv_len)
    outs = []
    for bq, bk in cands:
        before = fa.launches["flash_fwd"]
        out, lse = fa.mha_fwd(q, k, v, causal=causal, kv_len=kv_len,
                              block_q=bq, block_k=bk)
        assert fa.launches["flash_fwd"] == before + 1
        torch.cuda.synchronize()
        assert _close_to_plain(out, r_out, torch.bfloat16)
        assert (lse - r_lse).abs().max() <= 1e-3
        outs.append((out, lse))
    (o1, l1), (o2, l2) = outs
    assert torch.equal(o1.view(torch.int16), o2.view(torch.int16))
    assert torch.equal(l1, l2)


def test_kernel_refuses_a_tile_it_lacks(cuda_device):
    q, k, v, _ = _flash_operands(1, 128, 128, 2, 128, torch.bfloat16,
                                 cuda_device)
    before = dict(fa.launches)
    with pytest.raises(RuntimeError, match="launch failed"):
        fa._launch_fwd(q, k, v, True, 128, (128, 64))
    with pytest.raises(ValueError, match="tile"):
        fa.mha_fwd(q, k, v, causal=True, block_q=128)
    with pytest.raises(ValueError, match="tile"):
        fa.mha_fwd(q.float(), k.float(), v.float(), block_q=128)
    assert fa.launches == before


def test_autotune_picks_a_tile_on_the_card_and_caches_it(cuda_device,
                                                         monkeypatch,
                                                         tmp_path):
    from paddle_tpu_torch.kernels import autotune
    monkeypatch.setattr(autotune, "_CACHE_PATH", str(tmp_path / "at.json"))
    monkeypatch.setattr(autotune, "_CACHE", {})
    monkeypatch.setattr(autotune, "_loaded", False)
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE", "1")
    q, k, v, _ = _flash_operands(2, 512, 512, 4, 64, torch.bfloat16,
                                 cuda_device, seed=9)
    tuned0 = autotune.autotune_status()["tuned"]
    timing0 = fa.tuning_launches
    before = fa.launches["flash_fwd"]
    out, _ = fa.mha_fwd(q, k, v, causal=True)
    assert fa.launches["flash_fwd"] == before + 1    # timing not counted
    assert fa.tuning_launches == timing0 + 2 * (1 + 3)
    pick = autotune.cached("flash_fwd", fa._flash_sig(q, k, True))
    assert pick in fa.flash_block_candidates(64, torch.bfloat16)
    assert autotune.autotune_status()["tuned"] == tuned0 + 1
    again, _ = fa.mha_fwd(q, k, v, causal=True)
    assert autotune.autotune_status()["tuned"] == tuned0 + 1
    assert fa.tuning_launches == timing0 + 8
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), again.view(torch.int16))
    import json
    assert json.loads((tmp_path / "at.json").read_text()) == {
        f"flash_fwd::{fa._flash_sig(q, k, True)}": list(pick)}


def test_int8_engine_under_the_global_kill_runs_the_plain_version(
        cuda_device, monkeypatch):
    """PADDLE_TPU_DISABLE_PALLAS at engine build turns the int8 sites
    into quant_matmul_ref and leaves the weights quantized."""
    import numpy as np

    from paddle_tpu_torch.inference import ServingEngine
    cfg, params = _small_llama(cuda_device)
    prompts = [np.arange(9) % cfg.vocab_size, np.arange(17) % 100]
    launched = {}
    for kill in (False, True):
        if kill:
            monkeypatch.setenv("PADDLE_TPU_DISABLE_PALLAS", "1")
        eng = ServingEngine(params, cfg, family="llama", num_slots=2,
                            max_len=64, quant="int8", device=cuda_device)
        assert eng.quant
        before = qm.launches
        eng.generate(prompts, 4)
        launched[kill] = qm.launches - before
    assert launched[False] > 0 and launched[True] == 0


def test_ce_routes_follow_the_registry_on_the_card(cuda_device, forced):
    """"pallas_fused" launches the one-pass kernel once; "jax" launches
    none; a primal-only call on the default route launches the forward
    alone."""
    from paddle_tpu_torch.models.losses import fused_softmax_ce
    x, t = _ce_inputs(64, 1000, torch.bfloat16, cuda_device)
    t[0] = 3
    x.requires_grad_()
    runs = {}
    for impl in (None, "pallas_fused", "jax"):
        forced["ce"] = impl
        before = dict(fce.launches)
        loss = fused_softmax_ce(x, t)
        torch.autograd.grad(loss, x)
        runs[impl] = {k: fce.launches[k] - before[k] for k in before}
    assert runs == {
        None: {"ce_fwd": 1, "ce_bwd": 1, "fused_ce": 0},
        "pallas_fused": {"ce_fwd": 0, "ce_bwd": 0, "fused_ce": 1},
        "jax": {"ce_fwd": 0, "ce_bwd": 0, "fused_ce": 0}}
    forced["ce"] = None
    before = dict(fce.launches)
    with torch.no_grad():
        fused_softmax_ce(x, t)
    assert {k: fce.launches[k] - before[k] for k in before} == {
        "ce_fwd": 1, "ce_bwd": 0, "fused_ce": 0}


def test_llama_train_step_launches_each_kernel(cuda_device, forced):
    """A 2-layer bf16 GQA Llama step on the card with the fused update
    selected: flash forward 2L (remat), dq and dk/dv L, the two-pass CE
    once each way, the update once per leaf (11); the loss agrees with
    the step on the plain versions."""
    from paddle_tpu_torch.models.gpt import init_opt_state
    from paddle_tpu_torch.models.llama import (LlamaConfig,
                                               init_llama_params,
                                               train_step)
    forced["fused_update"] = "pallas"
    cfg = LlamaConfig(vocab_size=1000, hidden_size=256, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_seq_len=128)
    params = init_llama_params(cfg, seed=0, device=cuda_device)
    opt = init_opt_state(params)
    tokens = torch.randint(0, 1000, (2, 129), device=cuda_device,
                           generator=torch.Generator(
                               device=cuda_device).manual_seed(0))
    before = _launch_counts()
    loss, _, _ = train_step(params, opt, tokens, cfg)
    after = _launch_counts()
    L = cfg.num_layers
    assert {k: after[k] - before[k] for k in after} == {
        "flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
        "ce_fwd": 1, "ce_bwd": 1, "fused_ce": 0, "leaf_update": 11}
    assert torch.isfinite(loss)


# --------------------------------------------------------------------------
# the K-tick dispatch as a CUDA graph replay
# --------------------------------------------------------------------------
def _small_llama(dev):
    from paddle_tpu_torch.models import llama
    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=256, num_layers=2,
                            num_heads=4, num_kv_heads=2, max_seq_len=256,
                            dtype=torch.bfloat16, remat=False)
    params = llama.init_llama_params(cfg, seed=0, device="cpu")
    # std 0.02 weights repeat one token: widen them so streams move
    params = {k: v * 8 if k.endswith("_w") or k == "wte" else v
              for k, v in params.items()}
    return cfg, params


@pytest.mark.parametrize("layout,spec", [("dense", False), ("paged", False),
                                         ("paged", True), ("dense", True)])
def test_graphed_multi_tick_dispatch_equals_eager(cuda_device, layout, spec):
    """A K = 4 dispatch replayed from its CUDA graph leaves the emission
    matrix, the state buffers and the cache bit-equal to the same K-tick
    function run eagerly from the same state; the replay launches no
    counted kernel, the eager run 4 x the tick's int8 calls; the engine's
    streams equal its K = 1 streams, with at most two graphs captured and
    every later dispatch a replay."""
    import numpy as np

    from paddle_tpu_torch.inference import ServingEngine
    cfg, params = _small_llama(cuda_device)
    kw = dict(family="llama", num_slots=4, max_len=128, max_top_k=8,
              quant="int8", kv_layout=layout, device=cuda_device)
    if layout == "paged":
        kw.update(page_size=16, prefill_chunk=32)
    if spec:
        kw.update(spec_decode="spec", gamma=2, draft_layers=1)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in
               (9, 40, 17, 5, 23)]
    temps = [(0.0, 0), (0.9, 5), (0.0, 0), (0.0, 0), (1.1, 0)]

    def run(**extra):
        eng = ServingEngine(params, cfg, **kw, **extra)
        reqs = [eng.submit(p, 20, temperature=t, top_k=k)
                for p, (t, k) in zip(prompts, temps)]
        eng.drain()
        return eng, [r.tokens for r in reqs]
    eng1, want = run()
    cap0 = qm.captured
    eng, got = run(multi_tick=4)
    assert got == want
    c = eng.counters
    assert 1 <= c["graph_captures"] == len(eng._graphs) <= 2
    assert c["graph_replays"] == c["decode_ticks"] - c["graph_captures"]
    per_tick = eng._qmm_full + (eng.spec_gamma * eng._qmm_draft
                                if spec else 0)
    # each graph recorded the kernel, 4 x the tick's int8 calls
    assert qm.captured - cap0 == c["graph_captures"] * 4 * per_tick

    # one more dispatch, replayed and then rerun eagerly from its state
    reqs = [eng.submit(p, 12) for p in prompts[:4]]
    eng.step()                                   # admits, one dispatch
    if eng.paged:
        eng._prepare_tick_pages()
        eng._sync_page_table()
    sampling = False
    bufs = list(eng._gbufs) + [eng._cache["k"], eng._cache["v"]]
    snap = [t.clone() for t in bufs]
    n0 = qm.launches
    eng._graphs[sampling].replay()
    torch.cuda.synchronize()
    assert qm.launches == n0                     # counted at replay: none
    graphed = [eng._graph_out[sampling].clone()] + [t.clone() for t in bufs]
    for t, s in zip(bufs, snap):
        t.copy_(s)
    emit = eng._multi_ticks(sampling)
    torch.cuda.synchronize()
    assert qm.launches - n0 == 4 * per_tick
    eager = [emit] + bufs
    for a, b in zip(graphed, eager):
        assert torch.equal(a, b)
    assert (graphed[0] >= 0).any()               # real tokens came out
    eng.drain()
    assert all(r.finish_reason == "length" for r in reqs)


def test_graph_replay_survives_rope_table_eviction(cuda_device):
    """A graph bakes the RoPE tables' addresses, and `_rope_tables` is a
    bounded memo: with the tables evicted by 20 other lengths and their
    memory baited, a replay still equals the eager dispatch bit for bit
    (the engine holds what its graph read)."""
    import numpy as np

    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models import llama
    cfg, params = _small_llama(cuda_device)
    eng = ServingEngine(params, cfg, family="llama", num_slots=4,
                        max_len=128, quant="int8", multi_tick=4,
                        device=cuda_device)
    rng = np.random.default_rng(4)
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, size=n), 24)
            for n in (9, 30, 17, 5)]
    eng.step()                           # admits; warm-up, then capture
    assert eng.counters["graph_captures"] == 1
    bufs = list(eng._gbufs) + [eng._cache["k"], eng._cache["v"]]
    snap = [t.clone() for t in bufs]
    eager = [eng._multi_ticks(False).clone()] + [t.clone() for t in bufs]
    for t, s in zip(bufs, snap):
        t.copy_(s)
    held = eng._graph_held[False]
    for n in range(20):                  # evicts the engine's tables
        llama._rope_tables(1000 + n, cfg.head_dim, cfg.rope_theta,
                           cuda_device)
    fresh = llama.cached_rope_tables(cfg, eng._cache)
    assert fresh[0] is not held[0]
    bait = [torch.full_like(t, 1e4) for t in held for _ in range(8)]
    eng._graphs[False].replay()
    torch.cuda.synchronize()
    graphed = [eng._graph_out[False]] + bufs
    for a, b in zip(graphed, eager):
        assert torch.equal(a, b)
    del bait
    eng.drain()
    assert all(r.finish_reason == "length" for r in reqs)


def test_split_bufs_outgrown_after_capture_stay_alive(cuda_device):
    """A graph bakes the split-K workspace's address: a larger plan on
    the same stream after capture replaces the buffer in `_split_bufs`,
    but the old one stays allocated and the replay still gives the
    eager bits."""
    x, w, s = _operands(8, 2048, 1024, torch.bfloat16, cuda_device)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        want = qm.quant_matmul(x, w, s)         # sizes the buffers
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = qm.quant_matmul(x, w, s)
    key = (cuda_device.index, side.cuda_stream)
    baked = [t.data_ptr() for t in qm._SPLIT_BUFS[key]]
    plan = qm._plan(8, 2048, 1024, qm._sm_count(cuda_device))
    assert plan.splits > 1
    big = plan._replace(n_tiles=plan.n_tiles * 256,
                        workspace_floats=plan.workspace_floats * 256)
    grown = qm._split_bufs(cuda_device, side.cuda_stream, big)
    assert all(g.data_ptr() != b for g, b in zip(grown, baked))
    alive = {t.data_ptr() for t in qm._RETIRED_BUFS}
    assert set(baked) <= alive
    junk = torch.full((1 << 26,), 7.0, device=cuda_device)   # reuse bait
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    del junk
