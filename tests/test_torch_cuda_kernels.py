"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Run them where there is one:

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py

Without a card every test here skips (decided inside the `cuda_device`
fixture, never at import or collection time, so every pytest-xdist
worker collects the same tests).
"""
import pytest
import torch

from paddle_tpu_torch.kernels import quant_matmul as qm

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
          (1, 64, 128), (33, 256, 96), (5, 200, 130), (17, 70, 40)]


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
