"""Decode attention in the port against the JAX package: the cache
writes (clamping and dropping exactly as the reference does) and the
masked cached attention, dense and mixed, with GQA."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from paddle_tpu.kernels import decode_attention as jda
from paddle_tpu_torch.kernels import decode_attention as tda


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file runs (the suite runs several
    pytest-xdist workers side by side); restored after, so other files
    in the same worker keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, S, KV, HD = 3, 8, 2, 4


def _cache(seed=0):
    return np.random.RandomState(seed).randn(B, S, KV, HD).astype(np.float32)


def _write(kc, k, pos):
    want = np.asarray(jda.write_kv(jnp.asarray(kc), jnp.asarray(k),
                                   jnp.asarray(pos)))
    tpos = pos if np.ndim(pos) == 0 else torch.from_numpy(pos)
    got = tda.write_kv(torch.from_numpy(kc.copy()), torch.from_numpy(k),
                       tpos if np.ndim(pos) else int(pos))
    return got.numpy(), want


@pytest.mark.parametrize("T,pos", [(1, 0), (2, 3), (3, 5), (3, 7), (1, 9)])
def test_write_kv_scalar_pos_clamps_like_dynamic_update_slice(T, pos):
    k = np.random.RandomState(1).randn(B, T, KV, HD).astype(np.float32)
    got, want = _write(_cache(), k, np.int32(pos))
    np.testing.assert_array_equal(got, want)


def test_write_kv_per_row_single_token_clamps_past_the_end():
    k = np.random.RandomState(2).randn(B, 1, KV, HD).astype(np.float32)
    pos = np.array([0, 5, S + 3], np.int32)      # the last row clamps
    got, want = _write(_cache(), k, pos)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[2, S - 1], k[2, 0])


def test_write_kv_per_row_multi_token_drops_past_the_end():
    k = np.random.RandomState(3).randn(B, 3, KV, HD).astype(np.float32)
    pos = np.array([0, S - 2, S + 1], np.int32)  # row 1 drops one, row 2 all
    kc = _cache()
    got, want = _write(kc, k, pos)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[2], kc[2])


def _attn_inputs(H, kv, T, dtype, seed=4):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, H, HD).astype(np.float32)
    kc = rng.randn(B, S, kv, HD).astype(np.float32)
    vc = rng.randn(B, S, kv, HD).astype(np.float32)
    # the same values on both sides: bf16 inputs are rounded once here
    cast = (lambda a: np.asarray(jnp.asarray(a, dtype).astype(jnp.float32)))
    return cast(q), cast(kc), cast(vc)


@pytest.mark.parametrize("H,kv", [(4, 4), (4, 2), (6, 1)])
@pytest.mark.parametrize("T,pos", [(1, "rows"), (3, "rows"), (1, 4),
                                   (4, 0)])
def test_cached_attention_dense_matches_jax(H, kv, T, pos):
    q, kc, vc = _attn_inputs(H, kv, T, jnp.float32)
    pos = (np.array([0, 3, S - T], np.int32) if pos == "rows"
           else np.int32(pos))
    want = np.asarray(jda.cached_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos),
        impl="dense"))
    tpos = torch.from_numpy(pos) if np.ndim(pos) else int(pos)
    got = tda.cached_attention(torch.from_numpy(q), torch.from_numpy(kc),
                               torch.from_numpy(vc), tpos, impl="dense")
    assert got.dtype == torch.float32 and got.shape == (B, T, H, HD)
    # f32 scores, softmax and context on both sides
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("H,kv", [(4, 2), (4, 4)])
def test_cached_attention_mixed_matches_jax_with_bf16_cache(H, kv):
    q, kc, vc = _attn_inputs(H, kv, 1, jnp.bfloat16)
    pos = np.array([1, 4, S - 1], np.int32)
    want = np.asarray(jda.cached_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kc, jnp.bfloat16),
        jnp.asarray(vc, jnp.bfloat16), jnp.asarray(pos), impl="mixed"))
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    got = tda.cached_attention(bf(q), bf(kc), bf(vc), torch.from_numpy(pos),
                               impl="mixed")
    # 'mixed' runs QK^T and P.V in bf16: each side rounds scores,
    # probabilities and context to bf16 (2^-8 relative) at its own
    # points; |ctx| <= max|v| < 5 here, so a few bf16 steps is 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.1)
    # "paged" names a cache layout: its gathered view runs the dense
    # math, as the reference's attn_math_impl maps it
    paged = tda.cached_attention(bf(q), bf(kc), bf(vc), torch.from_numpy(pos),
                                 impl="paged")
    assert torch.equal(paged, tda.cached_attention(
        bf(q), bf(kc), bf(vc), torch.from_numpy(pos), impl="dense"))
    with pytest.raises(ValueError):
        tda.cached_attention(bf(q), bf(kc), bf(vc), torch.from_numpy(pos),
                             impl="blocked")


def test_stale_cache_beyond_the_position_is_never_attended():
    q, kc, vc = _attn_inputs(4, 2, 1, jnp.float32)
    pos = torch.tensor([2, 2, 2])
    a = tda.cached_attention(torch.from_numpy(q), torch.from_numpy(kc),
                             torch.from_numpy(vc), pos)
    kc2, vc2 = kc.copy(), vc.copy()
    kc2[:, 3:] = np.nan
    vc2[:, 3:] = 1e9
    b = tda.cached_attention(torch.from_numpy(q), torch.from_numpy(kc2),
                             torch.from_numpy(vc2), pos)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_attended_tokens_matches_jax():
    positions = np.array([3, 0, 7, 2], np.int32)
    active = np.array([True, False, True, True])
    want = int(jda.attended_tokens(jnp.asarray(positions),
                                   jnp.asarray(active)))
    got = int(tda.attended_tokens(torch.from_numpy(positions),
                                  torch.from_numpy(active)))
    assert got == want == 4 + 8 + 3
