"""Weight-only int8 in the port against the JAX package: the quantizer
bit for bit, the dequant-matmul's plain version within stated
tolerances, the leaf_matmul seam and the PADDLE_TPU_QUANT kill switch."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from paddle_tpu.kernels import quant_matmul as jqm
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import init_gpt_params as jax_init_gpt_params
from paddle_tpu.quantization import int8 as jint8
from paddle_tpu.quantization.serving import (
    quantize_serving_params as jax_quantize_serving_params)
from paddle_tpu_torch.kernels import quant_matmul as qm
from paddle_tpu_torch.quantization import int8 as tint8
from paddle_tpu_torch.quantization.serving import quantize_serving_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file runs (the suite runs several
    pytest-xdist workers side by side); restored after, so other files
    in the same worker keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", [(4, 6, 10), (2, 64, 96), (3, 5, 7, 9)])
def test_stacked_quantizer_bit_equal_to_jax(shape):
    w = np.random.RandomState(0).randn(*shape).astype(np.float32) * 3
    w[0, 0, 0] = 0.5 * np.abs(w).max()          # exercise half-to-even
    jq, js = jint8.quantize_weight_stacked(w)
    tq, ts = tint8.quantize_weight_stacked(w)
    assert tq.dtype == np.int8 and ts.dtype == np.float32
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(ts, js)
    with pytest.raises(ValueError):
        tint8.quantize_weight_stacked(np.zeros((3, 4), np.float32))


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_quantize_weight_bit_equal_to_jax(axis):
    w = np.random.RandomState(1).randn(17, 23).astype(np.float32)
    for a, b in zip(tint8.quantize_weight(w, axis),
                    jint8.quantize_weight(w, axis)):
        np.testing.assert_array_equal(a, b)


def _jax_gpt_params():
    import jax
    cfg = JaxGPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                       num_heads=2, ffn_hidden=64, max_seq_len=64,
                       sequence_parallel=False, remat=False,
                       dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in
            jax_init_gpt_params(cfg, jax.random.PRNGKey(0)).items()}


@pytest.mark.parametrize("as_tensor", [False, True])
def test_quantize_serving_params_bit_equal_to_jax(as_tensor):
    params = _jax_gpt_params()
    jq, _, jinfo = jax_quantize_serving_params(params, "gpt")
    src = ({k: torch.from_numpy(v) for k, v in params.items()}
           if as_tensor else params)
    tq, tinfo = quantize_serving_params(src, "gpt")
    assert sorted(tq) == sorted(jq)
    for k in jq:
        got = tq[k].numpy() if as_tensor else np.asarray(tq[k])
        want = np.asarray(jq[k])
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert tinfo == {k: jinfo[k] for k in tinfo}
    assert "wte" in tq and "qkv_w" not in tq
    with pytest.raises(ValueError, match="quant leaf table"):
        quantize_serving_params(params, "bert")


def _operands(M, K, N, seed=3):
    rng = np.random.RandomState(seed)
    w_q, scale = jint8.quantize_weight(rng.randn(K, N).astype(np.float32),
                                       channel_axis=1)
    scale = (scale / 127.0).astype(np.float32)
    return rng.randn(M, K).astype(np.float32), w_q, scale


@pytest.mark.parametrize("M,K,N", [(1, 64, 128), (8, 128, 384),
                                   (33, 256, 96)])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_plain_version_matches_jax_f32(M, K, N, impl):
    x, w_q, scale = _operands(M, K, N)
    want = np.asarray(jqm.quant_matmul(
        jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale), impl=impl,
        interpret=(impl == "pallas")))
    got = qm.quant_matmul_ref(torch.from_numpy(x), torch.from_numpy(w_q),
                              torch.from_numpy(scale))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    # f32 on both sides; they differ only by summation order over K
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("M,K,N", [(1, 64, 128), (8, 128, 384),
                                   (33, 256, 96)])
def test_plain_version_matches_jax_bf16(M, K, N):
    x, w_q, scale = _operands(M, K, N)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jqm.quant_matmul(
        xb, jnp.asarray(w_q), jnp.asarray(scale), impl="pallas",
        interpret=True).astype(jnp.float32))
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(
        torch.bfloat16)
    got = qm.quant_matmul_ref(xt, torch.from_numpy(w_q),
                              torch.from_numpy(scale))
    assert got.dtype == torch.bfloat16
    # the same f32 value rounds to bf16 on both sides; summation order
    # can put the two f32 sums on either side of a rounding boundary:
    # at most one bf16 step (2^-7 relative) apart
    got = got.float().numpy()
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-6)


def test_quant_matmul_on_cpu_is_the_plain_version_and_never_launches():
    x, w_q, scale = _operands(3, 16, 24)
    before = qm.launches
    xt = torch.from_numpy(x).reshape(3, 1, 16)
    y = qm.quant_matmul(xt, torch.from_numpy(w_q), torch.from_numpy(scale))
    assert y.shape == (3, 1, 24)
    torch.testing.assert_close(
        y, qm.quant_matmul_ref(xt, torch.from_numpy(w_q),
                               torch.from_numpy(scale)), rtol=0, atol=0)
    oracle = x @ (w_q.astype(np.float32) * scale[None, :])
    np.testing.assert_allclose(y.reshape(3, 24).numpy(), oracle,
                               rtol=1e-5, atol=1e-5)
    assert qm.launches == before == 0


def test_leaf_matmul_routes_by_tree():
    rng = np.random.RandomState(4)
    w = rng.randn(8, 12).astype(np.float32)
    x = torch.from_numpy(rng.randn(2, 3, 8).astype(np.float32))
    y_fp = qm.leaf_matmul(x, {"w": torch.from_numpy(w)}, "w")
    np.testing.assert_allclose(y_fp.numpy(),
                               np.einsum("btk,kn->btn", x.numpy(), w),
                               rtol=1e-6)
    w_q, scale = tint8.quantize_weight(w, channel_axis=1)
    leaves = {"w_q": torch.from_numpy(w_q),
              "w_scale": torch.from_numpy(scale / 127.0)}
    y_q = qm.leaf_matmul(x, leaves, "w")
    np.testing.assert_allclose(y_q.numpy(), y_fp.numpy(), atol=0.15)
    seen = []
    qm.leaf_matmul(x, leaves, "w",
                   qmm=lambda *a: seen.append(a) or qm.quant_matmul_ref(*a))
    assert len(seen) == 1


def test_env_kill_switch_fails_safe(monkeypatch, capsys):
    monkeypatch.setenv(qm.ENV_QUANT, "pallsa")        # typo
    assert qm.quant_impl() == "off"
    assert qm.resolve_quant("int8") is False          # the typo kills
    assert "fails safe" in capsys.readouterr().err
    monkeypatch.setenv(qm.ENV_QUANT, "off")
    assert qm.resolve_quant("int8") is False
    monkeypatch.setenv(qm.ENV_QUANT, "xla")
    assert qm.resolve_quant("off") is False           # knob off wins
    assert qm.resolve_quant("auto") is True
    monkeypatch.delenv(qm.ENV_QUANT)
    assert qm.resolve_quant("auto") is False          # default off
    assert qm.resolve_quant("int8") is True
    with pytest.raises(ValueError):
        qm.resolve_quant("fp8")


def test_registry_winner_sits_between_env_and_default(monkeypatch):
    from paddle_tpu_torch.kernels import registry
    monkeypatch.delenv(qm.ENV_QUANT, raising=False)
    asked = []

    def winner(kernel, backend=None, bucket="*", path=None):
        asked.append((kernel, backend))
        return "pallas" if kernel == "quant_matmul" else None
    monkeypatch.setattr(registry, "winner", winner)
    assert qm.quant_impl("cpu") == "pallas"
    assert qm.resolve_quant("auto", "cpu") is True     # the winner enables
    assert asked[-1] == ("quant_matmul", "cpu")
    assert qm.resolve_quant("off", "cpu") is False     # knob off wins
    monkeypatch.setenv(qm.ENV_QUANT, "off")
    assert qm.quant_impl("cpu") == "off"
    assert qm.resolve_quant("auto", "cpu") is False    # env still kills
    assert qm.resolve_quant("int8", "cpu") is False
    monkeypatch.delenv(qm.ENV_QUANT)
    monkeypatch.setattr(registry, "winner", lambda *a, **k: None)
    assert qm.resolve_quant("auto", "cpu") is False    # no row: off


@pytest.mark.parametrize("value", ["", "off", "0", "dense", "1", "on",
                                   "int8", "xla", "pallas", " PALLAS ",
                                   "pallsa", "enable"])
def test_env_classification_matches_jax(monkeypatch, value):
    monkeypatch.setenv(qm.ENV_QUANT, value)
    assert qm._env_value() == jqm._env_value()
