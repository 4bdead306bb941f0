"""The Llama serving slice of the port against the JAX package: the
grouped KV cache, the cached forward's logits and caches (prefill,
per-row decode with a row parked past the cache, a scalar position past
the RoPE table), greedy_generate and the engine's greedy streams token
for token (fp and int8, with joins, leaves and eos), the int8 launch
count, the sampled-stream invariant, and LlamaModel.generate.

A small Llama (vocab 64, hidden 64, 2 layers, 4 heads over 2 KV heads)
in f32 on both sides: tests/conftest.py pins JAX matmuls to full f32, so
the residue is f32 summation order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models import llama as jl
from paddle_tpu.quantization.serving import (
    quantize_serving_params as jax_quantize_serving_params)
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.kernels import quant_matmul as qm
from paddle_tpu_torch.models import LlamaModel
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file runs (the suite runs several
    pytest-xdist workers side by side); restored after, so other files
    in the same worker keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPE = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=64)
V, L, MAXLEN = SHAPE["vocab_size"], SHAPE["num_layers"], 32
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def setup():
    """Weights drawn with numpy at std 0.3 (norm scales near 1), as the
    GPT serving tests draw them: under the default init (0.02) a tiny
    model repeats one token forever, so token parity would mean little."""
    jc = jl.LlamaConfig(**SHAPE, dtype=jnp.float32, remat=False)
    tc = tl.LlamaConfig(**SHAPE, dtype=torch.float32, remat=False)
    shapes = {k: v.shape for k, v in
              jl.init_llama_params(jc, jax.random.PRNGKey(0)).items()}
    rng = np.random.RandomState(0)
    params = {}
    for k, shp in sorted(shapes.items()):
        if k.endswith("_w") or k == "wte":
            params[k] = rng.randn(*shp).astype(np.float32) * 0.3
        else:
            params[k] = 1.0 + 0.1 * rng.randn(*shp).astype(np.float32)
    return jc, tc, params


def _trees(params, quant):
    """The numpy tree (int8-rewritten by the JAX quantizer when `quant`)
    as JAX arrays and as port tensors."""
    if quant:
        params = {k: np.asarray(v) for k, v in
                  jax_quantize_serving_params(params, "llama")[0].items()}
    return ({k: jnp.asarray(v) for k, v in params.items()},
            params_from_jax(params, "cpu"))


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, n).astype(np.int32) for n in lens]


LENS = (5, 9, 13, 3, 7)


def test_init_kv_cache_holds_kv_heads(setup):
    jc, tc, _ = setup
    got = tl.init_kv_cache(tc, 3, 16, device="cpu")
    want = jl.init_kv_cache(jc, 3, 16)
    for name in ("k", "v"):
        assert tuple(got[name].shape) == want[name].shape == (
            L, 3, 16, SHAPE["num_kv_heads"], 16)
        assert got[name].dtype == tc.dtype and not got[name].any()
    bf = tl.init_kv_cache(tl.LlamaConfig(**SHAPE), 1, 8, device="cpu")
    assert bf["k"].dtype == torch.bfloat16


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_forward_cached_matches_jax(setup, quant):
    jc, tc, params = setup
    jp, tp = _trees(params, quant)
    B, T0, S = 3, 7, 16
    toks = np.random.RandomState(1).randint(0, V, (B, T0)).astype(np.int32)
    lj, cj = jl.llama_forward_cached(jp, jnp.asarray(toks),
                                     jl.init_kv_cache(jc, B, S), 0, jc)
    tcache = tl.init_kv_cache(tc, B, S, device="cpu")
    lt, tcache = tl.llama_forward_cached(tp, torch.from_numpy(toks), tcache,
                                         0, tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(cj["k"]),
                               **TOL)
    np.testing.assert_allclose(tcache["v"].numpy(), np.asarray(cj["v"]),
                               **TOL)
    # per-row decode positions (the engine's tick); the last row is
    # parked past the cache, where RoPE and the write both clamp
    pos = np.array([T0, T0 - 2, S + 3], np.int32)
    nxt = np.random.RandomState(2).randint(0, V, (B, 1)).astype(np.int32)
    lj2, cj2 = jl.llama_forward_cached(jp, jnp.asarray(nxt), cj,
                                       jnp.asarray(pos), jc)
    lt2, tcache = tl.llama_forward_cached(tp, torch.from_numpy(nxt), tcache,
                                          torch.from_numpy(pos), tc)
    assert np.isfinite(lt2.numpy()).all()
    np.testing.assert_allclose(lt2.numpy(), np.asarray(lj2), **TOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(cj2["k"]),
                               **TOL)
    np.testing.assert_allclose(tcache["v"].numpy(), np.asarray(cj2["v"]),
                               **TOL)
    # a scalar position past the table: the RoPE slice and the write
    # start clamp like dynamic_slice
    lj3, cj3 = jl.llama_forward_cached(jp, jnp.asarray(nxt), cj2, S + 5, jc)
    lt3, tcache = tl.llama_forward_cached(tp, torch.from_numpy(nxt), tcache,
                                          S + 5, tc)
    np.testing.assert_allclose(lt3.numpy(), np.asarray(lj3), **TOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(cj3["k"]),
                               **TOL)


def test_rope_at_per_row_positions_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 4, 16).astype(np.float32)
    cos, sin = jl._rope_tables(40, 16, 10000.0)
    idx = np.array([[1, 2, 3], [30, 31, 39]])
    want = jl._apply_rope(jnp.asarray(x), cos[idx], sin[idx])
    tcos, tsin = tl._rope_tables(40, 16, 10000.0)
    got = tl._apply_rope(torch.from_numpy(x), tcos[torch.from_numpy(idx)],
                         tsin[torch.from_numpy(idx)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_draft_slice_is_not_ported(setup):
    """The draft slice (layers=), which raised before speculative decode
    was ported, against the JAX package's: the first layer's logits and
    cache, int8 too."""
    jc, tc, params = setup
    for quant in (False, True):
        jp, tp = _trees(params, quant)
        toks = np.random.RandomState(4).randint(0, V, (2, 5)).astype(np.int32)
        lj, cj = jl.llama_forward_cached(
            jp, jnp.asarray(toks),
            {k: v[:1] for k, v in jl.init_kv_cache(jc, 2, 8).items()}, 0, jc,
            layers=1)
        cache = tl.init_kv_cache(tc, 2, 8, device="cpu")
        lt, cache = tl.llama_forward_cached(tp, torch.from_numpy(toks), cache,
                                            0, tc, layers=1)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        np.testing.assert_allclose(cache["k"][:1].numpy(),
                                   np.asarray(cj["k"]), **TOL)
        assert not cache["k"][1:].any()


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_greedy_generate_matches_jax(setup, quant):
    jc, tc, params = setup
    jp, tp = _trees(params, quant)
    prompt = _prompts((6,), seed=3)[0][None]
    want = np.asarray(jl.greedy_generate(jp, jnp.asarray(prompt), jc, 10))
    got = tl.greedy_generate(tp, torch.from_numpy(prompt).long(), tc, 10)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(want[0, 6:].tolist())) > 2      # not a constant stream


@pytest.mark.parametrize("quant", ["off", "int8"])
def test_engine_greedy_streams_token_identical_to_jax(setup, quant):
    jc, tc, params = setup
    prompts = _prompts(LENS)
    # 5 requests on 2 slots: requests join and leave mid-decode
    je = JaxEngine(params, jc, family="llama", num_slots=2, max_len=MAXLEN,
                   quant=quant)
    te = ServingEngine(params, tc, family="llama", num_slots=2,
                       max_len=MAXLEN, quant=quant, device="cpu")
    want = je.generate(prompts, 8)
    got = te.generate(prompts, 8)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    assert all(len(set(a.tolist())) > 2 for a in want)   # streams move
    assert te.quant == (quant == "int8")
    # eos: stop at the first occurrence of a token the streams do emit
    eos = int(want[0][3])
    want_e = je.generate(prompts, 8, eos_id=eos)
    reqs = [te.submit(p, 8, eos_id=eos) for p in prompts]
    te.drain()
    for a, r in zip(want_e, reqs):
        np.testing.assert_array_equal(np.asarray(r.tokens, np.int32), a)
        assert r.finish_reason == ("eos" if a[-1] == eos else "length")
    assert any(r.finish_reason == "eos" for r in reqs)


def test_int8_engine_counts_seven_leaves_a_layer_and_the_head(setup):
    _, tc, params = setup
    eng = ServingEngine(params, tc, family="llama", num_slots=2,
                        max_len=MAXLEN, quant="int8", device="cpu")
    eng.generate(_prompts(LENS), 4)
    st = eng.quant_stats()
    assert st["quant"] == "int8" and st["per_layer"] == 7 and st["head"] == 1
    c = eng.counters
    assert c["quant_matmuls"] == (7 * L + 1) * (c["prefills"]
                                                + c["decode_ticks"])
    assert qm.launches == 0                       # the CPU never launches
    assert not any(k in eng._params for k in ("q_w", "gate_w", "down_w"))
    assert tuple(eng._cache["k"].shape) == (L, 2, MAXLEN,
                                            SHAPE["num_kv_heads"], 16)


def _sampled_run(params, tc, first_max_new, second_max_new):
    """Two greedy companions, then the sampled requests (ids 2 and 3),
    on two slots: whichever companion finishes first frees the slot the
    first sampled request lands in."""
    eng = ServingEngine(params, tc, family="llama", num_slots=2,
                        max_len=MAXLEN, seed=7, max_top_k=8, device="cpu")
    pa, pb, ps = _prompts((4, 6, 5), seed=9)
    eng.submit(pa, first_max_new)
    eng.submit(pb, second_max_new)
    r = eng.submit(ps, 12, temperature=0.9, top_k=6)
    r2 = eng.submit(ps, 12, temperature=1.3)
    eng.drain()
    return r, r2


def test_sampled_streams_are_slot_and_batch_invariant(setup):
    _, tc, params = setup
    a, a2 = _sampled_run(params, tc, 2, 20)      # lands in slot 0
    b, b2 = _sampled_run(params, tc, 20, 2)      # lands in slot 1
    assert a.finish_reason == b.finish_reason == "length"
    assert a.tokens == b.tokens and a2.tokens == b2.tokens
    eng = ServingEngine(params, tc, family="llama", num_slots=1,
                        max_len=MAXLEN, device="cpu")
    greedy = eng.generate([_prompts((4, 6, 5), seed=9)[2]], 12)[0].tolist()
    assert a.tokens != greedy and a2.tokens != greedy


def test_llama_model_generate(setup):
    _, tc, params = setup
    model = LlamaModel(tc, device="cpu",
                       params=params_from_jax(params, "cpu"))
    prompts = _prompts((4, 6, 3))
    out = model.generate(prompts, 5, num_slots=2, max_len=MAXLEN)
    want = ServingEngine(params, tc, family="llama", num_slots=2,
                         max_len=MAXLEN, device="cpu").generate(prompts, 5)
    for a, b in zip(out, want):
        np.testing.assert_array_equal(a, b)
    e_fp = model._engine
    assert e_fp.family.name == "llama"
    model.generate(prompts, 2, num_slots=2, max_len=MAXLEN)
    assert model._engine is e_fp                 # reused
    model.generate(prompts, 2, num_slots=2, max_len=MAXLEN, quant="int8")
    e_q = model._engine
    assert e_q is not e_fp and e_q.quant
    with torch.no_grad():
        model.wte.mul_(2.0)                      # an in-place weight update
    again = model.generate(prompts, 5, num_slots=2, max_len=MAXLEN,
                           quant="int8")
    assert model._engine is not e_q              # never serves stale weights
    doubled = dict(params, wte=params["wte"] * 2.0)
    want_q = ServingEngine(doubled, tc, family="llama", num_slots=2,
                           max_len=MAXLEN, quant="int8",
                           device="cpu").generate(prompts, 5)
    for a, b in zip(again, want_q):
        np.testing.assert_array_equal(a, b)
