"""The GPT serving slice of the port against the JAX package: weights
carried across, the cached forward's logits and caches, greedy engine
streams token for token (fp and int8, with joins, leaves and eos), the
sampled-stream invariant, and GPTModel.generate."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.quantization.serving import (
    quantize_serving_params as jax_quantize_serving_params)
from paddle_tpu_torch.inference import ServingEngine, family_for
from paddle_tpu_torch.kernels import quant_matmul as qm
from paddle_tpu_torch.models import GPTModel
from paddle_tpu_torch.models import gpt as tgpt
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


V, D, L, H, MAXSEQ, MAXLEN = 64, 64, 2, 4, 64, 32


def _cfgs():
    jc = jgpt.GPTConfig(vocab_size=V, hidden_size=D, num_layers=L,
                        num_heads=H, max_seq_len=MAXSEQ, dtype=jnp.float32,
                        remat=False, sequence_parallel=False)
    tc = tgpt.GPTConfig(vocab_size=V, hidden_size=D, num_layers=L,
                        num_heads=H, max_seq_len=MAXSEQ, dtype=torch.float32)
    return jc, tc


@pytest.fixture(scope="module")
def setup():
    """Weights drawn with numpy at a larger std than the default init
    (0.02), under which a tiny model repeats one token forever: streams
    here change from token to token, so token parity means something."""
    jc, tc = _cfgs()
    shapes = {k: v.shape for k, v in
              jgpt.init_gpt_params(jc, jax.random.PRNGKey(0)).items()}
    rng = np.random.RandomState(0)
    params = {}
    for k, shp in shapes.items():
        if k.endswith("_w") or k in ("wte", "wpe"):
            params[k] = rng.randn(*shp).astype(np.float32) * 0.3
        elif k.endswith("_scale"):
            params[k] = 1.0 + 0.1 * rng.randn(*shp).astype(np.float32)
        else:
            params[k] = 0.05 * rng.randn(*shp).astype(np.float32)
    return jc, tc, params


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, n).astype(np.int32) for n in lens]


LENS = (5, 9, 13, 3, 7)


def test_params_from_jax_fp_and_int8(setup):
    _, _, params = setup
    qp, _, _ = jax_quantize_serving_params(params, "gpt")
    for tree in (params, {k: np.asarray(v) for k, v in qp.items()}):
        t = params_from_jax(tree, "cpu")
        assert sorted(t) == sorted(tree)
        for k, v in tree.items():
            assert t[k].numpy().dtype == v.dtype and t[k].shape == v.shape
            np.testing.assert_array_equal(t[k].numpy(), v)
    bf = np.asarray(jnp.asarray(params["wpe"], jnp.bfloat16))
    t = params_from_jax({"wpe": bf}, "cpu")["wpe"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t.float().numpy(), np.asarray(jnp.asarray(bf).astype(jnp.float32)))


@pytest.mark.parametrize("quant", [False, True])
def test_forward_cached_prefill_and_decode_match_jax(setup, quant):
    jc, tc, params = setup
    if quant:
        params = {k: np.asarray(v) for k, v in
                  jax_quantize_serving_params(params, "gpt")[0].items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = params_from_jax(params, "cpu")
    B, T0, S = 3, 7, 16
    toks = np.random.RandomState(1).randint(0, V, (B, T0)).astype(np.int32)
    lj, cj = jgpt.gpt_forward_cached(jp, jnp.asarray(toks),
                                     jgpt.init_kv_cache(jc, B, S), 0, jc)
    tcache = tgpt.init_kv_cache(tc, B, S, device="cpu")
    lt, tcache = tgpt.gpt_forward_cached(tp, torch.from_numpy(toks), tcache,
                                         0, tc)
    # f32 end to end on both sides (tests/conftest.py pins JAX matmuls to
    # full f32); the residue is f32 summation order through two layers
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **tol)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(cj["k"]),
                               **tol)
    # per-row decode positions (the engine's tick), one inactive-looking
    # row parked past the prompt
    pos = np.array([T0, T0 - 2, T0 + 3], np.int32)
    nxt = np.random.RandomState(2).randint(0, V, (B, 1)).astype(np.int32)
    lj2, cj2 = jgpt.gpt_forward_cached(jp, jnp.asarray(nxt), cj,
                                       jnp.asarray(pos), jc)
    lt2, tcache = tgpt.gpt_forward_cached(tp, torch.from_numpy(nxt), tcache,
                                          torch.from_numpy(pos), tc)
    np.testing.assert_allclose(lt2.numpy(), np.asarray(lj2), **tol)
    np.testing.assert_allclose(tcache["v"].numpy(), np.asarray(cj2["v"]),
                               **tol)
    # a scalar decode position clamps the wpe slice like dynamic_slice
    lj3, _ = jgpt.gpt_forward_cached(jp, jnp.asarray(nxt), cj2, MAXSEQ + 5,
                                     jc)
    lt3, _ = tgpt.gpt_forward_cached(tp, torch.from_numpy(nxt), tcache,
                                     MAXSEQ + 5, tc)
    np.testing.assert_allclose(lt3.numpy(), np.asarray(lj3), **tol)


def test_greedy_generate_matches_jax(setup):
    jc, tc, params = setup
    prompt = _prompts((6,), seed=3)[0][None]
    want = np.asarray(jgpt.greedy_generate(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(prompt),
        jc, 10))
    got = tgpt.greedy_generate(params_from_jax(params, "cpu"),
                               torch.from_numpy(prompt).long(), tc, 10)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(want[0, 6:].tolist())) > 2      # not a constant stream


@pytest.mark.parametrize("quant", ["off", "int8"])
def test_engine_greedy_streams_token_identical_to_jax(setup, quant):
    jc, tc, params = setup
    prompts = _prompts(LENS)
    # 5 requests on 2 slots: requests join and leave mid-decode
    je = JaxEngine(params, jc, family="gpt", num_slots=2, max_len=MAXLEN,
                   quant=quant)
    te = ServingEngine(params, tc, family="gpt", num_slots=2,
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


def test_int8_engine_counts_one_full_pass_per_prefill_and_tick(setup):
    _, tc, params = setup
    eng = ServingEngine(params, tc, num_slots=2, max_len=MAXLEN,
                        quant="int8", device="cpu")
    eng.generate(_prompts(LENS), 4)
    st = eng.quant_stats()
    assert st["quant"] == "int8" and st["per_layer"] == 4 and st["head"] == 1
    assert st["quant_bytes"] < 0.55 * st["fp_bytes"]
    c = eng.counters
    assert c["quant_matmuls"] == (4 * L + 1) * (c["prefills"]
                                                + c["decode_ticks"])
    assert qm.launches == 0                       # the CPU never launches
    assert not any(k in eng._params for k in ("qkv_w", "mlp_up_w"))


def _sampled_run(params, tc, first_max_new, second_max_new):
    """Two greedy companions, then the sampled request (id 2), on two
    slots: whichever companion finishes first frees the slot the sampled
    request lands in."""
    eng = ServingEngine(params, tc, num_slots=2, max_len=MAXLEN, seed=7,
                        max_top_k=8, device="cpu")
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
    # the draws are real: not the greedy stream of the same prompt
    eng = ServingEngine(params, tc, num_slots=1, max_len=MAXLEN,
                        device="cpu")
    greedy = eng.generate([_prompts((4, 6, 5), seed=9)[2]], 12)[0].tolist()
    assert a.tokens != greedy and a2.tokens != greedy


def test_sample_rows_depend_only_on_their_own_inputs():
    from paddle_tpu_torch.inference.serving import _sample
    g = torch.Generator().manual_seed(0)
    lg = torch.randn(5, 40, generator=g)
    temps = torch.tensor([0.0, 0.7, 1.0, 1.5, 0.9])
    top_ks = torch.tensor([0, 0, 4, 8, 1], dtype=torch.int32)
    rid = torch.tensor([3, 9, 4, 11, 2], dtype=torch.int32)
    gi = torch.tensor([0, 5, 1, 7, 2], dtype=torch.int32)
    full = _sample(lg, temps, top_ks, 1, rid, gi, 8)
    perm = torch.tensor([3, 0, 4, 2, 1])
    np.testing.assert_array_equal(
        _sample(lg[perm], temps[perm], top_ks[perm], 1, rid[perm],
                gi[perm], 8).numpy(), full[perm].numpy())
    sub = _sample(lg[1:3], temps[1:3], top_ks[1:3], 1, rid[1:3], gi[1:3], 8)
    np.testing.assert_array_equal(sub.numpy(), full[1:3].numpy())
    assert int(full[0]) == int(torch.argmax(lg[0]))         # greedy row
    top4 = torch.topk(lg[2], 4).indices.tolist()
    assert int(full[2]) in top4
    assert int(full[4]) == int(torch.argmax(lg[4]))          # top_k = 1


def test_cancel_and_poisoned_quarantine(setup):
    _, tc, params = setup
    prompts = _prompts((5, 9, 6, 3, 20))
    clean = ServingEngine(params, tc, num_slots=3, max_len=MAXLEN,
                          device="cpu").generate(prompts, 6)
    # a non-finite position embedding that only the LAST prompt reaches
    # (the others, bucket padding included, stay below position 16): its
    # prefill logits are NaN, and nothing admitted after it reuses its
    # cache row
    bad = dict(params)
    bad["wpe"] = params["wpe"].copy()
    bad["wpe"][18] = np.nan
    eng = ServingEngine(bad, tc, num_slots=3, max_len=MAXLEN, device="cpu")
    reqs = [eng.submit(p, 6) for p in prompts]
    eng.step()                                   # 0, 1, 2 in slots
    assert reqs[0].slot is not None and reqs[3].slot is None
    assert reqs[0].cancel() and not reqs[0].cancel()     # mid-decode
    assert reqs[3].cancel()                              # still queued
    eng.drain()
    reasons = [r.finish_reason for r in reqs]
    assert reasons == ["cancelled", "length", "length", "cancelled",
                       "poisoned"]
    for i in (1, 2):
        np.testing.assert_array_equal(np.asarray(reqs[i].tokens), clean[i])
    assert not eng.has_work()


def test_unported_knobs_and_families_raise(setup):
    _, tc, params = setup
    for knob in (dict(telemetry="on"), dict(retries=5),
                 dict(queue_ttl_s=1.0), dict(max_queue=4),
                 dict(tracing=True), dict(watchdog_timeout=1.0)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServingEngine(params, tc, device="cpu", **knob)
    with pytest.raises(TypeError):
        ServingEngine(params, tc, device="cpu", not_a_knob=1)
    with pytest.raises(ValueError, match="unknown model family"):
        family_for("bert")
    eng = ServingEngine(params, tc, device="cpu", kv_layout="dense",
                        spec_decode="off", max_len=MAXLEN)
    with pytest.raises(ValueError):
        eng.submit(np.arange(30), 8)             # past max_len
    with pytest.raises(ValueError):
        eng.submit([1, 2], 4, top_k=3)           # max_top_k = 0


def test_gpt_model_generate(setup):
    _, tc, params = setup
    model = GPTModel(tc, device="cpu", params=params_from_jax(params, "cpu"))
    prompts = _prompts((4, 6, 3))
    out = model.generate(prompts, 5, num_slots=2, max_len=MAXLEN)
    want = ServingEngine(params, tc, num_slots=2, max_len=MAXLEN,
                         device="cpu").generate(prompts, 5)
    for a, b in zip(out, want):
        np.testing.assert_array_equal(a, b)
    e_fp = model._engine
    model.generate(prompts, 2, num_slots=2, max_len=MAXLEN)
    assert model._engine is e_fp                 # reused
    model.generate(prompts, 2, num_slots=2, max_len=MAXLEN, quant="int8")
    assert model._engine is not e_fp and model._engine.quant
    with torch.no_grad():
        model.wte.mul_(1.0)                      # an in-place weight update
    e_q = model._engine
    model.generate(prompts, 2, num_slots=2, max_len=MAXLEN, quant="int8")
    assert model._engine is not e_q              # never serves stale weights
    fresh = GPTModel(tc, seed=3, device="cpu")
    assert sorted(dict(fresh.named_parameters())) == sorted(
        k for k in params)
    assert fresh.generate([np.array([1, 2])], 3, num_slots=1,
                          max_len=MAXLEN)[0].shape == (3,)
