"""Speculative decode in the port against the JAX package
(tests/test_spec_decode.py's and tests/test_paged_kv.py's spec checks):
the acceptance rule, the `layers=` draft slice of both families, spec
streams token for token against the JAX spec engine and the port's
non-spec engine (dense and paged, GPT and Llama), a mixed sampled and
greedy batch, the cache the in-place draft leaves behind, the page
rollback, copy-on-write under a speculating writer, and the int8 calls
of a spec tick.

The JAX test's small configs in f32 (GPT vocab 64, hidden 32, 2 layers;
Llama 4 heads over 2 KV heads), MAXLEN 64, page size 8."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models import decode as jdecode
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import llama as jl
from paddle_tpu_torch.inference import ServingEngine, spec_decode
from paddle_tpu_torch.inference import serving as srv
from paddle_tpu_torch.kernels import quant_matmul as qm
from paddle_tpu_torch.kernels.decode_attention import gather_pages
from paddle_tpu_torch.models import LlamaModel
from paddle_tpu_torch.models import decode as tdecode
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import params_from_jax
from test_torch_paged_kv import (GPT_SHAPE, LLAMA_SHAPE, MAXLEN, PS, V,
                                 _assert_streams, _check_pool,
                                 _numpy_params, _prompts)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file runs (the suite runs several
    pytest-xdist workers side by side); restored after, so other files
    in the same worker keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GAMMA = 3


@pytest.fixture(scope="module")
def families():
    """{family: (jax cfg, port cfg, numpy params, jax module, port
    module)}."""
    jg = jgpt.GPTConfig(**GPT_SHAPE, sequence_parallel=False, remat=False,
                        dtype=jnp.float32)
    jlc = jl.LlamaConfig(**LLAMA_SHAPE, dtype=jnp.float32, remat=False)
    out = {}
    for name, jc, tc, jmod, tmod, init in (
            ("gpt", jg, tgpt.GPTConfig(**GPT_SHAPE, dtype=torch.float32),
             jgpt, tgpt, jgpt.init_gpt_params),
            ("llama", jlc, tl.LlamaConfig(**LLAMA_SHAPE, dtype=torch.float32,
                                          remat=False),
             jl, tl, jl.init_llama_params)):
        shapes = {k: v.shape for k, v in
                  init(jc, jax.random.PRNGKey(0)).items()}
        out[name] = (jc, tc, _numpy_params(shapes), jmod, tmod)
    return out


def _engine(params, cfg, family, layout, **kw):
    kw.setdefault("num_slots", 3)
    if layout == "paged":
        kw.setdefault("page_size", PS)
    return ServingEngine(params, cfg, family=family, max_len=MAXLEN,
                         kv_layout=layout, device="cpu", **kw)


def _fwd(tmod):
    return tmod.gpt_forward_cached if tmod is tgpt else \
        tmod.llama_forward_cached


def test_greedy_accept_matches_jax():
    rng = np.random.RandomState(0)
    for g in (1, 3, 6):
        target = rng.randint(0, 4, (64, g + 1)).astype(np.int32)
        draft = np.where(rng.rand(64, g) < 0.7, target[:, :g],
                         rng.randint(0, 4, (64, g))).astype(np.int32)
        want = np.asarray(jdecode.greedy_accept(jnp.asarray(draft),
                                                jnp.asarray(target)))
        got = tdecode.greedy_accept(torch.from_numpy(draft),
                                    torch.from_numpy(target))
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.min() == 0 and want.max() == g   # both ends reached


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_layers_draft_writes_equal_the_full_pass(families, family):
    """forward_cached(layers=K) writes layers < K with the bits the full
    pass writes there, leaves the rest alone, and gives the JAX draft
    slice's logits; a paged cache the same."""
    jc, tc, params, jmod, tmod = families[family]
    fwd = _fwd(tmod)
    tp = params_from_jax(params, "cpu")
    B, T0, S = 2, 7, 16
    toks = np.random.RandomState(1).randint(0, V, (B, T0)).astype(np.int32)
    full = tmod.init_kv_cache(tc, B, S, device="cpu")
    fwd(tp, torch.from_numpy(toks), full, 0, tc)
    draft = tmod.init_kv_cache(tc, B, S, device="cpu")
    lt, _ = fwd(tp, torch.from_numpy(toks), draft, 0, tc, layers=1)
    assert torch.equal(draft["k"][0], full["k"][0])
    assert torch.equal(draft["v"][0], full["v"][0])
    assert not draft["k"][1:].any() and not draft["v"][1:].any()
    jfwd = jmod.gpt_forward_cached if family == "gpt" else \
        jmod.llama_forward_cached
    jcache = jmod.init_kv_cache(jc, B, S)
    jcache = {k: v[:1] for k, v in jcache.items()}
    lj, cj = jfwd({k: jnp.asarray(v) for k, v in params.items()},
                  jnp.asarray(toks), jcache, 0, jc, layers=1)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(draft["k"][:1].numpy(), np.asarray(cj["k"]),
                               rtol=1e-4, atol=1e-4)
    # the same draft over a paged pool, rows at their own positions
    P = 1 + B * (S // PS)
    pool = tmod.init_kv_cache(tc, P, PS, device="cpu")
    pt = torch.arange(1, P).reshape(B, S // PS)
    lp, _ = fwd(tp, torch.from_numpy(toks), dict(pool, pt=pt),
                torch.zeros(B, dtype=torch.long), tc, layers=1)
    np.testing.assert_allclose(lp.numpy(), lt.numpy(), rtol=1e-5, atol=1e-5)
    view = gather_pages(pool["k"][0], pt)
    assert torch.equal(view[:, :T0], draft["k"][0][:, :T0])
    assert not pool["k"][1].any()


@pytest.fixture(scope="module")
def jax_spec_streams(families):
    """The JAX spec engine's greedy streams, one per family (GPT dense,
    Llama paged with chunked prefill)."""
    prompts = _prompts([3, 11, 25, 40, 7], seed=31)
    out = {}
    for family, kw in (("gpt", {}),
                       ("llama", dict(kv_layout="paged", page_size=PS,
                                      prefill_chunk=PS))):
        jc, _, params, _, _ = families[family]
        out[family] = JaxEngine(
            params, jc, family=family, num_slots=3, max_len=MAXLEN,
            spec_decode="spec", gamma=GAMMA, draft_layers=1,
            **kw).generate(prompts, 10)
    return prompts, out


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_spec_streams_equal_jax_and_nonspec(families, jax_spec_streams,
                                            family, layout):
    _, tc, params, _, _ = families[family]
    prompts, want = jax_spec_streams
    assert len(set(np.concatenate(want[family]).tolist())) > 5
    kw = dict(prefill_chunk=PS) if layout == "paged" else {}
    eng = _engine(params, tc, family, layout, spec_decode="spec",
                  gamma=GAMMA, draft_layers=1, **kw)
    got = eng.generate(prompts, 10)
    _assert_streams(got, want[family])
    plain = _engine(params, tc, family, layout, **kw).generate(prompts, 10)
    _assert_streams(plain, want[family])
    c = eng.counters
    assert c["decode_ticks"] < 5 * 9            # it took fewer ticks
    assert 0 < c["spec_accepted"] <= c["spec_proposed"]
    assert c["tokens_emitted"] == 50
    if layout == "paged":
        _check_pool(eng)
        assert eng.pool_stats()["pages_in_use"] == 0


def test_spec_knobs_and_kill_switch(families, monkeypatch):
    _, tc, params, _, _ = families["llama"]
    eng = _engine(params, tc, "llama", "dense", spec_decode="spec")
    assert eng.spec and eng.spec_gamma == 4 and eng.spec_draft_layers == 1
    assert not _engine(params, tc, "llama", "dense").spec   # auto: off
    monkeypatch.setenv("PADDLE_TPU_SPEC_DECODE", "spec")
    assert _engine(params, tc, "llama", "dense").spec
    monkeypatch.setenv("PADDLE_TPU_SPEC_DECODE", "off")
    assert not _engine(params, tc, "llama", "dense",
                       spec_decode="spec").spec
    monkeypatch.setenv("PADDLE_TPU_SPEC_DECODE", "bogus")
    assert spec_decode.spec_decode_impl("cpu") == "off"
    monkeypatch.delenv("PADDLE_TPU_SPEC_DECODE")
    with pytest.raises(ValueError, match="draft_layers"):
        _engine(params, tc, "llama", "dense", spec_decode="spec",
                draft_layers=3)
    with pytest.raises(ValueError, match="gamma"):
        _engine(params, tc, "llama", "dense", spec_decode="spec", gamma=0)
    with pytest.raises(ValueError):
        spec_decode.resolve_spec("maybe")
    # A5's knobs are ported: they build and take effect
    eng = _engine(params, tc, "llama", "paged", spec_decode="spec",
                  multi_tick=4, host_kv_bytes=1 << 20)
    assert eng.mt_k == 4 and eng._host_tier is not None
    assert eng._tick_span == 4 * (eng.spec_gamma + 1)
    # tensor-parallel serving is ported (A6d): a mesh without a tp axis
    # is refused by name
    import types
    with pytest.raises(ValueError, match="has no 'tp' axis"):
        _engine(params, tc, "llama", "paged",
                mesh=types.SimpleNamespace(mesh_dim_names=("dp",),
                                           shape=(1,)))
    # the watchdog is ported (A7 part 2): the paged spec engine builds
    # with it and takes its budget
    eng = _engine(params, tc, "llama", "paged", spec_decode="spec",
                  watchdog_timeout=1.0)
    assert eng.spec and eng.paged and eng.watchdog_timeout == 1.0


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_mixed_sampled_and_greedy_batch(families, layout):
    """Sampled rows ride the spec tick on verify row 0 and never accept
    drafts: their streams equal the non-spec engine's, as do the greedy
    rows'."""
    _, tc, params, _, _ = families["gpt"]
    prompts = _prompts([5, 9, 14, 6], seed=32)
    temps = [(0.0, 0), (0.9, 5), (0.0, 0), (1.1, 0)]

    def run(**kw):
        eng = _engine(params, tc, "gpt", layout, max_top_k=8, seed=3, **kw)
        reqs = [eng.submit(p, 10, temperature=t, top_k=k)
                for p, (t, k) in zip(prompts, temps)]
        eng.drain()
        return [r.tokens for r in reqs], eng
    want, _ = run()
    got, eng = run(spec_decode="spec", gamma=GAMMA, draft_layers=1)
    _assert_streams(got, want)
    greedy = _engine(params, tc, "gpt", layout).generate(prompts, 10)
    assert want[1] != greedy[1].tolist() and want[3] != greedy[3].tolist()
    assert eng.counters["spec_accepted"] > 0


class _ThrowawayDraft:
    """The reference's draft semantics as a forward: draft passes
    (layers=) write a copy of the cache made at the tick's first draft
    step, which the verify pass (no layers=) discards."""

    def __init__(self, fwd):
        self.fwd, self.view = fwd, None

    def __call__(self, params, tokens, cache, pos, cfg, layers=None):
        if layers is None:
            self.view = None
            return self.fwd(params, tokens, cache, pos, cfg)
        if self.view is None:
            self.view = {k: v.clone() for k, v in cache.items()}
        return self.fwd(params, tokens, self.view, pos, cfg, layers=layers)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_in_place_draft_leaves_the_cache_of_a_throwaway_draft(
        families, family, layout):
    """The draft writes the real cache in place (layers < draft_layers,
    positions pos..pos+gamma-1). After every spec tick the whole cache
    (the pool but its scratch page) holds the bits an engine whose draft
    writes a throwaway copy holds, as the reference's does: the verify
    pass rewrote every position the draft wrote. Below each row's new
    position it also holds the non-spec engine's values (to f32
    rounding: the verify pass multiplies gamma+1 rows where the non-spec
    tick multiplies one, and CPU matmul bits depend on the row count)."""
    _, tc, params, _, tmod = families[family]
    L = tc.num_layers
    prompts = _prompts([5, 13, 9], seed=33)
    kw = dict(spec_decode="spec", gamma=GAMMA, draft_layers=1)
    fam = srv.ModelFamily(family, _ThrowawayDraft(_fwd(tmod)),
                          tmod.init_kv_cache)
    ref = _engine(params, tc, fam, layout, **kw)
    b = _engine(params, tc, family, layout, **kw)
    a = _engine(params, tc, family, layout)
    for p in prompts:
        for eng in (a, b, ref):
            eng.submit(p, 20)

    def view(eng, name, i, n):
        if layout == "dense":
            return eng._cache[name][:, i, :n]
        pt = torch.from_numpy(eng._ptab[i:i + 1])
        return torch.stack([gather_pages(eng._cache[name][layer], pt)[0, :n]
                            for layer in range(L)])
    checks = 0
    while b.has_work():
        b.step()
        ref.step()
        np.testing.assert_array_equal(b._positions, ref._positions)
        for name in ("k", "v"):
            if layout == "paged":
                np.testing.assert_array_equal(b._ptab, ref._ptab)
                assert torch.equal(b._cache[name][:, 1:],
                                   ref._cache[name][:, 1:]), name
            else:
                assert torch.equal(b._cache[name], ref._cache[name]), name
        while a.has_work() and any(
                b._active[i] and (not a._active[i]
                                  or a._positions[i] < b._positions[i])
                for i in range(3)):
            a.step()
        for i in range(3):
            n = int(b._positions[i])
            if b._active[i] and a._active[i] and a._positions[i] == n:
                for name in ("k", "v"):
                    np.testing.assert_allclose(
                        view(b, name, i, n).numpy(),
                        view(a, name, i, n).numpy(), rtol=1e-5, atol=1e-5)
                checks += 1
    a.drain()
    assert checks >= 10


def test_spec_rollback_keeps_shared_pages_and_accounting(families):
    """Gamma-token verify writes and the rejected-page rollback leave
    the shared prefix pages bit-equal to the non-spec engine's and, at
    the end, the pool accounting equal; between ticks no slot maps a
    page past its position."""
    _, tc, params, _, _ = families["gpt"]
    rng = np.random.RandomState(23)
    system = rng.randint(0, V, 2 * PS).astype(np.int32)
    prompts = [np.concatenate([system, rng.randint(0, V, k).astype(np.int32)])
               for k in (2, 3)]
    ref = _engine(params, tc, "gpt", "paged")
    want = ref.generate(prompts, 8)
    ref_pids = sorted(ref._pool.by_key.values())
    ref_pages = ref._cache["k"][:, ref_pids].clone()
    eng = _engine(params, tc, "gpt", "paged", spec_decode="spec", gamma=GAMMA,
                  draft_layers=tc.num_layers)
    reqs = [eng.submit(p, 8) for p in prompts]
    while eng.has_work():
        eng.step()
        _check_pool(eng)
        for i in np.nonzero(eng._active)[0]:
            first = -(-int(eng._positions[i]) // PS)
            assert not eng._ptab[i, first:].any(), \
                "speculative pages survived the rollback"
    _assert_streams([r.tokens for r in reqs], want)
    pids = sorted(eng._pool.by_key.values())
    assert torch.equal(eng._cache["k"][:, pids], ref_pages)
    got, exp = eng.pool_stats(), ref.pool_stats()
    for key in ("pages_in_use", "pages_cached", "pages_shared",
                "pages_reserved", "pages_free"):
        assert got[key] == exp[key], (key, got, exp)


def test_spec_cow_sharer_isolated_from_speculating_writer(families):
    _, tc, params, _, _ = families["llama"]
    prompt = _prompts([2 * PS], seed=24)[0]               # page-aligned
    want = _engine(params, tc, "llama", "dense").generate([prompt], 8)[0]
    eng = _engine(params, tc, "llama", "paged", spec_decode="spec", gamma=4,
                  draft_layers=1)
    ra = eng.submit(prompt, 8)
    rb = eng.submit(prompt, 8)                            # aligned-full COW
    eng.drain()
    assert eng.pool_stats()["cow_copies"] > 0
    _assert_streams([ra.tokens, rb.tokens], [want, want])
    _check_pool(eng)


def test_int8_calls_of_a_spec_tick(families, monkeypatch):
    """Counted at the plain version the CPU path calls: a full pass a
    tick plus gamma draft passes of draft_layers layers and the head,
    7 leaves a Llama layer; the engine's own count the same."""
    _, tc, params, _, _ = families["llama"]
    calls = {"n": 0}
    real = qm.quant_matmul_ref

    def counting(x, w_q, scale):
        calls["n"] += 1
        return real(x, w_q, scale)
    monkeypatch.setattr(qm, "quant_matmul_ref", counting)
    L, K = tc.num_layers, 1
    eng = _engine(params, tc, "llama", "paged", quant="int8",
                  spec_decode="spec", gamma=GAMMA, draft_layers=K)
    reqs = [eng.submit(p, 12) for p in _prompts([5, 9], seed=34)]
    eng.step()                                   # the prefills and a tick
    q0, c0 = calls["n"], eng.counters["quant_matmuls"]
    eng.step()
    per_tick = (7 * L + 1) + GAMMA * (7 * K + 1)
    assert calls["n"] - q0 == per_tick
    assert eng.counters["quant_matmuls"] - c0 == per_tick
    eng.drain()
    c = eng.counters
    assert calls["n"] == c["quant_matmuls"] == (7 * L + 1) * (
        c["prefill_chunks"] + c["decode_ticks"]) + GAMMA * (
        7 * K + 1) * c["decode_ticks"]
    assert all(r.finish_reason == "length" for r in reqs)
    assert qm.launches == 0                      # the CPU never launches


def test_llama_model_generate_passes_the_paged_and_spec_knobs(families):
    _, tc, params, _, _ = families["llama"]
    model = LlamaModel(tc, device="cpu",
                       params=params_from_jax(params, "cpu"))
    prompts = _prompts([4, 19, 11], seed=35)
    want = model.generate(prompts, 6, num_slots=2, max_len=MAXLEN)
    dense = model._engine
    knobs = dict(kv_layout="paged", page_size=PS, prefill_chunk=PS,
                 spec_decode="spec", gamma=2, draft_layers=1)
    _assert_streams(model.generate(prompts, 6, num_slots=2, max_len=MAXLEN,
                                   **knobs), want)
    eng = model._engine
    assert eng is not dense and eng.paged and eng.spec
    assert eng.spec_gamma == 2 and eng.prefill_chunk == PS
    model.generate(prompts, 6, num_slots=2, max_len=MAXLEN, **knobs)
    assert model._engine is eng                      # reused
    model.generate(prompts, 6, num_slots=2, max_len=MAXLEN,
                   **dict(knobs, gamma=3))
    assert model._engine is not eng and model._engine.spec_gamma == 3
