"""Multi-tick decode and the host KV tier of the port against the JAX
package (tests/test_multi_tick.py's TestResolve, TestParity,
TestDispatchEconomy and TestHostTier), and the capture-safety repairs
of the tick (each bit-equal to the code it replaced).

The JAX test's small configs in f32 (GPT vocab 64, hidden 32, 2 layers;
Llama 4 heads over 2 KV heads), MAXLEN 64, page size 8, weights drawn
by numpy at std 0.3 so that the streams move. Sampled streams are held
to the port's own K = 1 streams here; both draw with the reference's
threefry keys on (seed, request id, token index), and
tests/test_torch_prng.py holds them to the JAX engines' streams."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import llama as jl
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.inference import multi_tick as mt
from paddle_tpu_torch.inference import serving as srv
from paddle_tpu_torch.inference.host_kv import HostKVTier, resolve_host_kv
from paddle_tpu_torch.kernels import decode_attention as tda
from paddle_tpu_torch.models import GPTModel
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama as tl
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


@pytest.fixture(scope="module")
def families():
    """{family: (jax cfg, port cfg, numpy params)}."""
    out = {}
    for name, jc, tc, init in (
            ("gpt", jgpt.GPTConfig(**GPT_SHAPE, sequence_parallel=False,
                                   remat=False, dtype=jnp.float32),
             tgpt.GPTConfig(**GPT_SHAPE, dtype=torch.float32),
             jgpt.init_gpt_params),
            ("llama", jl.LlamaConfig(**LLAMA_SHAPE, dtype=jnp.float32,
                                     remat=False),
             tl.LlamaConfig(**LLAMA_SHAPE, dtype=torch.float32, remat=False),
             jl.init_llama_params)):
        shapes = {k: v.shape for k, v in
                  init(jc, jax.random.PRNGKey(0)).items()}
        out[name] = (jc, tc, _numpy_params(shapes))
    return out


def _eng(params, cfg, family="gpt", **kw):
    kw.setdefault("num_slots", 3)
    kw.setdefault("kv_layout", "dense")
    if kw["kv_layout"] == "paged":
        kw.setdefault("page_size", PS)
    return ServingEngine(params, cfg, family=family, max_len=MAXLEN,
                         device="cpu", **kw)


SPEC = dict(spec_decode="spec", gamma=2, draft_layers=1)


# ---------------------------------------------------------------- selection
class TestResolve:
    def test_default_off(self, monkeypatch):
        monkeypatch.delenv(mt.ENV_MULTI_TICK, raising=False)
        assert mt.resolve_multi_tick(0) == 1
        assert mt.multi_tick_impl("cpu") == "off"   # no table committed

    def test_explicit_knob(self, monkeypatch):
        monkeypatch.delenv(mt.ENV_MULTI_TICK, raising=False)
        assert mt.resolve_multi_tick(4) == 4
        assert mt.resolve_multi_tick(1) == 1

    def test_env_kill_switch_beats_knob(self, monkeypatch):
        for v in ("0", "off", "false", "no", "single", "1"):
            monkeypatch.setenv(mt.ENV_MULTI_TICK, v)
            assert mt.resolve_multi_tick(8) == 1

    def test_env_int_enables(self, monkeypatch):
        monkeypatch.setenv(mt.ENV_MULTI_TICK, "6")
        assert mt.resolve_multi_tick(0) == 6
        # an explicit engine knob still wins in the on direction
        assert mt.resolve_multi_tick(3) == 3

    def test_env_scan_uses_default(self, monkeypatch):
        monkeypatch.setenv(mt.ENV_MULTI_TICK, "scan")
        assert mt.resolve_multi_tick(0) == mt.DEFAULT_MULTI_TICK_K

    def test_garbage_fails_safe_off(self, monkeypatch, capsys):
        monkeypatch.setenv(mt.ENV_MULTI_TICK, "turbo")
        assert mt.resolve_multi_tick(0) == 1
        assert "treating as 'off'" in capsys.readouterr().err

    def test_negative_raises(self, monkeypatch):
        monkeypatch.delenv(mt.ENV_MULTI_TICK, raising=False)
        with pytest.raises(ValueError):
            mt.resolve_multi_tick(-2)

    def test_registry_winner_enables(self, monkeypatch):
        from paddle_tpu_torch.kernels import registry
        monkeypatch.delenv(mt.ENV_MULTI_TICK, raising=False)
        monkeypatch.setattr(
            registry, "winner",
            lambda kernel, backend=None, **kw:
            "scan" if (kernel, backend) == ("multi_tick", "cpu") else None)
        assert mt.multi_tick_impl("cpu") == "scan"
        assert mt.resolve_multi_tick(0, "cpu") == mt.DEFAULT_MULTI_TICK_K

    def test_host_kv_resolve(self, monkeypatch, capsys):
        monkeypatch.delenv("PADDLE_TPU_HOST_KV", raising=False)
        assert resolve_host_kv(1 << 20) == 1 << 20
        monkeypatch.setenv("PADDLE_TPU_HOST_KV", "off")
        assert resolve_host_kv(1 << 20) == 0
        monkeypatch.setenv("PADDLE_TPU_HOST_KV", str(1 << 16))
        assert resolve_host_kv(0) == 1 << 16
        monkeypatch.setenv("PADDLE_TPU_HOST_KV", "lots")
        assert resolve_host_kv(1 << 20) == 0
        assert "treating as 'off'" in capsys.readouterr().err
        with pytest.raises(ValueError):
            resolve_host_kv(-1)

    def test_engine_knobs(self, families, monkeypatch):
        _, tc, params = families["gpt"]
        monkeypatch.delenv(mt.ENV_MULTI_TICK, raising=False)
        eng = _eng(params, tc, multi_tick=4)
        assert eng.mt_k == 4 and eng._tick_span == 4
        monkeypatch.setenv(mt.ENV_MULTI_TICK, "off")
        assert _eng(params, tc, multi_tick=4).mt_k == 1
        # the tier rides the paged layout with prefix sharing only
        assert _eng(params, tc, host_kv_bytes=1 << 20)._host_tier is None
        assert _eng(params, tc, kv_layout="paged", prefix_sharing=False,
                    host_kv_bytes=1 << 20)._host_tier is None
        assert _eng(params, tc, kv_layout="paged",
                    host_kv_bytes=1 << 20)._host_tier is not None


# ------------------------------------------------------------ stream parity
@pytest.fixture(scope="module")
def jax_streams(families):
    """The JAX engine's multi_tick=4 greedy streams: GPT dense, Llama
    paged with chunked prefill, and both with spec decode."""
    prompts = _prompts([5, 7, 6, 23, 11], seed=41)
    out = {}
    for key, family, kw in (
            ("gpt", "gpt", {}),
            ("llama_paged", "llama",
             dict(kv_layout="paged", page_size=PS, prefill_chunk=PS)),
            ("gpt_spec", "gpt", dict(kv_layout="paged", page_size=PS,
                                     **SPEC)),
            ("llama_spec", "llama", SPEC)):
        jc, _, params = families[family]
        out[key] = JaxEngine(params, jc, family=family, num_slots=3,
                             max_len=MAXLEN, multi_tick=4,
                             **kw).generate(prompts, 12)
    return prompts, out


class TestParity:
    @pytest.mark.parametrize("k", [1, 4, 8])
    def test_gpt_dense_greedy(self, families, jax_streams, k):
        _, tc, params = families["gpt"]
        prompts, want = jax_streams
        assert len(set(np.concatenate(want["gpt"]).tolist())) > 5
        eng = _eng(params, tc, multi_tick=k)
        _assert_streams(eng.generate(prompts, 12), want["gpt"])
        assert eng.counters["graph_captures"] == 0       # no card here

    @pytest.mark.parametrize("layout", ["dense", "paged"])
    @pytest.mark.parametrize("family", ["gpt", "llama"])
    def test_greedy_layouts(self, families, jax_streams, family, layout):
        """Both layouts, with chunked prefill where paged, against the
        JAX engine's K = 4 streams (its dense and paged streams are the
        same) and the port's own K = 1."""
        _, tc, params = families[family]
        prompts, want = jax_streams
        want = want["gpt" if family == "gpt" else "llama_paged"]
        kw = dict(prefill_chunk=PS) if layout == "paged" else {}
        eng = _eng(params, tc, family, kv_layout=layout, multi_tick=4,
                   **kw)
        _assert_streams(eng.generate(prompts, 12), want)
        _assert_streams(_eng(params, tc, family, kv_layout=layout,
                             **kw).generate(prompts, 12), want)
        if layout == "paged":
            _check_pool(eng)
            assert eng.pool_stats()["pages_in_use"] == 0

    @pytest.mark.parametrize("layout", ["dense", "paged"])
    @pytest.mark.parametrize("family", ["gpt", "llama"])
    def test_spec(self, families, jax_streams, family, layout):
        _, tc, params = families[family]
        prompts, want = jax_streams
        eng = _eng(params, tc, family, kv_layout=layout, multi_tick=4,
                   **SPEC)
        got = eng.generate(prompts, 12)
        _assert_streams(got, want[family + "_spec"])
        _assert_streams(got, _eng(params, tc, family).generate(prompts, 12))
        c = eng.counters
        assert 0 < c["spec_accepted"] <= c["spec_proposed"]
        if layout == "paged":
            _check_pool(eng)
            assert eng.pool_stats()["pages_in_use"] == 0

    @pytest.mark.parametrize("layout,family,k,spec", [
        ("dense", "gpt", 4, False), ("dense", "llama", 8, False),
        ("paged", "gpt", 4, False), ("paged", "llama", 2, True),
        ("dense", "gpt", 3, True)])
    def test_sampled_equals_single_tick(self, families, layout, family, k,
                                        spec):
        """A mixed batch: sampled rows (temperature, top-k) beside greedy
        ones; every stream equals the K = 1 engine's."""
        _, tc, params = families[family]
        prompts = _prompts([5, 9, 14, 6], seed=42)
        temps = [(0.0, 0), (0.9, 5), (0.0, 0), (1.1, 0)]

        def run(**kw):
            eng = _eng(params, tc, family, kv_layout=layout, max_top_k=8,
                       seed=3, **kw)
            reqs = [eng.submit(p, 10, temperature=t, top_k=tk)
                    for p, (t, tk) in zip(prompts, temps)]
            eng.drain()
            return [r.tokens for r in reqs]
        want = run()
        got = run(multi_tick=k, **(SPEC if spec else {}))
        _assert_streams(got, want)
        greedy = _eng(params, tc, family, kv_layout=layout).generate(
            prompts, 10)
        assert list(greedy[1]) != got[1] or list(greedy[3]) != got[3]

    @pytest.mark.parametrize("layout,spec", [("dense", False),
                                             ("paged", True)])
    def test_eos_early_exit(self, families, layout, spec):
        """An EOS landing mid-dispatch truncates exactly where the
        single-tick engine stops: the device's retire mask mirrors the
        host rules."""
        _, tc, params = families["gpt"]
        prompts = _prompts((5, 6, 9), seed=5)
        ref = _eng(params, tc).generate(prompts, 20)
        eos = int(ref[0][2])                    # the 3rd token becomes EOS
        want = _eng(params, tc).generate(prompts, 20, eos_id=eos)
        eng = _eng(params, tc, kv_layout=layout, multi_tick=4,
                   **(SPEC if spec else {}))
        reqs = [eng.submit(p, 20, eos_id=eos) for p in prompts]
        eng.drain()
        _assert_streams([r.tokens for r in reqs], want)
        assert len(reqs[0].tokens) == 3 and reqs[0].finish_reason == "eos"
        if layout == "paged":
            _check_pool(eng)

    def test_quarantine_mid_dispatch(self, families):
        """A row flagged non-finite at the second tick of a dispatch: its
        first token is delivered, then only that request is poisoned;
        the co-batched streams equal the clean run's."""
        _, tc, params = families["gpt"]
        prompts = _prompts((5, 6, 9), seed=6)
        clean = _eng(params, tc).generate(prompts, 8)
        eng = _eng(params, tc, multi_tick=4)
        fwd, calls = eng.family.forward_cached, {"n": 0}

        def poisoning(params_, toks, cache, pos, cfg, **kw):
            logits, cache = fwd(params_, toks, cache, pos, cfg, **kw)
            if toks.shape[0] == eng.num_slots:  # a decode tick
                calls["n"] += 1
                if calls["n"] == 2:             # tick 2 of dispatch 1
                    logits = logits.clone()
                    logits[1] = float("nan")
            return logits, cache
        eng.family = srv.ModelFamily("gpt", poisoning, eng.family.init_cache)
        reqs = [eng.submit(p, 8) for p in prompts]
        eng.drain()
        assert [r.finish_reason for r in reqs] == ["length", "poisoned",
                                                   "length"]
        assert reqs[1].tokens == list(clean[1][:2])
        _assert_streams([reqs[0].tokens, reqs[2].tokens],
                        [clean[0], clean[2]])


# ------------------------------------------------- dispatch economy
class TestDispatchEconomy:
    @pytest.mark.parametrize("k,spec", [(4, False), (3, False), (4, True)])
    def test_dispatches_per_stream(self, families, k, spec):
        """A dispatch is one decode_ticks count and one pull: a gen-G
        stream takes ceil((G - 1) / K) dispatches after its prefill's
        token (ceil(G / K) for the reference's G with its first token
        counted), K ticks of int8 calls each."""
        _, tc, params = families["gpt"]
        gen = 13
        eng = _eng(params, tc, num_slots=1, multi_tick=k, quant="int8",
                   **(dict(SPEC, draft_layers=2) if spec else {}))
        out = eng.generate(_prompts((5,), seed=6), gen)
        assert len(out[0]) == gen
        c = eng.counters
        per_tick = eng._qmm_full + (eng.spec_gamma * eng._qmm_draft
                                    if spec else 0)
        if spec:
            assert c["decode_ticks"] <= -(-(gen - 1) // k)
        else:
            assert c["decode_ticks"] == -(-(gen - 1) // k)
        assert c["quant_matmuls"] == (eng._qmm_full * c["prefills"]
                                      + k * per_tick * c["decode_ticks"])

    @pytest.mark.parametrize("layout,k,spec", [
        ("dense", 1, False), ("paged", 1, False), ("dense", 4, False),
        ("paged", 2, True), ("dense", 1, True)])
    def test_sampler_draws_are_counted(self, families, monkeypatch, layout,
                                       k, spec):
        """The engine's sampler counters name every draw: one a prefill
        pass that sampled (a chunked prefill's last chunk) and K a
        sampled dispatch, while greedy dispatches draw nothing (a
        sampled request that ends early leaves greedy dispatches
        behind). The card's launch checks (chip_smoke.py `check_draws`)
        rest on these counts."""
        _, tc, params = families["gpt"]
        draws = []
        sample = srv._sample

        def counted(*args, **kw):
            draws.append(1)
            return sample(*args, **kw)
        monkeypatch.setattr(srv, "_sample", counted)
        kw = dict(prefill_chunk=4) if layout == "paged" else {}
        eng = _eng(params, tc, kv_layout=layout, max_top_k=8, seed=3,
                   multi_tick=k, **kw, **(SPEC if spec else {}))
        prompts = _prompts([9, 6, 5], seed=8)
        reqs = [eng.submit(p, n, temperature=t, top_k=tk)
                for p, n, (t, tk) in zip(prompts, (4, 12, 3),
                                         ((0.9, 5), (0.0, 0), (1.1, 0)))]
        eng.drain()
        assert [len(r.tokens) for r in reqs] == [4, 12, 3]
        c = eng.counters
        assert c["sampled_passes"] == 2
        assert 0 < c["sampled_dispatches"] < c["decode_ticks"]
        assert c["sampled_captures"] == 0          # no CUDA graph here
        assert len(draws) == c["sampled_passes"] + k * c[
            "sampled_dispatches"]

    def test_reference_dispatch_count(self, families):
        """The reference's own count: ceil(G/K) dispatches for a gen-G
        stream on a warm engine (tests/test_multi_tick.py:199)."""
        _, tc, params = families["gpt"]
        gen, k = 12, 4
        eng = _eng(params, tc, num_slots=1, multi_tick=k)
        eng.generate(_prompts((5,), seed=6), gen)          # warm
        t0 = eng.counters["decode_ticks"]
        out = eng.generate(_prompts((5,), seed=6), gen)
        assert len(out[0]) == gen
        assert eng.counters["decode_ticks"] - t0 == -(-gen // k)

    def test_facade_cache_key_on_k(self, families):
        _, tc, _ = families["gpt"]
        model = GPTModel(tc, seed=0, device="cpu")
        prompts = _prompts((5,), seed=8)
        want = model.generate(prompts, 4, num_slots=2, max_len=MAXLEN)
        outs = model.generate(prompts, 4, num_slots=2, max_len=MAXLEN,
                              multi_tick=2)
        e2 = model._engine
        assert e2.mt_k == 2
        _assert_streams(outs, want)
        model.generate(prompts, 4, num_slots=2, max_len=MAXLEN,
                       multi_tick=4)
        e4 = model._engine
        assert e4 is not e2 and e4.mt_k == 4         # K rebuilds ...
        model.generate(prompts, 4, num_slots=2, max_len=MAXLEN,
                       multi_tick=4)
        assert model._engine is e4                   # ... the same K reuses

    def test_static_buffers_never_rebind(self, families):
        """A CUDA graph bakes addresses: across admissions, finishes and
        page-table changes the state buffers, the cache and the page
        table stay the same tensors."""
        _, tc, params = families["llama"]
        eng = _eng(params, tc, "llama", kv_layout="paged", multi_tick=4,
                   prefill_chunk=PS, host_kv_bytes=1 << 20, num_pages=8)
        ptrs = [t.data_ptr() for t in eng._gbufs] + [
            eng._cache[k].data_ptr() for k in ("k", "v", "pt")]
        eng.generate(_prompts((5, 19, 7, 12), seed=9), 9)
        assert ptrs == [t.data_ptr() for t in eng._gbufs] + [
            eng._cache[k].data_ptr() for k in ("k", "v", "pt")]

    @pytest.mark.parametrize("layout", ["dense", "paged"])
    def test_family_names_its_memoized_reads(self, families, layout):
        """A graph's holder keeps what the forward reads from a memo:
        Llama's held tensors are the very RoPE tables the cached forward
        takes for this cache (dense max_len, paged the table's reach);
        GPT reads nothing beyond params and cache."""
        _, tc, params = families["llama"]
        eng = _eng(params, tc, "llama", kv_layout=layout, multi_tick=4)
        cos, sin = eng.family.held_tensors(tc, eng._cache)
        reach = MAXLEN if layout == "dense" else eng.max_pages * PS
        want = tl._rope_tables(reach, tc.head_dim, tc.rope_theta,
                               torch.device("cpu"))
        assert cos is want[0] and sin is want[1]
        _, gc, gparams = families["gpt"]
        gpt_eng = _eng(gparams, gc, kv_layout=layout)
        assert gpt_eng.family.held_tensors(gc, gpt_eng._cache) == ()


# ---------------------------------------------------------------- host tier
def _families_prompts(n_fam=3, share=2 * PS, tail=4, seed=9):
    rng = np.random.RandomState(seed)
    prompts = []
    for _ in range(n_fam):
        head = rng.randint(1, V - 1, share).astype(np.int32)
        for _ in range(2):
            prompts.append(np.concatenate(
                [head, rng.randint(1, V - 1, tail).astype(np.int32)]))
    return prompts


class TestHostTier:
    def test_lru_unit(self):
        tier = HostKVTier(max_bytes=4096)
        k = torch.zeros(2, 8, 2, 4)                  # 512 B each
        assert tier.put("a", k, k) and tier.put("b", k, k)
        assert "a" in tier and tier.get("a") is not None
        assert tier.put("a", k, k) is False          # a dup refreshes only
        for i in range(6):
            tier.put(f"x{i}", k, k)
        assert tier.bytes <= 4096 and tier.drops > 0
        st = tier.stats()
        assert st["entries"] == len(tier) and st["spills"] == 8
        lru = HostKVTier(max_bytes=2048)             # two pages
        lru.put("a", k, k)
        lru.put("b", k, k)
        lru.get("a")                                 # a hit refreshes "a"
        lru.put("c", k, k)
        assert "b" not in lru and "a" in lru and "c" in lru
        assert tier.put("huge", torch.zeros(4096), k) is False
        src = torch.arange(64.0).reshape(2, 8, 2, 2)
        tier.put("c", src, src)
        src.zero_()                                  # the tier copied
        assert tier.get("c")[0].sum() == sum(range(64))

    @pytest.mark.parametrize("family,k", [("gpt", 1), ("llama", 4)])
    def test_capacity_beyond_device_pool(self, families, family, k):
        """Prefix reuse outlives device-pool eviction: a pool too small to
        cache every family's prefix serves host hits (swap-ins > 0), with
        streams equal to a tier-less engine's, the pool consistent after
        every step and no prefill of the swapped-in tokens."""
        _, tc, params = families[family]
        prompts = _families_prompts()
        kw = dict(num_slots=1, kv_layout="paged", num_pages=6,
                  multi_tick=k)
        plain = _eng(params, tc, family, **kw)
        tiered = _eng(params, tc, family, host_kv_bytes=1 << 20, **kw)
        for _ in range(2):                           # round 2 re-hits
            want = plain.generate(prompts, 4)
            reqs = [tiered.submit(p, 4) for p in prompts]
            while tiered.has_work():
                tiered.step()
                _check_pool(tiered)
            _assert_streams([r.tokens for r in reqs], want)
        st = tiered.pool_stats()["host_tier"]
        assert st["spills"] > 0 and st["swapins"] > 0 and st["bytes"] > 0
        assert st["drops"] == 0
        page_bytes = 2 * tiered._cache["k"][:, 0].numel() * 4
        assert st["bytes"] == st["entries"] * page_bytes
        # swapped-in pages are prompt tokens that were not prefilled
        assert (tiered.counters["prefix_hits"]
                > plain.counters["prefix_hits"])

    def test_swapped_page_bit_equal_to_spilled(self, families):
        """The bits that come back are the bits that left."""
        _, tc, params = families["gpt"]
        eng = _eng(params, tc, num_slots=1, kv_layout="paged", num_pages=4,
                   host_kv_bytes=1 << 20)
        prompt = _prompts([2 * PS + 1], seed=3)[0]
        eng.generate([prompt], 2)
        keys = [srv._prefix_key(prompt, (j + 1) * PS) for j in range(2)]
        pids = [eng._pool.lookup(key) for key in keys]
        before = [eng._cache["k"][:, p].clone() for p in pids]
        eng.generate(_prompts([3 * PS - 2], seed=4), 2)   # evicts both
        assert all(eng._pool.lookup(key) is None for key in keys)
        assert torch.equal(eng._host_tier.get(keys[0])[0], before[0])
        eng.generate([prompt], 2)
        after = [eng._cache["k"][:, eng._pool.lookup(key)] for key in keys]
        assert all(torch.equal(a, b) for a, b in zip(after, before))
        assert eng.pool_stats()["host_tier"]["swapins"] == 2

    def test_staged_uploads_follow_the_queue_head(self, families):
        """Uploads staged for a waiting head are dropped when it is
        cancelled, and when another head waits: nothing staged outlives
        the request it was staged for."""
        _, tc, params = families["gpt"]
        eng = _eng(params, tc, num_slots=1, kv_layout="paged", num_pages=4,
                   host_kv_bytes=1 << 20)
        prompt = _prompts([2 * PS + 1], seed=3)[0]
        eng.generate([prompt], 2)
        eng.generate(_prompts([3 * PS - 2], seed=4), 2)   # spills both
        keys = [srv._prefix_key(prompt, (j + 1) * PS) for j in range(2)]
        assert all(key in eng._host_tier for key in keys)
        head = eng.submit(prompt, 2)
        eng._prefetch_host(head)
        assert sorted(eng._host_stage) == sorted(keys)
        eng.cancel(head)
        assert not eng._host_stage
        head = eng.submit(prompt, 2)
        eng._prefetch_host(head)
        other = eng.submit(_prompts([PS + 3], seed=5)[0], 2)
        eng._prefetch_host(other)                    # a new head waits
        assert not eng._host_stage
        eng.cancel(head)
        eng.drain()
        assert other.finish_reason == "length"

    def test_swap_in_never_evicts_its_own_device_hits(self, families):
        """A prefix whose first page is on the host and the rest cached on
        the device, with no free page left: the swap-in's allocation must
        not evict the request's own device hits (they are retained
        first), so the stream equals a tier-less engine's."""
        _, tc, params = families["gpt"]
        a = _prompts([3 * PS + 1], seed=11)[0]      # 3 registered pages
        b = _prompts([2 * PS], seed=12)[0]          # 2, both registered
        want = _eng(params, tc, num_slots=1).generate([a], 2)[0]
        eng = _eng(params, tc, num_slots=1, kv_layout="paged", num_pages=5,
                   host_kv_bytes=1 << 20)
        eng.generate([a], 2)
        eng.generate([b], 1)            # evicts a's first page to the host
        st = eng.pool_stats()
        assert st["pages_free"] == 0 and st["host_tier"]["spills"] == 1
        r = eng.submit(a, 2)
        eng.step()
        _check_pool(eng)
        assert r.shared_tokens == 3 * PS
        eng.drain()
        _assert_streams([r.tokens], [want])
        assert eng.pool_stats()["host_tier"]["swapins"] == 1

    def test_ledger_prices_host_tier(self, families):
        _, tc, params = families["gpt"]
        eng = _eng(params, tc, num_slots=1, kv_layout="paged", num_pages=6,
                   host_kv_bytes=1 << 20)
        eng.generate(_families_prompts(), 4)
        led = eng.memory_ledger()
        comps = led["components"]
        tier_bytes = eng.pool_stats()["host_tier"]["bytes"]
        assert comps["kv_pool_host"] == tier_bytes > 0
        assert led["host_total"] == tier_bytes
        # host rows stay out of the device total
        assert led["total"] == pytest.approx(
            sum(v for n, v in comps.items() if n != "kv_pool_host"))
        pool = eng._cache["k"]
        assert comps["kv_pool_device"] == (
            2 * pool.numel() * pool.element_size() + 8 * eng._ptab.size)


# ------------------------------------------------------ capture safety
def _write_kv_before(kc, k, pos):
    """write_kv as it was before the capture-safety repair (a boolean
    mask at T > 1)."""
    k = k.to(kc.dtype)
    B, T = k.shape[:2]
    S = kc.shape[1]
    rows = torch.arange(B)
    if T == 1:
        kc[rows, pos.long().clamp(0, S - 1)] = k[:, 0]
        return kc
    qpos = pos.long()[:, None] + torch.arange(T)[None, :]
    keep = qpos < S
    kc[rows[:, None].expand(B, T)[keep], qpos[keep]] = k[keep]
    return kc


def _cached_attention_before(q, kc, vc, pos, impl="dense"):
    """cached_attention as it was before the repair (a host scale tensor
    and a host -inf)."""
    B, T, H, hd = q.shape
    S, KV = kc.shape[1], kc.shape[2]
    G = H // KV
    dot_dt = kc.dtype if impl == "mixed" else torch.float32
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=dot_dt)
    qf = q.reshape(B, T, KV, G, hd).to(dot_dt) * scale
    s = torch.einsum("btkgd,bskd->bkgts", qf, kc.to(dot_dt))
    qpos = pos.long()[:, None] + torch.arange(T)[None, :]
    mask = (torch.arange(S)[None, None, :]
            <= qpos[..., None])[:, None, None, :, :]
    s = torch.where(mask, s.float(), torch.tensor(float("-inf")))
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bkgts,bskd->btkgd",
                       p.to(dot_dt) if impl == "mixed" else p,
                       vc.to(dot_dt))
    return ctx.reshape(B, T, H, hd).float()


class TestCaptureSafety:
    @pytest.mark.parametrize("T", [1, 3, 5])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_write_kv_bit_equal_without_mask(self, T, dtype):
        """Per-row positions before, at and past S (one row wholly past):
        the same writes as the masked version, nothing past S written."""
        rng = np.random.RandomState(T)
        B, S, KV, hd = 5, 12, 2, 4
        kc0 = torch.from_numpy(rng.randn(B, S, KV, hd).astype(np.float32))
        kc0 = kc0.to(dtype)
        k = torch.from_numpy(rng.randn(B, T, KV, hd).astype(np.float32))
        for pos in ([0, 3, S - T, S - 2, S - 1], [S - 1, S, S + 3, 4, 9],
                    [S - T + 1, 2, S, 0, S - 1]):
            pos = torch.tensor(pos)
            got = tda.write_kv(kc0.clone(), k, pos)
            want = _write_kv_before(kc0.clone(), k, pos)
            assert torch.equal(got, want)

    @pytest.mark.parametrize("impl", ["dense", "mixed"])
    @pytest.mark.parametrize("hd", [4, 8, 64])
    def test_cached_attention_bit_equal(self, impl, hd):
        rng = np.random.RandomState(hd)
        B, T, H, KV, S = 3, 2, 4, 2, 10
        q = torch.from_numpy(rng.randn(B, T, H, hd).astype(np.float32))
        kc = torch.from_numpy(rng.randn(B, S, KV, hd).astype(np.float32))
        vc = torch.from_numpy(rng.randn(B, S, KV, hd).astype(np.float32))
        pos = torch.tensor([0, 4, S - T])
        for dt in (torch.float32, torch.bfloat16):
            got = tda.cached_attention(q.to(dt), kc.to(dt), vc.to(dt), pos,
                                       impl)
            want = _cached_attention_before(q.to(dt), kc.to(dt), vc.to(dt),
                                            pos, impl)
            assert torch.equal(got, want)

    def test_sample_bit_equal(self):
        """The sampler equals the reference's `_sample` (threefry keys
        per slot, the top-k draw over ranks) on rows whose draw does not
        hang on an ulp of the noise (tests/test_torch_prng.py)."""
        from test_torch_prng import check_sample
        rng = np.random.RandomState(0)
        n, vocab = 64, 50
        lg = rng.randn(n, vocab).astype(np.float32)
        temps = rng.choice([0.0, 0.5, 1.0, 2.0], n).astype(np.float32)
        top_ks = rng.randint(0, 9, n).astype(np.int32)
        req_ids = np.arange(n, dtype=np.int32)
        gen_idx = rng.randint(0, 40, n).astype(np.int32)
        got, checked = check_sample(lg, temps, top_ks, req_ids, gen_idx, 7,
                                    8)
        assert checked >= 60
        assert len(set(got.tolist())) > 10
