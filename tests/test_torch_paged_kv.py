"""The paged KV layout of the port against the JAX package
(tests/test_paged_kv.py's classes): the page scatter and gather, the
layout selector, paged streams token for token against the JAX paged
engine and the port's dense engine (GPT and Llama), prefix sharing,
copy-on-write, the mid-prefill scratch routing, the pool accounting
under churn, pool exhaustion, chunked prefill and the gamma-token writes
of the speculative verify pass.

The JAX test's small configs in f32 (GPT vocab 64, hidden 32, 2 layers,
2 heads; Llama 4 heads over 2 KV heads), MAXLEN 64, page size 8, with
weights drawn by numpy at std 0.3 so that the streams move."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.kernels import decode_attention as jda
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import llama as jl
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.inference import serving as srv
from paddle_tpu_torch.inference.serving import PoolExhaustedError
from paddle_tpu_torch.kernels import decode_attention as tda
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama as tl


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file runs (the suite runs several
    pytest-xdist workers side by side); restored after, so other files
    in the same worker keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MAXLEN = 64
PS = 8          # test page size
V = 64
GPT_SHAPE = dict(vocab_size=V, hidden_size=32, num_layers=2, num_heads=2,
                 ffn_hidden=64, max_seq_len=128)
LLAMA_SHAPE = dict(vocab_size=V, hidden_size=32, num_layers=2, num_heads=4,
                   num_kv_heads=2, max_seq_len=128)


def _numpy_params(shapes):
    """Matmul weights and tables at std 0.3, scales near 1, biases
    small: a tiny model at the default init repeats one token."""
    rng = np.random.RandomState(0)
    out = {}
    for k, shp in sorted(shapes.items()):
        if k.endswith("_w") or k in ("wte", "wpe"):
            out[k] = rng.randn(*shp).astype(np.float32) * 0.3
        elif k.endswith("_scale") or k.endswith("norm") or k == "norm_f":
            out[k] = 1.0 + 0.1 * rng.randn(*shp).astype(np.float32)
        else:
            out[k] = 0.05 * rng.randn(*shp).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def gpt_setup():
    jc = jgpt.GPTConfig(**GPT_SHAPE, sequence_parallel=False, remat=False,
                        dtype=jnp.float32)
    tc = tgpt.GPTConfig(**GPT_SHAPE, dtype=torch.float32)
    shapes = {k: v.shape for k, v in
              jgpt.init_gpt_params(jc, jax.random.PRNGKey(0)).items()}
    return jc, tc, _numpy_params(shapes)


@pytest.fixture(scope="module")
def llama_setup():
    jc = jl.LlamaConfig(**LLAMA_SHAPE, dtype=jnp.float32, remat=False)
    tc = tl.LlamaConfig(**LLAMA_SHAPE, dtype=torch.float32, remat=False)
    shapes = {k: v.shape for k, v in
              jl.init_llama_params(jc, jax.random.PRNGKey(0)).items()}
    return jc, tc, _numpy_params(shapes)


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, n).astype(np.int32) for n in lens]


def _dense(params, cfg, family="gpt", **kw):
    kw.setdefault("num_slots", 3)
    return ServingEngine(params, cfg, family=family, max_len=MAXLEN,
                         kv_layout="dense", device="cpu", **kw)


def _paged(params, cfg, family="gpt", **kw):
    kw.setdefault("num_slots", 3)
    kw.setdefault("page_size", PS)
    return ServingEngine(params, cfg, family=family, max_len=MAXLEN,
                         kv_layout="paged", device="cpu", **kw)


def _assert_streams(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a, np.int32),
                                      np.asarray(b, np.int32))


def _check_pool(eng):
    """Every page in exactly one of free, cached and live; table
    references equal the refcounts; reservations conserved; the prefix
    maps inverse to each other."""
    pool = eng._pool
    refs = np.zeros(pool.num_pages, np.int64)
    refs[0] = 1                                  # scratch pin
    for row in eng._ptab:
        for pid in row[row != 0]:
            refs[pid] += 1
    np.testing.assert_array_equal(refs, pool.ref)
    free, cached = set(pool.free), set(pool.cached)
    live = {i for i in range(1, pool.num_pages) if pool.ref[i] > 0}
    assert not (free & cached) and not (free & live) and not (cached & live)
    assert len(free) + len(cached) + len(live) == pool.num_pages - 1
    assert pool.reserved == int(eng._slot_reserve.sum())
    assert pool.by_key == {v: k for k, v in pool.key_of.items()}
    assert all(pool.ref[p] == 0 for p in cached)


def _slot_pages(eng, pids):
    return eng._cache["k"][:, pids].clone()


# --------------------------------------------------------------------------
# kernel seam: gather/scatter against the JAX package and the dense write
# --------------------------------------------------------------------------
class TestPagedKernels:
    def test_scatter_gather_roundtrip_matches_jax_and_dense(self):
        rng = np.random.RandomState(0)
        B, S, KV, hd, ps = 2, 32, 2, 4, 8
        mp = S // ps
        pos = np.array([5, 17], np.int32)
        k = rng.randn(B, 1, KV, hd).astype(np.float32)
        dense0 = rng.randn(B, S, KV, hd).astype(np.float32)
        pages0 = np.concatenate([np.zeros((1, ps, KV, hd), np.float32),
                                 dense0.reshape(B * mp, ps, KV, hd)])
        table = np.arange(1, B * mp + 1, dtype=np.int32).reshape(B, mp)
        want = jda.gather_pages(
            jda.write_kv_paged(jnp.asarray(pages0), jnp.asarray(table),
                               jnp.asarray(k), jnp.asarray(pos)),
            jnp.asarray(table))
        pages = torch.from_numpy(pages0.copy())
        tda.write_kv_paged(pages, torch.from_numpy(table),
                           torch.from_numpy(k), torch.from_numpy(pos))
        got = tda.gather_pages(pages, torch.from_numpy(table))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        dense = tda.write_kv(torch.from_numpy(dense0.copy()),
                             torch.from_numpy(k), torch.from_numpy(pos))
        np.testing.assert_array_equal(got.numpy(), dense.numpy())

    def test_out_of_table_positions_hit_scratch(self):
        B, KV, hd, ps, mp = 1, 1, 2, 4, 2
        table = np.array([[1, 2]], np.int32)
        k = np.ones((B, 1, KV, hd), np.float32)
        pos = np.array([ps * mp + 1], np.int32)
        want = jda.write_kv_paged(jnp.zeros((3, ps, KV, hd)),
                                  jnp.asarray(table), jnp.asarray(k),
                                  jnp.asarray(pos))
        out = tda.write_kv_paged(torch.zeros(3, ps, KV, hd),
                                 torch.from_numpy(table),
                                 torch.from_numpy(k), torch.from_numpy(pos))
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        # past the table: scratch page 0, never the real tail page
        assert out[1:].sum() == 0.0 and out[0].sum() != 0.0

    def test_paged_impl_selector(self, monkeypatch, gpt_setup):
        _, tc, params = gpt_setup
        monkeypatch.setenv("PADDLE_TPU_DECODE_ATTN_IMPL", "paged")
        assert tda.decode_attn_impl("cpu") == "paged"
        assert tda.attn_math_impl() == "dense"      # a layout, not math
        assert tda.kv_view_extent(True, MAXLEN, 8, PS) == 64
        assert tda.kv_view_extent(False, MAXLEN) == MAXLEN
        eng = ServingEngine(params, tc, max_len=MAXLEN, device="cpu")
        assert eng.paged                            # kv_layout "auto"
        monkeypatch.setenv("PADDLE_TPU_DECODE_ATTN_IMPL", "dense")
        assert not ServingEngine(params, tc, max_len=MAXLEN,
                                 device="cpu").paged   # the kill switch
        monkeypatch.delenv("PADDLE_TPU_DECODE_ATTN_IMPL")
        assert tda.decode_attn_impl("cpu") == "dense"  # no table here


# --------------------------------------------------------------------------
# parity: the JAX paged engine and the port's dense pool
# --------------------------------------------------------------------------
class TestPagedParity:
    def test_gpt_parity_mixed_lengths(self, gpt_setup):
        jc, tc, params = gpt_setup
        prompts = _prompts([3, 11, 25, 40, 7, 18], seed=1)
        want = JaxEngine(params, jc, num_slots=3, max_len=MAXLEN,
                         kv_layout="paged", page_size=PS).generate(prompts, 8)
        assert len(set(np.concatenate(want).tolist())) > 5  # streams move
        _assert_streams(_paged(params, tc).generate(prompts, 8), want)
        _assert_streams(_dense(params, tc).generate(prompts, 8), want)

    def test_llama_gqa_parity(self, llama_setup):
        jc, tc, params = llama_setup
        prompts = _prompts([3, 11, 25, 40], seed=2)
        want = JaxEngine(params, jc, family="llama", num_slots=3,
                         max_len=MAXLEN, kv_layout="paged", page_size=PS,
                         prefill_chunk=PS).generate(prompts, 8)
        got = _paged(params, tc, "llama", prefill_chunk=PS).generate(
            prompts, 8)
        _assert_streams(got, want)
        _assert_streams(_dense(params, tc, "llama").generate(prompts, 8),
                        want)

    def test_sampled_stream_parity(self, gpt_setup):
        """A sampled stream keys on (request id, token index): the
        layout must not move it."""
        _, tc, params = gpt_setup
        prompts = _prompts([5, 9, 14], seed=3)
        a = _dense(params, tc, max_top_k=8).generate(
            prompts, 6, temperature=0.8, top_k=5)
        b = _paged(params, tc, max_top_k=8).generate(
            prompts, 6, temperature=0.8, top_k=5)
        _assert_streams(b, a)
        greedy = _dense(params, tc).generate(prompts, 6)
        assert any(not np.array_equal(x, y) for x, y in zip(a, greedy))


# --------------------------------------------------------------------------
# prefix sharing + copy-on-write
# --------------------------------------------------------------------------
class TestPrefixSharing:
    def test_shared_prefix_pages_reused(self, gpt_setup):
        _, tc, params = gpt_setup
        rng = np.random.RandomState(7)
        system = rng.randint(0, V, 3 * PS).astype(np.int32)
        prompts = [np.concatenate(
            [system, rng.randint(0, V, k).astype(np.int32)])
            for k in (2, 3, 4)]
        want = _dense(params, tc).generate(prompts, 6)
        eng = _paged(params, tc)
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.step()                       # all three admit
        assert reqs[1].shared_tokens == 3 * PS
        assert reqs[2].shared_tokens == 3 * PS
        st = eng.pool_stats()
        assert st["pages_shared"] >= 3 and st["prefix_hits"] == 6
        _check_pool(eng)
        eng.drain()
        _assert_streams([r.tokens for r in reqs], want)
        _check_pool(eng)

    def test_cached_pages_survive_request_death(self, gpt_setup):
        _, tc, params = gpt_setup
        prompt = _prompts([2 * PS + 3], seed=8)[0]
        eng = _paged(params, tc)
        first = eng.generate([prompt], 6)[0]
        assert eng.pool_stats()["pages_cached"] >= 2
        r2 = eng.submit(prompt, 6)
        eng.drain()
        assert r2.shared_tokens == 2 * PS
        _assert_streams([r2.tokens], [first])
        _check_pool(eng)

    def test_cow_isolation_writer_vs_sharer(self, gpt_setup):
        """Two equal page-aligned prompts: the second copies the last
        shared page and writes its copy; both streams equal the dense
        one (the sharer never sees the writer)."""
        _, tc, params = gpt_setup
        prompt = _prompts([2 * PS], seed=9)[0]
        want = _dense(params, tc).generate([prompt], 8)[0]
        eng = _paged(params, tc)
        ra = eng.submit(prompt, 8)
        rb = eng.submit(prompt, 8)
        eng.drain()
        assert eng.pool_stats()["cow_copies"] > 0
        _assert_streams([ra.tokens, rb.tokens], [want, want])
        _check_pool(eng)

    def test_midprefill_slot_never_writes_shared_pages(self, gpt_setup):
        """A slot mid-chunked-prefill is inactive in the decode tick but
        its table maps real, shared pages: its discarded row must write
        to scratch, never through the table."""
        _, tc, params = gpt_setup
        rng = np.random.RandomState(19)
        system = rng.randint(0, V, 2 * PS).astype(np.int32)
        pa = np.concatenate([system, rng.randint(0, V, 3).astype(np.int32)])
        pb = np.concatenate([system,
                             rng.randint(0, V, 3 * PS).astype(np.int32)])
        want_a = _dense(params, tc).generate([pa], 12)[0]
        want_b = _dense(params, tc).generate([pb], 4)[0]
        eng = _paged(params, tc, prefill_chunk=PS)
        ra = eng.submit(pa, 12)
        while not ra.tokens:                 # chunked prefill of A
            eng.step()
        pids = [int(p) for p in eng._ptab[ra.slot, :2]]
        assert 0 not in pids                 # A's registered prefix
        snap = _slot_pages(eng, pids)
        rb = eng.submit(pb, 4)               # maps A's pages, chunks
        ticks_mid_prefill = 0
        while not rb.tokens and not rb.done:
            eng.step()                       # A decodes; B inactive
            assert torch.equal(_slot_pages(eng, pids), snap), \
                "mid-prefill slot scattered into shared pages"
            ticks_mid_prefill += 1
        assert ticks_mid_prefill >= 2
        eng.drain()
        _assert_streams([ra.tokens, rb.tokens], [want_a, want_b])
        _check_pool(eng)

    def test_prefix_hashes_memoized_per_request(self, gpt_setup,
                                                monkeypatch):
        """The head of the queue replans every tick while it waits for
        pages: its prefix digests are hashed once, not every tick."""
        calls = {"n": 0}
        real = srv._prefix_key

        def counting(prompt, n):
            calls["n"] += 1
            return real(prompt, n)

        monkeypatch.setattr(srv, "_prefix_key", counting)
        _, tc, params = gpt_setup
        eng = _paged(params, tc, num_slots=2, num_pages=6)
        occupant = eng.submit(_prompts([4], seed=21)[0], 20)
        eng.step()                      # occupant reserves 3 pages
        waiter = eng.submit(_prompts([4 * PS], seed=22)[0], 4)
        calls["n"] = 0
        for _ in range(10):
            eng.step()
        assert not waiter.tokens        # still waiting for pages
        assert calls["n"] <= len(waiter.prompt) // PS
        eng.drain()
        assert occupant.done and waiter.done
        _check_pool(eng)

    def test_sharing_kill_switch(self, gpt_setup):
        _, tc, params = gpt_setup
        prompt = _prompts([2 * PS], seed=10)[0]
        eng = _paged(params, tc, prefix_sharing=False)
        eng.generate([prompt], 4)
        r2 = eng.submit(prompt, 4)
        eng.drain()
        assert r2.shared_tokens == 0
        st = eng.pool_stats()
        assert st["pages_cached"] == 0 and st["prefix_hits"] == 0
        _check_pool(eng)


# --------------------------------------------------------------------------
# refcount / free accounting across churn
# --------------------------------------------------------------------------
class TestPoolAccounting:
    def test_join_evict_cancel_churn(self, gpt_setup):
        _, tc, params = gpt_setup
        rng = np.random.RandomState(11)
        system = rng.randint(0, V, 2 * PS).astype(np.int32)
        eng = _paged(params, tc, num_slots=3)
        live = []
        for wave in range(6):
            # shared-prefix and unique prompts joining mid-decode
            if wave % 2 == 0:
                p = np.concatenate(
                    [system, rng.randint(0, V, wave + 2).astype(np.int32)])
            else:
                p = rng.randint(0, V, 5 + wave).astype(np.int32)
            live.append(eng.submit(p, 10))
            eng.step()
            _check_pool(eng)
            if wave == 2:
                assert live[0].cancel()            # mid-decode cancel
                _check_pool(eng)
            if wave == 4:
                for r in live:                     # mass eviction
                    r.cancel()
                _check_pool(eng)
        eng.drain()
        _check_pool(eng)
        assert all(r.done for r in live)
        st = eng.pool_stats()
        assert st["pages_in_use"] == 0 and st["pages_reserved"] == 0
        assert st["pages_free"] + st["pages_cached"] == st["num_pages"] - 1

    def test_max_ticks_eviction_frees_every_page(self, gpt_setup):
        _, tc, params = gpt_setup
        eng = _paged(params, tc, prefill_chunk=PS)
        out = eng.generate(_prompts([40, 12, 5], seed=12), 20, max_ticks=3)
        assert any(len(o) < 20 for o in out)
        _check_pool(eng)
        assert eng.pool_stats()["pages_in_use"] == 0
        assert not eng._prefilling and not eng.has_work()


# --------------------------------------------------------------------------
# pool exhaustion
# --------------------------------------------------------------------------
class TestPoolExhaustion:
    def test_never_fits_raises_typed(self, gpt_setup):
        _, tc, params = gpt_setup
        eng = _paged(params, tc, num_pages=4)     # 3 allocatable pages
        with pytest.raises(PoolExhaustedError) as ei:
            eng.submit(_prompts([30])[0], 20)     # needs 7 pages
        assert ei.value.pages_needed > ei.value.pages_total

    def test_exhausted_admission_queues_never_wedges(self, gpt_setup):
        """More demand than pages: later requests wait queued and admit
        as earlier ones free their pages; every stream equals dense."""
        _, tc, params = gpt_setup
        prompts = _prompts([12, 14, 10, 9, 13, 11], seed=13)
        want = _dense(params, tc, num_slots=6).generate(prompts, 10)
        eng = _paged(params, tc, num_slots=6, num_pages=9)
        reqs = [eng.submit(p, 10) for p in prompts]
        eng.step()
        assert sum(1 for r in eng._slot_req if r is not None) < 6
        _check_pool(eng)
        eng.drain()
        _check_pool(eng)
        assert all(r.finish_reason == "length" for r in reqs)
        _assert_streams([r.tokens for r in reqs], want)

    def test_aligned_full_rejoin_exact_pool_never_livelocks(self,
                                                            gpt_setup):
        """A pool sized exactly to the envelope: an aligned-full cached
        match would cost envelope + 1 pages forever, so the planner
        admits the request unshared instead of queueing it for good."""
        _, tc, params = gpt_setup
        prompt = _prompts([PS], seed=20)[0]
        envelope = -(-(PS + 9 - 1) // PS)            # 2 pages
        eng = _paged(params, tc, num_slots=1, num_pages=envelope + 1)
        first = eng.generate([prompt], 9)[0]
        assert eng.pool_stats()["pages_cached"] == 1
        r2 = eng.submit(prompt, 9)
        eng.drain(max_ticks=100)
        assert r2.done and r2.finish_reason == "length"
        _assert_streams([r2.tokens], [first])
        _check_pool(eng)


# --------------------------------------------------------------------------
# chunked prefill
# --------------------------------------------------------------------------
class TestChunkedPrefill:
    def test_chunked_parity(self, gpt_setup):
        _, tc, params = gpt_setup
        prompts = _prompts([40, 3, 33, 17], seed=14)
        want = _dense(params, tc).generate(prompts, 8)
        eng = _paged(params, tc, prefill_chunk=PS)
        _assert_streams(eng.generate(prompts, 8), want)
        c = eng.counters
        # 40 -> 5 chunks, 3 -> 1, 33 -> 5, 17 -> 3 (no prefix shared)
        assert c["prefill_chunks"] == 14 and c["prefills"] == 4
        assert eng.pool_stats()["prefill_chunks"] == 14

    def test_decode_interleaves_with_long_prefill(self, gpt_setup):
        """While a long prompt prefills chunk by chunk, a decoding
        stream emits every tick."""
        _, tc, params = gpt_setup
        eng = _paged(params, tc, prefill_chunk=PS)
        short = eng.submit(_prompts([4], seed=15)[0], 30)
        eng.step()
        long_req = eng.submit(_prompts([40], seed=16)[0], 4)
        eng.step()
        assert long_req._pf_next is not None       # mid-prefill
        ticks_while_prefilling = 0
        while long_req._pf_next is not None and not long_req.done:
            n0 = len(short.tokens)
            eng.step()
            if not short.done:
                assert len(short.tokens) == n0 + 1, \
                    "decoding stream stalled during chunked prefill"
                ticks_while_prefilling += 1
        assert ticks_while_prefilling >= 2
        eng.drain()
        want = _dense(params, tc).generate([_prompts([40], seed=16)[0]],
                                           4)[0]
        _assert_streams([long_req.tokens], [want])

    def test_cancel_mid_chunked_prefill_frees_pages(self, gpt_setup):
        _, tc, params = gpt_setup
        eng = _paged(params, tc, prefill_chunk=PS)
        r = eng.submit(_prompts([40], seed=17)[0], 4)
        eng.step()                                 # admits: reserves
        assert eng.pool_stats()["pages_reserved"] == 6
        eng.step()                                 # the first chunk
        assert r._pf_next == PS
        assert eng.pool_stats()["pages_in_use"] == 1
        assert r.cancel()
        assert r.finish_reason == "cancelled"
        _check_pool(eng)
        assert eng.pool_stats()["pages_in_use"] == 0
        eng.drain()
        _check_pool(eng)
        assert not eng._prefilling


# --------------------------------------------------------------------------
# the speculative verify pass's gamma-token writes
# --------------------------------------------------------------------------
class TestSpecMultiTokenWrites:
    def test_gamma_token_paged_write_matches_sequential(self):
        """A gamma+1-token write lands as gamma+1 one-token writes do,
        across a page boundary, and as the JAX package's write does."""
        rng = np.random.RandomState(3)
        B, KV, hd, ps, mp, T = 2, 2, 4, 8, 4, 5
        pages0 = rng.randn(1 + B * mp, ps, KV, hd).astype(np.float32)
        table = torch.arange(1, B * mp + 1).reshape(B, mp)
        pos = torch.tensor([6, 13])                  # both cross a page
        k = torch.from_numpy(rng.randn(B, T, KV, hd).astype(np.float32))
        got = tda.write_kv_paged(torch.from_numpy(pages0.copy()), table, k,
                                 pos)
        seq = torch.from_numpy(pages0.copy())
        for t in range(T):
            tda.write_kv_paged(seq, table, k[:, t:t + 1], pos + t)
        assert torch.equal(got, seq)
        want = jda.write_kv_paged(jnp.asarray(pages0),
                                  jnp.asarray(table.numpy(), jnp.int32),
                                  jnp.asarray(k.numpy()),
                                  jnp.asarray(pos.numpy(), jnp.int32))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_gamma_token_dense_write_drops_past_cache_end(self):
        rng = np.random.RandomState(4)
        B, S, KV, hd, T = 2, 16, 1, 2, 4
        kc0 = rng.randn(B, S, KV, hd).astype(np.float32)
        k = rng.randn(B, T, KV, hd).astype(np.float32)
        pos = np.array([S - 2, 3], np.int32)          # row 0: 2 of 4 out
        out = tda.write_kv(torch.from_numpy(kc0.copy()), torch.from_numpy(k),
                           torch.from_numpy(pos))
        want = jda.write_kv(jnp.asarray(kc0), jnp.asarray(k),
                            jnp.asarray(pos))
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        assert np.array_equal(out.numpy()[0, S - 2:], k[0, :2])
