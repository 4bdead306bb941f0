"""The port's threefry sampling (paddle_tpu_torch/inference/prng.py)
against jax.random on the installed jax, the serving sampler `_sample`
against the reference's, and the sampled streams of the port's engines
against the JAX engines' (tests/test_multi_tick.py's small configs, as
tests/test_torch_multi_tick.py builds them): dense, paged, spec decode
and K = 4.

Bits, keys and uniforms must be equal to the bit. The Gumbel noise
takes two f32 logs, which may round differently from XLA's: within one
f32 ulp. A sampled token must equal the reference's wherever the two
best perturbed logits are more than an ulp apart (a margin test on the
reference's own noise); the streams are drawn with weights that make
those margins wide, and must be equal token for token."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import serving as jsrv
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.inference import prng
from paddle_tpu_torch.inference import serving as srv
from test_torch_multi_tick import SPEC, _eng, families  # noqa: F401
from test_torch_paged_kv import PS, _assert_streams, _prompts

SEEDS = (0, 7, 12345, 2**31 + 5, 2**32 - 1)
TINY = float(np.finfo(np.float32).tiny)


def _words(key):
    return [int(w) for w in np.asarray(key)]


def _ulps(a, b):
    """|a - b| in f32 ulps of the larger magnitude."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))


class TestBits:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_prng_key(self, seed):
        assert prng.prng_key(seed) == tuple(_words(jax.random.PRNGKey(seed)))

    @pytest.mark.parametrize("seed", SEEDS)
    def test_fold_in(self, seed):
        key = jax.random.PRNGKey(seed)
        for data in (0, 1, 3, 255, 2**31 + 1, 2**32 - 1):
            got = prng.fold_in(prng.prng_key(seed), data)
            assert [int(w) for w in got] == _words(
                jax.random.fold_in(key, data))

    def test_slot_keys_batched(self):
        """fold_in over [N] request ids and token indices, one key a row,
        equals the reference's per-slot keys."""
        rid = np.array([0, 1, 5, 99, 7, 2**20], np.int32)
        gi = np.array([0, 3, 2, 40, 0, 17], np.int32)
        k1, k2 = srv._slot_keys(11, torch.from_numpy(rid),
                                torch.from_numpy(gi))
        want = np.asarray(jsrv._slot_keys(jax.random.PRNGKey(11),
                                          jnp.asarray(rid), jnp.asarray(gi)))
        assert k1.tolist() == want[:, 0].tolist()
        assert k2.tolist() == want[:, 1].tolist()

    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("shape", [(1,), (5,), (64,), (3, 7), (1000,),
                                       (2, 3, 4)])
    def test_random_bits(self, seed, shape):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
        got = prng.random_bits(prng.prng_key(seed), shape).numpy()
        assert got.shape == shape
        np.testing.assert_array_equal(got, want.astype(np.int64))

    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("minval", [0.0, TINY])
    def test_uniform(self, seed, minval):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.uniform(key, (4096,), jnp.float32,
                                             minval=minval))
        got = prng.uniform(prng.prng_key(seed), (4096,), minval).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))

    @pytest.mark.parametrize("seed", SEEDS)
    def test_gumbel_within_an_ulp(self, seed):
        """Each of the two logs within one f32 ulp of XLA's on the same
        input, so the noise within the outer log's ulp, the inner log's
        ulp carried through the outer one (d(-log x) = -dx / x) and the
        outer result's rounding of that: near x = 1 the outer log
        cancels to a small value, and an ulp of x is many ulps of it."""
        key = jax.random.PRNGKey(seed)
        u = np.array(jax.random.uniform(key, (4096,), jnp.float32,
                                          minval=TINY))
        x = -np.array(jnp.log(u))
        assert _ulps(-torch.log(torch.from_numpy(u)).numpy(), x).max() <= 1
        assert _ulps(-torch.log(torch.from_numpy(x)).numpy(),
                     -np.asarray(jnp.log(x))).max() <= 1
        want = np.asarray(jax.random.gumbel(key, (4096,), jnp.float32))
        got = prng.gumbel(prng.prng_key(seed), (4096,)).numpy()
        tol = 2 * np.spacing(np.abs(want)) + np.spacing(x) / x
        assert (np.abs(got - want) <= tol).all()
        assert (got == want).mean() > 0.5

    def test_batched_draw_is_each_rows_draw(self):
        keys = srv._slot_keys(3, torch.tensor([4, 9]), torch.tensor([1, 6]))
        both = prng.random_bits(keys, (33,))
        for i in range(2):
            one = prng.random_bits((int(keys[0][i]), int(keys[1][i])), (33,))
            assert torch.equal(both[i], one)


def _margin_ok(key, logits):
    """The two best of logits + the reference's Gumbel noise are more
    than an ulp apart: the draw does not hang on a rounding."""
    z = np.sort(np.asarray(jax.random.gumbel(key, logits.shape[-1:]))
                + np.asarray(logits))[-2:]
    return np.isinf(z[0]) or z[1] - z[0] > np.spacing(np.abs(z[1]))


class TestSample:
    @pytest.mark.parametrize("vocab", [50, 512])
    def test_categorical(self, vocab):
        rng = np.random.RandomState(vocab)
        checked = 0
        for rid in range(40):
            lg = rng.randn(vocab).astype(np.float32) * 2
            jkey = jax.random.fold_in(jax.random.PRNGKey(5), rid)
            if not _margin_ok(jkey, lg):
                continue
            want = int(jax.random.categorical(jkey, jnp.asarray(lg)))
            got = int(prng.categorical(prng.fold_in(prng.prng_key(5), rid),
                                       torch.from_numpy(lg)))
            assert got == want
            checked += 1
        assert checked >= 35

    def _inputs(self, n, vocab, seed):
        rng = np.random.RandomState(seed)
        lg = rng.randn(n, vocab).astype(np.float32) * 3
        temps = rng.choice([0.0, 0.5, 1.0, 2.0], n).astype(np.float32)
        top_ks = rng.randint(0, 9, n).astype(np.int32)
        req_ids = np.arange(n, dtype=np.int32) * 3 + 1
        gen_idx = rng.randint(0, 40, n).astype(np.int32)
        return lg, temps, top_ks, req_ids, gen_idx

    @pytest.mark.parametrize("max_top_k", [0, 8])
    def test_sample_equals_reference(self, max_top_k):
        """Full and top-k draws, greedy rows among them, equal to the
        reference's `_sample` at every row whose draw has a margin; the
        top-k noise is indexed by rank, not by vocab id."""
        got, checked = check_sample(*self._inputs(96, 64, max_top_k), 7,
                                    max_top_k)
        assert checked >= 90
        assert len(set(got.tolist())) > 20


def check_sample(lg, temps, top_ks, rid, gi, seed, max_top_k):
    """The port's `_sample` against the reference's on the same numpy
    inputs: every row whose draw has a margin (`_margin_ok` on the
    reference's own noise) must pick the reference's token. Returns the
    port's tokens and how many rows were held."""
    keys = jsrv._slot_keys(jax.random.PRNGKey(seed), jnp.asarray(rid),
                           jnp.asarray(gi))
    want = np.asarray(jsrv._sample(jnp.asarray(lg), jnp.asarray(temps),
                                   jnp.asarray(top_ks), keys, max_top_k))
    got = srv._sample(*(torch.from_numpy(a) for a in (lg, temps, top_ks)),
                      seed, torch.from_numpy(rid), torch.from_numpy(gi),
                      max_top_k).numpy()
    checked = 0
    for i in range(len(lg)):
        t = np.float32(max(float(temps[i]), 1e-6))
        row = lg[i] / t
        if max_top_k and top_ks[i] > 0:
            vals = np.sort(lg[i])[::-1][:max_top_k].copy()
            vals[min(int(top_ks[i]), max_top_k):] = -np.inf
            row = vals / t
        if temps[i] > 0 and not _margin_ok(keys[i], row):
            continue
        assert got[i] == want[i], i
        checked += 1
    return got, checked


# ------------------------------------------------------------ the engines
MIX = [(0.9, 5), (0.0, 0), (1.1, 0), (0.7, 3), (1.0, 0)]


def _jax_run(jc, params, family, prompts, **kw):
    eng = JaxEngine(params, jc, family=family, num_slots=3, max_len=64,
                    max_top_k=8, seed=3, **kw)
    reqs = [eng.submit(p, 10, temperature=t, top_k=k)
            for p, (t, k) in zip(prompts, MIX)]
    eng.drain()
    return [list(np.asarray(r.tokens)) for r in reqs]


def _port_run(tc, params, family, prompts, **kw):
    eng = _eng(params, tc, family, max_top_k=8, seed=3, **kw)
    reqs = [eng.submit(p, 10, temperature=t, top_k=k)
            for p, (t, k) in zip(prompts, MIX)]
    eng.drain()
    return [r.tokens for r in reqs]


ENGINES = {
    "dense": ({}, {}),
    "paged": (dict(kv_layout="paged", page_size=PS, prefill_chunk=PS),
              dict(kv_layout="paged", prefill_chunk=PS)),
    "spec": (SPEC, SPEC),
    "k4": (dict(multi_tick=4), dict(multi_tick=4)),
}


@pytest.fixture(scope="module")
def sampled_jax(families):  # noqa: F811
    """The JAX engines' mixed streams (sampled rows with temperature and
    top-k beside greedy ones), by (family, engine)."""
    prompts = _prompts([5, 9, 14, 6, 11], seed=42)
    out = {}
    for family in ("gpt", "llama"):
        jc, _, params = families[family]
        for name, (jkw, _) in ENGINES.items():
            out[family, name] = _jax_run(jc, params, family, prompts, **jkw)
    return prompts, out


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_sampled_streams_equal_jax(families, sampled_jax,  # noqa: F811
                                   family, engine):
    _, tc, params = families[family]
    prompts, want = sampled_jax
    got = _port_run(tc, params, family, prompts, **ENGINES[engine][1])
    _assert_streams(got, want[family, engine])
    # the sampled rows really sample: they leave the greedy stream
    greedy = _eng(params, tc, family).generate(prompts, 10)
    assert any(list(greedy[i]) != got[i] for i in (0, 2, 3, 4))
