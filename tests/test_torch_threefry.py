"""The threefry bits' wrapper (paddle_tpu_torch/kernels/threefry.py) on
the CPU, where it runs its plain version: the batched draw is each
row's draw of jax.random.bits, the hash is the reference's on edge
words, and a device the kernel does not serve raises. The kernel itself
is held to the plain version on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py's phase 2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import prng
from paddle_tpu_torch.inference import serving as srv
from paddle_tpu_torch.kernels import threefry as tf


@pytest.mark.parametrize("n", [1, 7, 64, 1000])
def test_bits_rows_are_jax_draws(n):
    seeds = [0, 5, 2**31 + 9, 2**32 - 1]
    keys = [np.asarray(jax.random.PRNGKey(s)).astype(np.int64)
            for s in seeds]
    k1 = torch.tensor([int(k[0]) for k in keys])
    k2 = torch.tensor([int(k[1]) for k in keys])
    before = dict(tf.launches)
    got = tf.bits(k1, k2, n)
    assert tf.launches == before               # no kernel on the CPU
    assert got.shape == (len(seeds), n) and got.dtype == torch.int64
    for row, s in zip(got, seeds):
        want = np.asarray(jax.random.bits(jax.random.PRNGKey(s), (n,),
                                          jnp.uint32)).astype(np.int64)
        np.testing.assert_array_equal(row.numpy(), want)


def test_hash_on_edge_words():
    """threefry2x32 on Python ints at the words' edges equals jax's
    fold_in hash of the same words (key (k1, k2) over counts (0, d))."""
    for k1, k2 in ((0, 0), (2**32 - 1, 2**32 - 1), (1, 2**31)):
        key = jax.random.wrap_key_data(np.array([k1, k2], np.uint32))
        for d in (0, 1, 2**32 - 1):
            want = np.asarray(jax.random.key_data(
                jax.random.fold_in(key, d)))
            assert [int(w) for w in tf.threefry2x32(k1, k2, 0, d)] == \
                [int(w) for w in want]


@pytest.mark.parametrize("n", [1, 40, 1000])
def test_fold_draws_under_the_slot_keys(n):
    """A draw whose key is folded in with each row's (request id, token
    index), as `_sample` makes it, is the draw under the reference's
    slot keys given whole; int64 data folds in its low 32 bits, as
    int32 data does."""
    rid = torch.tensor([0, 7, 2**31 - 1, 12], dtype=torch.int32)
    gi = torch.tensor([0, 1, 40, -1], dtype=torch.int32)
    k1, k2 = srv._slot_keys(11, rid, gi)
    want = tf.bits(k1, k2, n)
    s1, s2 = prng.prng_key(11)
    assert torch.equal(tf.bits(s1, s2, n, (rid, gi)), want)
    assert torch.equal(tf.bits(s1, s2, n, (rid.long(), gi.long() & tf.M32)),
                       want)
    keyed = tf.bits(torch.full((4,), s1), torch.full((4,), s2), n,
                    (rid, gi))
    assert torch.equal(keyed, want)
    g = prng.gumbel((s1, s2), (n,), fold=(rid, gi))
    assert torch.equal(g, prng.gumbel((k1, k2), (n,)))


def test_bits_refuses_other_devices():
    k = torch.zeros(2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tf.bits(k, k, 4)
