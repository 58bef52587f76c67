"""The port's Threefry streams and XLA float32 arithmetic
(``elfi_tpu_torch.utils.threefry``, ``elfi_tpu_torch.utils.xla_math``)
against ``jax.random`` and XLA on the CPU.

Keys, splits, bits, ``uniform`` and ``randint`` are held bit for bit;
``log``, ``log1p`` and ``exp`` bit for bit over 2^23-input grids; ``normal``
and ``exponential`` within 2 ulp over all 2^23 values ``uniform`` can give
(measured on the CPU: ``exponential`` differs nowhere, ``normal`` at 137
inputs, all with ``|z| > 2.9``, by 1 or 2 ulp); ``poisson``'s counts
equal on a grid of rates on both sides of 10.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

import elfi_tpu_torch as et
from elfi_tpu_torch.utils import threefry as tf
from elfi_tpu_torch.utils import xla_math

torch.set_num_threads(1)

SEEDS = [0, 1, 271, 2**31 - 1, -1, -7, -2**31]
SHAPES = [(), (1,), (5,), (3, 4), (2, 3, 5)]
#: every float32 in [0, 1) that ``uniform`` can give: the 2^23 mantissas
_UNIT = ((np.arange(1 << 23, dtype=np.uint32) | 0x3F800000).view(np.float32)
         - np.float32(1))


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


def _words(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _ulps(a, b):
    """The distance of two float32 arrays in units in the last place."""
    def ordered(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_splits_and_fold_ins_equal_jax(seed):
    k, kt = jax.random.key(seed), tf.key(seed)
    np.testing.assert_array_equal(kt.numpy(), _words(k))
    assert tf.seed_words(seed) == tuple(_words(k))
    for num in (1, 2, 3, 7, (2, 3)):
        np.testing.assert_array_equal(tf.split(kt, num).numpy(),
                                      _words(jax.random.split(k, num)))
    for data in (0, 1, 99, 2**31 + 5):
        np.testing.assert_array_equal(tf.fold_in(kt, data).numpy(),
                                      _words(jax.random.fold_in(k, data)))
    # a chain of splits on the host, as an event loop runs it
    words = tf.seed_words(seed)
    for _ in range(4):
        k = jax.random.split(k, 3)[0]
        words = tf.host_split(words, 3)[0]
    assert words == tuple(_words(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_the_hash_equal_jax(seed):
    from jax._src import prng
    k, kt = jax.random.key(seed), tf.key(seed)
    for shape in SHAPES:
        np.testing.assert_array_equal(
            tf.random_bits(kt, shape).numpy(),
            np.asarray(jax.random.bits(k, shape)).astype(np.int64))
    for n in (1, 2, 7, 10):
        count = np.arange(n, dtype=np.uint32) * np.uint32(2654435761)
        want = prng.threefry_2x32(jax.random.key_data(k), count)
        got = tf.threefry_2x32(kt, torch.as_tensor(count.astype(np.int64)))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))
    # a batch of keys draws as each key alone
    keys = tf.split(kt, 4)
    np.testing.assert_array_equal(
        tf.random_bits(keys, (3,)).numpy(),
        np.stack([tf.random_bits(keys[i], (3,)).numpy() for i in range(4)]))


@pytest.mark.parametrize("seed", [0, 3, 271])
def test_uniform_and_randint_equal_jax(seed):
    k, kt = jax.random.key(seed), tf.key(seed)
    for lo, hi in [(0., 1.), (-np.pi / 2 + 1e-6, np.pi / 2 - 1e-6),
                   (-3., 7.5)]:
        np.testing.assert_array_equal(
            tf.uniform(kt, (4000,), lo, hi).numpy(),
            np.asarray(jax.random.uniform(k, (4000,), minval=lo,
                                          maxval=hi)))
    np.testing.assert_array_equal(tf.uniform(kt, (2, 3)).numpy(),
                                  np.asarray(jax.random.uniform(k, (2, 3))))
    for lo, hi in [(0, 1), (0, 5), (-3, 70000), (5, 5), (7, 2),
                   (-2**31, 2**31 - 1)]:
        got = tf.randint(kt, (1000,), lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax.random.randint(k, (1000,), lo, hi)))
    # a traced bound, as the toad model's day loop passes it
    traced = jax.jit(lambda key, i: jax.random.randint(
        key, (4, 66), 0, jnp.maximum(i, 1)))
    for i in (0, 1, 2, 17, 62):
        np.testing.assert_array_equal(
            tf.randint(kt, (4, 66), 0, torch.tensor(max(i, 1))).numpy(),
            np.asarray(traced(k, jnp.int32(i))))


def test_log_log1p_and_exp_equal_xla():
    f = np.float32
    x = np.concatenate([_UNIT + f(1), _UNIT * f(1e4), _UNIT * f(1e-30),
                        f([0, -1, np.inf, np.nan, 1e-40])])
    y = np.concatenate([-_UNIT, _UNIT * f(3), f([-1, np.inf, np.nan])])
    z = np.concatenate([_UNIT * f(190) - f(95), _UNIT * f(1e-3),
                        f([np.inf, -np.inf, np.nan])])
    for fn, jfn, v in [(xla_math.log, jnp.log, x),
                       (xla_math.log1p, jnp.log1p, y),
                       (xla_math.exp, jnp.exp, z)]:
        np.testing.assert_array_equal(fn(torch.as_tensor(v)).numpy(),
                                      np.asarray(jax.jit(jfn)(v)))


def test_normal_and_exponential_within_2_ulp_over_every_uniform():
    """All 2^23 inputs: the JAX samplers' maps from the uniform to the
    draw, and the port's.  Reported: how many differ at all."""
    u = (_UNIT.astype(np.float64) * 2 + tf._NORMAL_LO).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda u: lax.mul(np.float32(np.sqrt(2)), lax.erf_inv(u)))(u))
    got = (tf._SQRT2 * xla_math.erf_inv(torch.as_tensor(u))).numpy()
    d = _ulps(want, got)
    print(f"normal: {int((d > 0).sum())} of {u.size} inputs differ, "
          f"at most {int(d.max())} ulp")
    assert d.max() <= 2 and (d > 0).sum() <= 200
    want = np.asarray(jax.jit(lambda u: -jnp.log1p(-u))(_UNIT))
    got = (-xla_math.log1p(-torch.as_tensor(_UNIT))).numpy()
    d = _ulps(want, got)
    print(f"exponential: {int((d > 0).sum())} of {_UNIT.size} inputs "
          f"differ, at most {int(d.max())} ulp")
    assert d.max() <= 2
    # and the samplers themselves
    k, kt = jax.random.key(5), tf.key(5)
    np.testing.assert_array_equal(tf.exponential(kt, (300, 300)).numpy(),
                                  np.asarray(jax.random.exponential(
                                      k, (300, 300))))
    assert _ulps(np.asarray(jax.random.normal(k, (300, 300))),
                 tf.normal(kt, (300, 300)).numpy()).max() <= 2


def test_poisson_counts_equal_jax():
    """Knuth's loop below rate 10 and the transformed rejection above, each
    over the whole array, on the same grid; a rate of 0 gives 0."""
    lams = np.array([0, 0.01, 0.5, 3, 9.99, 10, 10.5, 38, 100, 12345.6],
                    np.float32)
    lam = np.repeat(lams, 200)
    for seed in (0, 1):
        want = np.asarray(jax.random.poisson(jax.random.key(seed), lam))
        got = tf.poisson(tf.key(seed), torch.as_tensor(lam))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert not got[:200].any()
    for lam in (3., 38.):
        np.testing.assert_array_equal(
            tf.poisson(tf.key(2), lam, (300,)).numpy(),
            np.asarray(jax.random.poisson(jax.random.key(2), np.float32(lam),
                                          (300,))))


def test_lgamma_at_the_integers_the_poisson_sampler_uses():
    """``lgamma(k + 1)`` in the rejection test.  Not bit for bit: measured
    on the CPU, 15 of the integers 1 .. 2999 differ from XLA's, all below
    43, by at most 12 ulp (at 3, where the Lanczos sum cancels most); the
    Poisson counts above never meet such a gap."""
    x = np.arange(1, 20000, dtype=np.float32)
    want = np.asarray(jax.jit(lax.lgamma)(x))
    got = xla_math.lgamma(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)
    assert (got[43:] == want[43:]).mean() > 0.999


def test_the_key_lands_on_the_backends_device():
    assert tf.key(3).device.type == "cpu"
    assert tf.key(3, device="meta").device.type == "meta"
    with pytest.raises(OverflowError):
        tf.key(2**32)
