"""The PyTorch port's RNG against smallpt_tpu/core/rng.py: threefry key
words equal, PCG4D words and every per-pass uniform stream bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smallpt_tpu.core import rng as jrng
from smallpt_tpu_torch.core import rng as trng


def test_key_words_check_values():
    np.testing.assert_array_equal(trng.base_key(7), [0, 7])
    np.testing.assert_array_equal(trng.fold_in(trng.base_key(0), 3),
                                  [2467461003, 3840466878])


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1])
def test_key_words_equal_jax(seed):
    jkey = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(trng.base_key(seed),
                                  np.asarray(jax.random.key_data(jkey)))
    for data in (0, 1, 5, 123456, 2**32 - 1):
        want = np.asarray(jax.random.key_data(jax.random.fold_in(jkey, data)))
        np.testing.assert_array_equal(
            trng.fold_in(trng.base_key(seed), data), want)
    # nested folds, as ProgressiveRenderer and render_image chain them
    k = jax.random.fold_in(jax.random.fold_in(jkey, 3), 11)
    np.testing.assert_array_equal(
        trng.fold_in(trng.fold_in(trng.base_key(seed), 3), 11),
        np.asarray(jax.random.key_data(k)))


def test_pcg4d_bit_equal_1000_inputs():
    words = np.random.default_rng(0).integers(0, 2**32, size=(4, 1000),
                                              dtype=np.uint64)
    want = jrng._pcg4d(*(jnp.asarray(w.astype(np.uint32)) for w in words))
    got = trng._pcg4d(*(torch.from_numpy(w.astype(np.int64)) for w in words))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32),
                                      np.asarray(w))
        assert int(g.min()) >= 0 and int(g.max()) < 2**32


def test_to_unit_bit_equal():
    bits = np.random.default_rng(1).integers(0, 2**32, size=1000,
                                             dtype=np.uint64)
    want = jrng._to_unit(jnp.asarray(bits.astype(np.uint32)), jnp.float32)
    got = trng._to_unit(torch.from_numpy(bits.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed,fold", [(0, None), (7, 3), (12345, 2**31 + 5)])
def test_per_pass_uniforms_bit_equal(seed, fold):
    jkey = jax.random.PRNGKey(seed)
    tkey = trng.base_key(seed)
    if fold is not None:
        jkey = jax.random.fold_in(jkey, fold)
        tkey = trng.fold_in(tkey, fold)
    r = np.random.default_rng(seed)
    sids = r.integers(0, 2**31 - 1, size=512).astype(np.int32)
    hist = r.integers(0, 64, size=512).astype(np.int32)
    depth = r.integers(0, 64, size=512).astype(np.int32)
    ts, th, td = (torch.from_numpy(a) for a in (sids, hist, depth))
    np.testing.assert_array_equal(
        trng.camera_uniforms(tkey, ts).numpy(),
        np.asarray(jrng.camera_uniforms(jkey, jnp.asarray(sids))))
    np.testing.assert_array_equal(
        trng.lens_uniforms(tkey, ts).numpy(),
        np.asarray(jrng.lens_uniforms(jkey, jnp.asarray(sids))))
    np.testing.assert_array_equal(
        trng.shade_uniforms(tkey, ts, th, td).numpy(),
        np.asarray(jrng.shade_uniforms(jkey, jnp.asarray(sids),
                                       jnp.asarray(hist), jnp.asarray(depth))))
