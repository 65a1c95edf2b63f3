"""The port's counter-based RNG and seed arithmetic against the JAX kernel's.

Every comparison here is exact: the generator is pure uint32 arithmetic, so
the port must give the JAX package's bits (`pallas_trace._pcg_hash`,
`_uniform`, `wave_seed`).  Inputs are drawn with numpy from fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_gpu_tpu.ops import pallas_trace as pt
from raytracing_gpu_tpu_torch.ops import cuda_trace as ct

torch.set_num_threads(1)


def _u32(rng, n):
    return rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def test_pcg_hash_matches_jax():
    x = _u32(np.random.default_rng(11), 8192)
    want = np.asarray(pt._pcg_hash(jnp.asarray(x)))
    got = ct.pcg_hash(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)  # exact


@pytest.mark.parametrize("salt", [0, 1, 3, 7, 8, 16, 31])
def test_uniform_matches_jax(salt):
    base = _u32(np.random.default_rng(12 + salt), 8192)
    want = np.asarray(pt._uniform(jnp.asarray(base), salt))
    got = ct.uniform(torch.from_numpy(base.astype(np.int64)), salt).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)  # exact: 24-bit values


def _jax_rng_base(n, seed):
    lane = jnp.arange(n, dtype=jnp.uint32)
    return pt._pcg_hash(lane ^ (jnp.asarray(seed, jnp.int32).astype(jnp.uint32)
                                * jnp.uint32(0x85EBCA6B)))


@pytest.mark.parametrize("draw", ["seed", "negative", "extremes"])
def test_rng_base_and_draw_windows_match_jax(draw):
    rng = np.random.default_rng(13)
    seeds = {"seed": rng.integers(0, 2**31 - 1, 4),
             "negative": rng.integers(-2**31, 0, 4),
             "extremes": np.array([-2**31, -1, 0, 2**31 - 1])}[draw]
    n = 4096
    for seed in seeds.astype(np.int64):
        jb = _jax_rng_base(n, int(seed))
        tb = ct.rng_base(n, int(seed), "cpu")
        np.testing.assert_array_equal(tb.numpy().astype(np.uint32),
                                      np.asarray(jb))  # exact
        # bounce b's window and the camera window (pallas_trace.py:1295,
        # 1585), read through the draws the kernel makes there
        for b, salt in ((0, 0), (3, 1), (7, 0)):
            jd = jb + jnp.uint32(b * 32) * jnp.uint32(0x68E31DA4)
            td = (tb + ((b * 32 * 0x68E31DA4) & 0xFFFFFFFF)) & 0xFFFFFFFF
            np.testing.assert_array_equal(ct.uniform(td, salt).numpy(),
                                          np.asarray(pt._uniform(jd, salt)))
        jc = jb + jnp.uint32(0x7F4A7C15) * jnp.uint32(0x68E31DA4)
        tc = (tb + ct._CAM_DRAW) & 0xFFFFFFFF
        np.testing.assert_array_equal(ct.uniform(tc, 1).numpy(),
                                      np.asarray(pt._uniform(jc, 1)))


def test_pcg_uniform_cpu_is_the_plain_stream():
    seed, n = -1540198401, 4096
    want = np.asarray(pt._uniform(_jax_rng_base(n, seed), 7))
    np.testing.assert_array_equal(ct.pcg_uniform(seed, n, 7, "cpu").numpy(),
                                  want)  # exact


@pytest.mark.parametrize("base", [2**31 - 2, 2**31 - 7919, 2**31 - 150000,
                                  2**31 - 1, 0, 414133122])
def test_wave_seed_wraps_like_jax(base):
    # near 2**31 the JAX int32 sum wraps negative; Python ints do not
    for idx in ((0, 0), (1, 0), (63, 3), (15, 1), (1000, 20000), (7,)):
        want = int(pt.wave_seed(jnp.int32(base), *idx))
        assert ct.wave_seed(base, *idx) == want, idx


def test_chunk_seed_is_int32_and_reproducible():
    a = [ct.chunk_seed(torch.Generator().manual_seed(1984)) for _ in range(2)]
    assert a[0] == a[1]
    gen = torch.Generator().manual_seed(7)
    draws = [ct.chunk_seed(gen) for _ in range(64)]
    assert all(0 <= d < 2**31 - 1 for d in draws)
    assert len(set(draws)) == len(draws)
