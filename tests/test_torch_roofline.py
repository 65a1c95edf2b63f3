"""The ceiling probe's plain version (`utils/roofline.py`) against the JAX
package's FMA chain, on the CPU.

`tools/roofline.py`'s Pallas kernel (`bench_vpu_fma.build.f`, :110-124)
computes a = x * 0.5 + 0.25, b = x * 0.125 + 0.5, then K steps of
x = x * a + b; the same loop in jax.numpy (the kernel body, without its
timing harness) is the reference here.  Tolerance rtol 1e-6: XLA may
contract a step into one FMA where torch rounds twice, and the chain
contracts errors (|a| < 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_gpu_tpu_torch.ops import build
from raytracing_gpu_tpu_torch.utils import roofline

torch.set_num_threads(1)


def _jax_chain(x, k):
    a = x * 0.5 + 0.25
    b = x * 0.125 + 0.5
    return jax.lax.fori_loop(0, k, lambda i, v: v * a + b, x)


@pytest.mark.parametrize("k", [0, 7, 64])
def test_fma_chain_matches_jax(k, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the CPU path must not build or load kernels")

    monkeypatch.setattr(build, "load", refuse)
    x = np.random.default_rng(81).random((256, 128), np.float32)
    want = np.asarray(jax.jit(_jax_chain, static_argnums=1)(jnp.asarray(x), k))
    before = roofline.launches
    got = roofline.fma_chain(torch.from_numpy(x), k)
    assert roofline.launches == before
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_ceilings_need_a_card():
    with pytest.raises(RuntimeError, match="CUDA card"):
        roofline.fma_ceiling("cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        roofline.hbm_ceiling("cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        roofline.card_peaks("cpu")
