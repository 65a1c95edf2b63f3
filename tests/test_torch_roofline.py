"""The ceiling probes (`utils/roofline.py`) and the roofline tool
(`tools/roofline_torch.py`) against the JAX package's, on the CPU.

`tools/roofline.py`'s Pallas kernel (`bench_vpu_fma.build.f`, :110-124)
computes a = x * 0.5 + 0.25, b = x * 0.125 + 0.5, then K steps of
x = x * a + b; the same loop in jax.numpy (the kernel body, without its
timing harness) is the reference here.  Tolerance rtol 1e-6: XLA may
contract a step into one FMA where torch rounds twice, and the chain
contracts errors (|a| < 1).

`bench_mxu`'s chain (:82-96), y = (y @ a) * 0.5 from y = a in bf16, at
64 x 64 and 3 steps: `roofline.mxu_chain` against the same jax.numpy
chain within rtol 2**-7 of each value (two bf16 ulps: one rounding of the
product and the sum's order may differ between XLA and torch; the halving
is exact).  `tools/roofline_torch.py --device cpu` prints the JAX tool's
`measure` lines with its keys, which are read from that tool's source.
"""

import ast
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_gpu_tpu_torch.ops import build
from raytracing_gpu_tpu_torch.utils import roofline

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_RTOL = 2.0**-7


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
        roofline.mxu_ceiling("cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        roofline.hbm_ceiling("cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        roofline.card_peaks("cpu")


def _jax_mxu_chain(a, reps):
    return jax.lax.fori_loop(0, reps, lambda i, y: (y @ a) * 0.5, a)


@pytest.mark.parametrize("fill", ["constant", "seeded"])
def test_mxu_chain_matches_jax(fill):
    a = (np.full((64, 64), 0.001, np.float32) if fill == "constant"
         else np.random.default_rng(83).random((64, 64), np.float32) / 8)
    want = np.asarray(jax.jit(_jax_mxu_chain, static_argnums=1)(
        jnp.asarray(a, jnp.bfloat16), 3).astype(jnp.float32))
    got = roofline.mxu_chain(torch.from_numpy(a).to(torch.bfloat16), 3)
    assert got.dtype == torch.bfloat16 and got.shape == (64, 64)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL,
                               atol=0)


def _jax_tool_lines() -> dict:
    """`measure` name -> its keyword names, from every `emit(...)` call of
    tools/roofline.py."""
    tree = ast.parse(open(os.path.join(ROOT, "tools", "roofline.py")).read())
    lines = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", None)
                == "emit"):
            kw = {k.arg: k.value for k in node.keywords}
            lines[kw["measure"].value] = set(kw) - {"measure"}
    return lines


def test_tool_prints_the_jax_tools_lines_on_the_cpu(capsys):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import roofline_torch
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    jax_lines = _jax_tool_lines()
    phases = ["walk_forward_kernel", "walk_record_kernel",
              "xla_shade_forward", "xla_shade_fwd_bwd", "e2e_chunk_fwd_bwd",
              "e2e_chunk_forward"]
    assert set(jax_lines) == {"device", "hbm_rw_chain", "mxu_bf16_matmul",
                              "vpu_f32_fma_chain", *phases}
    lines = roofline_torch.main(["--device", "cpu"])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == lines
    # on the CPU: the device line and A-F, no ceilings
    assert [x["measure"] for x in lines] == ["device"] + phases
    assert lines[0]["device"] == "cpu" and lines[0]["card"] is None
    for line in lines:
        assert jax_lines[line["measure"]] <= set(line), line["measure"]
    for line in lines[1:]:
        assert isinstance(line["seconds"], float)
        assert line["device_seconds"] is None and line["launches"] == {}
    assert lines[5]["route"] == "record-walk"
    assert lines[6]["route"] == "megakernel"
    assert lines[5]["chunk_rays"] == 16 * 16 * 2 and lines[1]["n_rays"] == 256


def test_tool_refuses_to_run_without_a_card():
    # the CPU has no card: the default device, cuda, is refused
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import roofline_torch
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    with pytest.raises(SystemExit):
        roofline_torch.main([])
