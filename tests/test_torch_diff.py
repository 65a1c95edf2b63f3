"""The port's training path on the CPU: shading, the fused chunk, gradients.

The JAX reference is `compile_fused_param_renderer(..., gen_rays=True)`, the
route `bench.py` takes on a TPU (its CPU default draws threefry rays, which
the port does not reproduce), run once per module at 32x32, 2 spp, depth 3,
ray_batch 512 (2 waves per sample).  The port gets the base seed
`chunk_seed(key)` of the same key and the parameters as numpy.

Tolerances: shading allclose rtol 1e-6 (the same float32 ops in the same
order); the chunk's primal, >= 99% of pixels within atol 1e-3 * max and
channel means within 1e-3 relative (the forward rule of
tests/test_torch_render.py); gradients allclose rtol 2e-4, atol 1e-7 (the
tolerance of tests/test_fused_diff.py, sums taken in another order).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_gpu_tpu.core.config import RenderSettings as JSettings
from raytracing_gpu_tpu.engine import diff as jdiff
from raytracing_gpu_tpu.engine import integrator as jintegrator
from raytracing_gpu_tpu.engine.fused_diff import (
    compile_fused_param_renderer as jax_fused)
from raytracing_gpu_tpu.models import scenes as jscenes
from raytracing_gpu_tpu.ops import pallas_trace as pt
from raytracing_gpu_tpu.scene import materials as jmaterials
from raytracing_gpu_tpu.scene import textures as jtextures
from raytracing_gpu_tpu.scene import types as jtypes
from raytracing_gpu_tpu_torch import RenderSettings, compile_renderer
from raytracing_gpu_tpu_torch.convert import params_from_numpy
from raytracing_gpu_tpu_torch.engine import diff, fused_diff, integrator
from raytracing_gpu_tpu_torch.models import scenes as tscenes
from raytracing_gpu_tpu_torch.ops import cuda_trace as ct
from raytracing_gpu_tpu_torch.scene import materials, textures
from raytracing_gpu_tpu_torch.scene import types as st

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port",
                      "cornell_grad_32.npz")
SETTINGS = dict(image_width=32, aspect_ratio=1.0, spp_per_chunk=2,
                num_chunks=1, max_depth=3, ray_batch=512)
TARGET = 0.25


def assert_sums_match(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    within = (err <= 1e-3 * np.abs(want).max()).all(-1).mean()
    assert within >= 0.99, within
    np.testing.assert_allclose(got.mean(0), want.mean(0), rtol=1e-3)


def assert_grads_match(got, want):
    assert set(got) == set(want)
    for k in want:
        g = got[k].detach().cpu().numpy()
        assert g.shape == want[k].shape, k
        np.testing.assert_allclose(g, want[k], rtol=2e-4, atol=1e-7,
                                   err_msg=k)


def _numpy_params(params):
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX fused chunk's primal and L2-loss gradients, and the base."""
    sd = jscenes.get("cornell_box")
    key = jax.random.PRNGKey(int(np.random.default_rng(81).integers(2**31)))
    chunk = jax_fused(sd.scene, sd.camera, JSettings(**SETTINGS),
                      gen_rays=True)
    params = jdiff.get_params(sd.scene)
    primal = np.asarray(chunk(params, key))
    grads = jax.grad(lambda p: jnp.mean((chunk(p, key) - TARGET) ** 2))(
        params)
    return dict(base=int(pt.chunk_seed(key)), primal=primal,
                grads=_numpy_params(grads), params=_numpy_params(params))


@pytest.mark.parametrize("save_planes", [True, False])
def test_fused_chunk_matches_jax(jax_ref, save_planes):
    tsd = tscenes.get("cornell_box")
    chunk = fused_diff.compile_fused_param_renderer(
        tsd.scene, tsd.camera, RenderSettings(**SETTINGS),
        save_planes=save_planes, device="cpu")
    assert chunk.save_planes is save_planes
    params = params_from_numpy(jax_ref["params"], "cpu")
    base = jax_ref["base"]
    out = chunk(params, base)
    loss, grads = diff.value_and_grad(params, lambda p: chunk(p, base),
                                      torch.full_like(out, TARGET))
    assert out.dtype == torch.float32 and tuple(out.shape) == (1024, 3)
    assert_sums_match(out.numpy(), jax_ref["primal"])
    assert_grads_match(grads, jax_ref["grads"])
    assert float(np.abs(jax_ref["grads"]["tex_c1"]).max()) > 0.0
    np.testing.assert_allclose(
        float(loss), np.mean((jax_ref["primal"] - TARGET) ** 2), rtol=1e-5)


def test_fused_chunk_matches_pinned_golden():
    g = np.load(GOLDEN)
    st_g = RenderSettings(image_width=int(g["image_width"]), aspect_ratio=1.0,
                          spp_per_chunk=int(g["spp_per_chunk"]),
                          num_chunks=1, max_depth=int(g["max_depth"]),
                          ray_batch=int(g["ray_batch"]),
                          t_min=float(g["t_min"]))
    tsd = tscenes.get("cornell_box")
    chunk = fused_diff.compile_fused_param_renderer(tsd.scene, tsd.camera,
                                                    st_g, device="cpu")
    params = diff.get_params(tsd.scene, "cpu")
    out = chunk(params, int(g["base"]))
    _, grads = diff.value_and_grad(params, lambda p: chunk(p, int(g["base"])),
                                   torch.full_like(out, float(g["target"])))
    assert_sums_match(out.numpy(), g["primal"])
    assert_grads_match(grads, {k: g[f"grad_{k}"] for k in diff.PARAM_KEYS})


def test_fused_primal_equals_the_forward_chunk():
    tsd = tscenes.get("cornell_box")
    st_ = RenderSettings(**SETTINGS)
    base = int(np.random.default_rng(82).integers(2**31 - 1))
    fused = fused_diff.compile_fused_param_renderer(tsd.scene, tsd.camera,
                                                    st_, device="cpu")
    fwd = compile_renderer(tsd.scene, tsd.camera, st_, device="cpu")
    got = fused(diff.get_params(tsd.scene, "cpu"), base)
    # same paths, same products: the two routes agree bit for bit here
    np.testing.assert_array_equal(got.numpy(), fwd(base).numpy())


@pytest.mark.parametrize("save_planes,walks_per_wave", [(True, 1),
                                                        (False, 2)])
def test_backward_rewalks_only_without_saved_planes(save_planes,
                                                    walks_per_wave):
    tsd = tscenes.get("cornell_box")
    st_ = RenderSettings(**SETTINGS)
    tracer = ct.Tracer(tsd.scene, "cpu")
    plain = tracer.bind_record(tsd.camera, 32, 32, st_.max_depth, st_.t_min)
    calls = []

    def walk(pix_base, n, seed):
        calls.append((pix_base, n, seed))
        return plain(pix_base, n, seed)

    chunk = fused_diff.fused_chunk_from_walk(tsd.scene, walk, st_,
                                             save_planes, "cpu")
    params = diff.get_params(tsd.scene, "cpu")
    _, grads = diff.value_and_grad(params, lambda p: chunk(p, 7), 0.0)
    waves = [(bid * 512, 512, ct.wave_seed(7, s, bid))
             for s in range(2) for bid in range(2)]
    assert calls == waves * walks_per_wave
    assert set(grads) == set(diff.PARAM_KEYS)


def test_gradient_matches_central_difference():
    """f(params) is deterministic for a fixed base (same paths), so the
    adjoint must match its central difference (as tests/test_grad.py)."""
    tsd = tscenes.get("cornell_box")
    chunk = fused_diff.compile_fused_param_renderer(
        tsd.scene, tsd.camera, RenderSettings(**SETTINGS), device="cpu")
    params = diff.get_params(tsd.scene, "cpu")
    base = 1234567

    def f(p):
        return float(chunk(p, base).double().sum())

    _, grads = diff.value_and_grad(params, lambda p: chunk(p, base).sum(),
                                   0.0, loss=lambda img, _t: img)
    eps = 2e-3
    for idx in [(1, 0), (3, 2)]:   # white wall red; light blue (emitter)
        plus = {k: v.clone() for k, v in params.items()}
        minus = {k: v.clone() for k, v in params.items()}
        plus["tex_c1"][idx] += eps
        minus["tex_c1"][idx] -= eps
        fd = (f(plus) - f(minus)) / (2 * eps)
        ad = float(grads["tex_c1"][idx])
        assert ad == pytest.approx(fd, rel=5e-2, abs=2e-2), (idx, ad, fd)
    assert torch.equal(grads["atlas_data"], torch.zeros(3))


def _checker_tables(n_mat: int, seed: int):
    """Synthetic material and texture tables: every material kind, solid
    and checker textures with random colors and scales."""
    rng = np.random.default_rng(seed)
    n_tex = n_mat
    kind = rng.choice([st.LAMBERTIAN, st.METAL, st.DIELECTRIC,
                       st.DIFFUSE_LIGHT], size=n_mat).astype(np.int32)
    kind[:4] = [st.LAMBERTIAN, st.DIFFUSE_LIGHT, st.DIELECTRIC, st.METAL]
    tex_kind = np.where(rng.random(n_tex) < 0.5, st.TEX_CHECKER,
                        st.TEX_SOLID).astype(np.int32)
    tex_kind[:2] = [st.TEX_CHECKER, st.TEX_SOLID]
    mats = dict(kind=kind, tex_id=rng.permutation(n_tex).astype(np.int32),
                fuzz=np.zeros(n_mat, np.float32),
                ir=np.full(n_mat, 1.5, np.float32))
    texs = dict(kind=tex_kind,
                c1=rng.random((n_tex, 3)).astype(np.float32),
                c2=rng.random((n_tex, 3)).astype(np.float32),
                scale=rng.uniform(0.5, 12.0, n_tex).astype(np.float32),
                image_id=np.full(n_tex, -1, np.int32))
    return mats, texs


def _scenes(case):
    """(JAX scene, port scene) pair for a shading case."""
    jsc = jscenes.get("cornell_box").scene
    tsc = tscenes.get("cornell_box").scene
    if case == "cornell":
        return jsc, tsc
    mats, texs = _checker_tables(*{"checker": (6, 83),
                                   "checker_many": (40, 84)}[case])
    jsc = jsc.replace(
        materials=jtypes.Materials(**{k: jnp.asarray(v)
                                      for k, v in mats.items()}),
        textures=jtypes.Textures(**{k: jnp.asarray(v)
                                    for k, v in texs.items()}))
    tsc = dataclasses.replace(tsc, materials=st.Materials(**mats),
                              textures=st.Textures(**texs))
    return jsc, tsc


def _hits(n_mat: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    mat_id = rng.integers(0, n_mat, n).astype(np.int32)
    p = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    uv = rng.random((2, n)).astype(np.float32)
    return mat_id, p, uv


@pytest.mark.parametrize("case", ["cornell", "checker", "checker_many"])
def test_shade_matches_jax(case):
    jsc, tsc = _scenes(case)
    n_mat = len(tsc.materials.kind)
    mat_id, p, uv = _hits(n_mat, 4096, 85)
    params = diff.get_params(tsc, "cpu")
    fast = materials._fast_shade(tsc, params, torch.from_numpy(mat_id),
                                 torch.from_numpy(p))
    want = jmaterials._fast_shade(jsc, jnp.asarray(mat_id), jnp.asarray(p))
    assert fast is not None and want is not None
    for got, ref in zip(fast, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=0)
    got = materials.shade(tsc, params, torch.from_numpy(mat_id),
                          torch.from_numpy(uv[0]), torch.from_numpy(uv[1]),
                          torch.from_numpy(p))
    ref = jmaterials.shade(jsc, jnp.asarray(mat_id), jnp.asarray(uv[0]),
                           jnp.asarray(uv[1]), jnp.asarray(p))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("case", ["cornell", "checker", "checker_many"])
def test_shade_packed_matches_jax(case):
    jsc, tsc = _scenes(case)
    n_mat = len(tsc.materials.kind)
    depth, n = 4, 2048
    rng = np.random.default_rng(86)
    mat_id, p, _ = _hits(n_mat, depth * n, 87)
    bits = rng.integers(0, 8, depth * n).astype(np.int32) << 16
    packed = (mat_id | bits).reshape(depth, n)
    p_planes = [p[:, k].reshape(depth, n) for k in range(3)]
    need_p = case != "cornell"
    planes = (packed, *p_planes) if need_p else (packed,)
    want = jintegrator.shade_packed(jsc, *map(jnp.asarray, planes),
                                    need_p=need_p, need_uv=False)
    got = integrator.shade_packed(tsc, diff.get_params(tsc, "cpu"),
                                  *map(torch.from_numpy, planes),
                                  need_p=need_p, need_uv=False)
    assert tuple(got.shape) == (n, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


def test_eval_texture_matches_jax_and_names_unported_kinds():
    jsc, tsc = _scenes("checker")
    rng = np.random.default_rng(88)
    tex_id = rng.integers(0, len(tsc.textures.kind), 1024).astype(np.int32)
    p = rng.uniform(-3.0, 3.0, (1024, 3)).astype(np.float32)
    u, v = rng.random((2, 1024)).astype(np.float32)
    got = textures.eval_texture(tsc, diff.get_params(tsc, "cpu"),
                                torch.from_numpy(tex_id), torch.from_numpy(u),
                                torch.from_numpy(v), torch.from_numpy(p))
    want = jtextures.eval_texture(jsc, jnp.asarray(tex_id), jnp.asarray(u),
                                  jnp.asarray(v), jnp.asarray(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    # an image slot with no image bound is cyan, in both packages
    kinds = tsc.textures.kind.copy()
    kinds[0] = st.TEX_IMAGE
    image = dataclasses.replace(
        tsc, textures=dataclasses.replace(tsc.textures, kind=kinds))
    jimage = jsc.replace(textures=jsc.textures.replace(kind=jnp.asarray(
        kinds)))
    got = textures.eval_texture(image, diff.get_params(image, "cpu"),
                                torch.from_numpy(tex_id), torch.from_numpy(u),
                                torch.from_numpy(v), torch.from_numpy(p))
    want = jtextures.eval_texture(jimage, jnp.asarray(tex_id), jnp.asarray(u),
                                  jnp.asarray(v), jnp.asarray(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    assert (got.numpy()[tex_id == 0] == (0.0, 1.0, 1.0)).all()
    # a material bound to it takes shade's general route
    assert materials._fast_shade(image, diff.get_params(image, "cpu"),
                                 torch.from_numpy(tex_id),
                                 torch.from_numpy(p)) is None
    att, _ = materials.shade(image, diff.get_params(image, "cpu"),
                             torch.from_numpy(tex_id), torch.from_numpy(u),
                             torch.from_numpy(v), torch.from_numpy(p))
    assert bool(torch.isfinite(att).all())


def test_params_round_trip():
    jsc = jscenes.get("cornell_box").scene
    tsc = tscenes.get("cornell_box").scene
    want = _numpy_params(jdiff.get_params(jsc))
    params = params_from_numpy(want, "cpu")
    assert list(params) == list(diff.PARAM_KEYS)
    for k, v in params.items():
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), want[k])
        np.testing.assert_array_equal(v.numpy(),
                                      diff.get_params(tsc, "cpu")[k].numpy())
    moved = {k: v * 0.5 for k, v in params.items()}
    back = diff.get_params(diff.set_params(tsc, moved), "cpu")
    for k in params:
        np.testing.assert_array_equal(back[k].numpy(), moved[k].numpy())
    with pytest.raises(KeyError, match="tex_c2"):
        params_from_numpy({"tex_c1": want["tex_c1"]}, "cpu")
    with pytest.raises(TypeError, match="float32"):
        params_from_numpy({**want, "atlas_data": np.zeros(3, np.int32)},
                          "cpu")


def test_bench_torch_exits_without_a_card():
    env = {**os.environ, "PYTHONPATH": ROOT, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py"),
                           "--reps", "1"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert "Mrays" not in proc.stdout
