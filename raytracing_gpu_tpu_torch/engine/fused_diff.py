"""The differentiable render chunk, with a closed-form backward pass.

Counterpart of `compile_fused_param_renderer` and `_shade_chain_bwd` in
`raytracing_gpu_tpu/engine/fused_diff.py`.  A chunk is `spp_per_chunk`
samples of every pixel, split into waves of `ray_batch` pixels.  Each
(sample, wave) runs the record kernel and shades its record planes
(`integrator.shade_packed`): the packed plane, the hit-point planes when a
checker or perlin texture needs them, and the uv planes when an image
texture does.  With `gen_rays=True` the
kernel makes the camera rays and walks every wave of the chunk in one
launch (`ops/cuda_trace.py` `Tracer.bind_record_chunk`);
with `gen_rays=False` each wave's rays are drawn in torch with
`render.chunk_sums`'s schedule (`render.wave_rays`) and walked on ray
planes (`Tracer.walk_packed`, kernel 1c): the record-walk route of
`render.compile_param_renderer`.

Per lane the shading is the product chain (reference `render.h:55-81`):

    L = sum_b T_b * E_b,   T_0 = 1,   T_{b+1} = T_b * F_b
    E_b = miss_b * background + hit_b * emit_b
    F_b = cont_b * att_b + (1 - cont_b)

whose adjoint is another linear chain: with the suffix sum
S_b = E_b + F_b * S_{b+1} (so L = S_0),

    dL/d att_b  = g * T_b * S_{b+1} * cont_b
    dL/d emit_b = g * T_b * hit_b

So the backward pass of a wave is one shade forward over its record plane,
a prefix product T, a reverse suffix sum S, and one vector-Jacobian product
of `materials.shade`: no per-bounce graph is kept.  The chunk is a
`torch.autograd.Function` whose backward is exactly that.  On an (sp, dp)
mesh of ranks (`mesh=`) each rank walks and shades its own waves.
"""

from __future__ import annotations

from typing import Callable, Iterator

import torch

from ..core.camera import Camera
from ..core.config import RenderSettings
from ..ops import cuda_trace
from ..scene import materials as materials_mod
from ..scene.types import Scene, host_table
from .diff import PARAM_KEYS
from .integrator import shade_packed, unpack_walk
from .render import _grid_geometry, shard_geometry, wave_rays

_SAVE_PLANES_MAX_BYTES = 1 << 30


def _shade_chain_bwd(scene: Scene, params: dict, planes, g: torch.Tensor,
                     need_p: bool, need_uv: bool) -> dict:
    """d<g, L(params)> / d params for one wave, by the closed-form adjoint.

    planes are the wave's record planes (packed[, px, py, pz][, u, v]); g
    is the incoming radiance cotangent (N, 3).  A parameter that `shade`
    does not use gets zeros of its own shape; the uv planes carry the
    atlas's gradient through the one VJP of `materials.shade`.
    """
    data = unpack_walk(planes, need_p, need_uv)
    d_, n = data.mat_id.shape
    dev = g.device
    h = data.hit.to(torch.float32)[..., None]     # (D, N, 1)
    m = data.miss.to(torch.float32)[..., None]
    c = data.cont.to(torch.float32)[..., None]

    # one flattened shade call per wave: the only parameter-dependent code
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        att_f, emit_f = materials_mod.shade(
            scene, leaves, data.mat_id.reshape(-1), data.u.reshape(-1),
            data.v.reshape(-1), data.p.reshape(-1, 3))
    att = att_f.detach().reshape(d_, n, 3)
    emit = emit_f.detach().reshape(d_, n, 3)

    bg = host_table(scene.background, dev, torch.float32)
    e_term = m * bg + h * emit                    # E_b
    f_term = c * att + (1.0 - c)                  # F_b

    # T_b: exclusive prefix product of F along the bounce axis
    t_chain = torch.cat([torch.ones((1, n, 3), dtype=torch.float32,
                                    device=dev),
                         torch.cumprod(f_term, dim=0)[:-1]], dim=0)
    # S_{b+1}: suffix sum S_b = E_b + F_b S_{b+1}, shifted down one bounce
    s = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    s_next = [s]
    for b in range(d_ - 1, 0, -1):
        s = e_term[b] + f_term[b] * s
        s_next.append(s)
    s_next = torch.stack(s_next[::-1])

    g_att = (g[None] * t_chain * s_next * c).reshape(-1, 3)
    g_emit = (g[None] * t_chain * h).reshape(-1, 3)
    outs = [(o, go) for o, go in ((att_f, g_att), (emit_f, g_emit))
            if o.requires_grad]
    grads = torch.autograd.grad([o for o, _ in outs], list(leaves.values()),
                                [go for _, go in outs], allow_unused=True)
    return {k: torch.zeros_like(v) if gr is None else gr
            for (k, v), gr in zip(leaves.items(), grads)}


def fused_chunk_from_walk(scene: Scene,
                          walk: Callable[[int, int, int], tuple],
                          settings: RenderSettings,
                          save_planes: bool | None = None,
                          device: torch.device | str = "cuda",
                          need_p: bool | None = None,
                          need_uv: bool | None = None,
                          mesh=None) -> Callable[[dict, int], torch.Tensor]:
    """The differentiable chunk over a record walk a wave at a time,
    `walk(pix_base, n, seed) -> planes`: (packed (max_depth, n) int32, then
    px, py, pz (max_depth, n) float32 when the scene's textures need the
    hit point, then u, v when an image texture needs them), the ray-plane
    kernel's (`compile_fused_param_renderer(gen_rays=False)`) or a plain
    version.  Wave (s, bid) walks with seed `wave_seed(base, s, bid)`, the
    JAX package's schedule (`fused_diff.py:184-193`).

    Returns `chunk(params, base) -> (npix_pad, 3)` float32 radiance sums,
    differentiable with respect to the tensors of `params`
    (`engine.diff.get_params`).

    save_planes: keep every wave's record planes from the forward pass for
    the backward pass, instead of walking the waves again.  Default: on
    when the planes of a chunk fit in 1 GiB.
    need_p, need_uv: whether the walk writes the hit-point and the uv
    planes; default the scene's bake's (`SceneBake.need_p`, `need_uv`).
    mesh: a `parallel.mesh.Mesh`; this rank then walks only its waves
    (`_local_waves`) and the chunk is sharded (`_fused_chunk`).
    """
    b = _grid_geometry(settings)[4]
    local = _local_waves(settings, mesh)

    def waves(base: int):
        for s, bid, row in local:
            yield row, walk(bid * b, b, cuda_trace.wave_seed(base, s, bid))

    return _fused_chunk(scene, waves, settings, save_planes, device, need_p,
                        need_uv, mesh)


def fused_chunk_from_chunk_walk(scene: Scene, walk_chunk: Callable[..., tuple],
                                settings: RenderSettings,
                                save_planes: bool | None = None,
                                device: torch.device | str = "cuda",
                                need_p: bool | None = None,
                                need_uv: bool | None = None,
                                mesh=None
                                ) -> Callable[[dict, int], torch.Tensor]:
    """`fused_chunk_from_walk` over a whole chunk's record walk,
    `walk_chunk(base, first, count) -> planes` of waves [first, first +
    count) in the schedule order, each plane (count, max_depth, ray_batch),
    walked once for each of `walk_chunk.groups` (`Tracer.bind_record_chunk`:
    one kernel launch a group, a whole chunk in one unless its planes pass
    `cuda_trace.RECORD_CHUNK_BYTES`).  The waves are shaded in the same order from the same
    planes, so the sums and the gradients equal the per-wave walk's bit for
    bit.  Without saved planes the backward pass walks the groups again.
    With a `mesh` this rank walks its own waves: each run of them that is
    consecutive in the schedule within one group is one launch (one a
    local sample under dp, the rank's whole share under sp alone)."""
    nb = _grid_geometry(settings)[5]
    local = _local_waves(settings, mesh)
    row_of = {s * nb + bid: row for s, bid, row in local}
    runs = []
    for w in sorted(row_of):
        if runs and runs[-1][1] == w:
            runs[-1][1] = w + 1
        else:
            runs.append([w, w + 1])
    launches = [(max(lo, first), min(hi, first + count) - max(lo, first))
                for lo, hi in runs for first, count in walk_chunk.groups
                if max(lo, first) < min(hi, first + count)]

    def waves(base: int):
        for first, count in launches:
            planes = walk_chunk(base, first, count)
            for k in range(count):
                yield row_of[first + k], tuple(p[k] for p in planes)

    return _fused_chunk(scene, waves, settings, save_planes, device, need_p,
                        need_uv, mesh)


def _local_waves(settings: RenderSettings, mesh) -> list:
    """The (sample, wave, output row) triples this rank walks, by global
    sample and wave index in the schedule order: every (s, bid) without a
    mesh; with one, sample sp * spp_local + s of wave dp * nb_local + r
    into row r, s < spp_local and r < nb_local (`fused_diff.py:339-345`).
    A wave that the dp padding adds past the image's nb waves is not
    walked: its pixels lie past the image, and its rows stay 0."""
    _h, _w, _npix, _npix_pad, _b, nb = _grid_geometry(settings)
    if mesh is None:
        return [(s, bid, bid) for s in range(settings.spp_per_chunk)
                for bid in range(nb)]
    *_, nb_local, spp_local = shard_geometry(settings, mesh)
    sp, dp = mesh.sp, mesh.dp
    return [(sp * spp_local + s, dp * nb_local + r, r)
            for s in range(spp_local) for r in range(nb_local)
            if dp * nb_local + r < nb]


def _fused_chunk(scene: Scene, waves: Callable[[int], Iterator[tuple]],
                 settings: RenderSettings, save_planes: bool | None,
                 device: torch.device | str, need_p: bool | None,
                 need_uv: bool | None, mesh=None
                 ) -> Callable[[dict, int], torch.Tensor]:
    """The differentiable chunk over `waves(base)`, the (output row, record
    planes) of its (sample, wave)s in the schedule order.

    With a `mesh` (`fused_diff.py:273-438`) the rows are this rank's dp
    span; the forward pass sums the span over the sp group and gathers
    the spans, so every rank returns the whole (npix_pad, 3) frame (rows
    padded to b * n_dp) and computes the same loss of it.  The backward
    pass takes this rank's rows of that loss's cotangent, runs the adjoint
    over its own waves and sums the parameter gradients over the mesh
    once: every wave's term is counted on exactly one rank.
    """
    feature = cuda_trace.unported_record_feature(scene)
    if feature is not None:
        raise NotImplementedError(f"{feature}: not yet ported")
    device = torch.device(device)
    if need_p is None or need_uv is None:
        bake = cuda_trace.bake_scene(scene)
        need_p = bake.need_p if need_p is None else need_p
        need_uv = bake.need_uv if need_uv is None else need_uv
    if mesh is None:
        _h, _w, _npix, local_npix, b, nb_local = _grid_geometry(settings)
        spp_local, lo = settings.spp_per_chunk, 0
    else:
        b, _nb, _pad, local_npix, nb_local, spp_local = shard_geometry(
            settings, mesh)
        lo = mesh.dp * local_npix
    max_depth = settings.max_depth
    n_planes = 1 + 3 * need_p + 2 * need_uv  # fused_diff.py:179
    plane_bytes = spp_local * nb_local * max_depth * b * 4 * n_planes
    if save_planes is None:
        save_planes = plane_bytes <= _SAVE_PLANES_MAX_BYTES

    class FusedChunk(torch.autograd.Function):
        @staticmethod
        def forward(ctx, base, *values):
            params = dict(zip(PARAM_KEYS, values))
            out = torch.zeros((nb_local, b, 3), dtype=torch.float32,
                              device=device)
            kept = []
            for row, planes in waves(base):
                out[row] += shade_packed(scene, params, *planes,
                                         need_p=need_p, need_uv=need_uv)
                if save_planes:
                    kept.append((row, planes))
            ctx.base = base
            ctx.kept = kept if save_planes else None
            ctx.save_for_backward(*values)
            out = out.reshape(local_npix, 3)
            if mesh is not None:
                out = mesh.gather_dp(mesh.sum_sp(out))
            return out

        @staticmethod
        def backward(ctx, g):
            params = dict(zip(PARAM_KEYS, ctx.saved_tensors))
            g_waves = g[lo:lo + local_npix].reshape(nb_local, b, 3)
            acc = {k: torch.zeros_like(v) for k, v in params.items()}
            kept = ctx.kept if ctx.kept is not None else waves(ctx.base)
            for row, planes in kept:
                d_p = _shade_chain_bwd(scene, params, planes, g_waves[row],
                                       need_p, need_uv)
                acc = {k: acc[k] + d_p[k] for k in acc}
            if mesh is not None:
                acc = {k: mesh.sum_all(v) for k, v in acc.items()}
            return (None, *(acc[k] for k in PARAM_KEYS))

    def chunk(params: dict, base: int) -> torch.Tensor:
        return FusedChunk.apply(int(base), *(params[k] for k in PARAM_KEYS))

    chunk.save_planes = save_planes
    return chunk


def compile_fused_param_renderer(
    scene: Scene, camera: Camera, settings: RenderSettings,
    save_planes: bool | None = None, gen_rays: bool = True,
    device: torch.device | str = "cuda",
    tracer: cuda_trace.Tracer | None = None, mesh=None,
) -> Callable[[dict, int], torch.Tensor]:
    """Differentiable chunk renderer `(params, base) -> (npix_pad, 3)` sums
    on `device`, with the closed-form backward pass; `base` is the int32
    chunk seed (`cuda_trace.chunk_seed`).

    The walks are the record kernel's on a CUDA device and its plain
    version on the CPU: on camera rays made in the kernel (`gen_rays`, the
    route `bench.py` takes), the whole chunk in one launch
    (`Tracer.bind_record_chunk`, `fused_chunk_from_chunk_walk`), or on
    each wave's rays drawn in torch (`render.wave_rays`) and walked as ray
    planes (kernel 1c), one launch a wave, the record-walk route of
    `render.compile_param_renderer`, which passes its `tracer` of `scene`.
    Raises NotImplementedError for a scene outside the ported feature set.
    See `fused_chunk_from_walk` for `save_planes`.

    mesh: an (sp, dp) `parallel.mesh.make_mesh` mesh that every rank of it
    passes (`fused_diff.py:273-438`).  Each rank walks its own share of
    the waves, by their global sample and wave index, so the sharded chunk
    equals the unsharded one (bit for bit under dp alone, to float
    summation order under sp), and `save_planes` counts this rank's
    planes.  Every rank returns the whole frame, its rows padded to
    ray_batch * n_dp, and gets the whole gradient (see `_fused_chunk`).
    """
    device = torch.device(device)
    if tracer is None:
        tracer = cuda_trace.Tracer(scene, device)  # raises for unported
    h, w, _npix, _npix_pad, b, _nb = _grid_geometry(settings)
    depth, t_min = settings.max_depth, settings.t_min
    if gen_rays:
        walk_chunk = tracer.bind_record_chunk(camera, h, w, depth, t_min, b,
                                              settings.spp_per_chunk)
        return fused_chunk_from_chunk_walk(scene, walk_chunk, settings,
                                           save_planes, device,
                                           tracer.need_p, tracer.need_uv,
                                           mesh)
    cam = camera.to(device)
    walk_rays = tracer.bind_walk_packed(depth, t_min)

    def walk(pix_base: int, n: int, seed: int) -> tuple:
        return walk_rays(*wave_rays(cam, settings, pix_base, n, seed, device))
    return fused_chunk_from_walk(scene, walk, settings, save_planes, device,
                                 tracer.need_p, tracer.need_uv, mesh)
