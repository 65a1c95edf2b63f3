"""The yardstick of the kernels' rooflines: NVIDIA's published H100 SXM
peaks, and the float32 operations and bytes of a render's chunk launches
of the forward megakernel (kernel 1a), counted from the paths whatever
implementation traced them.

The operation table is frozen from the port's chip smoke test, which
counted it from `csrc/megakernel.cuh`: add, multiply, divide, square
root, transcendental, min/max and compare each count once, the integer
hashes of the random stream not at all.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12     # float32 outside the tensor cores, dense
PEAK_BYTES_PER_S = 3.35e12  # HBM3; both at the 700 W limit

OPS_CAMERA = 25     # the camera ray: two draws, su/sv, origin, direction
OPS_RECT = 14       # one rect test: guard, divide, two lerps, compares
OPS_BOX = 51        # one box: transform, three divides, six slabs
OPS_MEDIUM = 60     # one medium: interval, free path (log), compares
OPS_BOUNCE = 10     # a bounce: the miss test, the media's 1 / |d|
OPS_SCATTER = {"lambertian": 50,  # face normal, normalize, draws, n + u
               "isotropic": 47}   # face normal, a point in the ball
OPS_FWD_CONT = 3    # the throughput's multiply a continued bounce
OPS_FWD_END = 9     # the path's term into its pixel's sum
RECT_BYTES, BOX_BYTES, MEDIUM_BYTES = 18 * 4, 24 * 4, 24 * 4
SUM_BYTES = 3 * 4   # a pixel row of a chunk's float32 sums


def render_work(n_rects: int, n_boxes: int, n_media: int, counts: dict,
                rays: float, chunks: int, rows: int) -> tuple:
    """(float32 operations, bytes) of a render's chunk launches: `rays`
    camera rays doing, on average, the work `counts` (`paths.zero_counts`)
    records of its sampled paths; each chunk writes its `rows` sums once
    and reads the scene's tables once."""
    per = rays / counts["paths"]
    segment = (n_rects * OPS_RECT + n_boxes * OPS_BOX + n_media * OPS_MEDIUM
               + OPS_BOUNCE)
    ops = (counts["paths"] * (OPS_CAMERA + OPS_FWD_END)
           + counts["live"] * segment + counts["cont"] * OPS_FWD_CONT
           + sum(counts["scatter"].get(k, 0) * v
                 for k, v in OPS_SCATTER.items()))
    tables = n_rects * RECT_BYTES + n_boxes * BOX_BYTES \
        + n_media * MEDIUM_BYTES
    return ops * per, chunks * (rows * SUM_BYTES + tables)


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the published peaks allow for the work."""
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)
