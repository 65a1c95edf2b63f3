"""The card's own ceilings: a float32 FMA rate, a memory read + write rate
and a bf16 matmul rate.

Counterpart of `tools/roofline.py`'s `bench_vpu_fma` (the Pallas kernel
`bench_vpu_fma.build.f`, :110-124), `bench_hbm_bw` (:65-79) and `bench_mxu`
(:82-96).  The FMA chain is the CUDA kernel `ops/csrc/roofline.cu`
(`rt_fma_chain`); its plain version is `fma_chain_reference`.  The memory
stream and the matmul chain are XLA code in the JAX package, not Pallas
kernels, so their counterparts are torch ops (`x.mul_`, `torch.matmul`).
Every rate is a difference of two CUDA-event timings at two chain lengths,
as `per_rep` (:54-57) takes them, so the launch and the loads and stores
cancel.  `card_peaks` reads the card's own peak rates from its attributes
(SM count and clock, memory clock and bus width).  The bounds that
`chip_smoke.py` prints divide by the larger of the two for each rate, so
that a probe that falls short of the card (the FMA chain reaches about two
thirds of it on an H100) never loosens a bound; no kernel of the port uses
the tensor cores, so no bound divides by the bf16 rate.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import build

FMA_ELEMENTS = 8 * 2**21   # 4x roofline.py's 2**21 elements: every SM full
FMA_STEPS = (64, 1088)     # the two chain lengths whose difference is timed
HBM_ELEMENTS = 64 * 2**20  # 256 MiB of float32, as bench_hbm_bw
HBM_ITERS = (4, 36)
MXU_N = 4096               # bench_mxu's 4096 x 4096 bf16 operands
MXU_REPS = (2, 18)         # its two chain lengths
# dense bf16 tensor-core FLOPs a clock an SM by compute capability: sm_90's
# four tensor cores take 512 bf16 FMAs a clock each; float32 is 128 lanes
# x 2 (`rt_device_peaks`)
BF16_FLOPS_PER_SM_CLOCK = {(9, 0): 4096}
FP32_FLOPS_PER_SM_CLOCK = 256

launches = 0  # rt_fma_chain launches in this process


def fma_chain_reference(x: torch.Tensor, k: int) -> torch.Tensor:
    """The plain version: a = x * 0.5 + 0.25, b = x * 0.125 + 0.5, then k
    steps of x = x * a + b (two roundings a step, where the kernel's FMA
    rounds once)."""
    a = x * 0.5 + 0.25
    b = x * 0.125 + 0.5
    for _ in range(k):
        x = x * a + b
    return x


def fma_chain(x: torch.Tensor, k: int) -> torch.Tensor:
    """`fma_chain_reference` of a contiguous float32 tensor: on a CUDA
    tensor the `rt_fma_chain` kernel (a failed launch raises), on a CPU
    tensor the plain version."""
    if x.device.type == "cpu":
        return fma_chain_reference(x, k)
    global launches
    if x.dtype != torch.float32 or not x.is_contiguous() or k < 0:
        raise ValueError(f"fma_chain takes a contiguous float32 tensor and "
                         f"k >= 0, got {x.dtype}, k={k}")
    y = torch.empty_like(x)
    lib = build.load()
    with torch.cuda.device(x.device):
        rc = lib.rt_fma_chain(x.data_ptr(), y.data_ptr(), x.numel(), int(k),
                              torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rt_fma_chain failed: CUDA error {rc} "
                           f"({lib.rt_error_string(rc).decode()})")
    launches += 1
    return y


def _event_ms(fn, reps: int = 3) -> float:
    """The least of `reps` CUDA-event timings of one call of `fn`, after a
    warm-up call."""
    fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop))
    return best


def _require_cuda(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the ceilings are measured on a CUDA card, not "
                           f"on {device}")
    return device


def fma_ceiling(device="cuda", n: int = FMA_ELEMENTS,
                steps: tuple = FMA_STEPS) -> dict:
    """The card's float32 FMA rate: 2 * n flops per chain step over the
    time one step adds, from the `fma_chain` kernel at two chain lengths."""
    device = _require_cuda(device)
    x = torch.rand(n, generator=torch.Generator().manual_seed(3)).to(device)
    k1, k2 = steps
    t1 = _event_ms(lambda: fma_chain(x, k1))
    t2 = _event_ms(lambda: fma_chain(x, k2))
    step_s = (t2 - t1) / 1e3 / (k2 - k1)
    return dict(flops_per_s=2 * n / step_s, seconds_per_step=step_s,
                elements=n, steps=steps, ms=(t1, t2))


def card_peaks(device="cuda") -> dict:
    """The card's peak float32 FLOP/s (SMs x 128 lanes x 2 x SM clock),
    memory bytes/s (2 x memory clock x bus width) and dense bf16 tensor
    FLOP/s (SMs x BF16_FLOPS_PER_SM_CLOCK x the same clock; None for a
    compute capability not in that table), from its attributes."""
    device = _require_cuda(device)
    out = (ctypes.c_double * 2)()
    lib = build.load()
    rc = lib.rt_device_peaks(device.index if device.index is not None
                             else torch.cuda.current_device(), out)
    if rc != 0:
        raise RuntimeError(f"rt_device_peaks failed: CUDA error {rc} "
                           f"({lib.rt_error_string(rc).decode()})")
    per_clock = BF16_FLOPS_PER_SM_CLOCK.get(
        torch.cuda.get_device_capability(device))
    bf16 = (None if per_clock is None
            else out[0] / FP32_FLOPS_PER_SM_CLOCK * per_clock)
    return dict(flops_per_s=out[0], bytes_per_s=out[1],
                bf16_flops_per_s=bf16)


def hbm_ceiling(device="cuda", n: int = HBM_ELEMENTS,
                iters: tuple = HBM_ITERS) -> dict:
    """The card's memory rate for a read + write stream: `x.mul_(c)` over
    n float32 values reads and writes each once; bytes per pass over the
    time one pass adds, at two pass counts (torch ops: `bench_hbm_bw` is
    XLA, not a Pallas kernel)."""
    device = _require_cuda(device)
    x = torch.arange(n, dtype=torch.float32, device=device)

    def passes(r):
        def run():
            for _ in range(r):
                x.mul_(0.999999)
        return run

    r1, r2 = iters
    t1, t2 = _event_ms(passes(r1)), _event_ms(passes(r2))
    pass_s = (t2 - t1) / 1e3 / (r2 - r1)
    return dict(bytes_per_s=2 * 4 * n / pass_s, seconds_per_pass=pass_s,
                elements=n, iters=iters, ms=(t1, t2))


def mxu_chain(a: torch.Tensor, reps: int) -> torch.Tensor:
    """`bench_mxu`'s chain: from y = a, `reps` steps of y = (y @ a) * 0.5,
    in a's dtype."""
    y = a
    for _ in range(reps):
        y = torch.matmul(y, a) * 0.5
    return y


def mxu_ceiling(device="cuda", n: int = MXU_N,
                reps: tuple = MXU_REPS) -> dict:
    """The card's bf16 matmul rate: 2 * n**3 flops per step of `mxu_chain`
    on n x n bf16 operands filled with 0.001 (`bench_mxu`), over the time
    one step adds, at two chain lengths."""
    device = _require_cuda(device)
    a = torch.full((n, n), 0.001, dtype=torch.bfloat16, device=device)
    r1, r2 = reps
    t1 = _event_ms(lambda: mxu_chain(a, r1))
    t2 = _event_ms(lambda: mxu_chain(a, r2))
    step_s = (t2 - t1) / 1e3 / (r2 - r1)
    return dict(flops_per_s=2 * n**3 / step_s, seconds_per_iter=step_s,
                n=n, reps=reps, ms=(t1, t2))
