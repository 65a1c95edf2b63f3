// Compute-ceiling probe: K chained float32 FMAs per element.
//
// Replaces the TPU kernel `bench_vpu_fma.build.f` (tools/roofline.py:110-124,
// pl.pallas_call at :121): per element x, a = x * 0.5 + 0.25 and
// b = x * 0.125 + 0.5, then K steps of x = x * a + b, written back.  The
// difference of two K values, timed on the card, gives the float32 rate
// this chain reaches (utils/roofline.py `fma_ceiling`).  On an H100 that is
// about two thirds of the card's peak: each step's FFMA reads three
// distinct registers (x, a and b differ per element) and the interleaved
// chains leave no operand to reuse, which register-bank conflicts may
// explain (untested).  So chip_smoke.py's bounds divide by the larger of
// this rate and the card's peak (`rt_device_peaks`).
//
// What bounds it: operations.  Each step is one FMA that depends on the
// last, so one chain runs at the FMA latency; a thread carries kChains
// independent chains (elements i, i + n/kChains, ...), as the TPU kernel's
// (256, 128) tile gives its vector unit independent lanes, and the launch
// gives every SM many more warps than the latency needs (2M elements and
// up).  The library builds with -fmad=false, so the step calls __fmaf_rn
// explicitly (one rounding, 2 flops); a and b are a multiply and an add
// each, as in the plain version.  The step loop is unrolled by 8.
//
// Entry points (plain C, bound with ctypes): rt_fma_chain(x, y, n, k, stream)
// returns cudaGetLastError() after the launch and never synchronizes;
// rt_device_peaks(device, out) writes the card's own peak rates, from its
// attributes: float32 FLOP/s = SMs x 128 FP32 lanes (sm_90) x 2 x the SM
// clock, and memory bytes/s = 2 (double data rate) x the memory clock x the
// bus width in bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 4;
constexpr double kFp32LanesPerSm = 128.0;  // Hopper (sm_90)

__global__ void __launch_bounds__(kThreads)
fma_chain_kernel(const float* __restrict__ x, float* __restrict__ y, int n,
                 int k) {
  const int stride = (n + kChains - 1) / kChains;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= stride) return;
  float v[kChains], a[kChains], b[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    const int e = min(i + c * stride, n - 1);  // a short tail repeats one
    v[c] = x[e];
    a[c] = v[c] * 0.5f + 0.25f;
    b[c] = v[c] * 0.125f + 0.5f;
  }
  int j = 0;
  for (; j + 8 <= k; j += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) v[c] = __fmaf_rn(v[c], a[c], b[c]);
    }
  }
  for (; j < k; ++j) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) v[c] = __fmaf_rn(v[c], a[c], b[c]);
  }
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    if (i + c * stride < n) y[i + c * stride] = v[c];
  }
}

}  // namespace

extern "C" int rt_fma_chain(const float* x, float* y, int n, int k,
                            void* stream) {
  if (n <= 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (n + kChains - 1) / kChains;
  const int blocks = (threads + kThreads - 1) / kThreads;
  fma_chain_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, n, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_device_peaks(int device, double* out) {
  int sms = 0, clock_khz = 0, mem_khz = 0, bus_bits = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&clock_khz, cudaDevAttrClockRate, device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&mem_khz, cudaDevAttrMemoryClockRate, device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&bus_bits, cudaDevAttrGlobalMemoryBusWidth,
                               device);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = static_cast<double>(sms) * kFp32LanesPerSm * 2.0 * clock_khz * 1e3;
  out[1] = 2.0 * mem_khz * 1e3 * (bus_bits / 8.0);
  return 0;
}
