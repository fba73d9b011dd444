// Polyphase P/Q rational resampler (K1) for Hopper, sm_90a.
//
// Replaces openbts_ttsou_tpu/ops/pallas_fir.py::_kernel (launched by
// polyphase_resample_pallas). Same function as fir.polyphase_resample:
//
//   out[b, m*p + r] = sum_t x[b, m*q + base[r] - t] * taps[r, t],  t < k_max
//
// where taps[r, t] = lpf[branch[r] + t*p] is branch r's compact tap row
// and base[r] = (k_max - 1) + delta[r] - pad_left, both from
// fir._polyphase_plan. Samples outside [0, t_in) read as zero (the
// reference's group-delay padding).
//
// What bounds it: memory. At the 512-carrier uplink shape (65/96, 961
// taps, 24000 -> 16250 samples a row) it reads 98.3 MB of complex64 and
// writes 66.6 MB, about 165 MB, against about 0.5 GFLOP of fp32 FMAs. At
// the data-sheet 3.35 TB/s the bytes take about 49 us, the arithmetic at
// 67 TFLOP/s about 7 us: a calculated bound, not a measurement.
//
// What the design does about it:
//  * complex64 is read directly as float2, one 8-byte load per sample; no
//    re/im plane split, no TPU lane padding and no dense zero-padded
//    [K', p] bank (pallas_fir.py:96-119 is TPU layout).
//  * one thread per output; neighbouring threads compute neighbouring
//    outputs of one row, so their loads fall on neighbouring addresses and
//    coalesce, and the k_max-sample windows of a warp overlap, so repeated
//    reads hit L1 and the device memory sees each input about once.
//  * each output loops over its branch's k_max (15 uplink) nonzero taps,
//    not the K' (109 uplink) columns of the dense bank.
//  * the [p, k_max] tap table and base offsets sit in shared memory (65x15
//    floats uplink, 96x7 downlink), loaded once per block of 1024 outputs.
//  * fp32 accumulation with fmaf; no tensor cores.
// Any (p, q) works; the shared table is sized at launch.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kOutPerThread = 4;
constexpr int kOutPerBlock = kThreads * kOutPerThread;

__global__ void __launch_bounds__(kThreads)
polyphase_resample_kernel(const float2* __restrict__ x,
                          float2* __restrict__ out,
                          const float* __restrict__ taps,
                          const int* __restrict__ base, int t_in, int n_out,
                          int p, int q, int k_max, int chunks) {
  extern __shared__ float smem[];
  float* s_taps = smem;                                      // [p, k_max]
  int* s_base = reinterpret_cast<int*>(smem + p * k_max);    // [p]
  for (int i = threadIdx.x; i < p * k_max; i += kThreads) s_taps[i] = taps[i];
  for (int i = threadIdx.x; i < p; i += kThreads) s_base[i] = base[i];
  __syncthreads();

  const int row = blockIdx.x / chunks;
  const int chunk = blockIdx.x - row * chunks;
  const float2* xr = x + static_cast<size_t>(row) * t_in;
  float2* orow = out + static_cast<size_t>(row) * n_out;

#pragma unroll
  for (int k = 0; k < kOutPerThread; ++k) {
    const int i = chunk * kOutPerBlock + k * kThreads + threadIdx.x;
    if (i >= n_out) break;
    const int m = i / p;
    const int r = i - m * p;
    const float* tr = s_taps + r * k_max;
    const long long s0 = static_cast<long long>(m) * q + s_base[r];
    float re = 0.f;
    float im = 0.f;
    for (int t = 0; t < k_max; ++t) {
      const long long s = s0 - t;
      if (s >= 0 && s < t_in) {
        const float2 v = __ldg(xr + s);
        const float h = tr[t];
        re = fmaf(v.x, h, re);
        im = fmaf(v.y, h, im);
      }
    }
    orow[i] = make_float2(re, im);
  }
}

}  // namespace

// x: [rows, t_in] complex64, out: [rows, n_out] complex64, taps: [p, k_max]
// float32, base: [p] int32, all on the device. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int polyphase_resample(const void* x, void* out, const void* taps,
                                  const void* base, int rows, int t_in,
                                  int n_out, int p, int q, int k_max,
                                  void* stream) {
  const int chunks = (n_out + kOutPerBlock - 1) / kOutPerBlock;
  const long long blocks = static_cast<long long>(rows) * chunks;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(p) * k_max * sizeof(float) +
                      static_cast<size_t>(p) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        polyphase_resample_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  polyphase_resample_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(out),
      static_cast<const float*>(taps), static_cast<const int*>(base), t_in,
      n_out, p, q, k_max, chunks);
  return static_cast<int>(cudaGetLastError());
}
