// The DFE's feedback recursion (K5) for Hopper, sm_90a.
//
// Same function as ops/dfe.py::feedback_recursion_plain (the loop of
// equalizeBurst, sigProcLib.cpp:1343-1399, after the feedforward
// filter), bit for bit. For each burst, with pf [T] the feedforward
// output, b [nu] the feedback taps, rot [T] the GMSK rotation and hist
// [nu] the last nu rotated decisions (zeros at the start), step i of T:
//
//   d    = pf[i] + sum_j b[j] * hist[j]
//   s    = d * conj(rot[i])
//   dec  = s.real > 0 ? +1 : -1       (strict >: 0 and NaN decide -1)
//   hist = [dec * rot[i], hist[0 .. nu - 2]]
//   soft[i] = clamp(0.5 * (s.real + 1), 0, 1)   (vector_slicer; a NaN stays)
//
// What it replaces: the plain form's step loop, ~9 eager PyTorch
// launches a step (1,451 a call of 157 steps). The JAX package has no
// Pallas kernel here: its recursion is a lax.scan that XLA fuses
// (openbts_ttsou_tpu/ops/dfe.py:93 equalize_burst).
//
// What bounds it: bytes, then latency. At B = 53,248 bursts (a 13-frame
// block of 512 carriers) and T = 157 it reads 67 MB of pf and writes
// 33 MB of soft bits, 0.030 ms at 3.35 TB/s; its float work (~50 flops
// a step) is 0.006 ms at 67 TFLOP/s. Each burst is a chain of T
// dependent steps (~40 cycles each), so the card has no more parallel
// work than one thread a burst: 1,664 warps.
//
// Design: one thread a burst, one warp a block; the nu taps, the nu
// history entries and the step's products stay in registers for the
// whole burst. pf is burst-major ([B, T]), so the thread of burst r
// reading its step i would touch one row a lane, 1,256 bytes apart; the
// block instead stages tiles of 32 steps of its 32 bursts through shared
// memory, a row's 256 contiguous bytes a warp load, and writes its soft
// bits the same way (rows padded by one element, so that a thread's
// reads of its own row are free of bank conflicts).
//
// Bit-exactness with the plain form as PyTorch runs it on the card:
//  * The complex product is c10::complex's (a*c - b*d, a*d + b*c) as
//    nvcc contracts it: fma(a, c, -(b*d)) and fma(a, d, b*c), pinned
//    here with __fmaf_rn / __fmul_rn.
//  * The sum over the nu products is the order of PyTorch's reduction
//    kernel over a contiguous dimension of nu: lanes of the largest
//    power of two W <= nu, lane k holding p[k] + p[k + W], then the
//    warp's shuffle-down pairs at distance W / 2, ..., 2, 1 (for nu = 5:
//    ((p0 + p4) + p2) + (p1 + p3)). Measured on an H100 with PyTorch
//    2.11: every sum at nu 1-8 matched this order, and no other.
//
// Instantiated for nu = 5 (CHAN_TAPS - 1, every program path) and 1;
// another depth is refused.
//  * dec * rot[i] is rot[i] or its negation exactly (up to the sign of
//    a zero, which changes no later value); s.real + 1 and 0.5 times it
//    are separate roundings, as the slicer's two ops are.
// tests/test_torch_cuda.py holds these rules to the eager ops.

#include <cuda_runtime.h>

namespace {

constexpr int kBursts = 32;  // bursts (threads) a block
constexpr int kSteps = 32;   // steps a staged tile

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fmaf_rn(a.x, b.x, -__fmul_rn(a.y, b.y)),
                     __fmaf_rn(a.x, b.y, __fmul_rn(a.y, b.x)));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

__host__ __device__ constexpr int lanes_of(int nu) {
  int w = 1;
  while (2 * w <= nu) w *= 2;
  return w;
}

// sum_j p[j] in the order of PyTorch's reduction over a contiguous
// dimension of NU (block width W, one accumulator pair a lane, then the
// warp's shuffle-down pairs at falling distance).
template <int NU>
__device__ __forceinline__ float2 feedback_sum(const float2 (&p)[NU]) {
  constexpr int W = lanes_of(NU);
  float2 lane[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    lane[k] = p[k];
    if (k + W < NU) lane[k] = cadd(lane[k], p[k + W]);
  }
#pragma unroll
  for (int off = W / 2; off > 0; off /= 2) {
#pragma unroll
    for (int k = 0; k < off; ++k) lane[k] = cadd(lane[k], lane[k + off]);
  }
  return lane[0];
}

__device__ __forceinline__ float slicer(float re) {
  const float u = __fmul_rn(0.5f, __fadd_rn(re, 1.0f));
  return u != u ? u : fminf(fmaxf(u, 0.0f), 1.0f);
}

template <int NU>
__global__ void __launch_bounds__(kBursts) equalize_kernel(
    const float2* __restrict__ pf, const float2* __restrict__ feedback,
    const float2* __restrict__ rot, float* __restrict__ soft, int bursts,
    int steps) {
  __shared__ float2 tile_in[kBursts][kSteps + 1];
  __shared__ float tile_out[kBursts][kSteps + 1];
  const int r = threadIdx.x;
  const long long b0 = static_cast<long long>(blockIdx.x) * kBursts;
  const int rows = static_cast<int>(
      bursts - b0 < kBursts ? bursts - b0 : kBursts);
  const bool active = r < rows;

  float2 b[NU], hist[NU];
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    b[j] = active ? __ldg(feedback + (b0 + r) * NU + j) : make_float2(0, 0);
    hist[j] = make_float2(0.0f, 0.0f);
  }

  for (int t0 = 0; t0 < steps; t0 += kSteps) {
    const int n = steps - t0 < kSteps ? steps - t0 : kSteps;
    if (r < n) {
#pragma unroll 8
      for (int row = 0; row < rows; ++row)
        tile_in[row][r] = __ldg(pf + (b0 + row) * steps + t0 + r);
    }
    __syncthreads();
    if (active) {
      for (int k = 0; k < n; ++k) {
        const float2 rv = __ldg(rot + t0 + k);
        float2 p[NU];
#pragma unroll
        for (int j = 0; j < NU; ++j) p[j] = cmul(b[j], hist[j]);
        const float2 d = cadd(tile_in[r][k], feedback_sum<NU>(p));
        const float2 s = cmul(d, make_float2(rv.x, -rv.y));
#pragma unroll
        for (int j = NU - 1; j > 0; --j) hist[j] = hist[j - 1];
        hist[0] = s.x > 0.0f ? rv : make_float2(-rv.x, -rv.y);
        tile_out[r][k] = slicer(s.x);
      }
    }
    __syncthreads();
    if (r < n) {
#pragma unroll 8
      for (int row = 0; row < rows; ++row)
        soft[(b0 + row) * steps + t0 + r] = tile_out[row][r];
    }
  }
}

template <int NU>
cudaError_t launch(const void* pf, const void* feedback, const void* rot,
                   void* soft, int bursts, int steps, cudaStream_t stream) {
  const int blocks = (bursts + kBursts - 1) / kBursts;
  equalize_kernel<NU><<<blocks, kBursts, 0, stream>>>(
      static_cast<const float2*>(pf), static_cast<const float2*>(feedback),
      static_cast<const float2*>(rot), static_cast<float*>(soft), bursts,
      steps);
  return cudaGetLastError();
}

}  // namespace

// One launch of the recursion over `bursts` bursts of `steps` steps on
// `stream`: pf [bursts, steps] and feedback [bursts, nu] and rot [steps]
// complex64, soft [bursts, steps] float32 out; every array contiguous,
// the complex ones 8-byte aligned; nu 5 or 1. Returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for another
// nu or an empty shape.
extern "C" int dfe_equalize(const void* pf, const void* feedback,
                            const void* rot, void* soft, int bursts,
                            int steps, int nu, void* stream) {
  if (bursts <= 0 || steps <= 0 || (nu != 5 && nu != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      nu == 5 ? launch<5>(pf, feedback, rot, soft, bursts, steps, st)
              : launch<1>(pf, feedback, rot, soft, bursts, steps, st));
}
