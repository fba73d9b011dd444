// The Viterbi decoder (K8) for Hopper, sm_90a.
//
// Same function as gsm/fec.py::viterbi_decode_plain, bit for bit: the
// reference's deferred-decision decoder of the rate-1/2, K=5 GSM code
// (ViterbiR2O4 + SoftVector::decode, BitVector.cpp:289-525), 16 states,
// no traceback. For each codeword (a row of 2K soft bits in [0, 1]) and
// each step t of K + 24:
//
//   each of the step's soft bits s (positions 2t, 2t + 1):
//     p = max(min(s, 1 - s), 0.01), ip = max(1 - p, 0.01),
//     match = 0.25 / ip, mismatch = 0.25 / p (past the row: both 0.5,
//     whatever the padded hard bit, the row's last, is);
//     v[e] = mismatch where the expected bit e differs from s > 0.5,
//     else match
//   bm[code]       = v0[code >> 1] + v1[code & 1]
//   cand[path][ns] = cost[prev[path][ns]] + bm[code[path][ns]]
//   take1          = cand[1][ns] < cand[0][ns]  (a tie keeps the 0-prefix)
//   cost[ns]       = the taken candidate
//   hist[ns]       = (hist[the taken prev] << 1) | (ns & 1)
//   t >= 24: out[t - 24] = bit 24 of hist[argmin cost], the first minimum
//
// What it replaces: the plain form's step loop, ~10 eager PyTorch
// launches a trellis step (2,100-2,500 a call of 189 or 228 bits, ~7,500
// in a resident window's four calls), and its [steps, rows, 32] branch
// metrics (0.2-0.3 GB a call at 512 carriers). The JAX package has no
// Pallas kernel here: its decoder is a lax.scan that XLA fuses.
//
// What bounds it: latency. Each codeword is a recurrence of K + 24
// dependent steps, so the card has no more parallel work than one thread
// a codeword (10,240 XCCH codewords at 512 carriers: 320 warps, fewer
// than the card's 528 schedulers). A window's four calls read ~57 MB and
// write ~3 MB, 0.019 ms at 3.35 TB/s: far below the recurrence.
//
// Design: one thread a codeword, one warp a block, so that a call's
// blocks spread over every SM. The 16 path costs (fp32) and survivor
// histories (uint32: only bit 24 is read, and a 32-bit shift keeps the
// low 32 bits of the plain form's int64) live in registers; the state
// loops are unrolled, so every trellis table index is a compile-time
// constant. The branch metrics are computed from the soft bits inside
// the step. Each thread reads its own row's two soft bits a step, the
// next step's issued before the current one is decoded: a warp's reads
// are 32 rows apart, but each 128-byte line it touches serves 16 steps
// from L1, and this measured 7% faster on an H100 than staging tiles of
// 16 steps of the block's rows through shared memory with cp.async
// (0.1485 against 0.1593 ms at XCCH's [10240, 456]). Rows are read at a
// stride, so a slice of wider rows (TCH's [..., :378], RACH's 36 bits of
// 148) needs no copy.
//
// Bit-exactness with the plain form:
//  * The divisions are IEEE (__fdiv_rn), the sums __fadd_rn and the
//    differences __fsub_rn: no reciprocal, no FMA, no fast math.
//  * min and the clamps keep a NaN, as torch's do; a NaN compares false,
//    so take1 keeps the 0-prefix; the survivor is the first NaN cost
//    where there is one (torch.argmin's rule), else the first minimum.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;  // codewords a block
constexpr int kStates = 16;
constexpr int kDeferral = 24;

// The trellis, as gsm/fec.py's _viterbi_prev, _viterbi_code and
// _viterbi_low_bit give it (path-major: entry path * 16 + ns): the
// predecessor of new state ns along each path, the expected output pair
// 2 * e0 + e1 on that branch, and ns's input bit.
__host__ __device__ constexpr int trellis_prev(int i) {
  constexpr int kPrev[2 * kStates] = {0, 0, 1, 1, 2,  2,  3,  3,
                                      4, 4, 5, 5, 6,  6,  7,  7,
                                      8, 8, 9, 9, 10, 10, 11, 11,
                                      12, 12, 13, 13, 14, 14, 15, 15};
  return kPrev[i];
}

__host__ __device__ constexpr int trellis_code(int i) {
  constexpr int kCode[2 * kStates] = {0, 3, 1, 2, 0, 3, 1, 2,
                                      3, 0, 2, 1, 3, 0, 2, 1,
                                      3, 0, 2, 1, 3, 0, 2, 1,
                                      0, 3, 1, 2, 0, 3, 1, 2};
  return kCode[i];
}

__host__ __device__ constexpr unsigned trellis_low(int ns) {
  constexpr unsigned kLow[kStates] = {0, 1, 0, 1, 0, 1, 0, 1,
                                      0, 1, 0, 1, 0, 1, 0, 1};
  return kLow[ns];
}

// The costs of expected bit 0 and 1 at one soft bit
// (BitVector.cpp:473-495).
__device__ __forceinline__ void bit_costs(float s, float& v0, float& v1) {
  const float oms = __fsub_rn(1.0f, s);
  float p = s < oms ? s : oms;  // a NaN s makes oms NaN too
  p = p < 0.01f ? 0.01f : p;
  float ip = __fsub_rn(1.0f, p);
  ip = ip < 0.01f ? 0.01f : ip;
  const float match = __fdiv_rn(0.25f, ip);
  const float mismatch = __fdiv_rn(0.25f, p);
  const bool hard = s > 0.5f;
  v0 = hard ? mismatch : match;
  v1 = hard ? match : mismatch;
}

// One add-compare-select over the 16 states with the step's four branch
// metrics bm[2 * e0 + e1].
__device__ __forceinline__ void acs(float (&cost)[kStates],
                                    uint32_t (&hist)[kStates],
                                    const float (&bm)[4]) {
  float nc[kStates];
  uint32_t nh[kStates];
#pragma unroll
  for (int ns = 0; ns < kStates; ++ns) {
    const int p0 = trellis_prev(ns), p1 = trellis_prev(kStates + ns);
    const float c0 = __fadd_rn(cost[p0], bm[trellis_code(ns)]);
    const float c1 = __fadd_rn(cost[p1], bm[trellis_code(kStates + ns)]);
    const bool take1 = c1 < c0;
    nc[ns] = take1 ? c1 : c0;
    nh[ns] = ((take1 ? hist[p1] : hist[p0]) << 1) | trellis_low(ns);
  }
#pragma unroll
  for (int ns = 0; ns < kStates; ++ns) {
    cost[ns] = nc[ns];
    hist[ns] = nh[ns];
  }
}

// The emitted bit: bit 24 of the history of the first minimum cost (the
// first NaN where there is one). A tree of pairs, the right one taken
// only where it wins strictly, keeps the lower index on every tie.
__device__ __forceinline__ uint8_t emitted(const float (&cost)[kStates],
                                           const uint32_t (&hist)[kStates]) {
  float c[kStates];
  uint32_t h[kStates];
#pragma unroll
  for (int i = 0; i < kStates; ++i) {
    c[i] = cost[i];
    h[i] = hist[i];
  }
#pragma unroll
  for (int w = 1; w < kStates; w *= 2) {
#pragma unroll
    for (int i = 0; i < kStates; i += 2 * w) {
      const float l = c[i], r = c[i + w];
      if (r < l || (r != r && l == l)) {
        c[i] = r;
        h[i] = h[i + w];
      }
    }
  }
  return static_cast<uint8_t>((h[0] >> kDeferral) & 1u);
}

__global__ void __launch_bounds__(kThreads) viterbi_kernel(
    const float* __restrict__ soft, long long row_stride, int rows, int k,
    uint8_t* __restrict__ out) {
  const long long row = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  const bool active = row < rows;
  const float* src = soft + (active ? row : rows - 1) * row_stride;
  uint8_t* const dst = out + row * k;
  float cost[kStates];
  uint32_t hist[kStates];
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    cost[s] = 0.0f;
    hist[s] = 0u;
  }
  float s0 = __ldg(src), s1 = __ldg(src + 1);
  for (int t = 0; t < k + kDeferral; ++t) {
    float bm[4] = {1.0f, 1.0f, 1.0f, 1.0f};  // past the row: 0.5 + 0.5
    if (t < k) {
      float n0 = s0, n1 = s1;
      if (t + 1 < k) {
        n0 = __ldg(src + 2 * t + 2);
        n1 = __ldg(src + 2 * t + 3);
      }
      float a0, a1, b0, b1;
      bit_costs(s0, a0, a1);
      bit_costs(s1, b0, b1);
      bm[0] = __fadd_rn(a0, b0);
      bm[1] = __fadd_rn(a0, b1);
      bm[2] = __fadd_rn(a1, b0);
      bm[3] = __fadd_rn(a1, b1);
      s0 = n0;
      s1 = n1;
    }
    acs(cost, hist, bm);
    if (t >= kDeferral) {
      const uint8_t bit = emitted(cost, hist);
      if (active) dst[t - kDeferral] = bit;
    }
  }
}

}  // namespace

// One launch of the decoder over `rows` codewords on `stream`: soft
// float32, row r's 2k soft bits at soft + r * row_stride (adjacent,
// 4-byte aligned); out uint8 [rows, k] contiguous. Returns
// cudaGetLastError() (0 on success).
extern "C" int viterbi_decode(const void* soft, long long row_stride,
                              int rows, int k, void* out, void* stream) {
  if (rows <= 0 || k <= 0 || row_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kThreads - 1) / kThreads;
  viterbi_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(soft), row_stride, rows, k,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
