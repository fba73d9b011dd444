// The exact receiver's threshold walk (K7) for Hopper, sm_90a.
//
// Same function as models/transceiver.py::exact_walk_plain (the walk of
// process_block_exact, Transceiver.cpp:294-375), bit for bit. For each
// carrier c, frame i by frame i over the block's F frames:
//
//   gate[j]    = energy[i, c, j] > thr * thr  and  active[i, c, j]
//   success[j] = gate[j] and det_ok[i, c, j]
//   adoption   (from the validity and estimate frames at frame entry):
//                want = (fn_delta(fn, est_fn[j]) > 50 or not valid[j])
//                       and need_dfe[c]; an adoption (want, TSC, success)
//                sets valid, est_fn = fn and last = i; a TSC burst that
//                passes the gate undetected clears valid
//   then the slot-ordered fold of trx/engine.py::threshold_walk over
//   j = 0..7, each slot: elapsed = fn_delta(fn, prev_false) (once),
//   quiet (active, gated out, elapsed > 50): thr -= 10, prev_false = fn;
//   hit (success): thr = max(thr - 1, 0); miss (active, gated in, not a
//   success): thr += 10 * exp(-elapsed), prev_false = fn.
//
// What it replaces: ~3,000 eager PyTorch launches a 13-frame block (the
// loop above on [C, 8] tensors). What bounds it: latency. The walk is a
// recurrence along F x 8 slots, so the card has no more parallel work
// than one thread a carrier. At [13, 512, 8] it reads 0.43 MB and
// writes 0.35 MB, 0.00025 ms at 3.35 TB/s: a calculated bound, far
// below one launch.
//
// Design: one thread a carrier, kThreads threads a block (512 carriers
// reach 16 SMs). The carried state (thr, prev_false, 8 validity bits, 8
// estimate frames, 8 last adoptions) stays in registers for the whole
// walk. A frame's inputs for the carrier are two float4 loads (energy)
// and one 8-byte load for each of the four flag rows (torch.bool is one
// byte); the next frame's are issued before the current one is walked.
// Outputs go out the same way, the entry threshold as one float.
//
// Bit-exactness with the eager form:
//  * fn_delta's % is Python's (the sign of the divisor); C's follows the
//    dividend, so it is ((d % H) + H) % H, folded at H / 2.
//  * The subtraction of frame numbers wraps as torch's int32 does.
//  * The products and sums are __fmul_rn / __fadd_rn / __fsub_rn, so no
//    FMA contracts 10 * exp(-x) + thr; exp is expf (never __expf).
//  * clamp(x, min=0) keeps a NaN, as torch's does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kHyperframe = 2048 * 26 * 51;  // 2715648
constexpr int kSlots = 8;

__device__ __forceinline__ int fn_delta(int v1, int v2) {
  const int d = static_cast<int>(static_cast<unsigned>(v1) -
                                 static_cast<unsigned>(v2));
  const int m = ((d % kHyperframe) + kHyperframe) % kHyperframe;
  return m >= kHyperframe / 2 ? m - kHyperframe : m;
}

__device__ __forceinline__ bool bit(unsigned long long row, int j) {
  return ((row >> (8 * j)) & 0xffull) != 0;
}

struct Frame {
  float4 e0, e1;
  unsigned long long active, is_tsc, detected, det_ok;
  int fn;
};

__device__ __forceinline__ Frame load_frame(
    const int* __restrict__ fns, const float4* __restrict__ energy,
    const unsigned long long* __restrict__ active,
    const unsigned long long* __restrict__ is_tsc,
    const unsigned long long* __restrict__ detected,
    const unsigned long long* __restrict__ det_ok, long long row, int i) {
  Frame f;
  f.e0 = __ldg(energy + 2 * row);
  f.e1 = __ldg(energy + 2 * row + 1);
  f.active = __ldg(active + row);
  f.is_tsc = __ldg(is_tsc + row);
  f.detected = __ldg(detected + row);
  f.det_ok = __ldg(det_ok + row);
  f.fn = __ldg(fns + i);
  return f;
}

__global__ void __launch_bounds__(kThreads) walk_kernel(
    const int* __restrict__ fns, const unsigned long long* __restrict__ active,
    const unsigned long long* __restrict__ is_tsc,
    const float4* __restrict__ energy,
    const unsigned long long* __restrict__ detected,
    const unsigned long long* __restrict__ det_ok,
    const uint8_t* __restrict__ need_dfe, const float* __restrict__ thr_in,
    const int* __restrict__ prev_false_in,
    const unsigned long long* __restrict__ valid_in,
    const int4* __restrict__ est_fn_in,
    unsigned long long* __restrict__ success_out,
    unsigned long long* __restrict__ valid_post_out,
    int4* __restrict__ last_post_out, float* __restrict__ thr_entry_out,
    float* __restrict__ thr_out, int* __restrict__ prev_false_out,
    unsigned long long* __restrict__ valid_out, int4* __restrict__ est_fn_out,
    int4* __restrict__ last_out, int frames, int chans) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= chans) return;

  float thr = thr_in[c];
  int prev_false = prev_false_in[c];
  const bool nd = need_dfe[c] != 0;
  unsigned valid = 0;  // bit j: slot j's channel estimate is valid
  {
    const unsigned long long v = valid_in[c];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) valid |= (bit(v, j) ? 1u : 0u) << j;
  }
  int est_fn[kSlots], last[kSlots];
  {
    const int4 a = est_fn_in[2 * c], b = est_fn_in[2 * c + 1];
    est_fn[0] = a.x; est_fn[1] = a.y; est_fn[2] = a.z; est_fn[3] = a.w;
    est_fn[4] = b.x; est_fn[5] = b.y; est_fn[6] = b.z; est_fn[7] = b.w;
  }
#pragma unroll
  for (int j = 0; j < kSlots; ++j) last[j] = -1;

  Frame cur = load_frame(fns, energy, active, is_tsc, detected, det_ok, c, 0);
  for (int i = 0; i < frames; ++i) {
    const long long row = static_cast<long long>(i) * chans + c;
    Frame nxt = cur;
    if (i + 1 < frames)
      nxt = load_frame(fns, energy, active, is_tsc, detected, det_ok,
                       row + chans, i + 1);
    const float e[kSlots] = {cur.e0.x, cur.e0.y, cur.e0.z, cur.e0.w,
                             cur.e1.x, cur.e1.y, cur.e1.z, cur.e1.w};
    const int fn = cur.fn;

    // the energy gate of all 8 slots against the threshold at frame entry
    thr_entry_out[row] = thr;
    const float thr2 = __fmul_rn(thr, thr);
    unsigned gate = 0, success = 0;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const bool g = e[j] > thr2 && bit(cur.active, j);
      gate |= (g ? 1u : 0u) << j;
      success |= ((g && bit(cur.det_ok, j)) ? 1u : 0u) << j;
    }

    // channel adoption, from validity and estimate frames at frame entry
    unsigned long long success_row = 0, valid_row = 0;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const bool v = (valid >> j) & 1u;
      const bool g = (gate >> j) & 1u;
      const bool s = (success >> j) & 1u;
      const bool tsc = bit(cur.is_tsc, j);
      const bool want = (fn_delta(fn, est_fn[j]) > 50 || !v) && nd;
      const bool do_est = want && tsc && s;
      const bool v_new = do_est || (v && !(!bit(cur.detected, j) && tsc && g));
      valid = (valid & ~(1u << j)) | ((v_new ? 1u : 0u) << j);
      if (do_est) {
        est_fn[j] = fn;
        last[j] = i;
      }
      success_row |= static_cast<unsigned long long>(s) << (8 * j);
      valid_row |= static_cast<unsigned long long>(v_new) << (8 * j);
    }

    // the slot-ordered threshold fold: quiet, then hit, then miss
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const bool act = bit(cur.active, j);
      const bool g = (gate >> j) & 1u;
      const bool s = (success >> j) & 1u;
      const float elapsed = static_cast<float>(fn_delta(fn, prev_false));
      if (act && !g && elapsed > 50.0f) {
        thr = __fsub_rn(thr, 10.0f);
        prev_false = fn;
      }
      if (s) {
        const float t = __fsub_rn(thr, 1.0f);
        thr = t < 0.0f ? 0.0f : t;
      }
      if (act && g && !s) {
        thr = __fadd_rn(thr, __fmul_rn(10.0f, expf(-elapsed)));
        prev_false = fn;
      }
    }

    success_out[row] = success_row;
    valid_post_out[row] = valid_row;
    last_post_out[2 * row] = make_int4(last[0], last[1], last[2], last[3]);
    last_post_out[2 * row + 1] = make_int4(last[4], last[5], last[6], last[7]);
    cur = nxt;
  }

  thr_out[c] = thr;
  prev_false_out[c] = prev_false;
  unsigned long long valid_row = 0;
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
    valid_row |= static_cast<unsigned long long>((valid >> j) & 1u) << (8 * j);
  valid_out[c] = valid_row;
  est_fn_out[2 * c] = make_int4(est_fn[0], est_fn[1], est_fn[2], est_fn[3]);
  est_fn_out[2 * c + 1] = make_int4(est_fn[4], est_fn[5], est_fn[6], est_fn[7]);
  last_out[2 * c] = make_int4(last[0], last[1], last[2], last[3]);
  last_out[2 * c + 1] = make_int4(last[4], last[5], last[6], last[7]);
}

}  // namespace

// One launch of the walk over [frames, chans, 8] on `stream`. Inputs:
// fns [F] int32; active, is_tsc, detected, det_ok [F, C, 8] bool; energy
// [F, C, 8] float32; need_dfe [C] bool; thr [C] float32; prev_false [C]
// int32; valid [C, 8] bool; est_fn [C, 8] int32. Outputs: success,
// valid_post [F, C, 8] bool; last_post [F, C, 8] int32; thr_entry [F, C]
// float32; thr_out [C] float32; prev_false_out [C] int32; valid_out
// [C, 8] bool; est_fn_out, last_out [C, 8] int32. Every tensor
// contiguous; the [.., 8] float32 and int32 ones 16-byte aligned, the
// [.., 8] bool ones 8-byte aligned. Returns cudaGetLastError() (0 on
// success).
extern "C" int exact_walk(const void* fns, const void* active,
                          const void* is_tsc, const void* energy,
                          const void* detected, const void* det_ok,
                          const void* need_dfe, const void* thr,
                          const void* prev_false, const void* valid,
                          const void* est_fn, void* success, void* valid_post,
                          void* last_post, void* thr_entry, void* thr_out,
                          void* prev_false_out, void* valid_out,
                          void* est_fn_out, void* last_out, int frames,
                          int chans, void* stream) {
  if (frames <= 0 || chans <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  using u64 = unsigned long long;
  const int blocks = (chans + kThreads - 1) / kThreads;
  walk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(fns), static_cast<const u64*>(active),
      static_cast<const u64*>(is_tsc), static_cast<const float4*>(energy),
      static_cast<const u64*>(detected), static_cast<const u64*>(det_ok),
      static_cast<const uint8_t*>(need_dfe), static_cast<const float*>(thr),
      static_cast<const int*>(prev_false), static_cast<const u64*>(valid),
      static_cast<const int4*>(est_fn), static_cast<u64*>(success),
      static_cast<u64*>(valid_post), static_cast<int4*>(last_post),
      static_cast<float*>(thr_entry), static_cast<float*>(thr_out),
      static_cast<int*>(prev_false_out), static_cast<u64*>(valid_out),
      static_cast<int4*>(est_fn_out), static_cast<int4*>(last_out), frames,
      chans);
  return static_cast<int>(cudaGetLastError());
}
