// Polyphase P/Q rational resampler (K1) for Hopper, sm_90a.
//
// Replaces openbts_ttsou_tpu/ops/pallas_fir.py::_kernel (launched by
// polyphase_resample_pallas). Same function as fir.polyphase_resample:
//
//   out[b, m*p + r] = sum_t x[b, m*q + (k_max-1) + delta[r] - t - pad_left]
//                           * taps[r, t],   t < k_max
//
// with branch r's taps and offsets from fir._polyphase_plan; samples
// outside [0, t_in) read as zero (the reference's group-delay padding).
//
// What bounds it: memory. At the 512-carrier uplink shape (65/96, 961
// taps, 24000 -> 16250 samples a row) it must read 98.3 MB of complex64
// and write 66.6 MB, 164.9 MB, against 0.49 GFLOP of fp32 FMAs on the
// nonzero taps. At the data-sheet 3.35 TB/s the bytes take 49 us, the
// FMAs 7 us at 67 TFLOP/s: a calculated bound, not a measurement.
//
// The design streams each input byte from device memory once and does
// the reuse between overlapping filter windows in shared memory and
// registers instead of in L1 (the first version loaded every tap of every
// output from global memory, about 15 loads an output):
//  * Tiles. A tile is mt (32) consecutive output cycles of one row, all p
//    phases: mt*p outputs, contiguous in the output row. Its input is one
//    slab of (mt-1)*q + K' samples.
//  * Slab staging by cp.async, zero-filled. The slab is copied into
//    shared memory as mt rows, row c holding the row_stride samples from
//    cycle c's first input on (each row carries the K'-q samples it
//    shares with the next one, so a window never crosses a row). Copies
//    are 16 bytes where the shared and global addresses have the same
//    16-byte parity and 8 bytes elsewhere; the src-size operand zero-fills
//    the half of a 16-byte copy past t_in, and whole samples outside
//    [0, t_in) (the group-delay pad before sample 0, the tail) are stored
//    as zeros, so the compute loop has no bounds test.
//  * Padded row stride. row_stride is 1 mod 16 float2 words, so 16 lanes
//    reading one column of 16 rows fall on 16 distinct 8-byte bank pairs:
//    no bank conflicts (a stride of 96 would put all of them on one bank).
//  * Reuse over R phases and K cycles in registers. The phases are cut
//    into groups of R consecutive ones (5 uplink, 4 downlink); a warp
//    holds K = 2 groups of 16 lanes, and lane c of a group computes its R
//    phases for cycles c and c + 16. Over the group's U-column union
//    window (21 uplink, 10 downlink) a lane loads its two samples and the
//    R taps of each column once from shared memory and does 4R FMAs on
//    them: 2U sample loads and R*U tap loads for 2R outputs, U/R + U/2 =
//    14.7 loads an output uplink (7.5 downlink), against k_max = 15
//    global loads an output before, and the tap loads are warp-wide
//    broadcasts. Each phase's taps sit at its offset in the union and
//    the rest of its row is zero, so every index is a compile-time
//    constant; the zeros cost 40% more FMAs uplink, still far under the
//    byte time. The taps are one [groups][R][U] table in shared memory,
//    read as warp-wide broadcasts, so that two blocks fit an SM (taps in
//    registers, 105 floats a lane uplink, leave room for one). R, U and
//    the group count are
//    template parameters (INSTANCE lines below; the plan in
//    ops/cuda_fir.py picks one), and any other (p, q, taps) runs the
//    runtime-width instantiation of the same kernel (R = K = 1,
//    U = k_max, taps read through L1).
//  * No division in the hot loops: a group's phases and a lane's cycles
//    come from the loop structure, output (cycle, phase) pairs in the
//    store loop are stepped, and offsets inside a row are 32-bit.
//  * Staged, coalesced stores. A tile's outputs are written into one of
//    two shared output stages as [mt][out_stride] (out_stride 1 mod 16,
//    conflict free) and leave, while the next tile computes, as 16-byte
//    stores by consecutive threads, with a lone 8-byte store at an
//    unaligned start or an odd end.
//  * Persistent blocks, two slab buffers, one barrier a tile. The grid is
//    the SM count times the blocks an SM holds (2 at both system shapes);
//    each block walks tiles with the grid's stride, and the copies of its
//    next tile run while it computes one tile and stores the one before.
//    A third slab buffer would leave room for one block an SM.
//  * No tensor cores. The work is bound by bytes, and wgmma would need
//    every overlapping [mt, K'] window copied into its canonical layout
//    and a dense bank that is 7x zeros (K' = 109 columns for 15 taps
//    uplink), and 3xTF32 to hold the 2e-4 tolerance.
// TMA is not used: a 2D tensor map over the rows needs 16-byte aligned
// row pitches (t_in*8 bytes), boxes of at most 256 a dimension and
// cuTensorMapEncodeTiled from libcuda, which the build does not link, and
// it writes unpadded boxes; 1D bulk copies need 16-byte
// aligned rows, which the padded odd row stride does not give.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

// The plan in ops/cuda_fir.py sizes tiles for these (STAGES, CYCLES).
constexpr int kStages = 2;     // slab buffers in the ring
constexpr int kOutStages = 2;  // output stages: stores overlap the compute
constexpr int kCycles = 2;     // cycles a lane computes (compile-time widths)
constexpr int kLanes = 32;

struct Geometry {
  int t_in, n_out, p, q, pad_left, u, groups, mt, row_stride, out_stride,
      tiles_per_row, n_tiles;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async8(float2* dst, const float2* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// 16 bytes to dst; only the first src_bytes come from src, the rest is 0
__device__ __forceinline__ void cp_async16(float2* dst, const float2* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dst <- x_row[i], or 0 outside [0, t_in)
__device__ __forceinline__ void copy_one(float2* dst, const float2* xr, int i,
                                         int t_in) {
  if (i >= 0 && i < t_in) {
    cp_async8(dst, xr + i);
  } else {
    *dst = make_float2(0.f, 0.f);
  }
}

__device__ __forceinline__ void tile_origin(const Geometry& g, int tile,
                                            int* b, int* m0) {
  const unsigned row = static_cast<unsigned>(tile) /
                       static_cast<unsigned>(g.tiles_per_row);
  *b = static_cast<int>(row);
  *m0 = (tile - *b * g.tiles_per_row) * g.mt;
}

// The 16-byte parity of x_row[i] (i may lie outside the row).
__device__ __forceinline__ int parity16(const float2* xr, int i) {
  return static_cast<int>(
      (static_cast<unsigned>(reinterpret_cast<uintptr_t>(xr) >> 3) +
       static_cast<unsigned>(i)) & 1u);
}

// Start the copies of `tile`'s slab into `slab`: row c gets the
// row_stride samples from gs = m0*q - pad_left + c*q on. One warp a row.
__device__ void stage_tile(float2* slab, const float2* __restrict__ x,
                           const Geometry& g, int tile, int warp,
                           int lane, int nwarps) {
  int b, m0;
  tile_origin(g, tile, &b, &m0);
  const float2* xr = x + static_cast<size_t>(b) * g.t_in;
  const int n = g.row_stride;
  for (int c = warp; c < g.mt; c += nwarps) {
    float2* dst = slab + c * n;
    const int gs = m0 * g.q - g.pad_left + c * g.q;  // sample of dst[0]
    const int dpar = static_cast<int>((smem_addr(dst) >> 3) & 1u);
    if (dpar == parity16(xr, gs)) {
      // dst[h + 2k] and x_row[gs + h + 2k] are both 16-byte aligned
      const int h = dpar;
      if (h && lane == 0) copy_one(dst, xr, gs, g.t_in);
      const int pairs = (n - h) >> 1;
      for (int k = lane; k < pairs; k += kLanes) {
        const int i = h + 2 * k;
        const int s = gs + i;
        const bool v0 = s >= 0 && s < g.t_in;
        const bool v1 = s + 1 >= 0 && s + 1 < g.t_in;
        if (v0) {
          cp_async16(dst + i, xr + s, v1 ? 16 : 8);
        } else {
          dst[i] = make_float2(0.f, 0.f);
          copy_one(dst + i + 1, xr, s + 1, g.t_in);
        }
      }
      if (((n - h) & 1) && lane == 0) copy_one(dst + n - 1, xr, gs + n - 1, g.t_in);
    } else {
      for (int i = lane; i < n; i += kLanes) copy_one(dst + i, xr, gs + i, g.t_in);
    }
  }
}

// Where a thread's first output pair of a tile sits in the stage, for
// an output row that starts on the 16-byte grid (h = 0) and off it (h =
// 1), and how far a step of all threads' pairs moves: computed once.
struct StoreWalk {
  int c0, r0, c1, r1, dc, dr;
};

__device__ StoreWalk store_walk(const Geometry& g, int tid, int nthreads) {
  StoreWalk w;
  w.c0 = 2 * tid / g.p;
  w.r0 = 2 * tid - w.c0 * g.p;
  w.c1 = (1 + 2 * tid) / g.p;
  w.r1 = 1 + 2 * tid - w.c1 * g.p;
  w.dc = 2 * nthreads / g.p;
  w.dr = 2 * nthreads - w.dc * g.p;
  return w;
}

// Write the tile's outputs from the [mt][out_stride] stage to the row,
// 16 bytes a thread where the row allows.
__device__ void store_tile(float2* __restrict__ out, const float2* ostage,
                           const Geometry& g, int tile, const StoreWalk& w,
                           int tid, int nthreads) {
  int b, m0;
  tile_origin(g, tile, &b, &m0);
  const int first = m0 * g.p;
  const int n = min(g.mt * g.p, g.n_out - first);
  float2* orow = out + static_cast<size_t>(b) * g.n_out + first;
  const int h = static_cast<int>((reinterpret_cast<uintptr_t>(orow) >> 3) & 1u);
  if (h && tid == 0) orow[0] = ostage[0];
  const int pairs = (n - h) >> 1;
  // pair k holds outputs o = h + 2k and o + 1; o = c*p + r
  int c = h ? w.c1 : w.c0;
  int r = h ? w.r1 : w.r0;
  for (int k = tid; k < pairs; k += nthreads) {
    int c1 = c, r1 = r + 1;
    if (r1 == g.p) {
      r1 = 0;
      ++c1;
    }
    const float2 a = ostage[c * g.out_stride + r];
    const float2 e = ostage[c1 * g.out_stride + r1];
    *reinterpret_cast<float4*>(orow + h + 2 * k) =
        make_float4(a.x, a.y, e.x, e.y);
    r += w.dr;
    c += w.dc;
    if (r >= g.p) {
      r -= g.p;
      ++c;
    }
  }
  if (((n - h) & 1) && tid == 0) {
    const int o = n - 1;
    const int oc = o / g.p;
    orow[o] = ostage[oc * g.out_stride + (o - oc * g.p)];
  }
}

// R phases of K cycles from their U-sample union windows, cycle i's at
// row[i * row_step + u]; tap(j, u) is phase j's tap at window column u,
// read once for the K cycles.
template <int R, int U, int K, typename Tap>
__device__ __forceinline__ void fir_group(const float2* row, int row_step,
                                          float2* orow, int out_step,
                                          int r_left, Tap tap) {
  float ax[K][R], ay[K][R];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) ax[i][j] = ay[i][j] = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float2 v[K];
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] = row[i * row_step + u];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float t = tap(j, u);
#pragma unroll
      for (int i = 0; i < K; ++i) {
        ax[i][j] = fmaf(v[i].x, t, ax[i][j]);
        ay[i][j] = fmaf(v[i].y, t, ay[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (j < r_left) orow[i * out_step + j] = make_float2(ax[i][j], ay[i][j]);
}

// Floats of the shared tap table: [groups][R][U], the plan's taps as they
// are (none for the runtime width).
template <int R, int U>
__host__ __device__ constexpr int tap_table_floats(int groups) {
  return U > 0 ? groups * R * U : 0;
}

// A compile-time instantiation (U > 0, g.mt == 32, g.groups <= W * K):
// a warp holds K groups of L = 32 / K lanes; lane c of group k of warp w
// computes cycles c, c + L, ... of phase group w * K + k. The runtime
// width (U == 0, K == 1, R == 1, g.u taps a phase, read through L1): lane
// c computes cycle c of groups w, w + W, ...
template <int R, int U, int W, int K>
__global__ void __launch_bounds__(W * kLanes, 2)
    resample_kernel(const float2* __restrict__ x, float2* __restrict__ out,
                    const float* __restrict__ taps,
                    const int* __restrict__ wb, Geometry g) {
  extern __shared__ __align__(16) float2 smem[];
  const int slab_words = g.mt * g.row_stride;
  float* stap = reinterpret_cast<float*>(smem);  // tap table, may be empty
  float2* slabs = smem + (tap_table_floats<R, U>(g.groups) + 3) / 4 * 2;
  const int out_words = g.mt * g.out_stride;
  float2* ostage = slabs + kStages * slab_words;  // [kOutStages][mt][...]
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  constexpr int L = kLanes / K;
  const int group = warp * K + lane / L;
  const int cyc = lane % L;

  // the lane's group: its window base and its taps in the block's table
  int my_wb = 0;
  if constexpr (U > 0) {
    const int gr = group < g.groups ? group : 0;
    for (int i = threadIdx.x; i < g.groups * R * U; i += W * kLanes)
      stap[i] = __ldg(taps + i);
    stap += gr * R * U;  // read after the loop's first barrier
    my_wb = __ldg(wb + gr);
  }
  const StoreWalk walk = store_walk(g, threadIdx.x, W * kLanes);

  int tile = blockIdx.x;
  const int stride = gridDim.x;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    const int t = tile + s * stride;
    if (t < g.n_tiles)
      stage_tile(slabs + s * slab_words, x, g, t, warp, lane, W);
    cp_async_commit();
  }
  // One barrier a tile. Iteration it computes tile it into output stage
  // it & 1 and stores tile it-1 from the other stage; the copies for tile
  // it + kStages - 1 go, after the barrier, into the slab buffer that
  // tile it-1's compute finished reading before it.
  int it = 0;
  int prev = -1;  // the tile whose outputs wait in stage (it - 1) & 1
  for (; tile < g.n_tiles; ++it, tile += stride) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int ahead = tile + (kStages - 1) * stride;
    if (ahead < g.n_tiles)
      stage_tile(slabs + ((it + kStages - 1) % kStages) * slab_words, x, g,
                 ahead, warp, lane, W);
    cp_async_commit();

    const float2* srow = slabs + (it % kStages) * slab_words +
                         cyc * g.row_stride;
    float2* orow = ostage + (it & 1) * out_words + cyc * g.out_stride;
    if constexpr (U > 0) {
      if (group < g.groups) {
        const float2* w = srow + my_wb;
        float2* o = orow + group * R;
        const int rs = L * g.row_stride, os = L * g.out_stride;
        fir_group<R, U, K>(w, rs, o, os, g.p - group * R,
                           [&](int j, int u) { return stap[j * U + u]; });
      }
    } else if (lane < g.mt) {
      for (int r = warp; r < g.groups; r += W) {
        const float2* w = srow + __ldg(wb + r);
        const float* tr = taps + r * g.u;
        float ax = 0.f, ay = 0.f;
        for (int u = 0; u < g.u; ++u) {
          const float2 v = w[u];
          const float h = __ldg(tr + u);
          ax = fmaf(v.x, h, ax);
          ay = fmaf(v.y, h, ay);
        }
        orow[r] = make_float2(ax, ay);
      }
    }
    if (prev >= 0)
      store_tile(out, ostage + ((it - 1) & 1) * out_words, g, prev, walk,
                 threadIdx.x, W * kLanes);
    prev = tile;
  }
  __syncthreads();
  if (prev >= 0)
    store_tile(out, ostage + ((it - 1) & 1) * out_words, g, prev, walk,
               threadIdx.x, W * kLanes);
  cp_async_wait<0>();
}

template <int R, int U, int W, int K>
int launch(const void* x, void* out, const void* taps, const void* wb,
           Geometry g, cudaStream_t stream) {
  if (U > 0 && (g.groups > W * K || g.mt != kLanes))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = resample_kernel<R, U, W, K>;
  const size_t smem =
      (static_cast<size_t>(tap_table_floats<R, U>(g.groups) + 3) / 4 * 2 +
       static_cast<size_t>(kStages) * g.mt * g.row_stride +
       static_cast<size_t>(kOutStages) * g.mt * g.out_stride) *
      sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, W * kLanes, smem)) != cudaSuccess)
    return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int blocks = sms * per_sm;
  if (blocks > g.n_tiles) blocks = g.n_tiles;
  kernel<<<static_cast<unsigned>(blocks), W * kLanes, smem, stream>>>(
      static_cast<const float2*>(x), static_cast<float2*>(out),
      static_cast<const float*>(taps), static_cast<const int*>(wb), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [rows, t_in] complex64, out: [rows, n_out] complex64, taps:
// [groups, r_group, u_width] float32, wb: [groups] int32, all on the
// device; the tile plan (ops/cuda_fir.py::tile_plan) gives r_group,
// u_width, mt, row_stride and out_stride. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int polyphase_resample(const void* x, void* out, const void* taps,
                                  const void* wb, int rows, int t_in,
                                  int n_out, int p, int q, int pad_left,
                                  int r_group, int u_width, int mt,
                                  int row_stride, int out_stride,
                                  void* stream) {
  if (rows <= 0 || n_out <= 0) return 0;
  if (p < 1 || q < 1 || r_group < 1 || u_width < 1 || mt < 1 || mt > kLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.t_in = t_in;
  g.n_out = n_out;
  g.p = p;
  g.q = q;
  g.pad_left = pad_left;
  g.u = u_width;
  g.groups = (p + r_group - 1) / r_group;
  g.mt = mt;
  g.row_stride = row_stride;
  g.out_stride = out_stride;
  const int cycles = (n_out + p - 1) / p;
  g.tiles_per_row = (cycles + mt - 1) / mt;
  const long long n_tiles = static_cast<long long>(rows) * g.tiles_per_row;
  if (n_tiles >= (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  g.n_tiles = static_cast<int>(n_tiles);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // (R, U, groups): the plan's INSTANCES in ops/cuda_fir.py; a block
  // holds the groups as warps of kCycles groups each
#define INSTANCE(R, U, G)                                        \
  if (r_group == R && u_width == U)                              \
    return launch<R, U, (G + kCycles - 1) / kCycles, kCycles>(   \
        x, out, taps, wb, g, s);
  INSTANCE(5, 21, 13)
  INSTANCE(4, 10, 24)
#undef INSTANCE
  if (r_group == 1) return launch<1, 0, 8, 1>(x, out, taps, wb, g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
