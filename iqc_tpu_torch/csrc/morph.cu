// Iterative binary morphology of segmentation ROIs: the two tails of
// segment_rois.
//
// Replaces the TPU kernels of iqc_tpu/ops/pallas_morph.py:
//   _grow_clean_kernel (via pallas_grow_clean) -> iqc_grow_clean
//   _clean_kernel (via pallas_clean)           -> iqc_clean
// Both run this step sequence on each [R, R] ROI, one bit per pixel:
//   1. (iqc_grow_clean only) `grow` rounds of m = cross_dilate(m) & allow
//      from the seeds; steps 2-4 are skipped when fill == 0;
//   2. open(1) = dilate(erode(m));
//   3. hole fill: `fill` rounds of o = cross_dilate(o) & ~m from
//      o = border_ring & ~m, then m = ~o;
//   4. close(2) = erode(erode(dilate(dilate(m)))), then
//      open(2) = dilate(dilate(erode(erode(m)))).
// Cross dilate/erode use the 5-point cross; pixels outside the ROI count as
// empty for both. The grow and hole-fill loops stop at the first round that
// changes nothing: a fixed point stays fixed, so the result is the same as
// after all their rounds.
//
// What bounds it on an H100: neither bytes nor operations. A predict request
// runs 16 ROIs of 128 x 128 (17 for the clean: the all-ones ROI rides
// along), 0.26-0.79 MB of byte masks and a few MFLOP of word operations.
// Its time is the launch and the chain of ~50 dependent steps. The design
// makes each step as short as it can be:
// - One block of R threads per ROI (4 warps at R = 128, one on each SM
//   sub-partition). Each thread holds one row in registers, as R/32 words,
//   for the mask, the gate (allow or ~m) and the hole-fill state.
// - Horizontal neighbours come from funnel shifts across the thread's own
//   words, the rows above and below from __shfl_up_sync/__shfl_down_sync;
//   only each warp's first and last rows go through shared memory (double
//   buffered), so one barrier per step remains, and in the grow and fill
//   loops that barrier is __syncthreads_or(changed), the early exit.
// - The byte masks are read and written with 16-byte accesses of
//   neighbouring lanes; 16 bytes pack into 16 bits with shifts, two lanes
//   make a word, and a staging buffer in shared memory hands the words to
//   the rows' threads.
// Measured on an H100 (kernel_bench.py, PERF.md) against one warp per ROI,
// R/32 rows a lane, 4 ROIs a block, no barrier at all and __any_sync as the
// early exit. That is slower at both shapes (11.5 us against 7.5 us for
// grow_clean at N = 16): with one warp a ROI, every step's R/32 rows run one
// after another on one SM sub-partition, where a block spreads them over
// four.
// ptxas (-Xptxas -v, sm_90a, R = 128): 37 registers, 2,304 B shared memory,
// no spills (R = 256: 46 registers, 9,216 B).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxR = 256;
constexpr uint32_t kAll = 0xffffffffu;

// 4 bytes of 0/1 (any nonzero byte counts as 1) -> 4 bits
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  x = __vcmpne4(x, 0u) & 0x01010101u;
  return (x | x >> 7 | x >> 14 | x >> 21) & 0xfu;
}

// 4 bits -> 4 bytes of 0/1
__device__ __forceinline__ uint32_t unpack4(uint32_t b) {
  return (b & 1u) | (b & 2u) << 7 | (b & 4u) << 14 | (b & 8u) << 21;
}

// One ROI of R x R pixels held by R threads, thread y holding row y as
// W = R / 32 words; bit t of word w is column 32w + t.
template <int R>
struct Tile {
  static constexpr int W = R / 32;
  static constexpr int kWarps = R / 32;
  using Row = uint32_t[W];

  uint32_t* stage;  // [R][W] of shared memory
  uint32_t* edges;  // [parity][first, last][warp][W] of shared memory
  int tid, lane, warp, parity;

  __device__ Tile(uint32_t* stage_, uint32_t* edges_)
      : stage(stage_), edges(edges_), tid(threadIdx.x), lane(threadIdx.x & 31),
        warp(threadIdx.x >> 5), parity(0) {}

  // [R, R] bytes -> this thread's row. The byte mask is read in 16-byte
  // chunks by neighbouring lanes; lanes 2q and 2q+1 hold the two halves of
  // word q.
  __device__ void load(const uint8_t* src, Row& m) const {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    __syncthreads();  // the staging buffer's last readers are done
#pragma unroll
    for (int q = 0; q < R / 16; ++q) {
      const int c = q * R + tid;
      const uint4 v = s[c];
      const uint32_t half = pack4(v.x) | pack4(v.y) << 4 | pack4(v.z) << 8 | pack4(v.w) << 12;
      const uint32_t high = __shfl_down_sync(kAll, half, 1);
      if ((lane & 1) == 0) stage[c >> 1] = half | high << 16;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < W; ++w) m[w] = stage[tid * W + w];
  }

  // this thread's row -> [R, R] bytes of 0/1, written in 16-byte chunks by
  // neighbouring lanes
  __device__ void store(const Row& m, uint8_t* dst) const {
    __syncthreads();
#pragma unroll
    for (int w = 0; w < W; ++w) stage[tid * W + w] = m[w];
    __syncthreads();
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int q = 0; q < R / 16; ++q) {
      const int c = q * R + tid;
      const uint32_t half = stage[c >> 1] >> (16 * (c & 1));
      d[c] = make_uint4(unpack4(half), unpack4(half >> 4), unpack4(half >> 8),
                        unpack4(half >> 12));
    }
  }

  // The barrier before a step: publishes this warp's first and last rows
  // for the neighbouring warps and returns whether `flag` held in any
  // thread of the ROI.
  __device__ __forceinline__ bool barrier(const Row& m, bool flag) {
    uint32_t* e = edges + parity * 2 * kWarps * W;
    if (lane == 0) {
#pragma unroll
      for (int w = 0; w < W; ++w) e[warp * W + w] = m[w];
    }
    if (lane == 31) {
#pragma unroll
      for (int w = 0; w < W; ++w) e[(kWarps + warp) * W + w] = m[w];
    }
    return __syncthreads_or(flag) != 0;
  }

  // m = cross_dilate(m) or cross_erode(m), ANDed with `gate` when kGated;
  // comes after barrier(m, ...). Returns whether this thread's row changed.
  template <bool kDilate, bool kGated>
  __device__ __forceinline__ bool step(Row& m, const Row& gate) {
    const uint32_t* e = edges + parity * 2 * kWarps * W;
    parity ^= 1;
    uint32_t out[W];
    bool changed = false;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      uint32_t up = __shfl_up_sync(kAll, m[w], 1);
      uint32_t dn = __shfl_down_sync(kAll, m[w], 1);
      if (lane == 0) up = warp > 0 ? e[(kWarps + warp - 1) * W + w] : 0u;
      if (lane == 31) dn = warp < kWarps - 1 ? e[(warp + 1) * W + w] : 0u;
      const uint32_t c = m[w];
      const uint32_t from_left = __funnelshift_l(w > 0 ? m[w - 1] : 0u, c, 1);
      const uint32_t from_right = __funnelshift_r(c, w < W - 1 ? m[w + 1] : 0u, 1);
      uint32_t v = kDilate ? (c | up | dn | from_left | from_right)
                           : (c & up & dn & from_left & from_right);
      if (kGated) v &= gate[w];
      out[w] = v;
      changed |= v != c;
    }
#pragma unroll
    for (int w = 0; w < W; ++w) m[w] = out[w];
    return changed;
  }

  template <bool kDilate>
  __device__ __forceinline__ void fixed_step(Row& m, const Row& gate) {
    barrier(m, true);
    step<kDilate, false>(m, gate);
  }

  // up to `rounds` rounds of m = cross_dilate(m) & gate, to the first round
  // that changes nothing
  __device__ __forceinline__ void gated_dilate(Row& m, const Row& gate, int rounds) {
    bool changed = true;
    for (int it = 0; it < rounds; ++it) {
      if (!barrier(m, changed)) break;
      changed = step<true, true>(m, gate);
    }
  }
};

// seeds == nullptr: clean `mask` (K3). Otherwise grow `seeds` inside
// `allow`, then clean unless fill == 0 (K2).
template <int R>
__global__ void __launch_bounds__(R)
morph_kernel(const uint8_t* __restrict__ seeds, const uint8_t* __restrict__ allow,
             uint8_t* __restrict__ out, int grow, int fill) {
  using Roi = Tile<R>;
  __shared__ uint32_t stage[R * Roi::W];
  __shared__ uint32_t edges[2 * 2 * Roi::kWarps * Roi::W];
  Roi tile(stage, edges);
  const size_t offset = static_cast<size_t>(blockIdx.x) * R * R;

  typename Roi::Row m, g;
  tile.load(seeds + offset, m);
  const bool grows = allow != nullptr;
  if (grows) {
    tile.load(allow + offset, g);
    tile.gated_dilate(m, g, grow);
  }
  if (!grows || fill > 0) {
    tile.template fixed_step<false>(m, g);  // open(1)
    tile.template fixed_step<true>(m, g);
    // hole fill: flood the background from the border ring inside ~m
    const int row = tile.tid;
#pragma unroll
    for (int w = 0; w < Roi::W; ++w) {
      uint32_t ring = (w == 0 ? 1u : 0u) | (w == Roi::W - 1 ? 0x80000000u : 0u);
      if (row == 0 || row == R - 1) ring = kAll;
      g[w] = ~m[w];
      m[w] = ring & g[w];
    }
    tile.gated_dilate(m, g, fill);
#pragma unroll
    for (int w = 0; w < Roi::W; ++w) m[w] = ~m[w];
    tile.template fixed_step<true>(m, g);  // close(2)
    tile.template fixed_step<true>(m, g);
    tile.template fixed_step<false>(m, g);
    tile.template fixed_step<false>(m, g);
    tile.template fixed_step<false>(m, g);  // open(2)
    tile.template fixed_step<false>(m, g);
    tile.template fixed_step<true>(m, g);
    tile.template fixed_step<true>(m, g);
  }
  tile.store(m, out + offset);
}

template <int R>
int launch(const uint8_t* seeds, const uint8_t* allow, uint8_t* out, int n, int grow,
           int fill, cudaStream_t stream) {
  morph_kernel<R><<<n, R, 0, stream>>>(seeds, allow, out, grow, fill);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* seeds, const void* allow, void* out, int n, int r, int grow,
             int fill, void* stream) {
  const auto* s = static_cast<const uint8_t*>(seeds);
  const auto* a = static_cast<const uint8_t*>(allow);
  auto* o = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 32: return launch<32>(s, a, o, n, grow, fill, st);
    case 64: return launch<64>(s, a, o, n, grow, fill, st);
    case 96: return launch<96>(s, a, o, n, grow, fill, st);
    case 128: return launch<128>(s, a, o, n, grow, fill, st);
    case 160: return launch<160>(s, a, o, n, grow, fill, st);
    case 192: return launch<192>(s, a, o, n, grow, fill, st);
    case 224: return launch<224>(s, a, o, n, grow, fill, st);
    case 256: return launch<256>(s, a, o, n, grow, fill, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// seeds, allow, out: [n, r, r] uint8 (0/1), contiguous, 16-byte aligned, on
// the current device; r a multiple of 32 in [32, 256]. Returns the CUDA
// error code of the launch (0 = success).
extern "C" int iqc_grow_clean(const void* seeds, const void* allow, void* out, int n,
                              int r, int grow_iterations, int fill_iterations,
                              void* stream) {
  if (n <= 0) return 0;
  if (r > kMaxR || grow_iterations < 0 || fill_iterations < 0 || !aligned(seeds) ||
      !aligned(allow) || !aligned(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch(seeds, allow, out, n, r, grow_iterations, fill_iterations, stream);
}

// mask, out: [n, r, r] uint8 (0/1), as for iqc_grow_clean.
extern "C" int iqc_clean(const void* mask, void* out, int n, int r, int fill_iterations,
                         void* stream) {
  if (n <= 0) return 0;
  if (r > kMaxR || fill_iterations < 0 || !aligned(mask) || !aligned(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch(mask, nullptr, out, n, r, 0, fill_iterations, stream);
}
