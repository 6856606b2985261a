// NMS suppression: pairwise IoU of score-sorted boxes and a bounded number
// of synchronous greedy-NMS rounds.
//
// Replaces the TPU kernel iqc_tpu/ops/pallas_nms.py::_suppress_kernel
// (called through pallas_suppression). For each image of a batch, given K
// boxes sorted by descending score (class-offset upstream so that boxes of
// different classes never overlap):
//   iou[i,j]     = union > 0 ? inter / max(union, 1e-9) : 0   (float32)
//   overlap[i,j] = iou[i,j] > threshold && i < j               (i suppresses j)
//   keep         = all ones, then `iterations` rounds of
//   keep'[j]     = !exists i: overlap[i,j] && keep[i]
// Every round reads the previous round's keep and writes a new one (Jacobi).
// An in-place update would converge differently on suppression chains
// deeper than the round count, so it is not done. A round that changes
// nothing has reached a fixed point, which every later round keeps, so the
// rounds stop there: the result is the same as after all `iterations`.
//
// What bounds it on an H100: neither bytes nor operations. A predict
// request runs one image of 300 boxes: 4.8 KB in, 0.7 MFLOP, nanoseconds of
// either (bound 0.0000108 ms). Its time is the launch, the IoU triangle
// (45,000 pairs) and the chain of dependent rounds. The design spreads the
// triangle over a thread-block cluster of kCluster blocks per image, on
// neighbouring SMs, and makes each round one block-local step:
// - Every block keeps all K boxes and the whole suppressor bitmask in
//   shared memory, transposed (sup[w][j]: bit t says box 32w+t suppresses
//   j), so that a warp's reads in a round are 32 consecutive words, free
//   of bank conflicts.
// - The triangle is dealt out as warp work units (run of kPerUnit
//   candidates j, word w), w <= j/32, evenly over every warp of the
//   cluster: lane t loads box 32w+t once and compares it with each j, and
//   one __ballot_sync per j makes the word, which lanes 0..kCluster-1 store
//   into every block's bitmask (distributed shared memory, DSMEM). At
//   K = 300 that is 390 units, about 3 per warp. A pair whose boxes do not
//   meet has IoU 0 whatever the union, so its division is skipped.
// - After one cluster sync every block runs the rounds alone: a warp per
//   32-candidate word, one ballot, and __syncthreads_or(changed) as the
//   round's only barrier and its early exit. Each block writes the keep
//   bytes of its own share of the candidates.
// Measured on an H100 (kernel_bench.py, PERF.md): kCluster over {1, 2, 4,
// 8}, kThreads over {256, 512, 1024} and kPerUnit over {1, 4}, and against
// sending each round's keep words to every block over DSMEM with a cluster
// sync a round, which costs 0.9 us a round against 0.3 us here. At B = 1
// the kernel takes 6 us with no round and 11 us with 16.
// ptxas (-Xptxas -v, sm_90a): 36 registers, 43,136 B shared memory, no
// spills.
//
// Rounding: built with --fmad=false and IEEE division, and the IoU is
// computed in the plain version's operation order, so the float32 values and
// hence the keep mask are bit-identical to it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxK = 512;
constexpr int kMaxWords = kMaxK / 32;
constexpr int kCluster = 8;     // blocks per image (swept over 1, 2, 4, 8)
constexpr int kThreads = 512;   // threads per block (swept over 256, 512, 1024)
constexpr int kWarps = kThreads / 32;
constexpr int kPerUnit = 4;     // candidates j per warp work unit (swept over 1, 4)
constexpr uint32_t kAll = 0xffffffffu;

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
suppress_kernel(const float* __restrict__ boxes, const float* __restrict__ threshold_in,
                uint8_t* __restrict__ keep_out, int k, int iterations) {
  __shared__ float x1[kMaxK], y1[kMaxK], x2[kMaxK], y2[kMaxK], area[kMaxK];
  // sup[w * kMaxK + j], bit t: box 32 * w + t suppresses candidate j
  __shared__ uint32_t sup[kMaxWords * kMaxK];
  __shared__ uint32_t keep[2][kMaxWords];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int image = blockIdx.x / kCluster;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int words = (k + 31) / 32;
  const int per_block = (words + kCluster - 1) / kCluster;  // words of candidates per block
  const int first_word = rank * per_block;
  const int own_words = max(0, min(words, first_word + per_block) - first_word);

  // the IoU threshold, read once from the device at run time (as the TPU
  // kernel reads thresh_ref from SMEM), so that a captured graph or an
  // exported program takes the value its input holds at each replay
  const float threshold = __ldg(threshold_in);
  const float* b = boxes + static_cast<size_t>(image) * k * 4;
  for (int j = threadIdx.x; j < k; j += kThreads) {
    const float a0 = b[4 * j], a1 = b[4 * j + 1], a2 = b[4 * j + 2], a3 = b[4 * j + 3];
    x1[j] = a0;
    y1[j] = a1;
    x2[j] = a2;
    y2[j] = a3;
    area[j] = fmaxf(a2 - a0, 0.0f) * fmaxf(a3 - a1, 0.0f);
  }
  for (int w = threadIdx.x; w < words; w += kThreads) {
    const int rem = k - 32 * w;
    keep[0][w] = rem >= 32 ? kAll : ((1u << rem) - 1u);
  }
  // the boxes are in place, and every block of the cluster has started, so
  // its shared memory may be written from the others
  cluster.sync();

  // Units (j0, w), w-major: word w covers candidates j = 32w .. k-1 in runs of
  // kPerUnit, j0 the first of a run; lane t compares box 32w+t with each.
  // Warp g of the cluster takes units g, g + kCluster * kWarps, ...;
  // (w, start) follows u upwards.
  int w = 0;
  int start = 0;  // first unit of word w
  for (int u = rank * kWarps + warp; w < words; u += kCluster * kWarps) {
    while (w < words && u - start >= (k - 32 * w + kPerUnit - 1) / kPerUnit) {
      start += (k - 32 * w + kPerUnit - 1) / kPerUnit;
      ++w;
    }
    if (w >= words) break;
    const int j0 = 32 * w + kPerUnit * (u - start);
    const int i = 32 * w + lane;
    const float xi1 = x1[i], yi1 = y1[i], xi2 = x2[i], yi2 = y2[i], ai = area[i];
#pragma unroll
    for (int q = 0; q < kPerUnit; ++q) {
      const int j = j0 + q;
      if (j >= k) break;  // warp-uniform
      bool over = false;
      if (i < j) {
        const float ix1 = fmaxf(xi1, x1[j]);
        const float iy1 = fmaxf(yi1, y1[j]);
        const float ix2 = fminf(xi2, x2[j]);
        const float iy2 = fminf(yi2, y2[j]);
        const float inter = fmaxf(ix2 - ix1, 0.0f) * fmaxf(iy2 - iy1, 0.0f);
        // boxes that do not meet have IoU 0 either way: skip the division
        float iou = 0.0f;
        if (inter != 0.0f) {
          const float uni = ai + area[j] - inter;
          iou = uni > 0.0f ? inter / fmaxf(uni, 1e-9f) : 0.0f;
        }
        over = iou > threshold;
      }
      const uint32_t bits = __ballot_sync(kAll, over);
      if (lane < kCluster) cluster.map_shared_rank(sup, lane)[w * kMaxK + j] = bits;
    }
  }
  cluster.sync();

  // No DSMEM access follows: each block runs the rounds on its own copy,
  // and the block barrier is each round's only synchronisation.
  int cur = 0;
  for (int it = 0; it < iterations; ++it) {
    bool changed = false;
    for (int word = warp; word < words; word += kWarps) {
      const int j = 32 * word + lane;
      bool live = false;
      if (j < k) {
        uint32_t hit = 0;
#pragma unroll
        for (int v = 0; v < kMaxWords; ++v) {
          if (v <= word) hit |= sup[v * kMaxK + j] & keep[cur][v];
        }
        live = hit == 0;
      }
      const uint32_t ballot = __ballot_sync(kAll, live);
      changed |= ballot != keep[cur][word];
      if (lane == 0) keep[cur ^ 1][word] = ballot;
    }
    cur ^= 1;
    // a round that changed nothing is a fixed point: later rounds keep it
    if (!__syncthreads_or(changed)) break;
  }

  uint8_t* out = keep_out + static_cast<size_t>(image) * k;
  for (int jl = threadIdx.x; jl < 32 * own_words; jl += kThreads) {
    const int j = 32 * first_word + jl;
    if (j < k) out[j] = static_cast<uint8_t>((keep[cur][j >> 5] >> (j & 31)) & 1u);
  }
}

}  // namespace

// boxes [batch, k, 4] float32 and keep [batch, k] uint8, contiguous, and the
// IoU threshold, one float32, all on the current device. Returns the CUDA
// error code of the launch (0 = success).
extern "C" int iqc_suppress(const void* boxes, const void* threshold, void* keep, int batch,
                            int k, int iterations, void* stream) {
  if (batch <= 0 || k <= 0) return 0;
  if (k > kMaxK || iterations < 0 || threshold == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  suppress_kernel<<<batch * kCluster, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(threshold),
      static_cast<uint8_t*>(keep), k, iterations);
  return static_cast<int>(cudaGetLastError());
}
