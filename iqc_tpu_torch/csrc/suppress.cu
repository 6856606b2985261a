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
// deeper than the round count, so it is not done.
//
// What bounds it on an H100: neither bytes nor operations. At the main
// path's shapes (8 images x 300 boxes) it moves about 40 KB and does about
// 11 MFLOP, under a microsecond of either; its time is the launch and the
// serial chain of rounds inside one block per image. The design therefore
// keeps everything for an image in shared memory for the whole kernel: the
// boxes (20 B each) and the overlap relation as a bitmask, stored per
// candidate j over its possible suppressors i (K x ceil(K/32) words, 12 KB at
// K = 300). A round is then ceil(K/32) AND/OR words per candidate and one
// warp ballot per 32 candidates, with one __syncthreads between rounds.
//
// Rounding: built with --fmad=false and IEEE division, and the IoU is
// computed in the plain version's operation order, so the float32 values and
// hence the keep mask are bit-identical to it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 512;
constexpr int kMaxWords = kMaxK / 32;

__global__ void suppress_kernel(const float* __restrict__ boxes,
                                uint8_t* __restrict__ keep_out, int k,
                                float threshold, int iterations) {
  __shared__ float x1[kMaxK], y1[kMaxK], x2[kMaxK], y2[kMaxK], area[kMaxK];
  // sup[j * words + w], bit t: box 32 * w + t suppresses box j
  __shared__ uint32_t sup[kMaxK * kMaxWords];
  __shared__ uint32_t keep[2][kMaxWords];

  const int words = (k + 31) / 32;
  const float* b = boxes + static_cast<size_t>(blockIdx.x) * k * 4;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const float a0 = b[4 * j], a1 = b[4 * j + 1], a2 = b[4 * j + 2], a3 = b[4 * j + 3];
    x1[j] = a0;
    y1[j] = a1;
    x2[j] = a2;
    y2[j] = a3;
    area[j] = fmaxf(a2 - a0, 0.0f) * fmaxf(a3 - a1, 0.0f);
  }
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    const int rem = k - 32 * w;
    keep[0][w] = rem >= 32 ? 0xffffffffu : ((1u << rem) - 1u);
  }
  __syncthreads();

  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    for (int w = 0; w < words; ++w) {
      uint32_t bits = 0;
      for (int t = 0; t < 32; ++t) {
        const int i = 32 * w + t;
        if (i >= j) break;
        const float ix1 = fmaxf(x1[i], x1[j]);
        const float iy1 = fmaxf(y1[i], y1[j]);
        const float ix2 = fminf(x2[i], x2[j]);
        const float iy2 = fminf(y2[i], y2[j]);
        const float inter = fmaxf(ix2 - ix1, 0.0f) * fmaxf(iy2 - iy1, 0.0f);
        const float uni = area[i] + area[j] - inter;
        const float iou = uni > 0.0f ? inter / fmaxf(uni, 1e-9f) : 0.0f;
        if (iou > threshold) bits |= 1u << t;
      }
      sup[j * words + w] = bits;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  int cur = 0;
  for (int it = 0; it < iterations; ++it) {
    // each warp owns whole 32-candidate words, so the ballot is warp-uniform
    for (int base = threadIdx.x - lane; base < 32 * words; base += blockDim.x) {
      const int j = base + lane;
      bool live = false;
      if (j < k) {
        uint32_t hit = 0;
        for (int w = 0; w < words; ++w) hit |= sup[j * words + w] & keep[cur][w];
        live = hit == 0;
      }
      const uint32_t ballot = __ballot_sync(0xffffffffu, live);
      if (lane == 0) keep[cur ^ 1][base / 32] = ballot;
    }
    __syncthreads();
    cur ^= 1;
  }

  uint8_t* out = keep_out + static_cast<size_t>(blockIdx.x) * k;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    out[j] = static_cast<uint8_t>((keep[cur][j >> 5] >> (j & 31)) & 1u);
  }
}

}  // namespace

// boxes [batch, k, 4] float32 and keep [batch, k] uint8, contiguous, on the
// current device. Returns the CUDA error code of the launch (0 = success).
extern "C" int iqc_suppress(const void* boxes, void* keep, int batch, int k,
                            float threshold, int iterations, void* stream) {
  if (batch <= 0 || k <= 0) return 0;
  if (k > kMaxK || iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((k + 31) / 32) * 32;
  suppress_kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<uint8_t*>(keep), k, threshold,
      iterations);
  return static_cast<int>(cudaGetLastError());
}
