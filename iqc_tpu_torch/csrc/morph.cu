// Iterative binary morphology of segmentation ROIs: the two tails of
// segment_rois.
//
// Replaces the TPU kernels of iqc_tpu/ops/pallas_morph.py:
//   _grow_clean_kernel (via pallas_grow_clean) -> iqc_grow_clean
//     geodesic growth: `grow` rounds of m = cross_dilate(m) & allow from the
//     seeds, then the clean body below (skipped when fill == 0);
//   _clean_kernel (via pallas_clean) -> iqc_clean
//     the clean body alone.
// The clean body: open(1) = dilate(erode(m)); hole fill: `fill` rounds of
// o = cross_dilate(o) & ~m from o = border_ring & ~m, then m = ~o;
// close(2) = erode(erode(dilate(dilate(m)))); open(2) = dilate(dilate(erode(erode(m)))).
// Cross dilate/erode use the 5-point cross; pixels outside the ROI count as
// empty for both.
//
// What bounds it on an H100: neither bytes nor operations. At the main
// path's shapes (64 ROIs of 128 x 128) each kernel reads one or two 1 MB
// byte masks and writes one; the ~50 dependent steps are cheap bit
// operations. What costs is the chain of dependent steps, each of which
// the TPU version paid as a pass over memory. The design keeps one ROI per
// block (so a shift can never reach into another ROI) and holds its masks
// bit-packed in shared memory for the whole sequence: one bit per pixel,
// R/32 32-bit words per row. A cross step is then five loads, four
// shifts and four AND/ORs per word and one __syncthreads; global memory is
// touched once to read the masks and once to write the result.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxR = 256;
constexpr int kMaxWords = kMaxR * kMaxR / 32;
constexpr int kThreads = 512;

struct Roi {
  int r;   // side in pixels, a multiple of 32
  int wr;  // 32-bit words per row
  int n;   // words per ROI
};

// dst = cross_dilate(src) or cross_erode(src), optionally ANDed with `gate`.
__device__ void cross_step(const uint32_t* src, uint32_t* dst, const uint32_t* gate,
                           bool dilate, const Roi& g) {
  for (int idx = threadIdx.x; idx < g.n; idx += blockDim.x) {
    const int row = idx / g.wr;
    const int w = idx - row * g.wr;
    const uint32_t c = src[idx];
    const uint32_t up = row > 0 ? src[idx - g.wr] : 0u;
    const uint32_t dn = row < g.r - 1 ? src[idx + g.wr] : 0u;
    const uint32_t prev = w > 0 ? src[idx - 1] : 0u;
    const uint32_t next = w < g.wr - 1 ? src[idx + 1] : 0u;
    // bit t of word w is column 32 * w + t
    const uint32_t from_left = (c << 1) | (prev >> 31);   // out[x] = m[x - 1]
    const uint32_t from_right = (c >> 1) | (next << 31);  // out[x] = m[x + 1]
    uint32_t v = dilate ? (c | up | dn | from_left | from_right)
                        : (c & up & dn & from_left & from_right);
    if (gate != nullptr) v &= gate[idx];
    dst[idx] = v;
  }
  __syncthreads();
}

__device__ void load_bits(const uint8_t* src, uint32_t* dst, const Roi& g) {
  for (int idx = threadIdx.x; idx < g.n; idx += blockDim.x) {
    const uint8_t* p = src + static_cast<size_t>(idx) * 32;
    uint32_t v = 0;
    for (int t = 0; t < 32; ++t) v |= (p[t] != 0 ? 1u : 0u) << t;
    dst[idx] = v;
  }
}

__device__ void store_bits(const uint32_t* src, uint8_t* dst, const Roi& g) {
  for (int idx = threadIdx.x; idx < g.n; idx += blockDim.x) {
    uint8_t* p = dst + static_cast<size_t>(idx) * 32;
    const uint32_t v = src[idx];
    for (int t = 0; t < 32; ++t) p[t] = static_cast<uint8_t>((v >> t) & 1u);
  }
}

// The clean body on the mask in *a; *a and *b are swapped as buffers
// ping-pong, and the result is left in *a. `inv` is scratch.
__device__ void clean_body(uint32_t** a, uint32_t** b, uint32_t* inv, int fill,
                           const Roi& g) {
  cross_step(*a, *b, nullptr, false, g);  // open(1)
  cross_step(*b, *a, nullptr, true, g);
  for (int idx = threadIdx.x; idx < g.n; idx += blockDim.x) {
    const int row = idx / g.wr;
    const int w = idx - row * g.wr;
    uint32_t ring;
    if (row == 0 || row == g.r - 1) {
      ring = 0xffffffffu;
    } else {
      ring = (w == 0 ? 1u : 0u) | (w == g.wr - 1 ? 0x80000000u : 0u);
    }
    const uint32_t iv = ~(*a)[idx];
    inv[idx] = iv;
    (*b)[idx] = ring & iv;  // outside seed
  }
  __syncthreads();
  uint32_t* o = *b;
  uint32_t* t = *a;
  for (int it = 0; it < fill; ++it) {
    cross_step(o, t, inv, true, g);
    uint32_t* s = o;
    o = t;
    t = s;
  }
  for (int idx = threadIdx.x; idx < g.n; idx += blockDim.x) t[idx] = ~o[idx];
  __syncthreads();
  // close(2), then open(2)
  const bool seq[8] = {true, true, false, false, false, false, true, true};
  for (int s = 0; s < 8; ++s) {
    cross_step(t, o, nullptr, seq[s], g);
    uint32_t* u = t;
    t = o;
    o = u;
  }
  *a = t;
  *b = o;
}

// One block per ROI. seeds == nullptr: clean `mask` (K3). Otherwise grow
// `seeds` inside `allow`, then clean unless fill == 0 (K2).
__global__ void morph_kernel(const uint8_t* __restrict__ seeds,
                             const uint8_t* __restrict__ allow,
                             uint8_t* __restrict__ out, int r, int grow, int fill) {
  __shared__ uint32_t buf0[kMaxWords], buf1[kMaxWords], buf2[kMaxWords];
  const Roi g{r, r / 32, r * r / 32};
  const size_t offset = static_cast<size_t>(blockIdx.x) * r * r;
  uint32_t* a = buf0;
  uint32_t* b = buf1;
  load_bits(seeds + offset, a, g);
  const bool grows = allow != nullptr;
  if (grows) load_bits(allow + offset, buf2, g);
  __syncthreads();
  if (grows) {
    for (int it = 0; it < grow; ++it) {
      cross_step(a, b, buf2, true, g);
      uint32_t* s = a;
      a = b;
      b = s;
    }
  }
  if (!grows || fill > 0) clean_body(&a, &b, buf2, fill, g);
  store_bits(a, out + offset, g);
}

bool valid_side(int r) { return r >= 32 && r <= kMaxR && r % 32 == 0; }

}  // namespace

// seeds, allow, out: [n, r, r] uint8 (0/1), contiguous, on the current device.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int iqc_grow_clean(const void* seeds, const void* allow, void* out, int n,
                              int r, int grow_iterations, int fill_iterations,
                              void* stream) {
  if (n <= 0) return 0;
  if (!valid_side(r) || grow_iterations < 0 || fill_iterations < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  morph_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seeds), static_cast<const uint8_t*>(allow),
      static_cast<uint8_t*>(out), r, grow_iterations, fill_iterations);
  return static_cast<int>(cudaGetLastError());
}

// mask, out: [n, r, r] uint8 (0/1), contiguous, on the current device.
extern "C" int iqc_clean(const void* mask, void* out, int n, int r, int fill_iterations,
                         void* stream) {
  if (n <= 0) return 0;
  if (!valid_side(r) || fill_iterations < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  morph_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), nullptr, static_cast<uint8_t*>(out), r, 0,
      fill_iterations);
  return static_cast<int>(cudaGetLastError());
}
