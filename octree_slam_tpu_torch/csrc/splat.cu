// The splat renderer's packed z-buffer, hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The reference's splat_zbuffer
// (octree_slam_tpu/render/splat.py) is plain XLA, which fuses it into a few
// device loops; the port's plain version of the same computation
// (render/splat.py, splat_zbuffer) is ~160 small PyTorch launches over the
// registry's whole capacity: the Morton decode's 9 levels of elementwise
// ops and stacks, the unpack, a cuBLAS product, the projection, the depth
// quantisation, and a scatter-min that sends every dropped row (out of
// view, behind the camera, unoccupied or past the registry's count) to one
// guard slot, all of them atomics on a single address. This kernel does the
// whole z-buffer half of the splat in one launch over the live rows only.
//
// What bounds it on an H100. A grid-stride loop over a grid sized to the
// card covers rows [0, count), with `count` read on the device (the
// registry's 0-d counter; no host read). A row is live where its key is
// >= 0. Each thread decodes its key's octant triples into the leaf centre,
// transforms and projects it, and packs quantized-depth << 16 | RGB565, all
// in registers: 8 B read a row (key and word), coalesced. A row out of
// view, behind the camera, past max_range or unoccupied does nothing. An
// in-view row reads its pixel's current word and issues atomicMin only
// where its word is smaller. Words only fall, so a stale read is never
// below the pixel's word and skipping on it is safe; min does not depend
// on order, so the z-buffer equals the plain version's word for word
// whatever the schedule. The 307,200-word image stays in L2. The caller
// fills the image with EMPTY (one fill launch) before this kernel runs.
//
// Float semantics follow the plain version on the card op for op: the
// centre as morton.decode_centers walks it (e *= 0.5, then c + (+-e) per
// axis); the camera point as the cuBLAS SIMT sgemm computes (centers - t)
// @ R, a fused multiply-add chain over k = 0, 1, 2 from zero; IEEE
// division; rintf for torch.round and truncation for the conversion to
// int32 (cvt.rzi, saturating, as PyTorch's conversion); the same clamp;
// the Python scalars as PyTorch rounds them to float32 (fx, fy, width / 2,
// height / 2, max_range, 32766 / max_range, 1e-3). Build with
// --fmad=false so that no other product is contracted into a sum.
//
// Interface: an extern "C" launcher taking raw device pointers, sizes and
// a cudaStream_t; it returns cudaGetLastError() after its launch. Loaded
// with ctypes by octree_slam_tpu_torch/_build.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// the deepest key: 30-bit Morton keys in an int32
constexpr int kMaxDepth = 10;
// resident threads a multiprocessor on sm_90
constexpr int kThreadsPerSM = 2048;

// keys, vals: i32[n]; count: i32[] or null (then every row is a
// candidate); center: f32[3]; half_size: f32[]; pose: f32[4, 4] at
// strides (s0, s1). Lowers buf's words (i32[width * height], filled by
// the caller); when `stats` is not null adds the live rows to stats[0]
// and the rows that issued an atomicMin to stats[1].
__global__ void __launch_bounds__(kThreads) splat_zbuffer_kernel(
    const int32_t* __restrict__ keys, const int32_t* __restrict__ vals,
    const int32_t* __restrict__ count, int n,
    const float* __restrict__ center, const float* __restrict__ half_size,
    const float* __restrict__ pose, int s0, int s1, float fx, float fy,
    float half_w, float half_h, int width, int height, int depth,
    float max_range, float z_scale, int32_t* __restrict__ buf,
    unsigned long long* __restrict__ stats) {
  const int rows = count != nullptr ? min(max(*count, 0), n) : n;
  float R[3][3], t[3], c0[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R[k][j] = pose[k * s0 + j * s1];
    t[k] = pose[k * s0 + 3 * s1];
    c0[k] = center[k];
  }
  const float hs = *half_size;
  unsigned live = 0, atomics = 0;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < rows;
       i += gridDim.x * kThreads) {
    const int32_t key = keys[i];
    if (key < 0) continue;
    ++live;
    const int32_t value = vals[i];
    // occupied iff alpha > 127
    if (((value >> 24) & 0xff) <= 127) continue;
    float c[3] = {c0[0], c0[1], c0[2]};
    float e = hs;
    for (int level = 0; level < depth; ++level) {
      const int octant = (key >> (3 * (depth - 1 - level))) & 7;
      e = e * 0.5f;
      c[0] = c[0] + ((octant & 1) ? e : -e);
      c[1] = c[1] + ((octant & 2) ? e : -e);
      c[2] = c[2] + ((octant & 4) ? e : -e);
    }
    float cam[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float acc = __fmaf_rn(c[0] - t[0], R[0][j], 0.0f);
      acc = __fmaf_rn(c[1] - t[1], R[1][j], acc);
      cam[j] = __fmaf_rn(c[2] - t[2], R[2][j], acc);
    }
    const float z = cam[2];
    if (!(z > 1e-3f && z < max_range)) continue;
    const int px = __float2int_rz(
        rintf(__fdiv_rn(fx * cam[0], z) + half_w));
    const int py = __float2int_rz(
        rintf(half_h - __fdiv_rn(fy * cam[1], z)));
    if (px < 0 || px >= width || py < 0 || py >= height) continue;
    const int qz =
        __float2int_rz(fminf(fmaxf(z * z_scale, 0.0f), 32766.0f));
    const int r = value & 0xff, g = (value >> 8) & 0xff,
              b = (value >> 16) & 0xff;
    const int32_t word =
        (qz << 16) | ((r >> 3) << 11) | ((g >> 2) << 5) | (b >> 3);
    int32_t* slot = buf + py * width + px;
    if (word < __ldcg(slot)) {
      atomicMin(slot, word);
      ++atomics;
    }
  }
  if (stats != nullptr) {
    // the block's sums, one atomic a block and counter
    __shared__ unsigned warp_sums[2][kThreads / 32];
    const unsigned l = __reduce_add_sync(0xffffffffu, live);
    const unsigned a = __reduce_add_sync(0xffffffffu, atomics);
    if ((threadIdx.x & 31) == 0) {
      warp_sums[0][threadIdx.x >> 5] = l;
      warp_sums[1][threadIdx.x >> 5] = a;
    }
    __syncthreads();
    if (threadIdx.x < 2) {
      unsigned long long block = 0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w)
        block += warp_sums[threadIdx.x][w];
      if (block) atomicAdd(stats + threadIdx.x, block);
    }
  }
}

// Sets *blocks to the blocks that fill the current device once: its
// multiprocessors times the blocks of kThreads resident on each.
cudaError_t card_blocks(int* blocks) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cached[dev] = sms * (kThreadsPerSM / kThreads);
  }
  *blocks = cached[dev];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// keys, vals: i32[n]; count: i32[] or null; center: f32[3]; half_size:
// f32[]; pose: f32[4, 4] at strides (s0, s1); buf: i32[width * height],
// filled with EMPTY by the caller; stats: int64[2] zeroed, or null. All on
// the current device.
int oslam_splat_zbuffer(const void* keys, const void* vals,
                        const void* count, int n, const void* center,
                        const void* half_size, const void* pose, int s0,
                        int s1, float fx, float fy, float half_w,
                        float half_h, int width, int height, int depth,
                        float max_range, float z_scale, void* buf,
                        void* stats, void* stream) {
  if (depth < 1 || depth > kMaxDepth || n < 0 || width <= 0 || height <= 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int card = 0;
  const cudaError_t err = card_blocks(&card);
  if (err != cudaSuccess) return (int)err;
  const int need = (n + kThreads - 1) / kThreads;
  const dim3 grid(need < card ? need : card);
  splat_zbuffer_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)keys, (const int32_t*)vals, (const int32_t*)count, n,
      (const float*)center, (const float*)half_size, (const float*)pose, s0,
      s1, fx, fy, half_w, half_h, width, height, depth, max_range, z_scale,
      (int32_t*)buf, (unsigned long long*)stats);
  return (int)cudaGetLastError();
}

}  // extern "C"
