// The hybrid renderer's edge-band march, hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The reference runs the band's trips as one
// lax.while_loop (octree_slam_tpu/render/hybrid.py:420), which XLA compiles
// into one device loop; the port's plain version of the same trips
// (render/hybrid.py, _trips_eager) is a Python loop of ~78 small PyTorch
// launches a trip, ~1,900 a frame at the production shape (57,600 lanes x
// 24 trips), whose host time set the cell's frame. This kernel runs the
// fixed-trip, single-sample march of render/hybrid.py in one launch.
//
// What bounds it on an H100. One thread a lane, every trip in registers:
// the position, the leaf quantisation, the Morton leaf index by bit
// interleave, one gather of the dense mirror's leaf word (a second of the
// dist field without fused_dist), the exit length, the guaranteed-free
// skip and the accumulation. The trips of a lane are a dependent chain of
// gathers from a 0.6 GB mirror, so the kernel is bound by the latency of
// those gathers, not by bandwidth: 57,600 lanes fit on the card at once
// (132 SMs x 2,048 threads), and each waits for about 24 gathers in turn.
// Its byte bound charges each gather one 32-byte sector. A lane stops at
// its first inactive trip: the plain version leaves an inactive lane's t,
// rgb and w exactly as they are, so stopping changes no output.
//
// Float semantics follow the plain version on the card op for op, so the
// outputs are equal word for word: the constants derive from the pool's
// 0-d half_size as the plain version's tensor ops do (a product with a
// Python number is a product with its float32 value; a quotient by a
// Python number, in PyTorch's CUDA true division, is a product with the
// float32 reciprocal of its float32 value; a quotient by a tensor is IEEE
// division; `127.0 / x` is x.reciprocal() * 127.0); float -> int32 by
// truncation (cvt.rzi, as PyTorch's conversion), floor, clamp; the exit
// length the minimum over the axes the ray moves along, +inf on the
// others; the skip ((d - 1) * cell_l) / linf. Build with --fmad=false so
// no product is contracted into the following sum.
//
// Interface: an extern "C" launcher taking raw device pointers, sizes and
// a cudaStream_t; it returns cudaGetLastError() after its launch. Loaded
// with ctypes by octree_slam_tpu_torch/_build.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// the deepest leaf level: 30-bit Morton keys, and the leaf's flat index
// (level_offset(depth) + key) stays inside int32
constexpr int kMaxDepth = 10;

// The low 10 bits of x spread to every third bit: the entry of
// raycast._spread3's table.
__device__ __forceinline__ uint32_t spread3(uint32_t x) {
  x &= 0x3ffu;
  x = (x | (x << 16)) & 0x030000ffu;
  x = (x | (x << 8)) & 0x0300f00fu;
  x = (x | (x << 4)) & 0x030c30c3u;
  x = (x | (x << 2)) & 0x09249249u;
  return x;
}

// clamp(floor((pos - lo) / cell).to(int32), 0, n - 1)
__device__ __forceinline__ int quantize(float pos, float lo, float cell,
                                        int n) {
  const int q = (int)floorf(__fdiv_rn(pos - lo, cell));
  return min(max(q, 0), n - 1);
}

// dirs, inv_dirs: f32[C, 3]; limit, start: f32[C]; miss: bool[C];
// values: the mirror's i32 words; dist: i32[G^3] (read only without
// kFused); origin: f32[3] at a stride of origin_stride; center: f32[3];
// half_size: f32[]. Writes rgb f32[C, 3], w f32[C], active bool[C] and,
// when `live` is not null, adds the lane-trips that marched to *live.
template <bool kFused>
__global__ void __launch_bounds__(kThreads) band_march_kernel(
    const float* __restrict__ dirs, const float* __restrict__ inv_dirs,
    const float* __restrict__ limit, const float* __restrict__ start,
    const uint8_t* __restrict__ miss, const int32_t* __restrict__ values,
    const int32_t* __restrict__ dist, const float* __restrict__ origin,
    int origin_stride, const float* __restrict__ center,
    const float* __restrict__ half_size, int C, int depth, int dist_level,
    int iters, float max_range, float* __restrict__ rgb_out,
    float* __restrict__ w_out, uint8_t* __restrict__ active_out,
    unsigned long long* __restrict__ live) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  unsigned trips = 0;
  if (lane < C) {
    // the march's constants as the plain version derives them
    const float hs = *half_size;
    const float two_hs = 2.0f * hs;
    const float leaf_cell = two_hs * (1.0f / (float)(1 << depth));
    const float cell_l = two_hs * (1.0f / (float)(1 << dist_level));
    const float eps = 0.05f * leaf_cell;
    const float min_step = 0.25f * leaf_cell;
    const int n_leaf = 1 << depth;
    const int shift_l = depth - dist_level;
    const int32_t leaf_off = ((1 << (3 * depth)) - 8) / 7;

    float o[3], lo[3], d[3], inv[3];
    bool moves[3], forward[3];
    float linf = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[k] = origin[k * origin_stride];
      lo[k] = center[k] - hs;
      d[k] = dirs[3 * lane + k];
      inv[k] = inv_dirs[3 * lane + k];
      moves[k] = fabsf(d[k]) > 1e-9f;
      forward[k] = d[k] > 0.0f;
      linf = fmaxf(linf, fabsf(d[k]));
    }
    linf = fmaxf(linf, 1e-6f);

    const bool missed = miss[lane] != 0;
    const float lim = limit[lane];
    float t = missed ? max_range : start[lane];
    float w = missed ? 255.0f : 0.0f;
    float rgb[3] = {0.0f, 0.0f, 0.0f};
    bool active = !missed;
    for (int i = 0; i < iters && active; ++i) {
      ++trips;
      float pos[3];
      int q[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        pos[k] = o[k] + d[k] * t;
        q[k] = quantize(pos[k], lo[k], leaf_cell, n_leaf);
      }
      const int32_t leaf = leaf_off + (int32_t)(spread3(q[0])
                                                | (spread3(q[1]) << 1)
                                                | (spread3(q[2]) << 2));
      const int32_t word = __ldg(values + (int64_t)leaf);
      const int col[3] = {word & 0xff, (word >> 8) & 0xff,
                          (word >> 16) & 0xff};
      const int a = (word >> 24) & 0xff;
      int dd;
      if (kFused) {
        // a free cell's stamp in the low byte; an occupied leaf (alpha
        // above OCCUPIED_ALPHA) sits in a distance-0 cell
        dd = a > 127 ? 0 : col[0];
      } else {
        const int cx = q[0] >> shift_l, cy = q[1] >> shift_l,
                  cz = q[2] >> shift_l;
        dd = __ldg(dist + (int64_t)((cz << (2 * dist_level))
                                    | (cy << dist_level) | cx));
      }
      const bool free = dd > 0;
      const float alpha = free ? 0.0f : (float)max(a - 127, 0);
      const int shift = free ? shift_l : 0;
      const float cell = free ? cell_l : leaf_cell;
      // ray length to the exit of the sampled cell (the dist cell when
      // free), over the axes the ray moves along
      float t_exit = INFINITY;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (moves[k]) {
          const float corner = lo[k] + (float)(q[k] >> shift) * cell;
          const float gap = forward[k] ? (corner + cell) - pos[k]
                                       : corner - pos[k];
          t_exit = fminf(t_exit, gap * inv[k]);
        }
      }
      t_exit = fmaxf(t_exit, 0.0f);
      const float skip =
          free ? __fdiv_rn((float)(dd - 1) * cell_l, linf) : 0.0f;
      const float t_next = t + fmaxf(t_exit + skip + eps, min_step);

      // the sample into the lane: accumulation, saturation at w >= 127,
      // the 127/w rescale of a ray that leaves the range
      const float a127 = alpha * (1.0f / 127.0f);
#pragma unroll
      for (int k = 0; k < 3; ++k) rgb[k] = rgb[k] + a127 * (float)col[k];
      const float w_new = w + alpha;
      const bool saturated = w_new >= 127.0f;
      w = saturated ? 255.0f : w_new;
      t = t_next;
      const bool oor = !saturated && t_next > lim;
      if (oor) {
        const float scale = __frcp_rn(fmaxf(w, 1.0f)) * 127.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) rgb[k] = rgb[k] * scale;
        w = 255.0f;
      }
      active = !saturated && !oor;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) rgb_out[3 * lane + k] = rgb[k];
    w_out[lane] = w;
    active_out[lane] = active ? 1 : 0;
  }
  if (live != nullptr) {
    // the block's lane-trips, one atomic a block
    __shared__ unsigned warp_trips[kThreads / 32];
    const unsigned sum = __reduce_add_sync(0xffffffffu, trips);
    if ((threadIdx.x & 31) == 0) warp_trips[threadIdx.x >> 5] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long block = 0;
#pragma unroll
      for (int i = 0; i < kThreads / 32; ++i) block += warp_trips[i];
      if (block) atomicAdd(live, block);
    }
  }
}

}  // namespace

extern "C" {

// dirs, inv_dirs: f32[C, 3]; limit, start: f32[C]; miss: bool[C]; values:
// i32 mirror words; dist: i32 dist field (may be null with fused != 0);
// origin: f32[3] at stride origin_stride; center: f32[3]; half_size: f32[];
// rgb: f32[C, 3]; w: f32[C]; active: bool[C]; live: int64[] or null. All
// contiguous on the current device but origin.
int oslam_band_march(const void* dirs, const void* inv_dirs,
                     const void* limit, const void* start, const void* miss,
                     const void* values, const void* dist, const void* origin,
                     int origin_stride, const void* center,
                     const void* half_size, int C, int depth, int dist_level,
                     int iters, float max_range, int fused, void* rgb,
                     void* w, void* active, void* live, void* stream) {
  if (depth < 1 || depth > kMaxDepth || dist_level < 0 || dist_level > depth
      || iters < 0 || (!fused && dist == nullptr))
    return (int)cudaErrorInvalidValue;
  if (C <= 0) return (int)cudaSuccess;
  const dim3 grid((C + kThreads - 1) / kThreads);
  const cudaStream_t st = (cudaStream_t)stream;
  auto kernel = fused ? &band_march_kernel<true> : &band_march_kernel<false>;
  kernel<<<grid, kThreads, 0, st>>>(
      (const float*)dirs, (const float*)inv_dirs, (const float*)limit,
      (const float*)start, (const uint8_t*)miss, (const int32_t*)values,
      (const int32_t*)dist, (const float*)origin, origin_stride,
      (const float*)center, (const float*)half_size, C, depth, dist_level,
      iters, max_range, (float*)rgb, (float*)w, (uint8_t*)active,
      (unsigned long long*)live);
  return (int)cudaGetLastError();
}

}  // extern "C"
