// Sensor stencils of the depth pyramid, hand-written for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels built by _window_call in
// octree_slam_tpu/sensor/pallas_ops.py (pl.pallas_call at :112):
//
//   bilateral7x7      <- pallas_ops.bilateral (:149), kind "bilateral"
//   bilateral_window  <- the XLA path of image_ops.bilateral_filter
//                        (:88-117), the bilateral of any other window size
//   gated_pyramid5x5  <- pallas_ops.gated_window_mean (:160), kind "gated",
//                        plus the caller's decimation in
//                        image_ops.subsample_depth (:129-133), for one or
//                        two pyramid levels in one launch
//
// What bounds them on an H100. The bilateral of radius r does (2r + 1)^2
// exp-weighted taps per pixel (49 at the 7x7) and moves 2.5 MB at 480x640:
// it is bound by instruction issue (about 15 instructions a tap, one of
// them the MUFU exp2 inside expf) and by the latency of each tap's
// dependent chain, not by memory. One engine, compiled for each radius
// 1..6 (bilateral7x7 is its radius-3 instance), cuts everything around the
// taps and keeps many taps in flight: each thread computes a run of
// outputs along x and keeps the neighbour values of one window row in
// registers (a few 8- or 16-byte shared loads per row and the row's
// spatial weights as 16-byte loads: at the 7x7, about 0.4 shared loads per
// tap); it forms all exp arguments of a row before any exp, so they issue
// back to back; the spatial weights sit in registers, indexed by |dx| at
// compile time; blocks whose window lies inside the image run a variant
// with no bounds test; the tile is staged with 16-byte loads, every load of
// a thread issued before the first store, and no per-element divide.
// Radii above 6 run a simple kernel with the radius known at run time: one
// output a thread, every tap bounds-tested.
//
// The gated pyramid moves 1.6 MB for two levels and is bound by latency:
// launch, the first load from device memory, one barrier. One launch makes
// both levels. Each block stages the L0 region it needs in shared memory,
// computes its L1 tile plus a 2-pixel L1 halo there (neighbouring blocks
// recompute the halo, bit for bit the same), writes the L1 tile, and
// computes its L2 tile from shared memory, so L1 never goes through device
// memory on its way to L2. Only the kept (2y, 2x) pixels are computed, not
// the full-resolution pass the TPU kernel decimated afterwards. Blocks of
// 512 threads give each thread at most one L1 pixel (each 5x5 mean is a
// serial chain of adds) and one pass of staging loads.
//
// Float semantics follow the plain PyTorch versions in sensor/cuda_ops.py
// term by term: the same tap order for each output (dy outer, dx inner),
// the same expression for the weight, IEEE division, rintf (round half to
// even, as torch.round), truncation toward zero for the subsample. Build
// with --fmad=false so s1 + nb * wgt rounds twice like the plain version,
// and without --use_fast_math (expf, not __expf). Out-of-image taps are
// decided by coordinate: depth 0 inside the image is data, so staged
// padding (0) is never taken for a sentinel.
//
// Interface: extern "C" launchers taking raw device pointers, sizes and a
// cudaStream_t; each returns cudaGetLastError() after its launch. Loaded
// with ctypes by octree_slam_tpu_torch/_build.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Stage rows [gy0, gy0 + rows) (rows <= kRows) and the kGroups 4-column
// groups from column gx0 (a multiple of 4) of an int32 plane as float into
// `tile` (row stride kStride floats, 16-byte aligned). Each of the block's
// kThreads threads takes one group in kThreads / kGroups rows per pass and
// issues every load before its first shared store, so the block waits for
// device memory once. With `vec` (W % 4 == 0 and a 16-byte aligned plane)
// a group lies wholly inside or outside the image and is one 16-byte load.
// Entries outside the image are 0; readers mask them by coordinate.
template <int kRows, int kGroups, int kStride, int kThreads>
__device__ __forceinline__ void stage(float* __restrict__ tile,
                                      const int32_t* __restrict__ src,
                                      int H, int W, int gy0, int gx0,
                                      int rows, bool vec) {
  constexpr int kPerPass = kThreads / kGroups;
  constexpr int kPasses = (kRows + kPerPass - 1) / kPerPass;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int tr = tid / kGroups, tg = tid - tr * kGroups;   // once a thread
  const int gx = gx0 + 4 * tg;
  const bool active = tr < kPerPass;
  int4 q[kPasses];
#pragma unroll
  for (int k = 0; k < kPasses; ++k) {
    const int gy = gy0 + tr + k * kPerPass;
    q[k] = make_int4(0, 0, 0, 0);
    if (!active || tr + k * kPerPass >= rows || gy < 0 || gy >= H) continue;
    const int32_t* p = src + (size_t)gy * W;
    if (vec) {
      if (gx >= 0 && gx < W)
        q[k] = __ldg(reinterpret_cast<const int4*>(p + gx));
    } else {
      if (gx >= 0 && gx < W) q[k].x = __ldg(p + gx);
      if (gx + 1 >= 0 && gx + 1 < W) q[k].y = __ldg(p + gx + 1);
      if (gx + 2 >= 0 && gx + 2 < W) q[k].z = __ldg(p + gx + 2);
      if (gx + 3 >= 0 && gx + 3 < W) q[k].w = __ldg(p + gx + 3);
    }
  }
#pragma unroll
  for (int k = 0; k < kPasses; ++k) {
    const int r = tr + k * kPerPass;
    if (active && r < rows)
      *reinterpret_cast<float4*>(tile + r * kStride + 4 * tg) = make_float4(
          (float)q[k].x, (float)q[k].y, (float)q[k].z, (float)q[k].w);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// kN consecutive floats or ints as one vector load or store
template <int kN> struct Vec;
template <> struct Vec<2> { using F = float2; using I = int2; };
template <> struct Vec<4> { using F = float4; using I = int4; };

// ---------------------------------------------------------------- bilateral

// (kRun, kTileH, kRowUnroll) of the instance of each radius 1..kMaxHalf,
// tuned on an H100 at 480x640 (PERF.md; examples/
// compare_stencil_kernels.py --shape): outputs a thread computes along x,
// output rows a block computes, and the unroll of the loop over window
// rows (2 * radius + 1 unrolls it fully). Runs of 4 and blocks of 8 or 32
// rows were slower at every radius: 32x16-output blocks make one wave at
// 480x640 (600 blocks of 256 threads, all resident at once). The unroll
// that won differs by radius; radius 3 is bilateral7x7.
struct WindowShape { int run, tile_h, row_unroll; };
constexpr int kMaxHalf = 6;
constexpr WindowShape kWindowShapes[kMaxHalf + 1] = {
    {0, 0, 0}, {2, 16, 3}, {2, 16, 5}, {2, 16, 1}, {2, 16, 4}, {2, 16, 2},
    {2, 16, 1}};

// The register-tiled bilateral, compiled for one radius kHalf (window
// kTaps x kTaps). A block of 16 x kTileH threads computes a kTileH x kTileW
// output tile; each thread computes a run of kRun outputs along x.
template <int kHalf>
struct BilateralShape {
  static constexpr int kRun = kWindowShapes[kHalf].run;
  static constexpr int kTileH = kWindowShapes[kHalf].tile_h;
  static constexpr int kRowUnroll = kWindowShapes[kHalf].row_unroll;
  static constexpr int kTaps = 2 * kHalf + 1;
  static constexpr int kBx = 16, kBy = kTileH;          // threads per block
  static constexpr int kThreads = kBx * kBy;
  static constexpr int kTileW = kBx * kRun;             // output columns
  // staged columns left of the tile: the window's reach rounded up to 4,
  // so the staged span starts on a 16-byte boundary of the image row
  static constexpr int kPad = 4 * ((kHalf + 3) / 4);
  static constexpr int kSpanH = kTileH + 2 * kHalf;     // staged rows
  static constexpr int kSpanW = kTileW + 2 * kPad;      // staged columns
  // a thread reads kSeg values of each window row from staged column
  // kRun tx + kLo (column x0 - kPad + kLo of the image), kLo a multiple of
  // kRun so that every read is one aligned vector load
  static constexpr int kLo = (kPad - kHalf) / kRun * kRun;
  static constexpr int kSeg =
      (kPad + kHalf + kRun - kLo + kRun - 1) / kRun * kRun;
  // the spatial weights of one window row, by |dx|, padded to float4s
  static constexpr int kSpRow = 4 * ((kHalf + 4) / 4);
  static_assert(kRun == 2 || kRun == 4, "kRun is a vector width");
  static_assert(kTaps * kSpRow <= kThreads, "one thread a spatial weight");
  static_assert(kSeg <= 32 && kTaps <= 32, "bit masks of 32 bits");
};

// The kTaps x kTaps taps of one thread's run of kRun outputs. `row0` points
// at the thread's first staged value (tile row of dy = -kHalf, column
// x0 - kPad + kLo); the neighbour of output j at dx sits at
// v[j + dx + kPad - kLo]. kBorder tests each tap against the image by
// coordinate: bit i of row_ok is window row i, bit k of col_ok is column
// x0 - kPad + kLo + k.
template <int kHalf, bool kBorder, int kRun = BilateralShape<kHalf>::kRun>
__device__ __forceinline__ void bilateral_taps(
    const float* __restrict__ row0, const float* __restrict__ space,
    float sig_d, const float (&c)[kRun], unsigned row_ok, unsigned col_ok,
    float (&s1)[kRun], float (&s2)[kRun]) {
  using S = BilateralShape<kHalf>;
  constexpr int kOff = S::kPad - S::kLo;
  // the loop over window rows, unrolled kRowUnroll times (kRun x kTaps
  // taps a trip): a runtime loop keeps the code small
#pragma unroll (S::kRowUnroll)
  for (int i = 0; i < S::kTaps; ++i) {
    if (kBorder && !((row_ok >> i) & 1u)) continue;
    const float* row = row0 + i * S::kSpanW;
    float v[S::kSeg];
#pragma unroll
    for (int q = 0; q < S::kSeg / kRun; ++q) {
      const typename Vec<kRun>::F f =
          *reinterpret_cast<const typename Vec<kRun>::F*>(row + kRun * q);
#pragma unroll
      for (int e = 0; e < kRun; ++e)
        v[kRun * q + e] = reinterpret_cast<const float*>(&f)[e];
    }
    float sp[S::kSpRow];                                   // by |dx|
#pragma unroll
    for (int q = 0; q < S::kSpRow / 4; ++q) {
      const float4 f =
          *reinterpret_cast<const float4*>(space + i * S::kSpRow + 4 * q);
      sp[4 * q] = f.x;
      sp[4 * q + 1] = f.y;
      sp[4 * q + 2] = f.z;
      sp[4 * q + 3] = f.w;
    }
    // all exp arguments of the row, then all exps, then the sums in tap
    // order: the kRun x kTaps exps are independent and issue back to back
    // (the sums alone are a serial chain). Out-of-image taps get a weight
    // that is never added.
    float wg[kRun][S::kTaps];
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
#pragma unroll
      for (int dx = -kHalf; dx <= kHalf; ++dx) {
        const float diff = c[j] - v[j + dx + kOff];
        wg[j][dx + kHalf] = -(sp[dx < 0 ? -dx : dx] + diff * diff * sig_d);
      }
    }
#pragma unroll
    for (int j = 0; j < kRun; ++j)
#pragma unroll
      for (int dx = 0; dx < S::kTaps; ++dx) wg[j][dx] = expf(wg[j][dx]);
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
#pragma unroll
      for (int dx = -kHalf; dx <= kHalf; ++dx) {
        const int k = j + dx + kOff;
        if (kBorder && !((col_ok >> k) & 1u)) continue;
        const float nb = v[k];
        const float wgt = wg[j][dx + kHalf];
        s1[j] = s1[j] + nb * wgt;
        s2[j] = s2[j] + wgt;
      }
    }
  }
}

// Thread (tx, ty) computes row ty, columns kRun tx .. kRun tx + kRun - 1 of
// the block's tile; blockIdx.z is the batch index.
template <int kHalf>
__global__ void __launch_bounds__(BilateralShape<kHalf>::kThreads)
    bilateral_kernel(const int32_t* __restrict__ in,
                     int32_t* __restrict__ out, int H, int W, double sig_s,
                     float sig_d, bool vec) {
  using S = BilateralShape<kHalf>;
  constexpr int kRun = S::kRun, kTileH = S::kTileH;
  __shared__ __align__(16) float tile[S::kSpanH * S::kSpanW];
  __shared__ __align__(16) float space[S::kTaps * S::kSpRow];
  const size_t plane = (size_t)H * W;
  const int32_t* src = in + blockIdx.z * plane;
  int32_t* dst = out + blockIdx.z * plane;
  const int bx0 = blockIdx.x * S::kTileW, by0 = blockIdx.y * kTileH;

  // space[i][a] = (dx^2 + dy^2) * sig_s for |dx| = a, dy = i - kHalf:
  // formed in double and rounded once to float, as the plain version's
  // Python scalar is when it meets a float32 tensor
  const int tid = threadIdx.y * S::kBx + threadIdx.x;
  if (tid < S::kTaps * S::kSpRow) {
    const int dy = tid / S::kSpRow - kHalf, a = tid % S::kSpRow;
    space[tid] = a <= kHalf ? (float)((double)(a * a + dy * dy) * sig_s)
                            : 0.0f;
  }
  stage<S::kSpanH, S::kSpanW / 4, S::kSpanW, S::kThreads>(
      tile, src, H, W, by0 - kHalf, bx0 - S::kPad, S::kSpanH, vec);
  __syncthreads();

  const int y = by0 + threadIdx.y;
  const int x0 = bx0 + kRun * threadIdx.x;
  const float* row0 =
      tile + threadIdx.y * S::kSpanW + kRun * threadIdx.x + S::kLo;
  float c[kRun], s1[kRun], s2[kRun];
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    c[j] = row0[kHalf * S::kSpanW + S::kPad - S::kLo + j];
    s1[j] = 0.0f;
    s2[j] = 0.0f;
  }
  const bool interior = bx0 >= kHalf && bx0 + S::kTileW + kHalf <= W &&
                        by0 >= kHalf && by0 + kTileH + kHalf <= H;
  if (interior) {
    bilateral_taps<kHalf, false>(row0, space, sig_d, c, 0u, 0u, s1, s2);
  } else {
    unsigned row_ok = 0u, col_ok = 0u;
#pragma unroll
    for (int i = 0; i < S::kTaps; ++i) {
      const int gy = y - kHalf + i;
      row_ok |= (unsigned)(gy >= 0 && gy < H) << i;
    }
#pragma unroll
    for (int k = 0; k < S::kSeg; ++k) {
      const int gx = x0 - S::kPad + S::kLo + k;
      col_ok |= (unsigned)(gx >= 0 && gx < W) << k;
    }
    bilateral_taps<kHalf, true>(row0, space, sig_d, c, row_ok, col_ok, s1,
                                s2);
  }
  if (y >= H) return;
  // the centre tap has weight 1, so s2 >= 1 for every output in the image
  typename Vec<kRun>::I rv;
  int* r = reinterpret_cast<int*>(&rv);
#pragma unroll
  for (int j = 0; j < kRun; ++j) r[j] = (int)rintf(s1[j] / s2[j]);
  int32_t* o = dst + (size_t)y * W + x0;
  if (vec && x0 + kRun <= W) {
    *reinterpret_cast<typename Vec<kRun>::I*>(o) = rv;
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j)
      if (x0 + j < W) o[j] = r[j];
  }
}

template <int kHalf>
cudaError_t launch_bilateral(const void* in, void* out, int B, int H, int W,
                             double sig_s, float sig_d, cudaStream_t stream) {
  using S = BilateralShape<kHalf>;
  const bool vec = W % 4 == 0 && aligned16(in) && aligned16(out);
  const dim3 block(S::kBx, S::kBy);
  const dim3 grid((W + S::kTileW - 1) / S::kTileW,
                  (H + S::kTileH - 1) / S::kTileH, B);
  bilateral_kernel<kHalf><<<grid, block, 0, stream>>>(
      (const int32_t*)in, (int32_t*)out, H, W, sig_s, sig_d, vec);
  return cudaGetLastError();
}

// ------------------------------------------------- bilateral, radius > 6

// The bilateral of a radius `half` above kMaxHalf, known at run time. A
// simple kernel: each thread computes one output with the taps in the plain
// version's order, from a (kWinTileH + 2 half) x (kWinTileW + 2 half) tile
// staged in dynamic shared memory, and every tap tests the image by
// coordinate. At a radius r it does (2r + 1)^2 exp-weighted taps a pixel
// over the same 8 bytes a pixel as the kernels above, so it is bound by
// instruction issue as they are.
constexpr int kWinTileW = 32;              // output columns per block
constexpr int kWinTileH = 16;              // output rows per block

__host__ __device__ inline int win_smem_floats(int half) {
  const int taps = 2 * half + 1;
  return (kWinTileH + 2 * half) * (kWinTileW + 2 * half) + taps * taps;
}

__global__ void __launch_bounds__(kWinTileW * kWinTileH)
    bilateral_window_kernel(const int32_t* __restrict__ in,
                            int32_t* __restrict__ out, int H, int W,
                            int half, double sig_s, float sig_d) {
  extern __shared__ __align__(16) float win_smem[];
  const int taps = 2 * half + 1;
  const int span_w = kWinTileW + 2 * half, span_h = kWinTileH + 2 * half;
  float* tile = win_smem;
  float* space = win_smem + span_h * span_w;
  const size_t plane = (size_t)H * W;
  const int32_t* src = in + blockIdx.z * plane;
  int32_t* dst = out + blockIdx.z * plane;
  const int bx0 = blockIdx.x * kWinTileW, by0 = blockIdx.y * kWinTileH;
  const int tid = threadIdx.y * kWinTileW + threadIdx.x;
  constexpr int kThreads = kWinTileW * kWinTileH;

  // space[i * taps + j] = (dx^2 + dy^2) * sig_s for dy = i - half,
  // dx = j - half: formed in double and rounded once to float, as the
  // plain version's Python scalar is when it meets a float32 tensor
  for (int k = tid; k < taps * taps; k += kThreads) {
    const int dy = k / taps - half, dx = k % taps - half;
    space[k] = (float)((double)(dx * dx + dy * dy) * sig_s);
  }
  // entries outside the image are 0; the taps test the image by coordinate
  for (int k = tid; k < span_h * span_w; k += kThreads) {
    const int r = k / span_w, c = k - r * span_w;
    const int gy = by0 - half + r, gx = bx0 - half + c;
    tile[k] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                  ? (float)__ldg(src + (size_t)gy * W + gx)
                  : 0.0f;
  }
  __syncthreads();

  const int y = by0 + threadIdx.y, x = bx0 + threadIdx.x;
  if (y >= H || x >= W) return;
  // the window's top-left tap; the centre is `half` rows and columns in
  const float* t = tile + threadIdx.y * span_w + threadIdx.x;
  const float c = t[half * span_w + half];
  float s1 = 0.0f, s2 = 0.0f;
  for (int i = 0; i < taps; ++i) {
    const int gy = y - half + i;
    if (gy < 0 || gy >= H) continue;
    for (int j = 0; j < taps; ++j) {
      const int gx = x - half + j;
      if (gx < 0 || gx >= W) continue;
      const float nb = t[i * span_w + j];
      const float diff = c - nb;
      const float wgt = expf(-(space[i * taps + j] + diff * diff * sig_d));
      s1 = s1 + nb * wgt;
      s2 = s2 + wgt;
    }
  }
  // the centre tap has weight 1, so s2 >= 1
  dst[(size_t)y * W + x] = (int)rintf(s1 / s2);
}

// ------------------------------------------------------------ gated pyramid

constexpr int kGx = 32, kGy = 16;          // threads per block
constexpr int kL1W = 28, kL1H = 8;         // L1 tile a block owns
constexpr int kL1Halo = 2;                 // L1 halo the L2 pass reads
constexpr int kR1W = kL1W + 2 * kL1Halo;   // 32: L1 region with the halo
constexpr int kR1H = kL1H + 2 * kL1Halo;   // 12
constexpr int kS0W = 2 * kR1W + 8;         // 72 staged L0 columns (at most)
constexpr int kS0H = 2 * kR1H + 3;         // 27 staged L0 rows (at most)

// The gated 5x5 mean at the kept pixel whose centre is t[0] in a staged
// float tile of row stride `stride`: the in-image neighbours (the centre is
// at (cy, cx) of an h x w image) within `gate` of the centre, 0 when none
// pass, truncated toward zero. Every term is an integer and the sums stay
// below 2^24, so they are exact in float.
__device__ __forceinline__ int gated_mean(const float* __restrict__ t,
                                          int stride, int cy, int cx, int h,
                                          int w, float gate) {
  const float c = t[0];
  float s = 0.0f, cnt = 0.0f;
#pragma unroll
  for (int dy = -2; dy <= 2; ++dy) {
    if (cy + dy < 0 || cy + dy >= h) continue;
#pragma unroll
    for (int dx = -2; dx <= 2; ++dx) {
      if (cx + dx < 0 || cx + dx >= w) continue;
      const float nb = t[dy * stride + dx];
      if (fabsf(nb - c) < gate) {
        s = s + nb;
        cnt = cnt + 1.0f;
      }
    }
  }
  const float mean = cnt > 0.0f ? s / fmaxf(cnt, 1.0f) : 0.0f;
  return (int)mean;
}

// levels == 1: out1 = subsample(in). levels == 2: also out2 =
// subsample(out1), from the block's L1 region in shared memory. A block
// owns the L1 tile at (kL1H * by, kL1W * bx) and the L2 tile at half those
// coordinates; blockIdx.z is the batch index.
__global__ void __launch_bounds__(kGx * kGy)
    gated_pyramid5x5_kernel(const int32_t* __restrict__ in,
                            int32_t* __restrict__ out1,
                            int32_t* __restrict__ out2, int H, int W,
                            float gate, int levels, bool vec) {
  __shared__ __align__(16) float l0[kS0H * kS0W];
  __shared__ float l1[kR1H * kR1W];
  const int H1 = H / 2, W1 = W / 2;
  const int halo = levels == 2 ? kL1Halo : 0;
  const int rh = kL1H + 2 * halo, rw = kL1W + 2 * halo;   // L1 region
  const int r0y = blockIdx.y * kL1H - halo, r0x = blockIdx.x * kL1W - halo;
  const int32_t* src = in + blockIdx.z * (size_t)H * W;

  // L0 rows 2*r0y - 2 .. 2*(r0y + rh - 1) + 2; columns from 2*r0x - 4, a
  // multiple of 4, through at least 2*(r0x + rw - 1) + 2
  stage<kS0H, kS0W / 4, kS0W, kGx * kGy>(l0, src, H, W, 2 * r0y - 2,
                                         2 * r0x - 4, 2 * rh + 3, vec);
  __syncthreads();

  int32_t* dst1 = out1 + blockIdx.z * (size_t)H1 * W1;
  for (int r = threadIdx.y; r < rh; r += kGy) {
    const int py = r0y + r;
    for (int c = threadIdx.x; c < rw; c += kGx) {
      const int px = r0x + c;
      int v = 0;
      if (py >= 0 && py < H1 && px >= 0 && px < W1) {
        // L0 pixel (2py, 2px) is staged at (2r + 2, 2c + 4)
        v = gated_mean(l0 + (2 * r + 2) * kS0W + 2 * c + 4, kS0W, 2 * py,
                       2 * px, H, W, gate);
        if (r >= halo && r < halo + kL1H && c >= halo && c < halo + kL1W)
          dst1[(size_t)py * W1 + px] = v;
      }
      l1[r * kR1W + c] = (float)v;
    }
  }
  if (levels == 1) return;
  __syncthreads();

  const int H2 = H1 / 2, W2 = W1 / 2;
  int32_t* dst2 = out2 + blockIdx.z * (size_t)H2 * W2;
  for (int r = threadIdx.y; r < kL1H / 2; r += kGy) {
    const int qy = blockIdx.y * (kL1H / 2) + r;
    for (int c = threadIdx.x; c < kL1W / 2; c += kGx) {
      const int qx = blockIdx.x * (kL1W / 2) + c;
      if (qy >= H2 || qx >= W2) continue;
      // L1 pixel (2qy, 2qx) is at (2r + halo, 2c + halo) of the region
      dst2[(size_t)qy * W2 + qx] =
          gated_mean(l1 + (2 * r + halo) * kR1W + 2 * c + halo, kR1W, 2 * qy,
                     2 * qx, H1, W1, gate);
    }
  }
}

}  // namespace

extern "C" {

// in, out: int32[B, H, W] contiguous on the current device.
int oslam_bilateral7x7(const void* in, void* out, int B, int H, int W,
                       double sig_s, float sig_d, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  return (int)launch_bilateral<3>(in, out, B, H, W, sig_s, sig_d,
                                  (cudaStream_t)stream);
}

// in, out: int32[B, H, W] contiguous on the current device; half >= 0 is
// the window's radius. Radii 1..kMaxHalf launch their compiled instance;
// any other the run-time-radius kernel, whose tile opts in to more than
// 48 KB of shared memory where it needs to; one past the block's limit is
// refused (cudaErrorInvalidValue).
int oslam_bilateral_window(const void* in, void* out, int B, int H, int W,
                           int half, double sig_s, float sig_d,
                           void* stream) {
  if (half < 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (half) {
    case 1: return (int)launch_bilateral<1>(in, out, B, H, W, sig_s, sig_d, st);
    case 2: return (int)launch_bilateral<2>(in, out, B, H, W, sig_s, sig_d, st);
    case 3: return (int)launch_bilateral<3>(in, out, B, H, W, sig_s, sig_d, st);
    case 4: return (int)launch_bilateral<4>(in, out, B, H, W, sig_s, sig_d, st);
    case 5: return (int)launch_bilateral<5>(in, out, B, H, W, sig_s, sig_d, st);
    case 6: return (int)launch_bilateral<6>(in, out, B, H, W, sig_s, sig_d, st);
    default: break;
  }
  static_assert(kMaxHalf == 6, "one case a compiled radius");
  const size_t smem = sizeof(float) * (size_t)win_smem_floats(half);
  if (smem > 48 * 1024) {
    int dev = 0, most = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    if (smem > (size_t)most) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        bilateral_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(kWinTileW, kWinTileH);
  const dim3 grid((W + kWinTileW - 1) / kWinTileW,
                  (H + kWinTileH - 1) / kWinTileH, B);
  bilateral_window_kernel<<<grid, block, smem, st>>>(
      (const int32_t*)in, (int32_t*)out, H, W, half, sig_s, sig_d);
  return (int)cudaGetLastError();
}

// in: int32[B, H, W]; out1: int32[B, H/2, W/2]; with levels == 2 also
// out2: int32[B, H/4', W/4'] where H/4' = (H/2)/2; all contiguous.
int oslam_gated_pyramid5x5(const void* in, void* out1, void* out2, int B,
                           int H, int W, float gate, int levels,
                           void* stream) {
  if (levels != 1 && levels != 2) return (int)cudaErrorInvalidValue;
  const int H1 = H / 2, W1 = W / 2;
  if (B <= 0 || H1 <= 0 || W1 <= 0) return (int)cudaSuccess;
  const bool vec = W % 4 == 0 && aligned16(in);
  const dim3 block(kGx, kGy);
  const dim3 grid((W1 + kL1W - 1) / kL1W, (H1 + kL1H - 1) / kL1H, B);
  gated_pyramid5x5_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int32_t*)in, (int32_t*)out1, (int32_t*)out2, H, W, gate, levels,
      vec);
  return (int)cudaGetLastError();
}

const char* oslam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
