// Sensor stencils of the depth pyramid, hand-written for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels built by _window_call in
// octree_slam_tpu/sensor/pallas_ops.py (pl.pallas_call at :112):
//
//   bilateral7x7        <- pallas_ops.bilateral (:149), kind "bilateral"
//   gated_subsample5x5  <- pallas_ops.gated_window_mean (:160), kind "gated",
//                          plus the caller's decimation in
//                          image_ops.subsample_depth (:129-133)
//
// What bounds them on an H100: each reads and writes a few MB (a 640x480
// int32 plane is 1.2 MB), far below what 3.35 TB/s makes expensive, so at
// the pyramid's sizes they are bound by launch latency and, for the
// bilateral, by its 49 expf per pixel. The bilateral stages a 16x16 tile
// plus a 3-pixel halo in shared memory so each input pixel is read from
// device memory about 1.9 times instead of 49; the gated subsample computes
// only the kept (2y, 2x) pixels (a quarter of the full-resolution work the
// TPU kernel did) straight from the L1/L2-cached input.
//
// Float semantics follow the plain PyTorch versions in sensor/cuda_ops.py
// term by term: the same tap order (dy outer, dx inner), the same
// expression for the weight, IEEE division, rintf (round half to even, as
// torch.round), truncation toward zero for the subsample. Build with
// --fmad=false so s1 + nb * wgt rounds twice like the plain version, and
// without --use_fast_math (expf, not __expf).
//
// Interface: extern "C" launchers taking raw device pointers, sizes and a
// cudaStream_t; each returns cudaGetLastError() after its launch. Loaded
// with ctypes by octree_slam_tpu_torch/_build.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kHalf = 3;                     // 7x7 window
constexpr int kSpan = kTile + 2 * kHalf;     // 22 staged rows / columns
constexpr int kTaps = (2 * kHalf + 1) * (2 * kHalf + 1);
constexpr float kOutside = -1.0f;            // depth is never negative

// One thread per output pixel; blockIdx.z is the batch index.
__global__ void bilateral7x7_kernel(const int32_t* __restrict__ in,
                                    int32_t* __restrict__ out, int H, int W,
                                    double sig_s, float sig_d) {
  __shared__ float tile[kSpan][kSpan + 1];
  __shared__ float space[kTaps];
  const size_t plane = (size_t)H * W;
  const int32_t* src = in + blockIdx.z * plane;
  int32_t* dst = out + blockIdx.z * plane;
  const int tid = threadIdx.y * kTile + threadIdx.x;

  // space2 * sig_s is formed in double and rounded once to float, as the
  // plain version's Python scalar is when it meets a float32 tensor
  if (tid < kTaps) {
    const int dy = tid / (2 * kHalf + 1) - kHalf;
    const int dx = tid % (2 * kHalf + 1) - kHalf;
    space[tid] = (float)((double)(dx * dx + dy * dy) * sig_s);
  }
  const int y0 = blockIdx.y * kTile - kHalf;
  const int x0 = blockIdx.x * kTile - kHalf;
  for (int i = tid; i < kSpan * kSpan; i += kTile * kTile) {
    const int ty = i / kSpan, tx = i % kSpan;
    const int gy = y0 + ty, gx = x0 + tx;
    tile[ty][tx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                       ? (float)src[(size_t)gy * W + gx]
                       : kOutside;
  }
  __syncthreads();

  const int x = blockIdx.x * kTile + threadIdx.x;
  const int y = blockIdx.y * kTile + threadIdx.y;
  if (x >= W || y >= H) return;
  const float c = tile[threadIdx.y + kHalf][threadIdx.x + kHalf];
  float s1 = 0.0f, s2 = 0.0f;
  for (int dy = -kHalf; dy <= kHalf; ++dy) {
    for (int dx = -kHalf; dx <= kHalf; ++dx) {
      const float nb = tile[threadIdx.y + kHalf + dy][threadIdx.x + kHalf + dx];
      // outside the image: weight 0 (the plain version adds 0 * 0)
      if (nb == kOutside) continue;
      const float diff = c - nb;
      const float wgt =
          expf(-(space[(dy + kHalf) * (2 * kHalf + 1) + dx + kHalf] +
                 diff * diff * sig_d));
      s1 = s1 + nb * wgt;
      s2 = s2 + wgt;
    }
  }
  // the centre tap has weight 1, so s2 >= 1
  dst[(size_t)y * W + x] = (int32_t)rintf(s1 / s2);
}

// One thread per KEPT pixel (2*oy, 2*ox): the mean of the in-image 5x5
// neighbours within `gate` of the centre, 0 when none pass, truncated.
__global__ void gated_subsample5x5_kernel(const int32_t* __restrict__ in,
                                          int32_t* __restrict__ out, int H,
                                          int W, int OH, int OW, float gate) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ox >= OW || oy >= OH) return;
  const int32_t* src = in + blockIdx.z * (size_t)H * W;
  int32_t* dst = out + blockIdx.z * (size_t)OH * OW;
  const int cy = 2 * oy, cx = 2 * ox;
  const float c = (float)__ldg(src + (size_t)cy * W + cx);
  // every term is an integer and the sums stay below 2^24: exact in float
  float s = 0.0f, cnt = 0.0f;
  for (int dy = -2; dy <= 2; ++dy) {
    const int y = cy + dy;
    if (y < 0 || y >= H) continue;
    for (int dx = -2; dx <= 2; ++dx) {
      const int x = cx + dx;
      if (x < 0 || x >= W) continue;
      const float nb = (float)__ldg(src + (size_t)y * W + x);
      if (fabsf(nb - c) < gate) {
        s = s + nb;
        cnt = cnt + 1.0f;
      }
    }
  }
  const float mean = cnt > 0.0f ? s / fmaxf(cnt, 1.0f) : 0.0f;
  dst[(size_t)oy * OW + ox] = (int32_t)mean;  // truncates toward zero
}

}  // namespace

extern "C" {

// in, out: int32[B, H, W] contiguous on the current device.
int oslam_bilateral7x7(const void* in, void* out, int B, int H, int W,
                       double sig_s, float sig_d, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const dim3 block(kTile, kTile);
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  bilateral7x7_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int32_t*)in, (int32_t*)out, H, W, sig_s, sig_d);
  return (int)cudaGetLastError();
}

// in: int32[B, H, W]; out: int32[B, H / 2, W / 2]; both contiguous.
int oslam_gated_subsample5x5(const void* in, void* out, int B, int H, int W,
                             float gate, void* stream) {
  const int OH = H / 2, OW = W / 2;
  if (B <= 0 || OH <= 0 || OW <= 0) return (int)cudaSuccess;
  const dim3 block(32, 8);
  const dim3 grid((OW + 31) / 32, (OH + 7) / 8, B);
  gated_subsample5x5_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int32_t*)in, (int32_t*)out, H, W, OH, OW, gate);
  return (int)cudaGetLastError();
}

const char* oslam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
