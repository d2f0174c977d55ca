// Correlation cost volume of the PWC-Net teacher for fldrx_torch, for Hopper
// (sm_90a). Plain C entry point, loaded with ctypes by
// fldrx_torch/ops/_build.py; it launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().
//
// Replaces the TPU kernel _corr_kernel (fldrx/ops/correlation.py:62,
// launched by _corr_one :76). For f1, f2 [B,H,W,C] f32 (NHWC, C the
// contiguous axis) it writes out [B,H,W,81]:
//   out[b,y,x,k] = (1/C) * sum_c f1[b,y,x,c] * f2[b,y+dy,x+dx,c],
//   k = (dy+4)*9 + (dx+4), dy, dx in [-4, 4], f2 read as 0 outside the frame
// (fldrx's channel order; the sum over C times the (1/C) multiply, as the
// TPU kernel computes it). The TPU kernel's channel-planar [C,H,W] layout and
// its whole padded f2 held in VMEM are not carried over.
//
// Design: one block of 8x32 threads per 8x32 tile of output pixels, one
// thread per pixel, each thread holding its 81 sums in registers. The input
// channels are walked in chunks of kCc: per chunk the block stages its f1
// tile (8x32 pixels) and the f2 tile with its +-4 halo (16x40 pixels) in
// shared memory, planar by channel, with zeros outside the frame and past C
// (the +-4 border masking and a C that is no multiple of kCc). Staging loads
// take kCc consecutive channels of one pixel per kCc consecutive threads, so
// each 32-byte sector read from device memory is used whole. In the compute
// loop the 32 threads of a warp (one tile row) read 32 consecutive words of
// a channel plane: no bank conflicts.
// Bound: bytes (f1 and f2 read once, the 81-channel volume written once;
// the volume is the larger part: 81 floats per pixel against 2C read). Each
// f2 element is reused 81 times from shared memory, so device memory sees
// the f2 tile plus its halo, (16*40)/(8*32) = 2.5x of f2 at worst, mostly
// from L2. The sums use fmaf in channel order, so they round differently
// from torch's mean: the plain version agrees to about 1e-6 relative.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 4;                 // max displacement
constexpr int kN = 2 * kD + 1;        // 9 displacements per axis
constexpr int kK = kN * kN;           // 81 output channels
constexpr int kTH = 8, kTW = 32;      // output tile (rows, cols)
constexpr int kHH = kTH + 2 * kD;     // f2 halo tile rows (16)
constexpr int kHW = kTW + 2 * kD;     // f2 halo tile cols (40)
constexpr int kCc = 8;                // channels per shared-memory chunk
constexpr int kThreads = kTH * kTW;   // 256
constexpr int kF1Plane = kThreads + 1;      // padded plane strides
constexpr int kF2Plane = kHH * kHW + 1;

__global__ void __launch_bounds__(kThreads)
correlation_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                   float* __restrict__ out, int H, int W, int C) {
  __shared__ float f1s[kCc * kF1Plane];
  __shared__ float f2s[kCc * kF2Plane];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTW + tx;
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH;
  const int64_t b = blockIdx.z;
  const float* f1b = f1 + b * H * (int64_t)W * C;
  const float* f2b = f2 + b * H * (int64_t)W * C;

  float acc[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) acc[k] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCc) {
    __syncthreads();                  // the previous chunk is consumed
    // f1 tile: kThreads pixels x kCc channels, channel fastest
    for (int j = tid; j < kThreads * kCc; j += kThreads) {
      const int c = j % kCc, p = j / kCc;
      const int y = y0 + p / kTW, x = x0 + p % kTW;
      float v = 0.f;
      if (y < H && x < W && c0 + c < C)
        v = f1b[((int64_t)y * W + x) * C + c0 + c];
      f1s[c * kF1Plane + p] = v;
    }
    // f2 tile with its halo: kHH x kHW pixels x kCc channels
    for (int j = tid; j < kHH * kHW * kCc; j += kThreads) {
      const int c = j % kCc, p = j / kCc;
      const int y = y0 - kD + p / kHW, x = x0 - kD + p % kHW;
      float v = 0.f;
      if (y >= 0 && y < H && x >= 0 && x < W && c0 + c < C)
        v = f2b[((int64_t)y * W + x) * C + c0 + c];
      f2s[c * kF2Plane + p] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < kCc; ++c) {
      const float a = f1s[c * kF1Plane + tid];
      const float* row = f2s + c * kF2Plane + ty * kHW + tx;
#pragma unroll
      for (int dy = 0; dy < kN; ++dy) {
#pragma unroll
        for (int dx = 0; dx < kN; ++dx)
          acc[dy * kN + dx] = fmaf(a, row[dy * kHW + dx], acc[dy * kN + dx]);
      }
    }
  }

  const int y = y0 + ty, x = x0 + tx;
  if (y < H && x < W) {
    const float inv_c = 1.f / (float)C;
    float* o = out + ((b * H + y) * (int64_t)W + x) * kK;
#pragma unroll
    for (int k = 0; k < kK; ++k) o[k] = acc[k] * inv_c;
  }
}

}  // namespace

extern "C" int fldrx_correlation_f32(const float* f1, const float* f2,
                                     float* out, int B, int H, int W, int C,
                                     void* stream) {
  if (B > 0 && H > 0 && W > 0 && C > 0) {
    dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
    dim3 block(kTW, kTH);
    correlation_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        f1, f2, out, H, W, C);
  }
  return (int)cudaGetLastError();
}
