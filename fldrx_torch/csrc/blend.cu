// The packed synthesis's six-way blend for fldrx_torch, for Hopper
// (sm_90a). Plain C entry point, loaded with ctypes by
// fldrx_torch/ops/_build.py; it launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().
//
// Replaces no TPU kernel: fldrx leaves this step to XLA
// (fldrx/model/fldrnet.py blend_planes_24, which XLA fuses into one pass).
// Added because in PyTorch the same step (model/fldrnet.py's blend6 on each
// of the four u-planes, then the interleave into plain rows and the copy of
// the chunk's frames into one tensor) is about 80 elementwise launches a t,
// each reading and writing float32 intermediates of the whole frame: at 4K
// on an H100 they took 3.3 ms a t, 12 times what the bytes need.
//
// Function, for a frame of H×W pixels (H, W multiples of 4) and batch item
// b: the refine UNet's s2d4 logits L [B, H/4, W/4, 96] (bfloat16 or
// float32, cell-major: channel (u·4 + v)·6 + c holds logit c of pixel
// (4y + u, 4x + v)), the six float32 candidates C_0..C_5 (warped0,
// warped1, im0_tot, im1_tot, x0, x1), each [B, H, W, 3] with contiguous
// rows and a batch stride of its own, t [B] and T [1] on the device:
//   x_i = L_i / T + (i odd ? log t : log(1 − t))
//   p_i = exp(x_i − max_j x_j) / Σ_j exp(x_j − max_j x_j)
//   out = p_0·C_0 + p_1·C_1 + … + p_5·C_5
// in the order and with the roundings of model/fldrnet.py's blend6: a
// divide by T (not a reciprocal multiply), the sum of the exponentials
// from 0 to 5, each product rounded before its add (no FMA). The output is
// plain rows [B, H, W, 3] or u-planes [B, 4, H/4, W·3] (row y of the frame
// is row y/4 of plane y%4), with a batch stride of its own. Neither t nor
// T is read on the host, so nothing synchronises the stream.
//
// Bound: bytes. Each input is read once and the output written once: at
// 4K (2304×4096) with bfloat16 logits 12 + 72 + 12 = 96 bytes a pixel,
// 0.906 GB, 0.27 ms at 3.35 TB/s. The arithmetic (about 70 float32
// operations a pixel, 6 of them exponentials) is far below the card's rate.
//
// Design: one thread per (batch item, pixel row, cell), that is 4 pixels
// of one row; a block of 256 threads covers 256 neighbouring cells of one
// row, and the grid's x walks the rows (the four rows of a logit cell run
// in neighbouring blocks, so a cell's logits, read by four threads, come
// from L2 after the first). A thread's 24 logits (row u of its cell) are
// contiguous: three 16-byte loads in bfloat16, six in float32. Its 4
// pixels × 3 channels of each candidate are 48 contiguous bytes, three
// float4 loads, and its output three float4 stores; neighbouring threads
// take neighbouring 48-byte pieces, so every load and store is coalesced
// and no shared memory is needed. All 21 (or 24) loads are issued before
// the arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCands = 6;

struct Candidates {
  const float* ptr[kCands];
  long long batch_stride[kCands];   // floats
};

__device__ __forceinline__ void unpack(const uint4 q, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 v = __bfloat1622float2(h[k]);
    f[2 * k] = v.x;
    f[2 * k + 1] = v.y;
  }
}

// the 24 logits of one row of a cell, as float32 (exact from bfloat16)
__device__ __forceinline__ void load_logits(const __nv_bfloat16* p,
                                            float* l) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
  unpack(a, l);
  unpack(b, l + 8);
  unpack(c, l + 16);
}

__device__ __forceinline__ void load_logits(const float* p, float* l) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float4 v = __ldg(q + k);
    l[4 * k] = v.x;
    l[4 * k + 1] = v.y;
    l[4 * k + 2] = v.z;
    l[4 * k + 3] = v.w;
  }
}

__device__ __forceinline__ void load12(const float* p, float* f) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float4 v = __ldg(q + k);
    f[4 * k] = v.x;
    f[4 * k + 1] = v.y;
    f[4 * k + 2] = v.z;
    f[4 * k + 3] = v.w;
  }
}

__device__ __forceinline__ void store12(float* p, const float* f) {
  float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    q[k] = make_float4(f[4 * k], f[4 * k + 1], f[4 * k + 2], f[4 * k + 3]);
}

// grid (B·H rows, ceil(W/4 / kThreads)); thread: cell cx of row y of item b
template <typename L, bool kPlanes>
__global__ void __launch_bounds__(kThreads)
blend6_kernel(const L* __restrict__ logits, const __grid_constant__ Candidates c,
              const float* __restrict__ t, const float* __restrict__ T,
              float* __restrict__ out, long long out_stride, int H, int W4) {
  const int cx = blockIdx.y * kThreads + threadIdx.x;
  if (cx >= W4) return;
  const int r = blockIdx.x;
  const int b = r / H;
  const int y = r - b * H;
  const int u = y & 3;
  const int H4 = H >> 2;

  float l[24];
  load_logits(logits + (((int64_t)b * H4 + (y >> 2)) * W4 + cx) * 96 + u * 24,
              l);
  float v[kCands][12];
  const int64_t at = ((int64_t)y * W4 + cx) * 12;
#pragma unroll
  for (int i = 0; i < kCands; ++i)
    load12(c.ptr[i] + b * c.batch_stride[i] + at, v[i]);
  const float tb = __ldg(t + b);
  const float Tp = __ldg(T);
  const float logt = logf(tb);
  const float log1mt = logf(__fsub_rn(1.0f, tb));

  float o[12];
#pragma unroll
  for (int px = 0; px < 4; ++px) {
    float x[kCands];
#pragma unroll
    for (int i = 0; i < kCands; ++i)
      x[i] = __fadd_rn(__fdiv_rn(l[px * 6 + i], Tp), (i & 1) ? logt : log1mt);
    float m = x[0];
#pragma unroll
    for (int i = 1; i < kCands; ++i) m = fmaxf(m, x[i]);
    float e[kCands];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kCands; ++i) {
      e[i] = expf(__fsub_rn(x[i], m));
      s = i ? __fadd_rn(s, e[i]) : e[i];
    }
    float p[kCands];
#pragma unroll
    for (int i = 0; i < kCands; ++i) p[i] = __fdiv_rn(e[i], s);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const int k = px * 3 + ch;
      float acc = __fmul_rn(p[0], v[0][k]);
#pragma unroll
      for (int i = 1; i < kCands; ++i)
        acc = __fadd_rn(acc, __fmul_rn(p[i], v[i][k]));
      o[k] = acc;
    }
  }
  float* dst = out + b * out_stride;
  if constexpr (kPlanes)
    dst += ((int64_t)u * H4 + (y >> 2)) * ((int64_t)W4 * 12) + cx * 12;
  else
    dst += at;
  store12(dst, o);
}

template <typename L, bool kPlanes>
void launch(const void* logits, const Candidates& c, const float* t,
            const float* T, float* out, long long out_stride, int B, int H,
            int W, cudaStream_t stream) {
  const int W4 = W / 4;
  const dim3 grid((unsigned)((int64_t)B * H),
                  (unsigned)((W4 + kThreads - 1) / kThreads));
  blend6_kernel<L, kPlanes><<<grid, kThreads, 0, stream>>>(
      (const L*)logits, c, t, T, out, out_stride, H, W4);
}

bool aligned16(const void* p) { return ((uintptr_t)p % 16) == 0; }

}  // namespace

// logits: [B, H/4, W/4, 96] contiguous, bfloat16 where logits_bf16 else
// float32; cands: a host array of the six candidates' device pointers
// (float32 [B, H, W, 3], rows contiguous); strides: a host array of 7
// int64 batch strides in floats, the six candidates' then the output's;
// t: float32 [B] and T: float32 [1] on the device; out: float32 plain rows
// [B, H, W, 3] or, where planes, u-planes [B, 4, H/4, W·3]. H and W
// multiples of 4; every pointer and batch stride 16-byte aligned.
extern "C" int fldrx_blend6(const void* logits, int logits_bf16,
                            const void* cands, const void* strides,
                            const void* t, const void* T, void* out,
                            int planes, int B, int H, int W, void* stream) {
  if (B < 0 || H < 0 || W < 0 || H % 4 != 0 || W % 4 != 0 ||
      (int64_t)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const auto* p = static_cast<const float* const*>(cands);
  const auto* st = static_cast<const long long*>(strides);
  Candidates c = {};
  bool ok = aligned16(logits) && aligned16(out) && st[kCands] % 4 == 0;
  for (int i = 0; i < kCands; ++i) {
    c.ptr[i] = p[i];
    c.batch_stride[i] = st[i];
    ok = ok && aligned16(p[i]) && st[i] % 4 == 0;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const float* tp = static_cast<const float*>(t);
  const float* Tp = static_cast<const float*>(T);
  float* o = static_cast<float*>(out);
  const long long os = st[kCands];
  if (logits_bf16) {
    if (planes)
      launch<__nv_bfloat16, true>(logits, c, tp, Tp, o, os, B, H, W, s);
    else
      launch<__nv_bfloat16, false>(logits, c, tp, Tp, o, os, B, H, W, s);
  } else {
    if (planes)
      launch<float, true>(logits, c, tp, Tp, o, os, B, H, W, s);
    else
      launch<float, false>(logits, c, tp, Tp, o, os, B, H, W, s);
  }
  return (int)cudaGetLastError();
}
