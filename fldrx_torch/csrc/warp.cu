// Bilinear gather (backward warp) and bilinear scatter-add splat (forward
// warp) for fldrx_torch, for Hopper (sm_90a). Plain C entry points, loaded
// with ctypes by fldrx_torch/ops/_build.py; each launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().
//
// gather replaces the TPU kernel _gather_kernel (fldrx/ops/fastwarp.py:307,
// launched by _gather_fast :386). It computes grid_sample's bilinear tap sum
// with zeros padding, term for term as the plain version
// fldrx_torch/ops/warp.py grid_sample_bilinear: floor, fractional parts, four
// validity-masked taps, summed in the order w00, w01, w10, w11. The _rn
// intrinsics keep nvcc from contracting the products and sums into FMAs, so
// the kernel and the plain version round alike. With mask != 0 the result
// is multiplied by the bwarp 0.999 validity mask in its separable form
// (fldrx_torch/ops/warp.py ones_mask_sep). The TPU kernel's bf16 windows,
// spill tiers and tiling are not carried over: a thread reads its four taps
// directly.
// Bound: bytes (per output pixel 2 coordinates, 4·C taps that neighbouring
// threads share through L1/L2, C outputs; a few flops each). One thread per
// output pixel, consecutive threads on consecutive pixels, so coordinate
// loads and output stores coalesce and taps of a smooth flow hit cache.
//
// splat replaces the TPU kernel _splat_kernel_up (fldrx/ops/fastwarp.py:986,
// launched by _splat_fast_planes :1129), and also serves the coarse feature
// splats that fldrx runs as an XLA scatter (fldrx/ops/splat.py:33). Each
// source pixel adds vals·w into the four integer neighbours of its target
// (tx, ty); corners outside the frame are dropped. One thread per source
// pixel, four corners × C channels of float atomicAdd into a zeroed output.
// The summation order of colliding adds changes from run to run, so the
// result is not bitwise deterministic (the TPU strip kernel is); it agrees
// with the plain index_add_ version to float rounding of a few-term sum.
// Bound: bytes (vals, two coordinates, the output), with atomics resolved
// in L2. The same kernel computes the plain-row splat _splat_kernel
// (fldrx/ops/fastwarp.py:776, launched by _splat_fast :936) that fldrx's
// training path runs: the port has one splat layout, plain rows.
//
// splat_grad is the VJP of splat, fldrx's _splat_diff_bwd
// (fldrx/ops/fastwarp.py:1529), whose pieces are the gather and the splat
// kernels above. One thread per source pixel, no atomics, so it is
// deterministic. It reads the cotangent g at the four corners of (tx, ty)
// once per channel and writes
//   dvals[i,c] = sum_k w_k g[corner_k, c]          (updateGradInput)
//   dtx[i] = sum_c vals[i,c] ((1-fy)(g01-g00) + fy(g11-g10))
//   dty[i] = sum_c vals[i,c] ((1-fx)(g10-g00) + fx(g11-g01))  (updateGradFlow)
// (each bracket evaluated as a difference of two y-samples, d_along)
// with out-of-frame corners read as 0, as the forward drops them. fldrx
// builds the same numbers from five gathers, four of them at integer taps;
// here they are one pass. dvals is summed term for term as the gather
// kernel sums (the plain version's order), so it matches bit for bit.
// dtx/dty are skipped when their pointers are null. Bound: bytes (vals,
// coordinates, g read, dvals and dtx/dty written).
//
// gather_grad is the VJP of gather, fldrx's _bwarp_diff_bwd
// (fldrx/ops/fastwarp.py:1569) without its S/(S-1) factor, which the port's
// autograd adds through the sampling coordinates. One thread per output
// pixel, with gm = g * keep (keep is the 0.999 mask, whose derivative is 0):
//   dimg: gm * w_k added into the four corners by float atomicAdd. The
//         order of colliding adds changes from run to run, so dimg is NOT
//         deterministic (the TPU's splat_at is); comparisons use
//         1e-4 * (1 + |ref|), as for the splat.
//   dsx[i] = sum_c gm_c ((1-fy)(I01-I00) + fy(I11-I10))
//   dsy[i] = sum_c gm_c ((1-fx)(I10-I00) + fx(I11-I01))
// dimg must be zeroed by the caller; either output is skipped when its
// pointer is null. Bound: bytes, with the dimg atomics resolved in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float clamp01(float v) {
  return fminf(fmaxf(v, 0.f), 1.f);
}

// floor(p) as an int, clamped to [-2, S] first: outside that range every
// tap is out of frame either way, and the clamp keeps the cast defined.
__device__ __forceinline__ int floor_index(float f, int S) {
  return (int)fminf(fmaxf(f, -2.f), (float)S);
}

// d/dx of a bilinear sample: the difference of the samples at the two
// integer x taps, (v01 gy + v11 fy) - (v00 gy + v10 fy), in the plain
// version's association (v01 one step along x, v10 one step along the
// other axis, fy the fraction along it, gy = 1 - fy).
__device__ __forceinline__ float d_along(float v00, float v01, float v10,
                                         float v11, float gy, float fy) {
  return __fsub_rn(__fadd_rn(__fmul_rn(v01, gy), __fmul_rn(v11, fy)),
                   __fadd_rn(__fmul_rn(v00, gy), __fmul_rn(v10, fy)));
}

__global__ void gather_kernel(const float* __restrict__ img,
                              const float* __restrict__ sx,
                              const float* __restrict__ sy,
                              float* __restrict__ out, int B, int H, int W,
                              int C, int Ho, int Wo, int mask) {
  const int64_t hw = (int64_t)Ho * Wo;
  const int64_t n = (int64_t)B * hw;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t b = i / hw;
    const float px = sx[i], py = sy[i];
    const float x0f = floorf(px), y0f = floorf(py);
    const float fx = __fsub_rn(px, x0f), fy = __fsub_rn(py, y0f);
    const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
    const float w00 = __fmul_rn(gx, gy), w01 = __fmul_rn(fx, gy);
    const float w10 = __fmul_rn(gx, fy), w11 = __fmul_rn(fx, fy);
    const int x0 = floor_index(x0f, W), y0 = floor_index(y0f, H);
    const bool vx0 = x0 >= 0 && x0 < W, vx1 = x0 + 1 >= 0 && x0 + 1 < W;
    const bool vy0 = y0 >= 0 && y0 < H, vy1 = y0 + 1 >= 0 && y0 + 1 < H;
    const float* base = img + b * H * (int64_t)W * C;
    const float* r0 = base + ((int64_t)y0 * W) * C;
    const float* r1 = r0 + (int64_t)W * C;
    float keep = 1.f;
    if (mask) {
      const float mx = clamp01(fminf(__fadd_rn(px, 1.f), __fsub_rn((float)W, px)));
      const float my = clamp01(fminf(__fadd_rn(py, 1.f), __fsub_rn((float)H, py)));
      keep = __fmul_rn(mx, my) >= 0.999f ? 1.f : 0.f;
    }
    float* o = out + i * C;
    for (int c = 0; c < C; ++c) {
      const float v00 = (vy0 && vx0) ? r0[(int64_t)x0 * C + c] : 0.f;
      const float v01 = (vy0 && vx1) ? r0[(int64_t)(x0 + 1) * C + c] : 0.f;
      const float v10 = (vy1 && vx0) ? r1[(int64_t)x0 * C + c] : 0.f;
      const float v11 = (vy1 && vx1) ? r1[(int64_t)(x0 + 1) * C + c] : 0.f;
      float acc = __fmul_rn(v00, w00);
      acc = __fadd_rn(acc, __fmul_rn(v01, w01));
      acc = __fadd_rn(acc, __fmul_rn(v10, w10));
      acc = __fadd_rn(acc, __fmul_rn(v11, w11));
      o[c] = __fmul_rn(acc, keep);
    }
  }
}

__global__ void splat_kernel(const float* __restrict__ vals,
                             const float* __restrict__ tx,
                             const float* __restrict__ ty,
                             float* __restrict__ out, int B, int H, int W,
                             int C) {
  const int64_t hw = (int64_t)H * W;
  const int64_t n = (int64_t)B * hw;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t b = i / hw;
    const float px = tx[i], py = ty[i];
    const float x0f = floorf(px), y0f = floorf(py);
    const float fx = __fsub_rn(px, x0f), fy = __fsub_rn(py, y0f);
    const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
    const int x0 = floor_index(x0f, W), y0 = floor_index(y0f, H);
    const int xs[4] = {x0, x0 + 1, x0, x0 + 1};
    const int ys[4] = {y0, y0, y0 + 1, y0 + 1};
    const float ws[4] = {__fmul_rn(gx, gy), __fmul_rn(fx, gy),
                         __fmul_rn(gx, fy), __fmul_rn(fx, fy)};
    const float* v = vals + i * C;
    for (int k = 0; k < 4; ++k) {
      if (xs[k] < 0 || xs[k] >= W || ys[k] < 0 || ys[k] >= H) continue;
      float* o = out + ((b * H + ys[k]) * (int64_t)W + xs[k]) * C;
      for (int c = 0; c < C; ++c) atomicAdd(o + c, __fmul_rn(v[c], ws[k]));
    }
  }
}

__global__ void splat_grad_kernel(const float* __restrict__ vals,
                                  const float* __restrict__ tx,
                                  const float* __restrict__ ty,
                                  const float* __restrict__ g,
                                  float* __restrict__ dvals,
                                  float* __restrict__ dtx,
                                  float* __restrict__ dty, int B, int H,
                                  int W, int C) {
  const int64_t hw = (int64_t)H * W;
  const int64_t n = (int64_t)B * hw;
  const bool coords = dtx != nullptr;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t b = i / hw;
    const float px = tx[i], py = ty[i];
    const float x0f = floorf(px), y0f = floorf(py);
    const float fx = __fsub_rn(px, x0f), fy = __fsub_rn(py, y0f);
    const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
    const float w00 = __fmul_rn(gx, gy), w01 = __fmul_rn(fx, gy);
    const float w10 = __fmul_rn(gx, fy), w11 = __fmul_rn(fx, fy);
    const int x0 = floor_index(x0f, W), y0 = floor_index(y0f, H);
    const bool vx0 = x0 >= 0 && x0 < W, vx1 = x0 + 1 >= 0 && x0 + 1 < W;
    const bool vy0 = y0 >= 0 && y0 < H, vy1 = y0 + 1 >= 0 && y0 + 1 < H;
    const float* base = g + b * hw * C;
    const float* r0 = base + ((int64_t)y0 * W) * C;
    const float* r1 = r0 + (int64_t)W * C;
    const float* v = vals + i * C;
    float* dv = dvals + i * C;
    float ax = 0.f, ay = 0.f;
    for (int c = 0; c < C; ++c) {
      const float g00 = (vy0 && vx0) ? r0[(int64_t)x0 * C + c] : 0.f;
      const float g01 = (vy0 && vx1) ? r0[(int64_t)(x0 + 1) * C + c] : 0.f;
      const float g10 = (vy1 && vx0) ? r1[(int64_t)x0 * C + c] : 0.f;
      const float g11 = (vy1 && vx1) ? r1[(int64_t)(x0 + 1) * C + c] : 0.f;
      float acc = __fmul_rn(g00, w00);
      acc = __fadd_rn(acc, __fmul_rn(g01, w01));
      acc = __fadd_rn(acc, __fmul_rn(g10, w10));
      acc = __fadd_rn(acc, __fmul_rn(g11, w11));
      dv[c] = acc;
      if (coords) {
        const float vc = v[c];
        ax += vc * d_along(g00, g01, g10, g11, gy, fy);
        ay += vc * d_along(g00, g10, g01, g11, gx, fx);
      }
    }
    if (coords) {
      dtx[i] = ax;
      dty[i] = ay;
    }
  }
}

__global__ void gather_grad_kernel(const float* __restrict__ img,
                                   const float* __restrict__ sx,
                                   const float* __restrict__ sy,
                                   const float* __restrict__ g,
                                   float* __restrict__ dimg,
                                   float* __restrict__ dsx,
                                   float* __restrict__ dsy, int B, int H,
                                   int W, int C, int Ho, int Wo, int mask) {
  const int64_t hw = (int64_t)Ho * Wo;
  const int64_t n = (int64_t)B * hw;
  const bool coords = dsx != nullptr;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t b = i / hw;
    const float px = sx[i], py = sy[i];
    if (mask) {
      const float mx = clamp01(fminf(__fadd_rn(px, 1.f), __fsub_rn((float)W, px)));
      const float my = clamp01(fminf(__fadd_rn(py, 1.f), __fsub_rn((float)H, py)));
      if (!(__fmul_rn(mx, my) >= 0.999f)) {      // gm = 0: nothing to add
        if (coords) {
          dsx[i] = 0.f;
          dsy[i] = 0.f;
        }
        continue;
      }
    }
    const float x0f = floorf(px), y0f = floorf(py);
    const float fx = __fsub_rn(px, x0f), fy = __fsub_rn(py, y0f);
    const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
    const float w00 = __fmul_rn(gx, gy), w01 = __fmul_rn(fx, gy);
    const float w10 = __fmul_rn(gx, fy), w11 = __fmul_rn(fx, fy);
    const int x0 = floor_index(x0f, W), y0 = floor_index(y0f, H);
    const bool v00 = y0 >= 0 && y0 < H && x0 >= 0 && x0 < W;
    const bool v01 = y0 >= 0 && y0 < H && x0 + 1 >= 0 && x0 + 1 < W;
    const bool v10 = y0 + 1 >= 0 && y0 + 1 < H && x0 >= 0 && x0 < W;
    const bool v11 = y0 + 1 >= 0 && y0 + 1 < H && x0 + 1 >= 0 && x0 + 1 < W;
    const int64_t o00 = ((b * H + y0) * (int64_t)W + x0) * C;
    const int64_t o01 = o00 + C, o10 = o00 + (int64_t)W * C, o11 = o10 + C;
    const float* gi = g + i * C;
    float ax = 0.f, ay = 0.f;
    for (int c = 0; c < C; ++c) {
      const float gm = gi[c];
      if (dimg) {
        if (v00) atomicAdd(dimg + o00 + c, __fmul_rn(gm, w00));
        if (v01) atomicAdd(dimg + o01 + c, __fmul_rn(gm, w01));
        if (v10) atomicAdd(dimg + o10 + c, __fmul_rn(gm, w10));
        if (v11) atomicAdd(dimg + o11 + c, __fmul_rn(gm, w11));
      }
      if (coords) {
        const float i00 = v00 ? img[o00 + c] : 0.f;
        const float i01 = v01 ? img[o01 + c] : 0.f;
        const float i10 = v10 ? img[o10 + c] : 0.f;
        const float i11 = v11 ? img[o11 + c] : 0.f;
        ax += gm * d_along(i00, i01, i10, i11, gy, fy);
        ay += gm * d_along(i00, i10, i01, i11, gx, fx);
      }
    }
    if (coords) {
      dsx[i] = ax;
      dsy[i] = ay;
    }
  }
}

constexpr int kThreads = 256;

int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  return (int)(b < (1 << 30) ? (b > 0 ? b : 1) : (1 << 30));
}

}  // namespace

extern "C" int fldrx_gather_f32(const float* img, const float* sx,
                                const float* sy, float* out, int B, int H,
                                int W, int C, int Ho, int Wo, int mask,
                                void* stream) {
  const int64_t n = (int64_t)B * Ho * Wo;
  if (n > 0)
    gather_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        img, sx, sy, out, B, H, W, C, Ho, Wo, mask);
  return (int)cudaGetLastError();
}

extern "C" int fldrx_splat_f32(const float* vals, const float* tx,
                               const float* ty, float* out, int B, int H,
                               int W, int C, void* stream) {
  const int64_t n = (int64_t)B * H * W;
  if (n > 0)
    splat_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        vals, tx, ty, out, B, H, W, C);
  return (int)cudaGetLastError();
}

// dtx and dty both null, or both set.
extern "C" int fldrx_splat_grad_f32(const float* vals, const float* tx,
                                    const float* ty, const float* g,
                                    float* dvals, float* dtx, float* dty,
                                    int B, int H, int W, int C,
                                    void* stream) {
  const int64_t n = (int64_t)B * H * W;
  if (n > 0)
    splat_grad_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        vals, tx, ty, g, dvals, dtx, dty, B, H, W, C);
  return (int)cudaGetLastError();
}

// dimg zeroed by the caller or null; dsx and dsy both null, or both set.
extern "C" int fldrx_gather_grad_f32(const float* img, const float* sx,
                                     const float* sy, const float* g,
                                     float* dimg, float* dsx, float* dsy,
                                     int B, int H, int W, int C, int Ho,
                                     int Wo, int mask, void* stream) {
  const int64_t n = (int64_t)B * Ho * Wo;
  if (n > 0)
    gather_grad_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        img, sx, sy, g, dimg, dsx, dsy, B, H, W, C, Ho, Wo, mask);
  return (int)cudaGetLastError();
}
