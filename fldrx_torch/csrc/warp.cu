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
// spill tiers and tiling are not carried over: a thread reads its taps
// directly.
// Bound: bytes (per output pixel 2 coordinates, 4·C taps that neighbouring
// threads share through L1/L2, C outputs; a few flops each). What costs on
// this card is the number of sectors each warp-wide load and store touches,
// and a thread that loops over a pixel's C channels strides its lanes C·4
// bytes apart:
//   route VEC4 (C % 4 == 0, img and out 16-byte aligned; the teacher's
//     C = 32…128): one thread per (output pixel, 4-channel group). Each tap
//     is one 16-byte __ldg and each output one 16-byte store; the lanes of
//     a pixel read and write one contiguous run, and each thread reads its
//     two coordinates once.
//   route SCALAR (any other C or alignment), 4-byte accesses:
//     at C = 2 and 3 (the 4K and training im_tot gathers, C = 3; the
//     flowback gathers on the flow grid, C = 2) one thread per output
//     pixel computes its C values once, and the block stages them in
//     shared memory and stores its run of kThreads·C floats with
//     consecutive threads on consecutive floats. Chosen by measurement
//     against one thread per output element, which recomputes the
//     weights C times (PERF.md's kernel table);
//     at any other C, one thread per output element (pixel, channel), so
//     consecutive lanes store consecutive floats and load neighbouring
//     taps, each lane recomputing its pixel's weights.
//
// splat replaces the TPU kernel _splat_kernel_up (fldrx/ops/fastwarp.py:986,
// launched by _splat_fast_planes :1129), and also serves the coarse feature
// splats that fldrx runs as an XLA scatter (fldrx/ops/splat.py:33). Each
// source pixel adds vals·w into the four integer neighbours of its target
// (tx, ty); corners outside the frame are dropped; the entry point zeroes
// the output first. The same kernel computes the plain-row splat
// _splat_kernel (fldrx/ops/fastwarp.py:776, launched by _splat_fast :936)
// that fldrx's training path runs: the port has one splat layout, plain
// rows.
// Bound: bytes (vals, two coordinates, the output), with the adds resolved
// in L2. What costs on this card is the number of reductions and the
// sectors each touches, so threads sit on channels and each add is a
// fire-and-forget reduction (atomicAdd whose result is unused compiles to
// RED):
//   route VEC4 (C % 4 == 0, vals and out 16-byte aligned; the level-0
//     softmax splats, C = 4): one thread per (source pixel, 4-channel
//     group), one 16-byte load of vals and one red.global.add.v4.f32 per
//     corner (atomicAdd on float4, sm_90), a quarter of the scalar
//     reductions.
//   route SCALAR (any other C or alignment; the feature splats, C = 49,
//     whose 196-byte rows are not 16-byte aligned): one thread per source
//     element (pixel, channel), so a warp's loads of vals and its
//     reductions into one corner hit contiguous addresses, and a C = 49
//     splat runs 49 threads where one ran.
// With the vector reductions the 4K C = 4 splat runs well under index_add_
// (PERF.md's kernel table), so it accumulates in global memory: there is
// no shared-memory canvas.
// The summation order of colliding adds changes from run to run, so the
// result is not bitwise deterministic (the TPU strip kernel is); it agrees
// with the plain index_add_ version to float rounding of a few-term sum.
//
// Both kernels index within one frame in 32 bits: a frame of more than
// 2^31 - 1 elements is refused (cudaErrorInvalidValue), as is a VEC4 route
// the pointers or C do not allow.
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

constexpr int kThreads = 256;

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

// The bilinear weights and corner taps of one point (px, py) in a W×H
// frame, as the plain version computes them.
struct Bilinear {
  float w00, w01, w10, w11;
  int x0, y0;
  bool v00, v01, v10, v11;
};

__device__ __forceinline__ Bilinear bilinear(float px, float py, int W,
                                             int H) {
  Bilinear t;
  const float x0f = floorf(px), y0f = floorf(py);
  const float fx = __fsub_rn(px, x0f), fy = __fsub_rn(py, y0f);
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  t.w00 = __fmul_rn(gx, gy);
  t.w01 = __fmul_rn(fx, gy);
  t.w10 = __fmul_rn(gx, fy);
  t.w11 = __fmul_rn(fx, fy);
  t.x0 = floor_index(x0f, W);
  t.y0 = floor_index(y0f, H);
  const bool vx0 = t.x0 >= 0 && t.x0 < W, vx1 = t.x0 + 1 >= 0 && t.x0 + 1 < W;
  const bool vy0 = t.y0 >= 0 && t.y0 < H, vy1 = t.y0 + 1 >= 0 && t.y0 + 1 < H;
  t.v00 = vy0 && vx0;
  t.v01 = vy0 && vx1;
  t.v10 = vy1 && vx0;
  t.v11 = vy1 && vx1;
  return t;
}

// The separable 0.999 validity mask of a sampling point: 1 or 0.
__device__ __forceinline__ float keep_of(float px, float py, int W, int H) {
  const float mx = clamp01(fminf(__fadd_rn(px, 1.f), __fsub_rn((float)W, px)));
  const float my = clamp01(fminf(__fadd_rn(py, 1.f), __fsub_rn((float)H, py)));
  return __fmul_rn(mx, my) >= 0.999f ? 1.f : 0.f;
}

// The gather's sum of four taps, in the plain version's order.
__device__ __forceinline__ float tap_sum(float v00, float v01, float v10,
                                         float v11, const Bilinear& t,
                                         float keep) {
  float acc = __fmul_rn(v00, t.w00);
  acc = __fadd_rn(acc, __fmul_rn(v01, t.w01));
  acc = __fadd_rn(acc, __fmul_rn(v10, t.w10));
  acc = __fadd_rn(acc, __fmul_rn(v11, t.w11));
  return __fmul_rn(acc, keep);
}

__device__ __forceinline__ float4 scale4(float4 v, float w) {
  return make_float4(__fmul_rn(v.x, w), __fmul_rn(v.y, w), __fmul_rn(v.z, w),
                     __fmul_rn(v.w, w));
}

// Route SCALAR of the gather at C other than 2, 3: one thread per output
// element (pixel i, channel c) of frame blockIdx.y.
__global__ void gather_lanes_kernel(const float* __restrict__ img,
                                    const float* __restrict__ sx,
                                    const float* __restrict__ sy,
                                    float* __restrict__ out, int B, int H,
                                    int W, int C, int Ho, int Wo, int mask) {
  const unsigned hw = (unsigned)Ho * Wo, n = hw * C;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const float* im = img + (int64_t)b * H * W * C;
    const float* bx = sx + (int64_t)b * hw;
    const float* by = sy + (int64_t)b * hw;
    float* o = out + (int64_t)b * n;
    for (unsigned e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
         e += gridDim.x * blockDim.x) {
      const unsigned i = e / C, c = e - i * C;
      const float px = bx[i], py = by[i];
      const Bilinear t = bilinear(px, py, W, H);
      const float keep = mask ? keep_of(px, py, W, H) : 1.f;
      const int64_t at = ((int64_t)t.y0 * W + t.x0) * C + c;
      const int64_t row = (int64_t)W * C;
      const float v00 = t.v00 ? __ldg(im + at) : 0.f;
      const float v01 = t.v01 ? __ldg(im + at + C) : 0.f;
      const float v10 = t.v10 ? __ldg(im + at + row) : 0.f;
      const float v11 = t.v11 ? __ldg(im + at + row + C) : 0.f;
      o[e] = tap_sum(v00, v01, v10, v11, t, keep);
    }
  }
}

// Route SCALAR of the gather at C = 2, 3: one thread per output pixel, its
// C values staged in shared memory, so that the block stores its run of
// kThreads·C floats with consecutive threads on consecutive floats.
template <int C>
__global__ void gather_pixels_kernel(const float* __restrict__ img,
                                     const float* __restrict__ sx,
                                     const float* __restrict__ sy,
                                     float* __restrict__ out, int B, int H,
                                     int W, int Ho, int Wo, int mask) {
  __shared__ float tile[kThreads * C];
  const unsigned hw = (unsigned)Ho * Wo;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const float* im = img + (int64_t)b * H * W * C;
    const float* bx = sx + (int64_t)b * hw;
    const float* by = sy + (int64_t)b * hw;
    float* o = out + (int64_t)b * hw * C;
    for (unsigned p0 = blockIdx.x * kThreads; p0 < hw;
         p0 += gridDim.x * kThreads) {
      const unsigned i = p0 + threadIdx.x;
      if (i < hw) {
        const float px = bx[i], py = by[i];
        const Bilinear t = bilinear(px, py, W, H);
        const float keep = mask ? keep_of(px, py, W, H) : 1.f;
        const float* r0 = im + ((int64_t)t.y0 * W + t.x0) * C;
        const float* r1 = r0 + (int64_t)W * C;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float v00 = t.v00 ? __ldg(r0 + c) : 0.f;
          const float v01 = t.v01 ? __ldg(r0 + C + c) : 0.f;
          const float v10 = t.v10 ? __ldg(r1 + c) : 0.f;
          const float v11 = t.v11 ? __ldg(r1 + C + c) : 0.f;
          tile[threadIdx.x * C + c] = tap_sum(v00, v01, v10, v11, t, keep);
        }
      }
      __syncthreads();
      const unsigned n = (hw - p0 < kThreads ? hw - p0 : kThreads) * C;
      for (unsigned j = threadIdx.x; j < n; j += kThreads)
        o[(int64_t)p0 * C + j] = tile[j];
      __syncthreads();
    }
  }
}

// Route VEC4 of the gather: one thread per (output pixel, 4-channel group)
// of frame blockIdx.y; C % 4 == 0, img and out 16-byte aligned.
__global__ void gather_vec4_kernel(const float* __restrict__ img,
                                   const float* __restrict__ sx,
                                   const float* __restrict__ sy,
                                   float* __restrict__ out, int B, int H,
                                   int W, int C, int Ho, int Wo, int mask) {
  const int G = C / 4;
  const unsigned hw = (unsigned)Ho * Wo, n = hw * G;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const float4* im =
        reinterpret_cast<const float4*>(img + (int64_t)b * H * W * C);
    const float* bx = sx + (int64_t)b * hw;
    const float* by = sy + (int64_t)b * hw;
    float4* o = reinterpret_cast<float4*>(out + (int64_t)b * hw * C);
    for (unsigned e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
         e += gridDim.x * blockDim.x) {
      const unsigned i = e / G, g = e - i * G;
      const float px = bx[i], py = by[i];
      const Bilinear t = bilinear(px, py, W, H);
      const float keep = mask ? keep_of(px, py, W, H) : 1.f;
      const int64_t at = ((int64_t)t.y0 * W + t.x0) * G + g;
      const int64_t row = (int64_t)W * G;
      const float4 q00 = t.v00 ? __ldg(im + at) : zero;
      const float4 q01 = t.v01 ? __ldg(im + at + G) : zero;
      const float4 q10 = t.v10 ? __ldg(im + at + row) : zero;
      const float4 q11 = t.v11 ? __ldg(im + at + row + G) : zero;
      o[e] = make_float4(tap_sum(q00.x, q01.x, q10.x, q11.x, t, keep),
                         tap_sum(q00.y, q01.y, q10.y, q11.y, t, keep),
                         tap_sum(q00.z, q01.z, q10.z, q11.z, t, keep),
                         tap_sum(q00.w, q01.w, q10.w, q11.w, t, keep));
    }
  }
}

// Route SCALAR of the splat: one thread per source element (pixel i,
// channel c) of frame blockIdx.y, four scalar reductions.
__global__ void splat_lanes_kernel(const float* __restrict__ vals,
                                   const float* __restrict__ tx,
                                   const float* __restrict__ ty,
                                   float* __restrict__ out, int B, int H,
                                   int W, int C) {
  const unsigned hw = (unsigned)H * W, n = hw * C;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const float* v = vals + (int64_t)b * n;
    const float* bx = tx + (int64_t)b * hw;
    const float* by = ty + (int64_t)b * hw;
    float* o = out + (int64_t)b * n;
    for (unsigned e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
         e += gridDim.x * blockDim.x) {
      const unsigned i = e / C, c = e - i * C;
      const Bilinear t = bilinear(bx[i], by[i], W, H);
      const float x = __ldg(v + e);
      const int64_t at = ((int64_t)t.y0 * W + t.x0) * C + c;
      const int64_t row = (int64_t)W * C;
      if (t.v00) atomicAdd(o + at, __fmul_rn(x, t.w00));
      if (t.v01) atomicAdd(o + at + C, __fmul_rn(x, t.w01));
      if (t.v10) atomicAdd(o + at + row, __fmul_rn(x, t.w10));
      if (t.v11) atomicAdd(o + at + row + C, __fmul_rn(x, t.w11));
    }
  }
}

// Route VEC4 of the splat: one thread per (source pixel, 4-channel group)
// of frame blockIdx.y, four 16-byte reductions; C % 4 == 0, vals and out
// 16-byte aligned.
__global__ void splat_vec4_kernel(const float* __restrict__ vals,
                                  const float* __restrict__ tx,
                                  const float* __restrict__ ty,
                                  float* __restrict__ out, int B, int H,
                                  int W, int C) {
  const int G = C / 4;
  const unsigned hw = (unsigned)H * W, n = hw * G;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const float4* v =
        reinterpret_cast<const float4*>(vals + (int64_t)b * hw * C);
    const float* bx = tx + (int64_t)b * hw;
    const float* by = ty + (int64_t)b * hw;
    float4* o = reinterpret_cast<float4*>(out + (int64_t)b * hw * C);
    for (unsigned e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
         e += gridDim.x * blockDim.x) {
      const unsigned i = e / G, g = e - i * G;
      const Bilinear t = bilinear(bx[i], by[i], W, H);
      const float4 x = __ldg(v + e);
      const int64_t at = ((int64_t)t.y0 * W + t.x0) * G + g;
      const int64_t row = (int64_t)W * G;
      if (t.v00) atomicAdd(o + at, scale4(x, t.w00));
      if (t.v01) atomicAdd(o + at + G, scale4(x, t.w01));
      if (t.v10) atomicAdd(o + at + row, scale4(x, t.w10));
      if (t.v11) atomicAdd(o + at + row + G, scale4(x, t.w11));
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

int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  return (int)(b < (1 << 30) ? (b > 0 ? b : 1) : (1 << 30));
}

// The routes of fldrx_gather_f32 and fldrx_splat_f32, as ops/fastwarp.py
// _route picks them.
constexpr int kScalar = 0, kVec4 = 1;

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// x: elements (or 4-channel groups) of one frame; y: frames.
dim3 grid_for(unsigned n, int B) {
  return dim3((n + kThreads - 1) / kThreads, B < 65535 ? B : 65535);
}

}  // namespace

extern "C" int fldrx_gather_f32(const float* img, const float* sx,
                                const float* sy, float* out, int B, int H,
                                int W, int C, int Ho, int Wo, int mask,
                                int route, void* stream) {
  const int64_t n = (int64_t)Ho * Wo * C;
  if (n >= (int64_t)1 << 31 ||
      (route == kVec4 && (C % 4 || !aligned16(img) || !aligned16(out))))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || B == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (route == kVec4)
    gather_vec4_kernel<<<grid_for(n / 4, B), kThreads, 0, s>>>(
        img, sx, sy, out, B, H, W, C, Ho, Wo, mask);
  else if (C == 3)
    gather_pixels_kernel<3><<<grid_for(n / 3, B), kThreads, 0, s>>>(
        img, sx, sy, out, B, H, W, Ho, Wo, mask);
  else if (C == 2)
    gather_pixels_kernel<2><<<grid_for(n / 2, B), kThreads, 0, s>>>(
        img, sx, sy, out, B, H, W, Ho, Wo, mask);
  else
    gather_lanes_kernel<<<grid_for(n, B), kThreads, 0, s>>>(
        img, sx, sy, out, B, H, W, C, Ho, Wo, mask);
  return (int)cudaGetLastError();
}

// Zeroes out, then adds into it.
extern "C" int fldrx_splat_f32(const float* vals, const float* tx,
                               const float* ty, float* out, int B, int H,
                               int W, int C, int route, void* stream) {
  const int64_t n = (int64_t)H * W * C;
  if (n >= (int64_t)1 << 31 ||
      (route == kVec4 && (C % 4 || !aligned16(vals) || !aligned16(out))))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || B == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * n * B, s);
  if (err != cudaSuccess) return (int)err;
  if (route == kVec4)
    splat_vec4_kernel<<<grid_for(n / 4, B), kThreads, 0, s>>>(
        vals, tx, ty, out, B, H, W, C);
  else
    splat_lanes_kernel<<<grid_for(n, B), kThreads, 0, s>>>(
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
