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
// kernels above. It reads the cotangent g at the four corners of (tx, ty)
// and writes
//   dvals[i,c] = sum_k w_k g[corner_k, c]          (updateGradInput)
//   dtx[i] = sum_c vals[i,c] ((1-fy)(g01-g00) + fy(g11-g10))
//   dty[i] = sum_c vals[i,c] ((1-fx)(g10-g00) + fx(g11-g01))  (updateGradFlow)
// (each bracket evaluated as a difference of two y-samples, d_along)
// with out-of-frame corners read as 0, as the forward drops them. fldrx
// builds the same numbers from five gathers, four of them at integer taps;
// here they are one pass, with no atomics. dvals is summed term for term
// as the gather sums (the plain version's order), so it matches bit for
// bit. Bound: bytes (g read, coordinates, dvals written; with dtx/dty also
// vals read and dtx/dty written). Two forms, each with its layout:
//   dvals only (dtx, dty null; the feature splats, whose flow is
//     detached): dvals IS the gather of g at (tx, ty) with no mask, so the
//     entry point launches the gather kernels above, on their routes.
//   dvals and dtx/dty (the softmax splats, C = 4): lane groups (below),
//     with 16-byte loads of g, vals and stores of dvals where C % 4 == 0
//     and the pointers allow it: at C = 4 one thread per pixel, four tap
//     loads, one load of vals and one store.
//
// gather_grad is the VJP of gather, fldrx's _bwarp_diff_bwd
// (fldrx/ops/fastwarp.py:1569) without its S/(S-1) factor, which the port's
// autograd adds through the sampling coordinates. With gm = g * keep (keep
// is the 0.999 mask, whose derivative is 0):
//   dimg: gm * w_k added into the four corners by float reductions. The
//         order of colliding adds changes from run to run, so dimg is NOT
//         deterministic (the TPU's splat_at is); comparisons use
//         1e-4 * (1 + |ref|), as for the splat.
//   dsx[i] = sum_c gm_c ((1-fy)(I01-I00) + fy(I11-I10))
//   dsy[i] = sum_c gm_c ((1-fx)(I10-I00) + fx(I11-I01))
// Bound: bytes (img and g read, coordinates, dimg, dsx, dsy written), the
// dimg adds resolved in L2. Two forms, each with its layout:
//   coords only (dimg null; the z and im_tot gathers, which warp data
//     frames): no atomics, a dot product over C per pixel. At C = 2, 3 one
//     thread per pixel, the block's run of g staged through shared memory
//     with consecutive threads on consecutive floats (as the gather's
//     stores); chosen by measurement against lane groups, which were
//     slower at C = 3 (PERF.md's kernel table); at other C lane groups. Its C = 3
//     tap loads are the forward gather's and bound it the same way.
//   dimg (the flowback gathers, C = 2, which warp a flow): lane groups, a
//     lane on V channels, every add a reduction whose result is unused
//     (RED), V floats wide: at C = 2 one float2 RED per corner, chosen by
//     measurement against two scalar ones. Merging a pixel's right-corner
//     adds into its right neighbour's left-corner adds where they hit the
//     same cells (half the reductions on a smooth flow) was measured and
//     did not pay.
// Lane groups: a pixel's C/V units of V channels (V = 4, or 2, where C and
// the pointers allow 16- or 8-byte accesses, else 1) spread over L lanes,
// L the power of two at or above C/V, at most 32, so that groups tile a
// warp; lane j takes units j, j + L, ... and the group sums its dsx/dsy
// (dtx/dty) with __shfl_xor_sync. The sums over channels change order
// against the plain version: 1e-4 * (1 + |ref|).
// Either gather_grad output is skipped when its pointer is null; the entry
// point zeroes dimg.

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
  float fx, fy, gx, gy;
  int x0, y0;
  bool v00, v01, v10, v11;
};

__device__ __forceinline__ Bilinear bilinear(float px, float py, int W,
                                             int H) {
  Bilinear t;
  const float x0f = floorf(px), y0f = floorf(py);
  t.fx = __fsub_rn(px, x0f);
  t.fy = __fsub_rn(py, y0f);
  t.gx = __fsub_rn(1.f, t.fx);
  t.gy = __fsub_rn(1.f, t.fy);
  t.w00 = __fmul_rn(t.gx, t.gy);
  t.w01 = __fmul_rn(t.fx, t.gy);
  t.w10 = __fmul_rn(t.gx, t.fy);
  t.w11 = __fmul_rn(t.fx, t.fy);
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

// The bilinear sum of four taps, in the plain version's order.
__device__ __forceinline__ float bilinear_sum(float v00, float v01, float v10,
                                              float v11, const Bilinear& t) {
  float acc = __fmul_rn(v00, t.w00);
  acc = __fadd_rn(acc, __fmul_rn(v01, t.w01));
  acc = __fadd_rn(acc, __fmul_rn(v10, t.w10));
  return __fadd_rn(acc, __fmul_rn(v11, t.w11));
}

// The gather's sum: the bilinear sum times the mask.
__device__ __forceinline__ float tap_sum(float v00, float v01, float v10,
                                         float v11, const Bilinear& t,
                                         float keep) {
  return __fmul_rn(bilinear_sum(v00, v01, v10, v11, t), keep);
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

// V consecutive floats: loaded (0 where `ok` is false), stored, added by
// one reduction (atomicAdd on float2/float4, sm_90, whose unused result
// makes it RED).
template <int V>
__device__ __forceinline__ void load_v(const float* p, bool ok, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 q = ok ? __ldg(reinterpret_cast<const float4*>(p))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = ok ? __ldg(reinterpret_cast<const float2*>(p))
                        : make_float2(0.f, 0.f);
    x[0] = q.x; x[1] = q.y;
  } else {
    x[0] = ok ? __ldg(p) : 0.f;
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&x)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else if constexpr (V == 2)
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  else
    *p = x[0];
}

template <int V>
__device__ __forceinline__ void red_v(float* p, const float (&x)[V], float w) {
  if constexpr (V == 4)
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(__fmul_rn(x[0], w), __fmul_rn(x[1], w),
                          __fmul_rn(x[2], w), __fmul_rn(x[3], w)));
  else if constexpr (V == 2)
    atomicAdd(reinterpret_cast<float2*>(p),
              make_float2(__fmul_rn(x[0], w), __fmul_rn(x[1], w)));
  else
    atomicAdd(p, __fmul_rn(x[0], w));
}

// The sum of v over a lane group of 2^lg lanes, in every lane of it; all
// 32 lanes of the warp must call it.
__device__ __forceinline__ float group_sum(float v, int lg) {
  for (int o = (1 << lg) >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// splat_grad with dtx/dty, lane groups: lane `lane` of the 2^lg lanes of
// source pixel i (frame blockIdx.y) takes the V-channel units lane,
// lane + 2^lg, ...; vals, g and dvals V-float aligned.
template <int V>
__global__ void splat_grad_lanes_kernel(const float* __restrict__ vals,
                                        const float* __restrict__ tx,
                                        const float* __restrict__ ty,
                                        const float* __restrict__ g,
                                        float* __restrict__ dvals,
                                        float* __restrict__ dtx,
                                        float* __restrict__ dty, int B, int H,
                                        int W, int C, int lg) {
  const unsigned hw = (unsigned)H * W;
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned i = (unsigned)(e >> lg);
  const int lane = (int)(e & ((1 << lg) - 1)), U = C / V;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const int64_t pix = (int64_t)b * hw + i;
    float ax = 0.f, ay = 0.f;
    if (i < hw) {
      const Bilinear t = bilinear(tx[pix], ty[pix], W, H);
      const float* r0 = g + ((int64_t)b * hw + (int64_t)t.y0 * W + t.x0) * C;
      const float* r1 = r0 + (int64_t)W * C;
      for (int u = lane; u < U; u += 1 << lg) {
        const int c = u * V;
        float g00[V], g01[V], g10[V], g11[V], v[V], dv[V];
        load_v<V>(r0 + c, t.v00, g00);
        load_v<V>(r0 + C + c, t.v01, g01);
        load_v<V>(r1 + c, t.v10, g10);
        load_v<V>(r1 + C + c, t.v11, g11);
        load_v<V>(vals + pix * C + c, true, v);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          dv[k] = bilinear_sum(g00[k], g01[k], g10[k], g11[k], t);
          ax += v[k] * d_along(g00[k], g01[k], g10[k], g11[k], t.gy, t.fy);
          ay += v[k] * d_along(g00[k], g10[k], g01[k], g11[k], t.gx, t.fx);
        }
        store_v<V>(dvals + pix * C + c, dv);
      }
    }
    ax = group_sum(ax, lg);
    ay = group_sum(ay, lg);
    if (i < hw && lane == 0) {
      dtx[pix] = ax;
      dty[pix] = ay;
    }
  }
}

// gather_grad, lane groups: lane `lane` of the 2^lg lanes of output pixel
// i (frame blockIdx.y) takes the V-channel units lane, lane + 2^lg, ...,
// adds gm·w_k into dimg's corners (if set) and its share of dsx/dsy (if
// set); img, g and dimg V-float aligned.
template <int V>
__global__ void gather_grad_lanes_kernel(const float* __restrict__ img,
                                         const float* __restrict__ sx,
                                         const float* __restrict__ sy,
                                         const float* __restrict__ g,
                                         float* __restrict__ dimg,
                                         float* __restrict__ dsx,
                                         float* __restrict__ dsy, int B,
                                         int H, int W, int C, int Ho, int Wo,
                                         int mask, int lg) {
  const unsigned hw = (unsigned)Ho * Wo;
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned i = (unsigned)(e >> lg);
  const int lane = (int)(e & ((1 << lg) - 1)), U = C / V;
  const bool coords = dsx != nullptr;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const int64_t pix = (int64_t)b * hw + i;
    float ax = 0.f, ay = 0.f;
    if (i < hw) {
      const float px = sx[pix], py = sy[pix];
      // keep = 0: gm = 0, nothing to add
      if (!mask || keep_of(px, py, W, H) != 0.f) {
        const Bilinear t = bilinear(px, py, W, H);
        const int64_t at = ((int64_t)b * H * W + (int64_t)t.y0 * W + t.x0) * C;
        const int64_t row = (int64_t)W * C;
        const float* gp = g + pix * C;
        for (int u = lane; u < U; u += 1 << lg) {
          const int c = u * V;
          float gm[V];
          load_v<V>(gp + c, true, gm);
          if (dimg) {
            if (t.v00) red_v<V>(dimg + at + c, gm, t.w00);
            if (t.v01) red_v<V>(dimg + at + C + c, gm, t.w01);
            if (t.v10) red_v<V>(dimg + at + row + c, gm, t.w10);
            if (t.v11) red_v<V>(dimg + at + row + C + c, gm, t.w11);
          }
          if (coords) {
            float i00[V], i01[V], i10[V], i11[V];
            load_v<V>(img + at + c, t.v00, i00);
            load_v<V>(img + at + C + c, t.v01, i01);
            load_v<V>(img + at + row + c, t.v10, i10);
            load_v<V>(img + at + row + C + c, t.v11, i11);
#pragma unroll
            for (int k = 0; k < V; ++k) {
              ax += gm[k] * d_along(i00[k], i01[k], i10[k], i11[k], t.gy,
                                    t.fy);
              ay += gm[k] * d_along(i00[k], i10[k], i01[k], i11[k], t.gx,
                                    t.fx);
            }
          }
        }
      }
    }
    if (coords) {
      ax = group_sum(ax, lg);
      ay = group_sum(ay, lg);
      if (i < hw && lane == 0) {
        dsx[pix] = ax;
        dsy[pix] = ay;
      }
    }
  }
}

// gather_grad, coords only, at C = 2, 3: one thread per output pixel; the
// block stages its run of kThreads·C floats of g in shared memory, loaded
// with consecutive threads on consecutive floats.
template <int C>
__global__ void gather_grad_pixels_kernel(const float* __restrict__ img,
                                          const float* __restrict__ sx,
                                          const float* __restrict__ sy,
                                          const float* __restrict__ g,
                                          float* __restrict__ dsx,
                                          float* __restrict__ dsy, int B,
                                          int H, int W, int Ho, int Wo,
                                          int mask) {
  __shared__ float tile[kThreads * C];
  const unsigned hw = (unsigned)Ho * Wo, p0 = blockIdx.x * kThreads;
  const unsigned i = p0 + threadIdx.x;
  const unsigned n = (hw - p0 < kThreads ? hw - p0 : kThreads) * C;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const float* gb = g + ((int64_t)b * hw + p0) * C;
    for (unsigned j = threadIdx.x; j < n; j += kThreads) tile[j] = __ldg(gb + j);
    __syncthreads();
    if (i < hw) {
      const int64_t pix = (int64_t)b * hw + i;
      const float px = sx[pix], py = sy[pix];
      float ax = 0.f, ay = 0.f;
      if (!mask || keep_of(px, py, W, H) != 0.f) {
        const Bilinear t = bilinear(px, py, W, H);
        const float* r0 =
            img + ((int64_t)b * H * W + (int64_t)t.y0 * W + t.x0) * C;
        const float* r1 = r0 + (int64_t)W * C;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float i00 = t.v00 ? __ldg(r0 + c) : 0.f;
          const float i01 = t.v01 ? __ldg(r0 + C + c) : 0.f;
          const float i10 = t.v10 ? __ldg(r1 + c) : 0.f;
          const float i11 = t.v11 ? __ldg(r1 + C + c) : 0.f;
          const float gm = tile[threadIdx.x * C + c];
          ax += gm * d_along(i00, i01, i10, i11, t.gy, t.fy);
          ay += gm * d_along(i00, i10, i01, i11, t.gx, t.fx);
        }
      }
      dsx[pix] = ax;
      dsy[pix] = ay;
    }
    __syncthreads();
  }
}

// The routes of fldrx_gather_f32 and fldrx_splat_f32, as ops/fastwarp.py
// _route picks them.
constexpr int kScalar = 0, kVec4 = 1;

bool aligned(const void* p, uintptr_t bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

bool aligned16(const void* p) { return aligned(p, 16); }

// x: elements (or 4-channel groups) of one frame; y: frames.
dim3 grid_for(unsigned n, int B) {
  return dim3((n + kThreads - 1) / kThreads, B < 65535 ? B : 65535);
}

// The gather's kernels, on `route` (checked by the caller).
void launch_gather(const float* img, const float* sx, const float* sy,
                   float* out, int B, int H, int W, int C, int Ho, int Wo,
                   int mask, int route, cudaStream_t s) {
  const unsigned n = (unsigned)Ho * Wo * C;
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
}

// The VJP kernels' vector width: 4 where C % 4 == 0 and every pointer is
// 16-byte aligned, 2 where C is even and every pointer 8-byte aligned,
// else 1. Null pointers are not read and do not count.
int vec_width(int C, const void* a, const void* b, const void* c) {
  const bool a16 = aligned(a, 16) && aligned(b, 16) && aligned(c, 16);
  if (C % 4 == 0 && a16) return 4;
  const bool a8 = aligned(a, 8) && aligned(b, 8) && aligned(c, 8);
  return C % 2 == 0 && a8 ? 2 : 1;
}

// log2 of the lane group of `units` units per pixel: the power of two at or
// above it, at most 32.
int group_log2(int units) {
  int lg = 0;
  while (lg < 5 && (1 << lg) < units) ++lg;
  return lg;
}

// Lane groups over hw pixels of 2^lg lanes each, whole blocks; y: frames.
dim3 grid_lanes(unsigned hw, int lg, int B) {
  const int64_t threads = (int64_t)hw << lg;
  return dim3((unsigned)((threads + kThreads - 1) / kThreads),
              B < 65535 ? B : 65535);
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
  launch_gather(img, sx, sy, out, B, H, W, C, Ho, Wo, mask, route,
                (cudaStream_t)stream);
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

// dtx and dty both null (dvals only: the gather of g, on the gather's
// route) or both set (lane groups).
extern "C" int fldrx_splat_grad_f32(const float* vals, const float* tx,
                                    const float* ty, const float* g,
                                    float* dvals, float* dtx, float* dty,
                                    int B, int H, int W, int C,
                                    void* stream) {
  const int64_t n = (int64_t)H * W * C;
  if (n >= (int64_t)1 << 31 || (dtx == nullptr) != (dty == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || B == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtx == nullptr) {
    const int route = C % 4 == 0 && aligned16(g) && aligned16(dvals)
                          ? kVec4 : kScalar;
    launch_gather(g, tx, ty, dvals, B, H, W, C, H, W, 0, route, s);
    return (int)cudaGetLastError();
  }
  const int V = vec_width(C, vals, g, dvals), lg = group_log2(C / V);
  const dim3 grid = grid_lanes((unsigned)H * W, lg, B);
  if (V == 4)
    splat_grad_lanes_kernel<4><<<grid, kThreads, 0, s>>>(
        vals, tx, ty, g, dvals, dtx, dty, B, H, W, C, lg);
  else if (V == 2)
    splat_grad_lanes_kernel<2><<<grid, kThreads, 0, s>>>(
        vals, tx, ty, g, dvals, dtx, dty, B, H, W, C, lg);
  else
    splat_grad_lanes_kernel<1><<<grid, kThreads, 0, s>>>(
        vals, tx, ty, g, dvals, dtx, dty, B, H, W, C, lg);
  return (int)cudaGetLastError();
}

// dimg null or zeroed here, then added into; dsx and dsy both null, or
// both set. Coords only at C = 2, 3: a thread per pixel; else lane groups.
extern "C" int fldrx_gather_grad_f32(const float* img, const float* sx,
                                     const float* sy, const float* g,
                                     float* dimg, float* dsx, float* dsy,
                                     int B, int H, int W, int C, int Ho,
                                     int Wo, int mask, void* stream) {
  const int64_t n_img = (int64_t)H * W * C, n_out = (int64_t)Ho * Wo * C;
  if (n_img >= (int64_t)1 << 31 || n_out >= (int64_t)1 << 31 ||
      (dsx == nullptr) != (dsy == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_img == 0 || B == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dimg) {
    const cudaError_t err =
        cudaMemsetAsync(dimg, 0, sizeof(float) * n_img * B, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_out == 0 || (!dimg && !dsx)) return (int)cudaGetLastError();
  const unsigned hw = (unsigned)Ho * Wo;
  if (!dimg && (C == 2 || C == 3)) {
    const dim3 grid((hw + kThreads - 1) / kThreads, B < 65535 ? B : 65535);
    if (C == 3)
      gather_grad_pixels_kernel<3><<<grid, kThreads, 0, s>>>(
          img, sx, sy, g, dsx, dsy, B, H, W, Ho, Wo, mask);
    else
      gather_grad_pixels_kernel<2><<<grid, kThreads, 0, s>>>(
          img, sx, sy, g, dsx, dsy, B, H, W, Ho, Wo, mask);
    return (int)cudaGetLastError();
  }
  const int V = vec_width(C, img, g, dimg ? dimg : img);
  const int lg = group_log2(C / V);
  const dim3 grid = grid_lanes(hw, lg, B);
  if (V == 4)
    gather_grad_lanes_kernel<4><<<grid, kThreads, 0, s>>>(
        img, sx, sy, g, dimg, dsx, dsy, B, H, W, C, Ho, Wo, mask, lg);
  else if (V == 2)
    gather_grad_lanes_kernel<2><<<grid, kThreads, 0, s>>>(
        img, sx, sy, g, dimg, dsx, dsy, B, H, W, C, Ho, Wo, mask, lg);
  else
    gather_grad_lanes_kernel<1><<<grid, kThreads, 0, s>>>(
        img, sx, sy, g, dimg, dsx, dsy, B, H, W, C, Ho, Wo, mask, lg);
  return (int)cudaGetLastError();
}
