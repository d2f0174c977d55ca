// The float32 resizes of fldrx_torch, for Hopper (sm_90a): bicubic,
// bilinear and nearest as separable tap filters. A plain C entry point,
// loaded with ctypes by fldrx_torch/ops/_build.py; it launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
//
// Replaces no TPU kernel: fldrx leaves its resize to XLA as two dense
// einsums against [out, in] interpolation matrices (fldrx/ops/resize.py:117),
// and ops/resize.py runs the same two einsums on the CPU and in training.
// Added because on the card the dense form does ≈400 GFLOP of float32
// matmuls in each of the 4K pair's pyramid and flow-extras stages (the
// frame pair to half size alone is 246 GFLOP), ≈10 ms a stage on an H100,
// for filters whose real taps are 4 (bicubic), 2 (bilinear) or 1
// (nearest) per output and axis.
//
// Function: x [N, H, W, C] float32 at any strides, C ≤ 4 (every resize of
// the port's paths: frames 3, flows 2 or 4, z maps 1) → out [N, OH, OW, C]
// row-major, with the tap tables of ops/resize.py (`_taps_np`: each output
// row's nonzero columns of the dense matrix, ascending, and their float32
// weights, padded with weight 0 to K ∈ {1, 2, 4} taps):
//   rows[oy, w, c] = Σ_i wy[oy, i] · x[iy[oy, i], w, c]
//   out[oy, ox, c] = Σ_j wx[ox, j] · rows[oy, ix[ox, j], c]
// rows first, as the dense form's first einsum, each sum in tap order with
// separate roundings (no fused multiply-add), so the kernel equals the
// plain version `resize_taps_plain` bit for bit.
//
// Bound: bytes, the input read once and the output written once (the ×8
// flow upsample of the 4K path writes 75.5 MB: 0.023 ms at 3.35 TB/s);
// the taps are ≤ 32 flops an output.
//
// Design: one block per output row and tile of `tw` output columns. The
// rows pass reads the tile's footprint, the input columns from its
// outputs' first tap to their last (`spans`, from the host), as one flat
// run of (column, channel) elements: adjacent threads on adjacent floats,
// so each of the row's taps is a coalesced load. It keeps the column sums
// in shared memory; the columns pass then reads them there and writes the
// tile's outputs as one contiguous run, adjacent threads on adjacent
// floats. Neighbouring
// outputs share their taps through shared memory (the ×8 upsample's 8 × 8
// outputs read 2 × 2 inputs) and neighbouring rows' blocks share input
// rows through L1/L2 (a ÷2 bicubic reads each input row for 2 output
// rows). The host picks `tw` so that the footprint fits `smem_floats`
// (ops/resize.py `_tile_np`).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 4;
constexpr int kMaxSmemFloats = 12288;   // 48 KB, no opt-in needed

template <int C>
__global__ void __launch_bounds__(kThreads)
resize_taps_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int64_t sn, int64_t sh, int64_t sw, int64_t sc,
                   int OH, int OW, int rows, int tw,
                   const int* __restrict__ spans,
                   const int* __restrict__ iy, const float* __restrict__ wy,
                   int ky, const int* __restrict__ ix,
                   const float* __restrict__ wx, int kx) {
  extern __shared__ float col[];
  const int ox0 = blockIdx.x * tw;
  const int ox1 = min(ox0 + tw, OW);
  const int lo = __ldg(spans + 2 * blockIdx.x);
  const int hi = __ldg(spans + 2 * blockIdx.x + 1);
  const int n_in = (hi - lo + 1) * C;
  const int n_out = (ox1 - ox0) * C;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int n = row / OH;
    const int oy = row - n * OH;
    const float* src = x + n * sn + lo * sw;
    int64_t yoff[kMaxTaps];
    float yw[kMaxTaps];
#pragma unroll
    for (int i = 0; i < kMaxTaps; ++i) {
      yoff[i] = i < ky ? __ldg(iy + (int64_t)oy * ky + i) * sh : 0;
      yw[i] = i < ky ? __ldg(wy + (int64_t)oy * ky + i) : 0.f;
    }
    // rows pass: the footprint's column sums
#pragma unroll 2
    for (int e = threadIdx.x; e < n_in; e += kThreads) {
      const int p = e / C;
      const float* s = src + p * sw + (e - p * C) * sc;
      float acc = __fmul_rn(yw[0], __ldg(s + yoff[0]));
#pragma unroll
      for (int i = 1; i < kMaxTaps; ++i)
        if (i < ky) acc = __fadd_rn(acc, __fmul_rn(yw[i], __ldg(s + yoff[i])));
      col[e] = acc;
    }
    __syncthreads();
    // columns pass: the tile's outputs, one contiguous run
    float* dst = out + ((int64_t)row * OW + ox0) * C;
    for (int e = threadIdx.x; e < n_out; e += kThreads) {
      const int p = e / C;
      const int c = e - p * C;
      const int64_t o = (int64_t)(ox0 + p) * kx;
      float acc = __fmul_rn(__ldg(wx + o), col[(__ldg(ix + o) - lo) * C + c]);
#pragma unroll
      for (int j = 1; j < kMaxTaps; ++j)
        if (j < kx)
          acc = __fadd_rn(acc,
                          __fmul_rn(__ldg(wx + o + j),
                                    col[(__ldg(ix + o + j) - lo) * C + c]));
      dst[e] = acc;
    }
    __syncthreads();
  }
}

template <int C>
void launch(const float* x, float* out, const long long* st, int OH,
            int OW, int rows, int tw, const int* spans, int smem_floats,
            const int* iy, const float* wy, int ky, const int* ix,
            const float* wx, int kx, cudaStream_t s) {
  const dim3 grid((unsigned)((OW + tw - 1) / tw),
                  (unsigned)(rows < 65535 ? rows : 65535));
  resize_taps_kernel<C><<<grid, kThreads, smem_floats * sizeof(float), s>>>(
      x, out, st[0], st[1], st[2], st[3], OH, OW, rows, tw, spans, iy, wy, ky,
      ix, wx, kx);
}

}  // namespace

// x [N, H, W, C] float32, C in 1..4, at the element strides strides[0..3]
// (a host array) → out [N, OH, OW, C] row-major. iy, wy: [OH, ky] int32
// and float32 tap tables on the device, ix, wx: [OW, kx]; ky, kx in 1..4.
// tw output columns a block; spans [ceil(OW / tw), 2] int32 on the device,
// each tile's first and last input column; smem_floats ≥ the largest tile
// footprint (columns × C), at most 12288. H and W are the input's, for
// the checks only.
extern "C" int fldrx_resize_taps_f32(const void* x, const void* strides,
                                     int N, int H, int W, int C,
                                     const void* iy, const void* wy, int ky,
                                     const void* ix, const void* wx, int kx,
                                     int OH, int OW, int tw,
                                     const void* spans, int smem_floats,
                                     void* out, void* stream) {
  if (N <= 0 || OH <= 0 || OW <= 0) return (int)cudaGetLastError();
  if (H <= 0 || W <= 0 || C < 1 || C > 4 || ky < 1 || ky > kMaxTaps ||
      kx < 1 || kx > kMaxTaps || tw <= 0 || smem_floats <= 0 ||
      smem_floats > kMaxSmemFloats)
    return (int)cudaErrorInvalidValue;
  if ((long long)N * OH > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long* st = (const long long*)strides;
  const float* xf = (const float*)x;
  float* o = (float*)out;
  const int rows = N * OH;
  cudaStream_t s = (cudaStream_t)stream;
  const int* iyp = (const int*)iy;
  const int* ixp = (const int*)ix;
  const float* wyp = (const float*)wy;
  const float* wxp = (const float*)wx;
  const int* sp = (const int*)spans;
  switch (C) {
    case 1: launch<1>(xf, o, st, OH, OW, rows, tw, sp, smem_floats, iyp, wyp,
                      ky, ixp, wxp, kx, s); break;
    case 2: launch<2>(xf, o, st, OH, OW, rows, tw, sp, smem_floats, iyp, wyp,
                      ky, ixp, wxp, kx, s); break;
    case 3: launch<3>(xf, o, st, OH, OW, rows, tw, sp, smem_floats, iyp, wyp,
                      ky, ixp, wxp, kx, s); break;
    default: launch<4>(xf, o, st, OH, OW, rows, tw, sp, smem_floats, iyp, wyp,
                       ky, ixp, wxp, kx, s); break;
  }
  return (int)cudaGetLastError();
}
