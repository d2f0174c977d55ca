// The u-plane interleave of the packed synthesis and its inverse for
// fldrx_torch, for Hopper (sm_90a). Plain C entry points, loaded with ctypes
// by fldrx_torch/ops/_build.py; each launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().
//
// Replaces the TPU kernels _interleave_kernel2 (fldrx/ops/repack.py:77) and
// _interleave_kernel (:102), launched by interleave_planes (:127), and their
// inverses _deinterleave_kernel2 (:91) and _deinterleave_kernel (:182),
// launched by extract_planes (:200). For u-planes [B, 4, H/4, R] and plain
// rows [B, H, R] (R = the bytes of one frame row, W·C elements):
//   interleave:   out[b, y] = planes[b, y % 4, y / 4]
//   deinterleave: planes[b, y % 4, y / 4] = rows[b, y]
// pure permutations of whole rows, bit-exact for any element type. The
// TPU's one-hot matmuls on the MXU and its per-row DMAs are not carried
// over: here each row is one block that copies it with coalesced vector
// loads and stores.
//
// Design: one block of 256 threads per row; the threads stride over the row
// in units of `Vec` (16 bytes where the row length and both base pointers
// allow it, else 4 or 2). Bound: bytes, every byte read once and written
// once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// row r = b * H + y of the plain rows <-> row b * H + (y % 4) * H/4 + y / 4
// of the u-planes
__device__ __forceinline__ int64_t plane_row(int64_t r, int H) {
  const int64_t b = r / H;
  const int y = (int)(r - b * H);
  return b * H + (int64_t)(y & 3) * (H >> 2) + (y >> 2);
}

template <typename Vec>
__device__ __forceinline__ void copy_row(const Vec* __restrict__ src,
                                         Vec* __restrict__ dst,
                                         int64_t row_vecs) {
  for (int64_t i = threadIdx.x; i < row_vecs; i += kThreads) dst[i] = src[i];
}

// one block per output row
template <typename Vec>
__global__ void __launch_bounds__(kThreads)
interleave_kernel(const Vec* __restrict__ planes, Vec* __restrict__ out,
                  int H, int64_t row_vecs) {
  const int64_t r = blockIdx.x;
  copy_row(planes + plane_row(r, H) * row_vecs, out + r * row_vecs, row_vecs);
}

// one block per input row
template <typename Vec>
__global__ void __launch_bounds__(kThreads)
deinterleave_kernel(const Vec* __restrict__ rows, Vec* __restrict__ planes,
                    int H, int64_t row_vecs) {
  const int64_t r = blockIdx.x;
  copy_row(rows + r * row_vecs, planes + plane_row(r, H) * row_vecs, row_vecs);
}

template <typename Vec, bool kToPlanes>
void launch(const void* src, void* dst, int B, int H, int64_t row_bytes,
            cudaStream_t stream) {
  const unsigned blocks = (unsigned)((int64_t)B * H);
  const int64_t row_vecs = row_bytes / (int64_t)sizeof(Vec);
  if constexpr (kToPlanes)
    deinterleave_kernel<Vec><<<blocks, kThreads, 0, stream>>>(
        (const Vec*)src, (Vec*)dst, H, row_vecs);
  else
    interleave_kernel<Vec><<<blocks, kThreads, 0, stream>>>(
        (const Vec*)src, (Vec*)dst, H, row_vecs);
}

bool aligned(const void* p, int n) { return ((uintptr_t)p % n) == 0; }

template <bool kToPlanes>
int repack(const void* src, void* dst, int B, int H, int row_bytes,
           void* stream) {
  if (B <= 0 || H <= 0 || row_bytes <= 0) return (int)cudaGetLastError();
  if (H % 4 != 0 || row_bytes % 2 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (row_bytes % 16 == 0 && aligned(src, 16) && aligned(dst, 16))
    launch<uint4, kToPlanes>(src, dst, B, H, row_bytes, s);
  else if (row_bytes % 4 == 0 && aligned(src, 4) && aligned(dst, 4))
    launch<uint32_t, kToPlanes>(src, dst, B, H, row_bytes, s);
  else
    launch<uint16_t, kToPlanes>(src, dst, B, H, row_bytes, s);
  return (int)cudaGetLastError();
}

}  // namespace

// planes [B, 4, H/4, row_bytes] -> out [B, H, row_bytes]; H a multiple of 4,
// row_bytes even (float32 and bfloat16 rows).
extern "C" int fldrx_interleave_planes(const void* planes, void* out, int B,
                                       int H, int row_bytes, void* stream) {
  return repack<false>(planes, out, B, H, row_bytes, stream);
}

// rows [B, H, row_bytes] -> out [B, 4, H/4, row_bytes]; the same conditions.
extern "C" int fldrx_extract_planes(const void* rows, void* out, int B, int H,
                                    int row_bytes, void* stream) {
  return repack<true>(rows, out, B, H, row_bytes, stream);
}
