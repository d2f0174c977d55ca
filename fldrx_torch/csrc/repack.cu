// The u-plane interleave of the packed synthesis for fldrx_torch, for Hopper
// (sm_90a). Plain C entry point, loaded with ctypes by
// fldrx_torch/ops/_build.py; it launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().
//
// Replaces the TPU kernels _interleave_kernel2 (fldrx/ops/repack.py:77) and
// _interleave_kernel (:102), launched by interleave_planes (:127). For
// u-planes [B, 4, H/4, R] (R = the bytes of one frame row, W·C elements) it
// writes the plain rows [B, H, R]:
//   out[b, y] = planes[b, y % 4, y / 4]
// a pure permutation of whole rows, bit-exact for any element type. The
// TPU's one-hot matmul on the MXU and its per-row DMAs are not carried over:
// here each output row is one block that copies its source row with
// coalesced vector loads and stores.
//
// Design: one block of 256 threads per output row; the threads stride over
// the row in units of `Vec` (16 bytes where the row length and both base
// pointers allow it, else 4 or 2). Bound: bytes, every byte read once and
// written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename Vec>
__global__ void __launch_bounds__(kThreads)
interleave_kernel(const Vec* __restrict__ planes, Vec* __restrict__ out,
                  int H, int64_t row_vecs) {
  const int64_t r = blockIdx.x;           // output row, b * H + y
  const int64_t b = r / H;
  const int y = (int)(r - b * H);
  const int64_t src_row = b * H + (int64_t)(y & 3) * (H >> 2) + (y >> 2);
  const Vec* src = planes + src_row * row_vecs;
  Vec* dst = out + r * row_vecs;
  for (int64_t i = threadIdx.x; i < row_vecs; i += kThreads) dst[i] = src[i];
}

template <typename Vec>
void launch(const void* planes, void* out, int B, int H, int64_t row_bytes,
            cudaStream_t stream) {
  interleave_kernel<Vec><<<(unsigned)((int64_t)B * H), kThreads, 0, stream>>>(
      (const Vec*)planes, (Vec*)out, H, row_bytes / (int64_t)sizeof(Vec));
}

bool aligned(const void* p, int n) { return ((uintptr_t)p % n) == 0; }

}  // namespace

// planes [B, 4, H/4, row_bytes] -> out [B, H, row_bytes]; H a multiple of 4,
// row_bytes even (float32 and bfloat16 rows).
extern "C" int fldrx_interleave_planes(const void* planes, void* out, int B,
                                       int H, int row_bytes, void* stream) {
  if (B <= 0 || H <= 0 || row_bytes <= 0) return (int)cudaGetLastError();
  if (H % 4 != 0 || row_bytes % 2 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (row_bytes % 16 == 0 && aligned(planes, 16) && aligned(out, 16))
    launch<uint4>(planes, out, B, H, row_bytes, s);
  else if (row_bytes % 4 == 0 && aligned(planes, 4) && aligned(out, 4))
    launch<uint32_t>(planes, out, B, H, row_bytes, s);
  else
    launch<uint16_t>(planes, out, B, H, row_bytes, s);
  return (int)cudaGetLastError();
}
