// The packed synthesis's repacks for fldrx_torch, for Hopper (sm_90a): the
// u-plane interleave and its inverse, and the refine UNet's space-to-depth
// input (pack_s2d4, below). Plain C entry points, loaded with ctypes by
// fldrx_torch/ops/_build.py; each launches on the caller's stream,
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

#include <cuda_bf16.h>
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


// ---------------------------------------------------------------------------
// pack_s2d4: the refine UNet's input in one pass
// ---------------------------------------------------------------------------
//
// Replaces no TPU kernel: fldrx leaves this step to XLA
// (fldrx/model/fldrnet.py:851, a jnp.concatenate of its u-plane pieces,
// cast to the UNet's dtype). Added because in PyTorch the same step is
// three passes over device memory: torch.cat of the ten float32 sources
// (26 channels, scattered 8- and 12-byte stores), .to(bfloat16) and the s2d
// permute-and-copy; at 4K on an H100 they took 6.7 ms a t, 15 times what
// the bytes need.
//
// Function: n ≤ 12 float32 NHWC sources [B, H, W, c_i], any batch stride,
// each frame's channels contiguous and either its pixels (rows: a row
// stride of its own) or its rows (columns: the frame stored W-major, as a
// resize's einsum leaves a flow field; a column stride of its own)
// contiguous, C = Σ c_i ≤ 32, H and W multiples of 4 → out
// [B, H/4, W/4, 16·C] in bfloat16 (round to nearest even, as .to() does)
// or float32, cell-major: out[b, y, x, (u·4 + v)·C + offset_i + c] =
// source_i[b, 4y + u, 4x + v, c]. Bit-exact with the three passes.
//
// Bound: bytes, each source read once and the output written once: 26 ×
// (4 + 2) bytes a pixel at 4K (2304×4096) is 1.47 GB, 0.44 ms at 3.35 TB/s.
//
// Design: one block per cell row (4 image rows) and a run of NC cells of
// one frame. Loads: what the block reads of a source is 4 contiguous runs
// (rows) or 4·NC contiguous pieces of 4·c_i floats (columns: a whole 32-
// or 48-byte sector each), so the block walks them as one flat index space
// of 16-byte vectors (4-byte where a source is not 16-byte aligned),
// adjacent threads on adjacent vectors, several loads in flight a thread
// before any is used. Staging: each value is converted and stored at its
// cell-major place in a shared-memory tile of NC cells. Stores: the
// block's cells are one contiguous run of the output (16·C·sizeof(T) bytes
// a cell: 832 in bf16 at C = 26), written with 16-byte stores. The ragged
// last block of a row is masked. The source table travels in the kernel's
// parameters (__grid_constant__), so there is nothing to upload.

namespace {

constexpr int kMaxSources = 12;
constexpr int kMaxChannels = 32;
constexpr int kFloatsInFlight = 16;   // a thread's loads before it stores

struct Sources {
  const float* ptr[kMaxSources];
  long long batch_stride[kMaxSources];       // floats
  long long line_stride[kMaxSources];        // floats: row, or column
  int chans[kMaxSources];
  int offset[kMaxSources];                   // first channel in a cell
  int cols;                                  // bit i: source i by columns
  unsigned char of_channel[kMaxChannels];    // channel in a cell -> source
};

// cells a block: the tile (NC cells × 16·C values) stays within 32 KB at
// C = 32 in either output type, so several blocks share an SM
template <typename T>
constexpr int kCells = 64 / (int)sizeof(T);

template <typename T>
__device__ __forceinline__ T convert(float v);
template <>
__device__ __forceinline__ float convert<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 convert<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The block's loads are vectors g of VW floats, S a channel slot (4 rows
// × 4·NC pixels; a source of c_i channels spans c_i slots, so g names its
// source through of_channel); within a source, in its memory order: row
// u, pixel p, channel c (rows) or pixel p, row u, channel c (columns).
template <typename T, int VW>
__global__ void __launch_bounds__(kThreads)
pack_s2d4_kernel(const __grid_constant__ Sources s, T* __restrict__ out,
                 int H, int W, int C) {
  constexpr int NC = kCells<T>;
  constexpr int S = 16 * NC / VW;          // vectors a channel slot
  constexpr int K = kFloatsInFlight / VW;  // vectors a thread a round
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);

  const int W4 = W >> 2;
  const int x0 = blockIdx.x * NC;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const int ncv = min(NC, W4 - x0);        // cells in this block
  const int cell = 16 * C;
  const int total = S * C;

  for (int base = 0; base < total; base += K * kThreads) {
    float v[K][VW];
    // where vector k lands, packed: ci | c << 6 | p << 12 | u << 20 |
    // offset_i << 22 | columns << 27 (the source's channels, the first
    // float's channel, pixel in the run and row in the cell, the source's
    // first channel in a cell, its order); -1 for none
    int where[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      where[k] = -1;
      const int g = base + k * kThreads + threadIdx.x;
      if (g >= total) continue;
      const int i = s.of_channel[g / S];
      const int ci = s.chans[i];
      const int e = (g - S * s.offset[i]) * VW;   // float in the source
      const int cols = (s.cols >> i) & 1;
      const float* src = s.ptr[i] + b * s.batch_stride[i];
      int u, p, f;
      if (!cols) {                 // row u: 4·NC pixels × c_i floats
        u = e / (4 * NC * ci);
        f = e - u * (4 * NC * ci);
        if (f >= 4 * ncv * ci) continue;
        p = f / ci;
        src += (int64_t)(4 * y + u) * s.line_stride[i] + 4 * x0 * ci + f;
      } else {                     // pixel p: 4 rows × c_i floats
        p = e / (4 * ci);
        if (p >= 4 * ncv) continue;
        f = e - p * (4 * ci);
        u = f / ci;
        src += (int64_t)(4 * x0 + p) * s.line_stride[i] + 4 * y * ci + f;
      }
      if constexpr (VW == 4) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(src));
        v[k][0] = q.x;
        v[k][1] = q.y;
        v[k][2] = q.z;
        v[k][3] = q.w;
      } else {
        v[k][0] = __ldg(src);
      }
      const int c = cols ? f - u * ci : f - p * ci;
      where[k] = ci | c << 6 | p << 12 | u << 20 | s.offset[i] << 22 |
                 cols << 27;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (where[k] < 0) continue;
      const int ci = where[k] & 63;
      int c = (where[k] >> 6) & 63;
      int p = (where[k] >> 12) & 255;
      int u = (where[k] >> 20) & 3;
      const int at = (where[k] >> 22) & 31;
      const bool cols = where[k] >> 27;
#pragma unroll
      for (int q = 0; q < VW; ++q) {
        tile[(p >> 2) * cell + ((u << 2) + (p & 3)) * C + at + c] =
            convert<T>(v[k][q]);
        if (++c == ci) {
          c = 0;
          if (cols)
            ++u;
          else
            ++p;
        }
      }
    }
  }
  __syncthreads();
  // the block's cells are one contiguous run of the output
  const int64_t first = ((int64_t)b * (H >> 2) + y) * W4 + x0;
  uint4* dst = reinterpret_cast<uint4*>(out + first * cell);
  const uint4* from = reinterpret_cast<const uint4*>(tile);
  const int n16 = ncv * cell * (int)sizeof(T) / 16;
  for (int k = threadIdx.x; k < n16; k += kThreads) dst[k] = from[k];
}

template <typename T, int VW>
void launch_pack(const Sources& s, void* out, int B, int H, int W, int C,
                 cudaStream_t stream) {
  constexpr int NC = kCells<T>;
  const dim3 grid((unsigned)((W / 4 + NC - 1) / NC), (unsigned)(H / 4),
                  (unsigned)B);
  const size_t smem = (size_t)NC * 16 * C * sizeof(T);
  pack_s2d4_kernel<T, VW><<<grid, kThreads, smem, stream>>>(s, (T*)out, H,
                                                            W, C);
}

template <typename T>
void pack(const Sources& s, bool vec, void* out, int B, int H, int W, int C,
          cudaStream_t stream) {
  if (vec)
    launch_pack<T, 4>(s, out, B, H, W, C, stream);
  else
    launch_pack<T, 1>(s, out, B, H, W, C, stream);
}

}  // namespace

// sources: n host arrays — data pointers, strides (int64 floats; batch,
// row, column for each source) and channel counts — of float32
// [B, H, W, c_i] frames, each with its channels contiguous and its column
// stride c_i (rows) or its row stride c_i (columns); out [B, H/4, W/4,
// 16·C] (C = Σ c_i ≤ 32), bfloat16 where out_bf16, else float32; H and W
// multiples of 4.
extern "C" int fldrx_pack_s2d4(const void* ptrs, const void* strides,
                               const void* chans, int n, void* out, int B,
                               int H, int W, int out_bf16, void* stream) {
  if (n <= 0 || n > kMaxSources || B < 0 || H < 0 || W < 0 || H % 4 != 0 ||
      W % 4 != 0 || H / 4 > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const auto* p = static_cast<const float* const*>(ptrs);
  const auto* st = static_cast<const long long*>(strides);
  const auto* cs = static_cast<const int*>(chans);
  Sources s = {};
  int C = 0;
  bool vec = true;   // 16-byte loads: every source 16-byte aligned
  for (int i = 0; i < n; ++i) {
    const long long sb = st[3 * i], sh = st[3 * i + 1], sw = st[3 * i + 2];
    if (cs[i] <= 0 || C + cs[i] > kMaxChannels)
      return (int)cudaErrorInvalidValue;
    const bool cols = sw != cs[i];
    if (cols && sh != cs[i]) return (int)cudaErrorInvalidValue;
    s.ptr[i] = p[i];
    s.batch_stride[i] = sb;
    s.line_stride[i] = cols ? sw : sh;
    s.chans[i] = cs[i];
    s.offset[i] = C;
    s.cols |= (int)cols << i;
    for (int c = 0; c < cs[i]; ++c) s.of_channel[C + c] = (unsigned char)i;
    C += cs[i];
    vec = vec && aligned(p[i], 16) && sb % 4 == 0 &&
          s.line_stride[i] % 4 == 0;
  }
  if (B == 0 || H == 0 || W == 0) return (int)cudaGetLastError();
  cudaStream_t stream_ = (cudaStream_t)stream;
  if (out_bf16)
    pack<__nv_bfloat16>(s, vec, out, B, H, W, C, stream_);
  else
    pack<float>(s, vec, out, B, H, W, C, stream_);
  return (int)cudaGetLastError();
}
