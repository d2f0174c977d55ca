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
// Bound: bytes. f1 and f2 are read once and the 81-channel volume written
// once; the volume is the larger part (81 floats a pixel against 2C read).
// The 81·(2C+1) operations a pixel take under half the bytes' time at every
// teacher shape (dec2, 8x128x128, C=32: 0.023 ms of bytes, 0.010 of f32
// operations at 3.35 TB/s and 67 TFLOP/s).
//
// Design: one block per TY x TX tile of output pixels (TX = 4*XG) and G
// groups of channels. A thread owns 4 neighbouring pixels along x and one
// displacement row dy: 36 sums (4 pixels x 9 dx) in registers. Its threads
// are ordered dy fastest, then tile row, then x group, then channel group.
//  - Staging: the channels are walked in chunks of 8. Group g takes chunks
//    g, g+G, ...; each chunk of f1 (the tile) and f2 (the tile with its +-4
//    halo) is copied into shared memory with 16-byte cp.async (zero-filled
//    outside the frame and past C) into a double buffer, so the next chunk
//    loads while this one is summed. Where C % 4 != 0 or an input is not
//    16-byte aligned the same layout is filled with scalar loads.
//  - Layout: a pixel's 8 channels take 3 float4 units (one of padding) and
//    an f2 row an odd number of units, so the 8 lanes of a 16-byte shared
//    load phase, which differ in dy and hence in f2 row, hit distinct banks.
//  - Sums: per float4 of channels a thread loads its 4 f1 pixels and the 12
//    f2 positions of its row once and does 144 fmaf: one f2 value serves
//    every (pixel, dx) pair that reads it. Channel order within a group.
//  - Output: each group writes its partial sums to shared memory (the
//    staging buffers, reused), the block adds the groups in order (no
//    atomics: the sum order is fixed) and writes each tile row's span of
//    out, TX*81 contiguous floats, with 16-byte stores where W % 4 == 0.
// The C entry point picks (TY, XG, G) from the frame: large volumes take
// 16x4 tiles and one channel group, the small ones (dec4-dec6) several
// groups, so each puts enough warps on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 4;                 // max displacement
constexpr int kN = 2 * kD + 1;        // 9 displacements per axis
constexpr int kK = kN * kN;           // 81 output channels
constexpr int kPX = 4;                // pixels per thread along x
constexpr int kCc = 8;                // channels per staged chunk
constexpr int kC4 = kCc / 4;          // float4 units of channels per chunk
constexpr int kCu = kC4 + 1;          // float4 units per staged pixel

template <int TY, int XG, int G>
struct Geom {
  static constexpr int kTX = kPX * XG;                  // tile width
  static constexpr int kThreadsG = kN * TY * XG;        // threads per group
  static constexpr int kThreads = kThreadsG * G;
  static constexpr int kF1Row = kTX * kCu + 1;          // float4 units
  static constexpr int kF2Row = (kTX + 2 * kD) * kCu + 1;   // odd
  static constexpr int kStage = TY * kF1Row + (TY + 2 * kD) * kF2Row;
  static constexpr int kOutRow = kTX * kK + 4;          // floats
  static constexpr int kOutG = TY * kOutRow;
  static constexpr int kIn = 2 * G * kStage * 16;       // bytes
  static constexpr int kOut = G * kOutG * 4;
  static constexpr int kSmem = kIn > kOut ? kIn : kOut;
  static_assert(kF2Row % 2 == 1, "an f2 row must take an odd unit count");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// One float4 of channels c..c+3 of a pixel into shared memory: 16-byte
// cp.async (C % 4 == 0, so the four are in or out of range together), else
// scalar loads; zeros outside the frame and past C.
__device__ __forceinline__ void stage4(float4* dst, const float* base,
                                       int64_t off, bool in_frame, int c,
                                       int C, bool vec) {
  if (vec) {
    const bool ok = in_frame && c < C;
    cp_async16(dst, ok ? base + off : base, ok);
  } else {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = (in_frame && c + q < C) ? base[off + q] : 0.f;
    *dst = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Channels c0..c0+7 of the f1 tile and of the f2 tile with its halo into
// `buf`, by the group's nt threads (this one is lt).
template <int TY, int XG, int G>
__device__ __forceinline__ void stage(float4* buf, const float* f1b,
                                      const float* f2b, int H, int W, int C,
                                      int x0, int y0, int c0, bool vec,
                                      int lt) {
  using Gm = Geom<TY, XG, G>;
  constexpr int TX = Gm::kTX, nt = Gm::kThreadsG;
  for (int j = lt; j < TY * TX * kC4; j += nt) {
    const int c4 = j % kC4, p = j / kC4;
    const int r = p / TX, x = p % TX;
    const int gy = y0 + r, gx = x0 + x, c = c0 + 4 * c4;
    stage4(buf + r * Gm::kF1Row + x * kCu + c4, f1b,
           ((int64_t)gy * W + gx) * C + c, gy < H && gx < W, c, C, vec);
  }
  float4* b2 = buf + TY * Gm::kF1Row;
  constexpr int HW = TX + 2 * kD;
  for (int j = lt; j < (TY + 2 * kD) * HW * kC4; j += nt) {
    const int c4 = j % kC4, p = j / kC4;
    const int r = p / HW, x = p % HW;
    const int gy = y0 - kD + r, gx = x0 - kD + x, c = c0 + 4 * c4;
    stage4(b2 + r * Gm::kF2Row + x * kCu + c4, f2b,
           ((int64_t)gy * W + gx) * C + c,
           gy >= 0 && gy < H && gx >= 0 && gx < W, c, C, vec);
  }
}

// The 36 sums of a thread (4 pixels of tile row `row` from x group `xg`,
// displacement row dyi) over one staged chunk.
template <int TY, int XG, int G>
__device__ __forceinline__ void accumulate(const float4* buf,
                                           float (&acc)[kPX * kN], int row,
                                           int dyi, int xg) {
  using Gm = Geom<TY, XG, G>;
  const float4* a1 = buf + row * Gm::kF1Row + xg * kPX * kCu;
  const float4* a2 = buf + TY * Gm::kF1Row + (row + dyi) * Gm::kF2Row
                     + xg * kPX * kCu;
#pragma unroll
  for (int c4 = 0; c4 < kC4; ++c4) {
    float4 a[kPX];
#pragma unroll
    for (int j = 0; j < kPX; ++j) a[j] = a1[j * kCu + c4];
#pragma unroll
    for (int i = 0; i < kPX + 2 * kD; ++i) {
      const float4 v = a2[i * kCu + c4];
#pragma unroll
      for (int j = 0; j < kPX; ++j) {
        const int dx = i - j;
        if (dx >= 0 && dx < kN) {
          float s = acc[j * kN + dx];
          s = fmaf(a[j].x, v.x, s);
          s = fmaf(a[j].y, v.y, s);
          s = fmaf(a[j].z, v.z, s);
          s = fmaf(a[j].w, v.w, s);
          acc[j * kN + dx] = s;
        }
      }
    }
  }
}

template <int TY, int XG, int G>
__global__ void __launch_bounds__(Geom<TY, XG, G>::kThreads)
correlation_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                   float* __restrict__ out, int H, int W, int C, bool vec_in,
                   bool vec_out) {
  using Gm = Geom<TY, XG, G>;
  constexpr int TX = Gm::kTX;
  extern __shared__ float4 smem[];

  const int t = threadIdx.x;
  const int comb = t % (kN * TY), rest = t / (kN * TY);
  const int dyi = comb % kN, row = comb / kN;
  const int xg = rest % XG, g = rest / XG;
  const int lt = t % Gm::kThreadsG;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int64_t b = blockIdx.z;
  const float* f1b = f1 + b * H * (int64_t)W * C;
  const float* f2b = f2 + b * H * (int64_t)W * C;

  float acc[kPX * kN];
#pragma unroll
  for (int k = 0; k < kPX * kN; ++k) acc[k] = 0.f;

  const int n_it = ((C + kCc - 1) / kCc + G - 1) / G;
  auto buf = [&](int it) { return smem + ((it & 1) * G + g) * Gm::kStage; };
  stage<TY, XG, G>(buf(0), f1b, f2b, H, W, C, x0, y0, g * kCc, vec_in, lt);
  cp_async_commit();
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) {
      stage<TY, XG, G>(buf(it + 1), f1b, f2b, H, W, C, x0, y0,
                       ((it + 1) * G + g) * kCc, vec_in, lt);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                  // chunk `it` is in shared memory
    accumulate<TY, XG, G>(buf(it), acc, row, dyi, xg);
    __syncthreads();                  // ... and consumed before it is reused
  }

  // the groups' partial sums into shared memory, in out's layout
  float* part = reinterpret_cast<float*>(smem) + g * Gm::kOutG
                + row * Gm::kOutRow + xg * kPX * kK + dyi * kN;
#pragma unroll
  for (int j = 0; j < kPX; ++j) {
#pragma unroll
    for (int dx = 0; dx < kN; ++dx) part[j * kK + dx] = acc[j * kN + dx];
  }
  __syncthreads();

  // each tile row's span of out, the groups added in order
  const float inv_c = 1.f / (float)C;
  const int n = min(TX, W - x0) * kK;
  const float* sm = reinterpret_cast<const float*>(smem);
  for (int r = 0; r < TY && y0 + r < H; ++r) {
    float* o = out + ((b * H + y0 + r) * (int64_t)W + x0) * kK;
    const float* s = sm + r * Gm::kOutRow;
    if (vec_out) {
      for (int e = 4 * t; e < n; e += 4 * Gm::kThreads) {
        float4 v = *reinterpret_cast<const float4*>(s + e);
#pragma unroll
        for (int gg = 1; gg < G; ++gg) {
          const float4 w = *reinterpret_cast<const float4*>(
              s + gg * Gm::kOutG + e);
          v.x += w.x; v.y += w.y; v.z += w.z; v.w += w.w;
        }
        *reinterpret_cast<float4*>(o + e) =
            make_float4(v.x * inv_c, v.y * inv_c, v.z * inv_c, v.w * inv_c);
      }
    } else {
      for (int e = t; e < n; e += Gm::kThreads) {
        float v = s[e];
#pragma unroll
        for (int gg = 1; gg < G; ++gg) v += s[gg * Gm::kOutG + e];
        o[e] = v * inv_c;
      }
    }
  }
}

template <int TY, int XG, int G>
int launch(const float* f1, const float* f2, float* out, int B, int H, int W,
           int C, bool vec_in, bool vec_out, cudaStream_t stream) {
  using Gm = Geom<TY, XG, G>;
  auto kernel = correlation_kernel<TY, XG, G>;
  if (Gm::kSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::kSmem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((W + Gm::kTX - 1) / Gm::kTX, (H + TY - 1) / TY, B);
  kernel<<<grid, Gm::kThreads, Gm::kSmem, stream>>>(f1, f2, out, H, W, C,
                                                     vec_in, vec_out);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// The geometry by the number of 16x4 tiles: volumes with at least 512
// (dec2, dec3 at batch 8) take one channel group; from 128 (dec4) two
// groups, so each block has twice the warps; below that (dec5, dec6) 8x2
// tiles and eight groups, so the few blocks walk C in eight parallel
// streams. Of the twelve geometries that tools/corr_geometry.py times,
// each is the fastest at its volumes but at dec3, where 16x8 tiles with
// one group take 10% less (PERF.md §6).
extern "C" int fldrx_correlation_f32(const float* f1, const float* f2,
                                     float* out, int B, int H, int W, int C,
                                     void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return (int)cudaGetLastError();
  const bool vec_in = C % 4 == 0 && aligned16(f1) && aligned16(f2);
  const bool vec_out = W % 4 == 0 && aligned16(out);
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t tiles = (int64_t)B * ((H + 3) / 4) * ((W + 15) / 16);
  if (tiles >= 512)
    return launch<4, 4, 1>(f1, f2, out, B, H, W, C, vec_in, vec_out, s);
  if (tiles >= 128)
    return launch<4, 4, 2>(f1, f2, out, B, H, W, C, vec_in, vec_out, s);
  return launch<2, 2, 8>(f1, f2, out, B, H, W, C, vec_in, vec_out, s);
}
