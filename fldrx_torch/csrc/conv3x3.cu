// 3x3, stride 1, pad 1 convolution on NHWC bf16 with f32 accumulation and a
// fused f32 bias, on Hopper's tensor cores (sm_90a). Plain C entry point,
// loaded with ctypes by fldrx_torch/ops/_build.py; it launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
//
// Replaces the TPU kernel _conv_kernel (fldrx/ops/fastconv.py:69, launched by
// conv3x3_pixrows :111), which the refine UNet's space-to-depth packed convs
// reach under bf16 (fldrx/model/fldrnet.py _packed_conv). Same function:
//   y[b,y,x,k] = bf16(bias[k] + sum_{ky,kx,c} x[b,y+ky-1,x+kx-1,c] * w[ky,kx,c,k])
// zero outside the frame, bf16 operands, f32 sums, the f32 bias added before
// the one rounding to bf16 (the Pallas kernel's order).
//
// Bound, at the packed UNet's shapes on the 4K path (H100 SXM: 989 TFLOP/s
// bf16 dense, 3.35 TB/s): enc1 576x1024 416->64, dec2 192->64 and dec3
// 256->96 do 1100-2900 flops per byte they must move, far above the card's
// ~295, so they are bound by operations (0.29, 0.13, 0.26 ms); enc2 64->32
// (43 flops/B, 0.034 ms by bytes) and enc3 288x512 128->64 (0.022 ms, near
// the balance point) are small. Only the tensor cores reach the operation
// bound: the f32 CUDA cores' 67 TFLOP/s alone need 4.2 ms for enc1.
//
// Design: an implicit GEMM, M = output pixels, N = output channels, reduction
// over 9 taps x Cin, with no im2col. A block owns a TH x 16 pixel tile and
// NB output channels (all K on the main path, so each input byte is fetched
// by one block per tile). The reduction runs in chunks of CC = 16 input
// channels, one k16 step of mma.sync: for each chunk the block stages the
// tile's (TH+2) x 18 input pixels (the one-pixel halo included, zeros
// outside the frame and past Cin, by cp.async's zero fill) and the chunk's
// weights [9][NB][CC] side by side in shared memory, through a 3-stage
// cp.async ring, so the next chunks load while the tensor cores work on this
// one, one __syncthreads per chunk. All 9 taps read the one staged tile:
// tap (ky, kx) of output row r is staged row r+ky shifted by kx pixels, which
// is just another row address for ldmatrix, so every input byte comes from
// device memory once per tile, not nine times. A warp owns MF tile rows (one
// m16 fragment each: 16 pixels of a row) times NF n8 fragments; for each kx
// it loads the MF+2 row fragments that its 3 ky taps share, and for each tap
// the tap's B fragments, then issues MF x NF mma.sync.m16n8k16 bf16 -> f32.
// Each staged pixel and weight row takes 48 bytes (16 channels + 16 bytes
// of padding), so the 8 rows of every ldmatrix phase fall in 8 distinct
// 16-byte bank groups: no bank conflicts. The sum order is fixed, so the
// kernel is deterministic.
//
// Why mma.sync and not wgmma: wgmma reads A either from registers, which
// gives no gain over mma.sync fed by ldmatrix, or from shared memory through
// a matrix descriptor whose rows follow a fixed stride and swizzle pattern;
// that descriptor cannot express the one-pixel shift of a tap window, so
// each tap would need its own restaged copy of the tile. ldmatrix takes one
// row address per lane, which makes the shifted windows free.
//
// Configurations (8 warps, 256 threads; the wrapper picks NB from K and lays
// the weights out for it): NB 32: 32x16 tile, a warp 4 rows x 32 channels;
// NB 64: 32x16 tile, 4 rows x 64; NB 96: 16x16 tile, warps 4 x 2, each 4
// rows x 48 channels. Ragged tiles (any H, W) are zero-filled on load and
// masked on store; K past the last weight row is zero in the packed weights
// and masked on store. Cin must be a multiple of 8 (one 16-byte copy): the
// wrapper pads it with zeros where it is not.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TW = 16;          // tile columns: the 16 rows of an m16 fragment
constexpr int CC = 16;          // input channels per stage: one k16 step
constexpr int PIX = CC + 8;     // bf16 per staged pixel or weight row (48 B)
constexpr int STAGES = 3;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <int NB, int WN, int MF>
struct Cfg {
  static constexpr int WM = kWarps / WN;            // warps along M
  static constexpr int TH = WM * MF;                 // tile rows
  static constexpr int NF = NB / (8 * WN);           // n8 fragments per warp
  static constexpr int XS_PIX = (TH + 2) * (TW + 2); // staged pixels
  static constexpr int XS = XS_PIX * PIX;            // bf16 per input stage
  static constexpr int WS = 9 * NB * PIX;            // bf16 per weight stage
  static constexpr int STAGE = XS + WS;
  static constexpr int SMEM = STAGES * STAGE * 2;    // bytes
  static_assert(NF % 2 == 0, "B fragments load in pairs");
  static_assert(SMEM <= 232448, "shared memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x [B][H][W][Cin] bf16 (Cin a multiple of 8); w [nch][nkb][9][NB][CC] bf16,
// zero past K and Cin (tap = ky * 3 + kx); bias [K] f32; out [B][H][W][K].
// Grid: x = tiles (row-major over the tile grid), y = B * nkb.
template <int NB, int WN, int MF>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ bias,
               __nv_bfloat16* __restrict__ out, int H, int W, int Cin, int K,
               int nkb, int tiles_x) {
  using C = Cfg<NB, WN, MF>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp % C::WM;
  const int warp_n = warp / C::WM;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int ty0 = (blockIdx.x / tiles_x) * C::TH;
  const int b = blockIdx.y / nkb;
  const int kb = blockIdx.y % nkb;
  const __nv_bfloat16* xb = x + (int64_t)b * H * W * Cin;
  const int nch = (Cin + CC - 1) / CC;

  auto load_stage = [&](int stage, int ch) {
    __nv_bfloat16* xs = smem + stage * C::STAGE;
    __nv_bfloat16* ws = xs + C::XS;
    const int c0 = ch * CC;
    for (int i = tid; i < C::XS_PIX * 2; i += kThreads) {
      const int p = i >> 1, part = i & 1;
      const int py = p / (TW + 2), px = p - py * (TW + 2);
      const int gy = ty0 + py - 1, gx = tx0 + px - 1, c = c0 + part * 8;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin;
      const __nv_bfloat16* src =
          ok ? xb + ((int64_t)gy * W + gx) * Cin + c : xb;
      cp_async16(xs + p * PIX + part * 8, src, ok ? 16 : 0);
    }
    const __nv_bfloat16* wsrc = w + ((int64_t)ch * nkb + kb) * (9 * NB * CC);
    for (int i = tid; i < 9 * NB * 2; i += kThreads) {
      const int r = i >> 1, part = i & 1;
      cp_async16(ws + r * PIX + part * 8, wsrc + r * CC + part * 8, 16);
    }
  };

  float acc[MF][C::NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < C::NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // per-lane ldmatrix offsets: A rows are the 16 pixels of a tile row (lanes
  // 16-31 the upper 8 channels); B rows are output channels, lanes 8-15 and
  // 24-31 the upper 8 input channels, lanes 16-31 the second n8 fragment
  const int a_pix = lane & 15, a_k = (lane >> 4) * 8;
  const int b_n = (lane & 7) + ((lane >> 4) << 3), b_k = ((lane >> 3) & 1) * 8;
  const int row0 = warp_m * MF;            // the warp's first tile row
  const int n0 = warp_n * C::NF * 8;       // its first channel in the block

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nch) load_stage(s, s);
    cp_async_commit();
  }

  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                       // chunk ch landed; ch-1 consumed
    if (ch + STAGES - 1 < nch)
      load_stage((ch + STAGES - 1) % STAGES, ch + STAGES - 1);
    cp_async_commit();

    const __nv_bfloat16* xs = smem + (ch % STAGES) * C::STAGE;
    const __nv_bfloat16* ws = xs + C::XS;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      uint32_t a[MF + 2][4];
#pragma unroll
      for (int i = 0; i < MF + 2; ++i)
        ldmatrix_x4(a[i], xs + ((row0 + i) * (TW + 2) + a_pix + kx) * PIX + a_k);
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const __nv_bfloat16* wt = ws + (ky * 3 + kx) * NB * PIX;
        uint32_t bf[C::NF][2];
#pragma unroll
        for (int j = 0; j < C::NF; j += 2) {
          uint32_t r[4];
          ldmatrix_x4(r, wt + (n0 + j * 8 + b_n) * PIX + b_k);
          bf[j][0] = r[0];
          bf[j][1] = r[1];
          bf[j + 1][0] = r[2];
          bf[j + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < MF; ++i)
#pragma unroll
          for (int j = 0; j < C::NF; ++j)
            mma_bf16(acc[i][j], a[i + ky], bf[j][0], bf[j][1]);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: fragment element e of (i, j) is pixel g (+8 for e >= 2) of tile
  // row row0 + i, channel 2q (+1 for odd e) of n8 fragment j
  const int g = lane >> 2, q = lane & 3;
  const bool pairs = (K & 1) == 0;
#pragma unroll
  for (int j = 0; j < C::NF; ++j) {
    const int n = kb * NB + n0 + j * 8 + 2 * q;
    const float b0 = n < K ? __ldg(bias + n) : 0.f;
    const float b1 = n + 1 < K ? __ldg(bias + n + 1) : 0.f;
#pragma unroll
    for (int i = 0; i < MF; ++i) {
      const int oy = ty0 + row0 + i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ox = tx0 + g + h * 8;
        if (oy >= H || ox >= W || n >= K) continue;
        __nv_bfloat16* o = out + (((int64_t)b * H + oy) * W + ox) * K + n;
        const float v0 = acc[i][j][2 * h] + b0;
        const float v1 = acc[i][j][2 * h + 1] + b1;
        if (pairs && n + 1 < K) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          o[0] = __float2bfloat16_rn(v0);
          if (n + 1 < K) o[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

template <int NB, int WN, int MF>
int launch(const void* x, const void* w, const float* bias, void* out, int B,
           int H, int W, int Cin, int K, cudaStream_t stream) {
  using C = Cfg<NB, WN, MF>;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles = ((H + C::TH - 1) / C::TH) * tiles_x;
  const int nkb = (K + NB - 1) / NB;
  auto kernel = conv3x3_kernel<NB, WN, MF>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(tiles, B * nkb);
  kernel<<<grid, kThreads, C::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), bias,
      static_cast<__nv_bfloat16*>(out), H, W, Cin, K, nkb, tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B][H][W][Cin] bf16, Cin a multiple of 8, 16-byte aligned; w packed by
// the wrapper as [ceil(Cin/16)][ceil(K/block_n)][9][block_n][16] bf16;
// block_n 32, 64 or 96; bias [K] f32; out [B][H][W][K] bf16.
extern "C" int fldrx_conv3x3_bf16(const void* x, const void* w,
                                  const float* bias, void* out, int B, int H,
                                  int W, int Cin, int K, int block_n,
                                  void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || K <= 0) return (int)cudaGetLastError();
  if (Cin <= 0 || Cin % 8 != 0 || ((uintptr_t)x % 16) != 0 ||
      ((uintptr_t)w % 16) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (block_n) {
    case 32: return launch<32, 1, 4>(x, w, bias, out, B, H, W, Cin, K, s);
    case 64: return launch<64, 1, 4>(x, w, bias, out, B, H, W, Cin, K, s);
    case 96: return launch<96, 2, 4>(x, w, bias, out, B, H, W, Cin, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
