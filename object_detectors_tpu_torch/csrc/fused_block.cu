// Fused stride-1 ResNet bottleneck, eval mode, FrozenBN folded into the
// weights, for sm_90a:
//
//   t1  = bf16(relu(x @ w1 + b1))            1x1, over the tile and its halo
//   t2  = bf16(relu(conv3x3(t1) + b2))       zero padding on t1 itself
//   out = bf16(relu((t2 @ w3 + b3) + id))    id = x, or x @ wd + bd
//
// Replaces the Pallas kernel object_detectors_tpu/kernels/fused_block.py
// (_block_kernel, launched by fused_bottleneck). Like it, one block keeps
// the whole bottleneck of one tile on chip: x is read from device memory
// for the tile and its one-pixel halo, t1 and t2 live in shared memory, and
// the output tile is written once.
//
// Layout: x and out are NHWC bf16 (a channels_last NCHW tensor as it lies
// in memory); weights are bf16 [N][K] (output channel major, input channel
// contiguous: w1 [Cm][Cin], w2 [3][3][Cm][Cm], w3 [Cout][Cm], wd
// [Cout][Cin]); shifts are f32. Every channel count is a multiple of 8, and
// Cm is at most kMaxMid (the shared memory of one block).
//
// Design: one block of 8 warps per (image, 8x8 output tile); partial tiles
// at the right and bottom edges are masked. The three products run on the
// tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulation), their
// operands read from shared memory with ldmatrix. Weights and x stream
// through shared memory in 64x64 chunks (K chunks of 64 input channels, N
// chunks of 64 output channels), zero-filled beyond the channel counts,
// copied with cp.async (no register round trip, all of a chunk in flight at
// once). Stages 2 and 3 keep the next chunk's copies in flight while they
// multiply the current one (a two-slot ring in the staging that the stage
// leaves free). The 3x3 is nine shifted products over the 10x10 t1 tile:
// ldmatrix takes one row address per lane, so a shifted window needs no
// copy.
//
// Bound on the H100: at the ResNet-50 shapes of 640x640 images, bytes for
// layer1 and layer2 (x in, out, weights once), tensor-core operations for
// layer3 and layer4. This version is still far from either: stage 1 waits
// for each chunk, recomputes the halo and wastes 28 of its 128 rows; Cm =
// 512 leaves one block on an SM; mma.sync is not wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8;                  // output tile: kTile x kTile pixels
constexpr int kHalo = kTile + 2;          // 10: the tile and its halo
constexpr int kHaloPix = kHalo * kHalo;   // 100
constexpr int kM1 = 128;                  // stage-1 rows: 100 halo pixels in 8 m-fragments
constexpr int kM2 = kTile * kTile;        // 64 output pixels
constexpr int kKC = 64;                   // K chunk
constexpr int kNC = 64;                   // N chunk
constexpr int kStage = kKC + 8;           // staging row stride: 144 bytes, conflict-free ldmatrix
constexpr int kThreads = 256;             // 8 warps
constexpr int kMaxMid = 576;              // largest Cm that fits in 227 KB

__host__ __device__ constexpr int round64(int c) { return (c + 63) / 64 * 64; }

// t1 [100][cmp + 8], t2 [64][cmp + 8], x staging [128][72], weight staging [64][72]
__host__ __device__ constexpr size_t smem_bytes(int cm) {
  return (size_t)(kHaloPix + kM2) * (round64(cm) + 8) * 2 + (size_t)(kM1 + kNC) * kStage * 2;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a (16x16, row major) * b (16x8, column major), f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  // 16 bytes global -> shared without a register round trip; zeros when
  // !valid (src-size 0 reads nothing, src is then any valid address)
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Start the copies of weight rows n0..n0+63, columns k0..k0+63 of a [N][K]
// matrix (row stride ldk) into staging [64][kStage]; zeros beyond nmax and
// kmax.
__device__ __forceinline__ void copy_weights(__nv_bfloat16* dst, const __nv_bfloat16* w,
                                             int ldk, int n0, int nmax, int k0, int kmax) {
  for (int i = threadIdx.x; i < kNC * (kKC / 8); i += kThreads) {
    const int r = i >> 3, c = (i & 7) * 8;
    const int n = n0 + r, k = k0 + c;
    const bool ok = n < nmax && k < kmax;
    cp_async16(dst + r * kStage + c, ok ? w + (size_t)n * ldk + k : w, ok);
  }
}

// Start the copies of channels k0..k0+63 of `rows` pixels of image b into
// staging [rows][kStage]: with halo, row r is pixel (y0 - 1 + r / 10,
// x0 - 1 + r % 10) for r < 100; without, row r is pixel (y0 + r / 8,
// x0 + r % 8). Zeros outside the image, beyond the halo and beyond cin.
template <bool kWithHalo>
__device__ __forceinline__ void copy_pixels(__nv_bfloat16* dst, const __nv_bfloat16* x, int b,
                                            int h, int w, int cin, int y0, int x0, int k0) {
  constexpr int rows = kWithHalo ? kM1 : kM2;
  for (int i = threadIdx.x; i < rows * (kKC / 8); i += kThreads) {
    const int r = i >> 3, c = (i & 7) * 8;
    const int k = k0 + c;
    int gy, gx;
    bool ok;
    if (kWithHalo) {
      gy = y0 - 1 + r / kHalo;
      gx = x0 - 1 + r % kHalo;
      ok = r < kHaloPix;
    } else {
      gy = y0 + r / kTile;
      gx = x0 + r % kTile;
      ok = true;
    }
    ok = ok && gy >= 0 && gy < h && gx >= 0 && gx < w && k < cin;
    cp_async16(dst + r * kStage + c,
               ok ? x + (((size_t)b * h + gy) * w + gx) * cin + k : x, ok);
  }
}

// B fragments of n-fragments (2j, 2j+1) for k step ks from staging [64][kStage]
__device__ __forceinline__ void load_b_pair(uint32_t (&b)[4], const __nv_bfloat16* ws, int nfrag0,
                                            int ks, int lane) {
  ldsm_x4(b, ws + (nfrag0 * 8 + (lane & 7) + ((lane >> 4) << 3)) * kStage + ks +
                 ((lane >> 3) & 1) * 8);
}

// acc (16 rows x 32 columns of this warp) += A (16 rows from `arow`, one row
// address a lane) x one 64-deep weight chunk in staging
__device__ __forceinline__ void mma_chunk(float (&acc)[4][4], const __nv_bfloat16* arow,
                                          const __nv_bfloat16* wbuf, int nf0, int lane) {
#pragma unroll
  for (int ks = 0; ks < kKC; ks += 16) {
    uint32_t a[4];
    ldsm_x4(a, arow + ks);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t bf[4];
      load_b_pair(bf, wbuf, nf0 + 2 * j, ks, lane);
      mma_bf16(acc[2 * j], a, bf[0], bf[1]);
      mma_bf16(acc[2 * j + 1], a, bf[2], bf[3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fused_bottleneck_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                        const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                        const float* __restrict__ b2, const __nv_bfloat16* __restrict__ w3,
                        const float* __restrict__ b3, const __nv_bfloat16* __restrict__ wd,
                        const float* __restrict__ bd, __nv_bfloat16* __restrict__ out, int h,
                        int w, int cin, int cm, int cout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cmp = round64(cm);
  const int ts = cmp + 8;  // t1 / t2 row stride
  __nv_bfloat16* t1s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* t2s = t1s + kHaloPix * ts;
  __nv_bfloat16* xs = t2s + kM2 * ts;
  __nv_bfloat16* ws = xs + kM1 * kStage;

  const int tiles_x = (w + kTile - 1) / kTile;
  const int y0 = (blockIdx.x / tiles_x) * kTile;
  const int x0 = (blockIdx.x % tiles_x) * kTile;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // ---- stage 1: t1 over the 10x10 halo tile; warp = one m-fragment, 8 n-fragments
  for (int n0 = 0; n0 < cmp; n0 += kNC) {
    float acc[8][4] = {};
    for (int k0 = 0; k0 < cin; k0 += kKC) {
      __syncthreads();
      copy_pixels<true>(xs, x, b, h, w, cin, y0, x0, k0);
      copy_weights(ws, w1, cin, n0, cm, k0, cin);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kKC; ks += 16) {
        uint32_t a[4];
        ldsm_x4(a, xs + (16 * warp + (lane & 15)) * kStage + ks + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bf[4];
          load_b_pair(bf, ws, 2 * j, ks, lane);
          mma_bf16(acc[2 * j], a, bf[0], bf[1]);
          mma_bf16(acc[2 * j + 1], a, bf[2], bf[3]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      const int n = n0 + f * 8 + 2 * t;
      const float s0 = n < cm ? b1[n] : 0.f, s1 = n < cm ? b1[n + 1] : 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = 16 * warp + g + 8 * hh;
        if (row < kHaloPix) {
          const int gy = y0 - 1 + row / kHalo, gx = x0 - 1 + row % kHalo;
          const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
          const float v0 = inside ? fmaxf(acc[f][2 * hh] + s0, 0.f) : 0.f;
          const float v1 = inside ? fmaxf(acc[f][2 * hh + 1] + s1, 0.f) : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(t1s + row * ts + n) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
  __syncthreads();  // t1 written; x and weight staging free

  // Stages 2 and 3 stream their weight chunks through a two-slot ring: the
  // copies of chunk c + 1 are in flight while chunk c is multiplied. Warp =
  // m-fragment (warp & 3) of the 64 output pixels, 4 n-fragments.
  const int mrow = 16 * (warp & 3);
  const int nf0 = (warp >> 2) * 4;

  // ---- stage 2: t2 = relu(sum of 9 shifted t1 windows @ w2[dy][dx] + b2);
  // chunk c = (output chunk, tap, K chunk); the slots are ws and xs
  {
    const int p = mrow + (lane & 15);  // the output pixel this lane addresses
    const int py = p / kTile, px = p % kTile;
    const int kc = cmp / kKC, per_n = 9 * kc, total = (cmp / kNC) * per_n;
    __nv_bfloat16* slot[2] = {ws, xs};
    auto fetch = [&](int c) {
      const int r = c % per_n;
      copy_weights(slot[c & 1], w2 + (size_t)(r / kc) * cm * cm, cm, (c / per_n) * kNC, cm,
                   (r % kc) * kKC, cm);
      cp_async_commit();
    };
    float acc[4][4] = {};
    fetch(0);
    for (int c = 0; c < total; ++c) {
      if (c + 1 < total) {
        fetch(c + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int r = c % per_n, tap = r / kc;
      const __nv_bfloat16* arow = t1s + ((py + tap / 3) * kHalo + px + tap % 3) * ts +
                                  (r % kc) * kKC + (lane >> 4) * 8;
      mma_chunk(acc, arow, slot[c & 1], nf0, lane);
      __syncthreads();
      if (r == per_n - 1) {
        const int n0 = (c / per_n) * kNC;
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int n = n0 + (nf0 + f) * 8 + 2 * t;
          const float s0 = n < cm ? b2[n] : 0.f, s1 = n < cm ? b2[n + 1] : 0.f;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = mrow + g + 8 * hh;
            const float v0 = fmaxf(acc[f][2 * hh] + s0, 0.f);
            const float v1 = fmaxf(acc[f][2 * hh + 1] + s1, 0.f);
            *reinterpret_cast<__nv_bfloat162*>(t2s + row * ts + n) =
                __floats2bfloat162_rn(v0, v1);
            acc[f][2 * hh] = acc[f][2 * hh + 1] = 0.f;
          }
        }
      }
    }
  }
  __syncthreads();  // t2 written; t1 and the staging free

  // ---- stage 3: out = relu((t2 @ w3 + b3) + identity); chunk c = (output
  // chunk, then the K chunks of w3 and, with a projection, those of x @ wd);
  // weight slots ws and the dead t1, x slots the two halves of xs
  const bool has_down = wd != nullptr;
  const int kw3 = cmp / kKC;
  const int per_n = kw3 + (has_down ? (cin + kKC - 1) / kKC : 0);
  const int total = ((cout + kNC - 1) / kNC) * per_n;
  __nv_bfloat16* wslot[2] = {ws, t1s};
  __nv_bfloat16* xslot[2] = {xs, xs + kM2 * kStage};
  auto fetch = [&](int c) {
    const int n0 = (c / per_n) * kNC, j = c % per_n;
    if (j < kw3) {
      copy_weights(wslot[c & 1], w3, cm, n0, cout, j * kKC, cm);
    } else {
      const int k0 = (j - kw3) * kKC;
      copy_pixels<false>(xslot[c & 1], x, b, h, w, cin, y0, x0, k0);
      copy_weights(wslot[c & 1], wd, cin, n0, cout, k0, cin);
    }
    cp_async_commit();
  };
  float acc[4][4] = {};
  float accd[4][4] = {};
  fetch(0);
  for (int c = 0; c < total; ++c) {
    if (c + 1 < total) {
      fetch(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int j = c % per_n;
    if (j < kw3) {
      mma_chunk(acc, t2s + (mrow + (lane & 15)) * ts + j * kKC + (lane >> 4) * 8, wslot[c & 1],
                nf0, lane);
    } else {
      mma_chunk(accd, xslot[c & 1] + (mrow + (lane & 15)) * kStage + (lane >> 4) * 8,
                wslot[c & 1], nf0, lane);
    }
    __syncthreads();
    if (j != per_n - 1) continue;
    const int n0 = (c / per_n) * kNC;
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int n = n0 + (nf0 + f) * 8 + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = mrow + g + 8 * hh;
        const int gy = y0 + row / kTile, gx = x0 + row % kTile;
        if (n < cout && gy < h && gx < w) {
          const size_t pix = ((size_t)b * h + gy) * w + gx;
          float i0, i1;
          if (has_down) {
            i0 = accd[f][2 * hh] + bd[n];
            i1 = accd[f][2 * hh + 1] + bd[n + 1];
          } else {
            const float2 xi =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + pix * cin + n));
            i0 = xi.x;
            i1 = xi.y;
          }
          const float v0 = fmaxf((acc[f][2 * hh] + b3[n]) + i0, 0.f);
          const float v1 = fmaxf((acc[f][2 * hh + 1] + b3[n + 1]) + i1, 0.f);
          *reinterpret_cast<__nv_bfloat162*>(out + pix * cout + n) =
              __floats2bfloat162_rn(v0, v1);
        }
        acc[f][2 * hh] = acc[f][2 * hh + 1] = 0.f;
        accd[f][2 * hh] = accd[f][2 * hh + 1] = 0.f;
      }
    }
  }
}

}  // namespace

extern "C" int fused_bottleneck_max_mid() { return kMaxMid; }

// Returns a cudaError_t (0 on success). wd and bd are null without a
// projection (then cout == cin).
extern "C" int fused_bottleneck_bf16(const void* x, const void* w1, const void* b1,
                                     const void* w2, const void* b2, const void* w3,
                                     const void* b3, const void* wd, const void* bd, void* out,
                                     int batch, int h, int w, int cin, int cm, int cout,
                                     void* stream) {
  if (cm > kMaxMid || cin % 8 || cm % 8 || cout % 8 || (wd == nullptr && cin != cout))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(cm);
  cudaError_t err = cudaFuncSetAttribute(fused_bottleneck_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((h + kTile - 1) / kTile) * ((w + kTile - 1) / kTile);
  if (batch == 0 || tiles == 0) return 0;
  dim3 grid(tiles, batch);
  fused_bottleneck_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<const __nv_bfloat16*>(w3),
      static_cast<const float*>(b3), static_cast<const __nv_bfloat16*>(wd),
      static_cast<const float*>(bd), static_cast<__nv_bfloat16*>(out), h, w, cin, cm, cout);
  return (int)cudaGetLastError();
}
