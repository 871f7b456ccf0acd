// Fused stride-1 ResNet bottleneck, eval mode, FrozenBN folded into the
// weights, for sm_90a:
//
//   t1  = bf16(relu(x @ w1 + b1))            1x1, over the tile and its halo
//   t2  = bf16(relu(conv3x3(t1) + b2))       zero padding on t1 itself
//   out = bf16(relu((t2 @ w3 + b3) + id))    id = x, or x @ wd + bd
//
// Replaces the Pallas kernel object_detectors_tpu/kernels/fused_block.py
// (_block_kernel, :33, launched by fused_bottleneck at :180). Like it, one
// CTA keeps the whole bottleneck of one tile on chip: x is read from device
// memory for the tile and its one-pixel halo, t1 and t2 live in shared
// memory as bf16, and the output tile is written once.
//
// Layout: x and out are NHWC bf16 (a channels_last NCHW tensor as it lies
// in memory); weights are bf16 [N][K] (output channel major, input channel
// contiguous: w1 [Cm][Cin], w2 [3][3][Cm][Cm], w3 [Cout][Cm], wd
// [Cout][Cin]); shifts are f32; f32 accumulation everywhere.
//
// Two variants, chosen by shape alone (never on a failure):
//
// v4, channel counts that are multiples of 64 with 64 <= Cm <= 512 (the
// ResNet-50 blocks). What bounds it on the H100 at a 640x640 batch of 16:
// device-memory bytes at layer1 (160x160, 0.08-0.13 ms) and layer2 (80x80,
// 0.06 ms); tensor-core operations at layer3 (40x40) and layer4 (20x20),
// 0.058 ms each. The earlier design (v2, below) reached 7 % of those bounds:
// each 64-pixel block streamed every weight from L2 through 64x64 cp.async
// chunks into mma.sync, whose B fragments every warp loaded again from
// shared memory, and layer4's 144 blocks ran in two waves. So v4:
//  - multiplies with wgmma (m64nNk16, bf16, f32 accumulators in registers):
//    B, the weight chunk, is read by the tensor cores straight from
//    128-byte-swizzled shared memory through a matrix descriptor, once for
//    the whole warpgroup; A comes from registers, loaded with ldmatrix in
//    mma.sync's A layout. That keeps v2's copy-free 3x3: a one-pixel shift of
//    the halo tile is not a whole 8-row core matrix, so no shared-memory A
//    descriptor can express it, but ldmatrix takes one row address a lane.
//  - keeps the loads in flight in every stage: one thread of warpgroup 2
//    issues TMA copies of the weight chunks (64 input x up to 128 output
//    channels, 16 KB) into a ring of 5-6 slots and of the x chunks (the halo
//    tile in stage 1, the output tile for a projection) into two or three
//    more, each slot with a full and an empty mbarrier; warpgroups 0 and 1
//    multiply, with 232 registers a thread (setmaxnreg: the loader keeps
//    40), and hand a step's slots back once the step after it is issued.
//    TMA zero-fills what lies outside the image or beyond a channel count,
//    so edges cost no code.
//  - gives a CTA 64 or 128 output pixels, both warpgroups on the same weight
//    chunk: two 64-row m-tiles (one each), or one m-tile with half the
//    columns each where shared memory allows only 64 rows (layer4).
//  - picks the tile by Cm so that the grid fills whole waves of 132 SMs at
//    one CTA an SM and wastes few rows at the ResNet-50 map sizes:
//      Cm 64   8x16 tile, halo 10x18 (3 m-tiles), 3200 CTAs (24.2 waves)
//      Cm 128  8x16 tile, halo 10x18, 800 CTAs (6.1 waves)
//      Cm 256  10x10 tile, halo 12x12, 256 CTAs (1.94 waves; 100 of 128 rows)
//      Cm 512  5x10 tile, halo 7x12, 128 CTAs (one wave; 50 of 64 rows)
//    against v2's 8x8 tiles: 400 CTAs (3.0 waves) at layer3 and 144 (two
//    waves, 44 % of the pixels outside the 20x20 map) at layer4.
//    At layers 3-4 (few CTAs, long sums) stage 1 keeps three x slots and
//    stage 3 loads the identity before its products instead of in its
//    epilogue; at layers 1-2 both cost more than they hide (PERF.md).
//  - uses no thread-block cluster: each CTA reads every weight from L2
//    once (1.1 GB a launch at layer4, 0.45-0.57 GB elsewhere). A version
//    that multicast each weight chunk to a 2-CTA cluster (half the L2
//    traffic) measured slower on the H100 (PERF.md), so the CTAs stay
//    independent.
//  - is, by count, limited by shared memory rather than by L2: every wgmma
//    reads its B tile (64 rows of A a byte) and ldmatrix its A fragments
//    from shared memory, which at the tensor cores' rate is about all of its
//    128 bytes a clock (not measured: no profiler of the SM). ptxas
//    serialises the wgmma of the Cm <= 256 configurations (a warpgroup-
//    dependent m-tile count in stage 1); a branch-free version that kept
//    them asynchronous measured slower, and is not used.
//  - traps, rather than hangs the card, if a barrier wait never ends.
// Shared memory: the weight ring, R1 (t1 [halo][Cm + 8], then the
// projection's x slots) and R2 (stage 1's x slots, then t2 [tile][Cm + 8]);
// the producer waits for t1's last reader before it writes the projection's
// x over it. The TMA descriptors of the weights are encoded once per
// prepared block (fused_bottleneck_encode_weights, with the driver's
// cuTensorMapEncodeTiled taken through cudaGetDriverEntryPoint, so no
// -lcuda), those of x at each launch; all are __grid_constant__ parameters.
//
// v2, every other shape the kernel takes (channels multiples of 8, Cm <=
// kMaxMid: the tests' Cm 8 and Cin 32 and the like): one block of 8 warps
// per (image, 8x8 output tile); partial tiles at the right and bottom edges
// are masked. The three products run on the tensor cores with mma.sync
// m16n8k16 (bf16 in, f32 accumulation), their operands read from shared
// memory with ldmatrix. Weights and x stream through shared memory in 64x64
// chunks (K chunks of 64 input channels, N chunks of 64 output channels),
// zero-filled beyond the channel counts, copied with cp.async. Stages 2 and
// 3 keep the next chunk's copies in flight while they multiply the current
// one (a two-slot ring in the staging that the stage leaves free). The 3x3
// is nine shifted products over the 10x10 t1 tile.

#include <cuda.h>  // CUtensorMap and the driver's enums only: nothing is linked from it
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

// ---------------------------------------------------------------- v4 ----
namespace {  // internal linkage: no other library's kernel of the same name can stand in
namespace v4 {

constexpr int kConsumers = 256;             // warpgroups 0 and 1 multiply
constexpr int kThreads = kConsumers + 128;  // warpgroup 2 loads (one thread issues the TMA)
constexpr int kKC = 64;                     // K chunk: 64 bf16, one 128-byte swizzle row
constexpr int kWRows = 128;                 // a weight slot holds up to 128 output channels
constexpr int kWSlot = kWRows * 128;        // bytes
constexpr int kSmemLimit = 232448;

__host__ __device__ constexpr int align1k(int b) { return (b + 1023) / 1024 * 1024; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// One configuration a Cm range: the output tile (kTH x kTW pixels a CTA),
// the output channels of a weight chunk in each stage (kNT1..3), the x
// slots (kSX), whether stage 3 loads the identity ahead of its products
// (kEarlyId), and the shared memory that follows: the weight ring, R1 (t1,
// then the x slots of the projection) and R2 (the x slots of stage 1, then
// t2). A third x slot and the early identity pay at layers 3-4 and cost at
// layers 1-2 (PERF.md), hence per configuration.
template <int kTH_, int kTW_, int kNT1_, int kNT2_, int kNT3_, int kCmMax_, int kSX_,
          bool kEarlyId_>
struct Cfg {
  static constexpr int kTH = kTH_, kTW = kTW_, kNT1 = kNT1_, kNT2 = kNT2_, kNT3 = kNT3_;
  static constexpr int kCmMax = kCmMax_, kSX = kSX_;
  static constexpr bool kEarlyId = kEarlyId_;
  static constexpr int kP = kTH * kTW, kMO = (kP + 63) / 64;                // output rows
  static constexpr int kHW = kTW + 2, kHP = (kTH + 2) * kHW, kMH = (kHP + 63) / 64;  // halo
  // one 64-row output tile: both warpgroups take its rows, each half the columns
  static constexpr bool kSplitN = kMO == 1;
  static constexpr int kN2 = kSplitN ? kNT2 / 2 : kNT2, kN3 = kSplitN ? kNT3 / 2 : kNT3;
  static constexpr int kX1 = align1k(kHP * 128), kX3 = align1k(kP * 128);
  static constexpr int kTS = kCmMax + 8;  // t1 / t2 row stride (elements) at the largest Cm
  static constexpr int kR1 = align1k(cmax(kHP * kTS * 2, kSX * kX3));
  static constexpr int kR2 = align1k(cmax(kP * kTS * 2, kSX * kX1));
  static constexpr int kSW = cmin(6, (kSmemLimit - 1024 - 256 - kR1 - kR2) / kWSlot);
  static constexpr int kSmem = 1024 + kSW * kWSlot + kR1 + kR2 + 256;
  static_assert(kMO <= 2 && kMH <= 4 && kSW >= 2 && kSmem <= kSmemLimit, "tile too large");
  static_assert(kNT1 <= kWRows && kNT2 <= kWRows && kNT3 <= kWRows, "weight chunk too wide");
};

//              TH  TW  NT1  NT2  NT3   Cm  SX  early identity
using C64 = Cfg<8, 16, 64, 64, 128, 64, 2, false>;       // layer1, 160x160
using C128 = Cfg<8, 16, 128, 128, 128, 128, 2, false>;   // layer2, 80x80
using C256 = Cfg<10, 10, 128, 128, 128, 256, 3, true>;   // layer3, 40x40
using C512 = Cfg<5, 10, 128, 128, 128, 512, 3, true>;    // layer4, 20x20

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4_addr(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Spin until the phase of parity `parity` has completed. A wait that never
// ends (a fault in the ring's accounting) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 22)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2,
                                       int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most kPending committed groups of this warpgroup are in flight
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// the consumers' own barrier (named barrier 1, the 256 threads of warpgroups 0 and 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Matrix descriptor of a K-major bf16 operand in 128-byte-swizzled shared
// memory (as TMA writes it with CU_TENSOR_MAP_SWIZZLE_128B): 8-row groups
// 1024 bytes apart; the K step of 16 within the 64-wide row is +32 bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// ldmatrix address of row r, 16-byte chunk c of a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t sw128_at(uint32_t tile, int r, int c) {
  return tile + r * 128 + ((c ^ (r & 7)) << 4);
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t bdesc);

// d (64 x 64, f32) += a (64 x 16, bf16 registers, mma.sync's A layout) * b (16 x 64,
// bf16, K-major in 128-byte-swizzled shared memory, descriptor bdesc)
template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t bdesc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc));
}

// d (64 x 128, f32) += a (64 x 16, bf16 registers, mma.sync's A layout) * b (16 x 128,
// bf16, K-major in 128-byte-swizzled shared memory, descriptor bdesc)
template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t bdesc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc));
}


template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

template <class C>
__global__ void __launch_bounds__(kThreads, 1)
block_kernel(const __grid_constant__ CUtensorMap map_w1, const __grid_constant__ CUtensorMap map_w2,
             const __grid_constant__ CUtensorMap map_w3, const __grid_constant__ CUtensorMap map_wd,
             const __grid_constant__ CUtensorMap map_xh, const __grid_constant__ CUtensorMap map_xo,
             const __nv_bfloat16* __restrict__ x, const float* __restrict__ b1,
             const float* __restrict__ b2, const float* __restrict__ b3,
             const float* __restrict__ bd, __nv_bfloat16* __restrict__ out, int h, int w, int cin,
             int cm, int cout, int has_down) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t wring = base;
  const uint32_t r1 = wring + C::kSW * kWSlot;
  const uint32_t r2 = r1 + C::kR1;
  const uint32_t bars = r2 + C::kR2;
  auto full_w = [&](uint32_t s) { return bars + 8 * s; };
  auto empty_w = [&](uint32_t s) { return bars + 8 * (C::kSW + s); };
  auto full_x = [&](uint32_t s) { return bars + 8 * (2 * C::kSW + s); };
  auto empty_x = [&](uint32_t s) { return bars + 8 * (2 * C::kSW + C::kSX + s); };
  const uint32_t t1_free = bars + 8 * (2 * C::kSW + 2 * C::kSX);
  __nv_bfloat16* t1 = reinterpret_cast<__nv_bfloat16*>(gbase + (r1 - base));
  __nv_bfloat16* t2 = reinterpret_cast<__nv_bfloat16*>(gbase + (r2 - base));
  const int ts = cm + 8;  // t1 / t2 row stride: 16 bytes past a multiple of 128, conflict-free

  const int tiles_x = (w + C::kTW - 1) / C::kTW, tiles_y = (h + C::kTH - 1) / C::kTH;
  const int img = blockIdx.x / (tiles_x * tiles_y);
  const int rem = blockIdx.x % (tiles_x * tiles_y);
  const int y0 = (rem / tiles_x) * C::kTH, x0 = (rem % tiles_x) * C::kTW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kSW; ++s) {
      mbar_init(full_w(s), 1);
      mbar_init(empty_w(s), 2);
    }
    for (int s = 0; s < C::kSX; ++s) {
      mbar_init(full_x(s), 1);
      mbar_init(empty_x(s), 2);
    }
    mbar_init(t1_free, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // ------------------------------------------------ producer (one thread)
    // hand registers to the consumers: 128 x 40 + 256 x 232 <= 65536
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != kConsumers) return;
    uint32_t wi = 0, xi = 0;
    auto next_w = [&]() {
      const uint32_t s = wi % C::kSW;
      mbar_wait(empty_w(s), ((wi / C::kSW) & 1) ^ 1);
      ++wi;
      return s;
    };
    auto next_x = [&]() {
      const uint32_t s = xi % C::kSX;
      mbar_wait(empty_x(s), ((xi / C::kSX) & 1) ^ 1);
      ++xi;
      return s;
    };
    for (int n0 = 0; n0 < cm; n0 += C::kNT1)
      for (int k0 = 0; k0 < cin; k0 += kKC) {
        const uint32_t s = next_w(), sx = next_x();
        mbar_expect_tx(full_w(s), C::kNT1 * 128);
        tma_2d(wring + s * kWSlot, &map_w1, k0, n0, full_w(s));
        mbar_expect_tx(full_x(sx), C::kHP * 128);
        tma_4d(r2 + sx * C::kX1, &map_xh, k0, x0 - 1, y0 - 1, img, full_x(sx));
      }
    for (int n0 = 0; n0 < cm; n0 += C::kNT2)
      for (int tap = 0; tap < 9; ++tap)
        for (int k0 = 0; k0 < cm; k0 += kKC) {
          const uint32_t s = next_w();
          mbar_expect_tx(full_w(s), C::kNT2 * 128);
          tma_3d(wring + s * kWSlot, &map_w2, k0, n0, tap, full_w(s));
        }
    if (has_down) mbar_wait(t1_free, 0);  // the projection's x slots overwrite t1
    for (int n0 = 0; n0 < cout; n0 += C::kNT3) {
      for (int k0 = 0; k0 < cm; k0 += kKC) {
        const uint32_t s = next_w();
        mbar_expect_tx(full_w(s), C::kNT3 * 128);
        tma_2d(wring + s * kWSlot, &map_w3, k0, n0, full_w(s));
      }
      if (has_down)
        for (int k0 = 0; k0 < cin; k0 += kKC) {
          const uint32_t s = next_w(), sx = next_x();
          mbar_expect_tx(full_w(s), C::kNT3 * 128);
          tma_2d(wring + s * kWSlot, &map_wd, k0, n0, full_w(s));
          mbar_expect_tx(full_x(sx), C::kP * 128);
          tma_4d(r1 + sx * C::kX3, &map_xo, k0, x0, y0, img, full_x(sx));
        }
    }
    return;
  }

  // -------------------------------------------------- consumers (256 threads)
  // Each step multiplies one 64-deep chunk: ldmatrix the A fragments, issue
  // four wgmma, commit; then wait for the step before it and hand that
  // step's slots back to the producer, so one step's products run while the
  // next one's fragments load. Steps alternate between two A buffers, so
  // no fragment is overwritten while a wgmma in flight still reads it.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const bool signal = (threadIdx.x & 127) == 0;  // one arrival a warpgroup
  uint32_t wi = 0, xi = 0;
  int held_w = -1, held_x = -1;  // the slots of the step still in flight
  auto take_w = [&]() {
    const uint32_t s = wi % C::kSW;
    mbar_wait(full_w(s), (wi / C::kSW) & 1);
    ++wi;
    return s;
  };
  auto take_x = [&]() {
    const uint32_t s = xi % C::kSX;
    mbar_wait(full_x(s), (xi / C::kSX) & 1);
    ++xi;
    return s;
  };
  auto release = [&]() {
    if (signal && held_w >= 0) mbar_arrive(empty_w(held_w));
    if (signal && held_x >= 0) mbar_arrive(empty_x(held_x));
    held_w = held_x = -1;
  };
  // after a step's commit: the step before it is done, its slots go back
  auto retire = [&](int s, int sx) {
    wgmma_wait<1>();
    release();
    held_w = s;
    held_x = sx;
  };
  auto drain = [&]() {
    wgmma_wait<0>();
    release();
  };

  // ---- stage 1: t1 = relu(x @ w1 + b1) over the halo tile, zero outside the
  // image; warpgroup wg takes the 64-row m-tiles wg and wg + 2
  {
    float acc[2][C::kNT1 / 2];
    uint32_t a0[2][4][4], a1[2][4][4];
    auto step = [&](uint32_t(&a)[2][4][4]) {
      const uint32_t s = take_w(), sx = take_x();
      const uint32_t xt = r2 + sx * C::kX1;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (wg + 2 * m >= C::kMH) continue;
        const int r = min((wg + 2 * m) * 64 + wl * 16 + (lane & 15), C::kHP - 1);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) ldsm_x4_addr(a[m][ks], sw128_at(xt, r, 2 * ks + (lane >> 4)));
      }
      wgmma_fence();
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (wg + 2 * m >= C::kMH) continue;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma<C::kNT1>(acc[m], a[m][ks], sw128_desc(wring + s * kWSlot + 32 * ks));
      }
      wgmma_commit();
      retire(s, sx);
    };
    for (int n0 = 0; n0 < cm; n0 += C::kNT1) {
      zero(acc[0]);
      zero(acc[1]);
      for (int k0 = 0; k0 < cin; k0 += 2 * kKC) {
        step(a0);
        if (k0 + kKC < cin) step(a1);
      }
      drain();
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (wg + 2 * m >= C::kMH) continue;
#pragma unroll
        for (int j = 0; j < C::kNT1 / 8; ++j) {
          const int n = n0 + 8 * j + 2 * t;
          if (n >= cm) continue;
          const float s0 = b1[n], s1 = b1[n + 1];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = (wg + 2 * m) * 64 + wl * 16 + g + 8 * hh;
            if (row >= C::kHP) continue;
            const int gy = y0 - 1 + row / C::kHW, gx = x0 - 1 + row % C::kHW;
            const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
            const float v0 = inside ? fmaxf(acc[m][4 * j + 2 * hh] + s0, 0.f) : 0.f;
            const float v1 = inside ? fmaxf(acc[m][4 * j + 2 * hh + 1] + s1, 0.f) : 0.f;
            *reinterpret_cast<__nv_bfloat162*>(t1 + row * ts + n) = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
  consumers_sync();  // t1 written

  // rows of stages 2 and 3: one 64-row m-tile a warpgroup, or both
  // warpgroups on the one m-tile, each with half of the chunk's columns
  const int mt = C::kSplitN ? 0 : wg;
  const int nhalf = C::kSplitN ? wg : 0;
  const int p = min(mt * 64 + wl * 16 + (lane & 15), C::kP - 1);  // this lane's A row
  const int kc = cm / kKC;

  // ---- stage 2: t2 = relu(sum over the 9 taps of shifted t1 @ w2[tap] + b2);
  // step i = (tap i / kc, K chunk i % kc)
  {
    const int py = p / C::kTW, px = p % C::kTW;
    const __nv_bfloat16* arow = t1 + (py * C::kHW + px) * ts + (lane >> 4) * 8;
    float acc[C::kN2 / 2];
    uint32_t a0[4][4], a1[4][4];
    auto step = [&](uint32_t(&a)[4][4], int i) {
      const int tap = i / kc;
      const __nv_bfloat16* src = arow + ((tap / 3) * C::kHW + tap % 3) * ts + (i % kc) * kKC;
      const uint32_t s = take_w();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) ldsm_x4_addr(a[ks], smem_u32(src + 16 * ks));
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma<C::kN2>(acc, a[ks], sw128_desc(wring + s * kWSlot + nhalf * C::kN2 * 128 + 32 * ks));
      wgmma_commit();
      retire(s, -1);
    };
    for (int n0 = 0; n0 < cm; n0 += C::kNT2) {
      zero(acc);
      for (int i = 0; i < 9 * kc; i += 2) {
        step(a0, i);
        if (i + 1 < 9 * kc) step(a1, i + 1);
      }
      drain();
#pragma unroll
      for (int j = 0; j < C::kN2 / 8; ++j) {
        const int n = n0 + nhalf * C::kN2 + 8 * j + 2 * t;
        if (n >= cm) continue;
        const float s0 = b2[n], s1 = b2[n + 1];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = mt * 64 + wl * 16 + g + 8 * hh;
          if (row >= C::kP) continue;
          const float v0 = fmaxf(acc[4 * j + 2 * hh] + s0, 0.f);
          const float v1 = fmaxf(acc[4 * j + 2 * hh + 1] + s1, 0.f);
          *reinterpret_cast<__nv_bfloat162*>(t2 + row * ts + n) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
  // t2 written; t1 read for the last time: the projection's x may overwrite it
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumers_sync();
  if (threadIdx.x == 0 && has_down) mbar_arrive(t1_free);

  // ---- stage 3: out = relu((t2 @ w3 + b3) + identity), identity = x or
  // x @ wd + bd; step i < kc multiplies t2 by w3, the others x by wd
  {
    const int steps = kc + (has_down ? cin / kKC : 0);
    const __nv_bfloat16* arow = t2 + p * ts + (lane >> 4) * 8;
    float acc[C::kN3 / 2], accd[C::kN3 / 2];
    uint32_t a0[4][4], a1[4][4];
    auto step = [&](uint32_t(&a)[4][4], int i) {
      const uint32_t s = take_w();
      int sx = -1;
      if (i < kc) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) ldsm_x4_addr(a[ks], smem_u32(arow + i * kKC + 16 * ks));
      } else {
        sx = take_x();
        const uint32_t xt = r1 + sx * C::kX3;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) ldsm_x4_addr(a[ks], sw128_at(xt, p, 2 * ks + (lane >> 4)));
      }
      wgmma_fence();
      const uint32_t b = wring + s * kWSlot + nhalf * C::kN3 * 128;
      if (i < kc) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) wgmma<C::kN3>(acc, a[ks], sw128_desc(b + 32 * ks));
      } else {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) wgmma<C::kN3>(accd, a[ks], sw128_desc(b + 32 * ks));
      }
      wgmma_commit();
      retire(s, sx);
    };
    for (int n0 = 0; n0 < cout; n0 += C::kNT3) {
      zero(acc);
      zero(accd);
      // with kEarlyId, the identity of this chunk's outputs, loaded now so
      // that its latency hides behind the chunk's products
      uint32_t xid[2][C::kN3 / 8];
      if constexpr (C::kEarlyId) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = mt * 64 + wl * 16 + g + 8 * hh;
          const int gy = y0 + row / C::kTW, gx = x0 + row % C::kTW;
          const bool ok = !has_down && row < C::kP && gy < h && gx < w;
          const size_t pix = (static_cast<size_t>(img) * h + gy) * w + gx;
#pragma unroll
          for (int j = 0; j < C::kN3 / 8; ++j) {
            const int n = n0 + nhalf * C::kN3 + 8 * j + 2 * t;
            xid[hh][j] = ok && n < cout
                             ? __ldg(reinterpret_cast<const unsigned int*>(x + pix * cin + n))
                             : 0u;
          }
        }
      }
      for (int i = 0; i < steps; i += 2) {
        step(a0, i);
        if (i + 1 < steps) step(a1, i + 1);
      }
      drain();
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = mt * 64 + wl * 16 + g + 8 * hh;
        const int gy = y0 + row / C::kTW, gx = x0 + row % C::kTW;
        if (row >= C::kP || gy >= h || gx >= w) continue;
        const size_t pix = (static_cast<size_t>(img) * h + gy) * w + gx;
#pragma unroll
        for (int j = 0; j < C::kN3 / 8; ++j) {
          const int n = n0 + nhalf * C::kN3 + 8 * j + 2 * t;
          if (n >= cout) continue;
          float i0, i1;
          if (has_down) {
            i0 = accd[4 * j + 2 * hh] + bd[n];
            i1 = accd[4 * j + 2 * hh + 1] + bd[n + 1];
          } else {
            const float2 xi2 = __bfloat1622float2(
                C::kEarlyId ? *reinterpret_cast<const __nv_bfloat162*>(&xid[hh][j])
                            : *reinterpret_cast<const __nv_bfloat162*>(x + pix * cin + n));
            i0 = xi2.x;
            i1 = xi2.y;
          }
          const float v0 = fmaxf((acc[4 * j + 2 * hh] + b3[n]) + i0, 0.f);
          const float v1 = fmaxf((acc[4 * j + 2 * hh + 1] + b3[n + 1]) + i1, 0.f);
          *reinterpret_cast<__nv_bfloat162*>(out + pix * cout + n) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

}  // namespace v4
}  // namespace

// ----------------------------------------------------------- host side ----
namespace {

constexpr int kV2 = 2, kV4 = 4;

// v4 takes channel counts that are multiples of 64 with 64 <= Cm <= 512 (the
// ResNet-50 blocks); v2 every other multiple of 8 up to Cm = kMaxMid; 0: none
int variant(int cin, int cm, int cout) {
  if (cin <= 0 || cm <= 0 || cout <= 0 || cm > kMaxMid || cin % 8 || cm % 8 || cout % 8) return 0;
  if (cin % 64 == 0 && cm % 64 == 0 && cout % 64 == 0 && cm <= 512) return kV4;
  return kV2;
}

// calls f with the v4 configuration of this Cm
template <class F>
int with_cfg(int cm, F f) {
  if (cm <= 64) return f(v4::C64{});
  if (cm <= 128) return f(v4::C128{});
  if (cm <= 256) return f(v4::C256{});
  return f(v4::C512{});
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library needs no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dimensions (innermost first, strides in bytes
// of dimensions 1..rank-1), 128-byte swizzle, zeros outside the tensor.
// Returns a cudaError_t, or 10000 + the driver's CUresult.
int encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
           const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                        strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

// x [B][H][W][Cin] as boxes of 64 channels over th x tw pixels of one image
int encode_x(CUtensorMap* map, const void* x, int batch, int h, int w, int cin, int th, int tw) {
  const cuuint64_t dims[4] = {(cuuint64_t)cin, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)cin * 2, (cuuint64_t)w * cin * 2,
                                 (cuuint64_t)h * w * cin * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)tw, (cuuint32_t)th, 1};
  return encode(map, x, 4, dims, strides, box);
}

// a [rows][k] weight as boxes of 64 input channels over nt output channels
int encode_w(CUtensorMap* map, const void* wt, int rows, int k, int nt) {
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)nt};
  return encode(map, wt, 2, dims, strides, box);
}

int tiles(int batch, int h, int w, int th, int tw) {
  return batch * ((h + th - 1) / th) * ((w + tw - 1) / tw);
}

int launch_v2(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
              const void* w3, const void* b3, const void* wd, const void* bd, void* out,
              int batch, int h, int w, int cin, int cm, int cout, cudaStream_t stream) {
  const size_t smem = smem_bytes(cm);
  cudaError_t err = cudaFuncSetAttribute(fused_bottleneck_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n = ((h + kTile - 1) / kTile) * ((w + kTile - 1) / kTile);
  if (batch == 0 || n == 0) return 0;
  dim3 grid(n, batch);
  fused_bottleneck_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<const __nv_bfloat16*>(w3),
      static_cast<const float*>(b3), static_cast<const __nv_bfloat16*>(wd),
      static_cast<const float*>(bd), static_cast<__nv_bfloat16*>(out), h, w, cin, cm, cout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_bottleneck_max_mid() { return kMaxMid; }

// What the kernel does with a shape: out[0] the variant (4 or 2), out[1] the
// cluster size, out[2], out[3] the output tile (rows, columns of pixels a
// CTA), out[4] the CTAs of the grid, out[5] the CTAs one SM holds at once.
// Returns a cudaError_t (cudaErrorInvalidValue for a shape it does not take).
extern "C" int fused_bottleneck_config(int batch, int h, int w, int cin, int cm, int cout,
                                       int* out) {
  const int v = variant(cin, cm, cout);
  if (v == 0) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  cudaError_t err;
  if (v == kV2) {
    const int smem = (int)smem_bytes(cm);
    err = cudaFuncSetAttribute(fused_bottleneck_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_bottleneck_kernel,
                                                          kThreads, smem);
    const int cfg[6] = {kV2, 1, kTile, kTile, tiles(batch, h, w, kTile, kTile), per_sm};
    for (int i = 0; i < 6; ++i) out[i] = cfg[i];
    return (int)err;
  }
  return with_cfg(cm, [&](auto c) {
    using C = decltype(c);
    err = cudaFuncSetAttribute(v4::block_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, v4::block_kernel<C>,
                                                          v4::kThreads, C::kSmem);
    const int cfg[6] = {kV4, 1, C::kTH, C::kTW, tiles(batch, h, w, C::kTH, C::kTW), per_sm};
    for (int i = 0; i < 6; ++i) out[i] = cfg[i];
    return (int)err;
  });
}

// Encodes the TMA descriptors of the four weights (w1 [Cm][Cin], w2
// [3][3][Cm][Cm], w3 [Cout][Cm], wd [Cout][Cin] or null) into `maps`, 4 x 128
// bytes of host memory that fused_bottleneck_bf16 takes; all zeros for a
// shape that v4 does not take. Returns a cudaError_t (or 10000 + CUresult).
extern "C" int fused_bottleneck_encode_weights(const void* w1, const void* w2, const void* w3,
                                               const void* wd, int cin, int cm, int cout,
                                               void* maps) {
  CUtensorMap m[4];
  memset(m, 0, sizeof(m));
  int err = 0;
  if (variant(cin, cm, cout) == kV4) {
    err = with_cfg(cm, [&](auto c) {
      using C = decltype(c);
      const cuuint64_t dims[3] = {(cuuint64_t)cm, (cuuint64_t)cm, 9};
      const cuuint64_t strides[2] = {(cuuint64_t)cm * 2, (cuuint64_t)cm * cm * 2};
      const cuuint32_t box[3] = {64, (cuuint32_t)C::kNT2, 1};
      int e = encode_w(&m[0], w1, cm, cin, C::kNT1);
      if (!e) e = encode(&m[1], w2, 3, dims, strides, box);
      if (!e) e = encode_w(&m[2], w3, cout, cm, C::kNT3);
      if (!e && wd != nullptr) e = encode_w(&m[3], wd, cout, cin, C::kNT3);
      return e;
    });
  }
  memcpy(maps, m, sizeof(m));
  return err;
}

// Returns a cudaError_t (0 on success, 10000 + CUresult if a descriptor
// cannot be encoded). wd and bd are null without a projection (then cout ==
// cin); maps are fused_bottleneck_encode_weights' for the same weights. The
// variant follows from the shape alone (fused_bottleneck_config).
extern "C" int fused_bottleneck_bf16(const void* x, const void* w1, const void* b1,
                                     const void* w2, const void* b2, const void* w3,
                                     const void* b3, const void* wd, const void* bd, void* out,
                                     int batch, int h, int w, int cin, int cm, int cout,
                                     const void* maps, void* stream) {
  const int v = variant(cin, cm, cout);
  if (v == 0 || (wd == nullptr && cin != cout)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v == kV2) return launch_v2(x, w1, b1, w2, b2, w3, b3, wd, bd, out, batch, h, w, cin, cm,
                                 cout, s);
  if (maps == nullptr) return (int)cudaErrorInvalidValue;
  return with_cfg(cm, [&](auto c) {
    using C = decltype(c);
    CUtensorMap m[6];
    memcpy(m, maps, 4 * sizeof(CUtensorMap));
    int e = encode_x(&m[4], x, batch, h, w, cin, C::kTH + 2, C::kTW + 2);
    if (!e) e = encode_x(&m[5], x, batch, h, w, cin, C::kTH, C::kTW);
    if (e) return e;
    cudaError_t err = cudaFuncSetAttribute(
        v4::block_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return (int)err;
    const int n = tiles(batch, h, w, C::kTH, C::kTW);
    if (n == 0) return 0;
    v4::block_kernel<C><<<n, v4::kThreads, C::kSmem, s>>>(
        m[0], m[1], m[2], m[3], m[4], m[5], static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(b1), static_cast<const float*>(b2),
        static_cast<const float*>(b3), static_cast<const float*>(bd),
        static_cast<__nv_bfloat16*>(out), h, w, cin, cm, cout, wd != nullptr);
    return (int)cudaGetLastError();
  });
}
