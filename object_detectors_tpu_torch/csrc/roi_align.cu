// Multiscale RoIAlign forward for Hopper (torchvision MultiScaleRoIAlign,
// aligned=False).
//
// Replaces the TPU kernels of object_detectors_tpu/kernels/roi_align_pallas.py:
// multiscale_roi_align_bands_grouped (the shipped default), _bands, _tiled and
// _pallas. All four compute this one function; their VMEM tiers, bands,
// overflow repool and SMEM batch chunks are TPU devices that a GPU kernel,
// which can read a window of any size, does not need.
//
// Inputs: up to four FPN level maps [B, C, H_l, W_l] in channels_last memory
// (NHWC bytes), bf16 or f32, each with its spatial scale; boxes [B, N, 4]
// xyxy f32 in image coordinates. Output [B, N, oh, ow, C] in the maps'
// dtype, accumulated in f32. The kernel takes each box's level as
// ops/roi_align.py:assign_fpn_levels does, in the same f32 operations.
//
// Semantics, as ops/roi_align.py:multiscale_roi_align_canvas: the box is
// scaled, roi_w = max(x2 - x1, 1) (and h), bin = roi / out; sample (k_y, k_x)
// of bin (i, j) sits at y1 + (i + (k_y + 0.5) / s) * bin_h; a sample outside
// [-1, H] x [-1, W] counts 0; the rest clamp to [0, H-1] x [0, W-1] and are
// interpolated from their four neighbours, weights (1-ly)(1-lx), (1-ly)lx,
// ly(1-lx), ly lx; the bin is the mean of its s^2 samples. Built with
// -fmad=false, the positions and weights are the plain version's bit for
// bit; only the order of the sums differs.
//
// Bound: bytes. At the Faster R-CNN shape (16 images x 1000 RoIs, 7x7, 256
// channels, bf16, P2-P5 of 640^2 images) the output is 401 MB and the level
// maps, read once, 279 MB: about 0.20 ms at 3.35 TB/s. Without FMA
// contraction the bilinear sums alone take 8 f32 instructions per element
// and sample, about 0.2 ms of the card's issue rate, beside the bf16
// conversions.
//
// Design: one block of 128 threads per RoI, six blocks an SM, RoIs in
// image-major order so that one image's maps (17.4 MB) stay in L2 while its
// RoIs are pooled.
// - Geometry once per RoI: one warp computes the oh*s y-samples (floor,
//   clamped neighbour, fraction, outside flag), another the ow*s x-samples,
//   and each numbers the distinct rows (columns) the inside samples' corners
//   touch with ballots: the positions grow with the sample index, so a row
//   is new exactly when it exceeds the last one listed. Every output pixel
//   then combines a y-entry and an x-entry, whose corner offsets are set
//   once for the branch the RoI takes.
// - The footprint, those rows x columns (at most 2*oh*s x 2*ow*s, 28 x 28 at
//   7x7, s = 2), is copied into shared memory 128 bytes of channels at a
//   time (64 bf16 or 32 f32) with 16-byte cp.async and interpolated from
//   there; a thread pools 32 bytes of channels of one output pixel. A
//   footprint of at most kStagePixels / 2 gets two slice buffers, the next
//   slice's copy in flight while this one is pooled; one of at most
//   kStagePixels gets one buffer; a larger one (28 x 28 is the most at 7x7,
//   s = 2; the RPN's proposals at frcnn640 reach 264) reads its corners
//   from global memory instead. The branch is taken per RoI; maps whose
//   channels are not 16-byte runs (the one-channel-a-thread instantiation)
//   always read directly.
// - Stores: 16-byte runs, streaming (st.global.cs), so that the 401 MB
//   output does not push the level maps out of L2.
// The gather from L2 into the SMs at the Faster R-CNN shape: the corner
// reads of every sample, 784 rows of 512 bytes a RoI or 6.4 GB a launch,
// before; each distinct footprint pixel once, 0.68 GB for the RPN's
// proposals of the frcnn640 path, after (chip_smoke prints both).
//
// The backward (roi_align_backward below) replaces no Pallas kernel: the JAX
// package differentiates its pooler with the XLA VJP of the canvas
// formulation, ops/roi_align.py:_pool_pallas_bwd, in 64-RoI chunks with f32
// accumulation. It takes the output cotangent [B, N, oh, ow, C] (f32 or
// bf16) and scatters, for every inside sample, g / s^2 times each of its four
// bilinear weights into an f32 copy of the level maps with atomicAdd; for
// bf16 maps a second kernel then rounds that buffer into the maps' dtype.
// Level, samples, clamps and the outside rule are the forward's
// (fpn_level, axis_taps); each term is the plain version's product bit for
// bit, and only the order of the f32 sums, which the atomics leave to the
// hardware, differs.
// Bound: bytes. At Faster R-CNN training (2 images x 512 RoIs, 7x7, 256
// channels, P2-P5 of 800^2 images) the cotangent is 51 MB in f32 and the
// level maps' cotangents 109 MB: about 0.05 ms at 3.35 TB/s. The kernel adds
// the f32 buffer's zeroing and, in bf16, its rounding pass; its 4 atomics
// per inside sample and channel (at most 4 s^2 per bin and channel) go to
// L2, 32 neighbouring channels a warp instruction.
// Design, simple first: one 128-thread block per RoI computes the taps once,
// as the forward does; its threads walk the RoI's (bin, channel) elements,
// neighbouring threads on neighbouring channels.
//
// C interface (loaded with ctypes): the entry points launch on `stream` and
// return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 6;      // blocks an SM: registers and shared memory are sized for it
constexpr int kMaxLevels = 4;
constexpr int kVecs = 2;           // 16-byte vectors of channels a thread pools
constexpr int kSliceBytes = 128;   // channels of one staged pass, per pixel
// The largest footprint staged in shared memory: 128 + 4 bytes a pixel, about
// 37 KB a block with the taps, six blocks an SM.
constexpr int kStagePixels = 272;
constexpr int kMaxSmem = 227 * 1024 - 64;  // less the static shared memory
constexpr unsigned kFull = 0xffffffffu;

struct Level {
  const void* data;
  int h;
  int w;
  float scale;
};

struct Levels {
  Level l[kMaxLevels];
};

// One sample position along one axis of a RoI.
struct __align__(16) Tap {
  int o0;     // element offset of its floor row (column) in the map, or in the stage
  int o1;     // the same for the neighbour row (column)
  float f;    // the clamped position minus its floor; -1 outside the map
  float omf;  // 1 - f
  int g0;     // floor of the clamped position: a row (column) of the level map
  int g1;     // min(g0 + 1, size - 1)
  int c0;     // g0's and g1's places among the distinct rows (columns) the RoI touches
  int c1;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = p[i];
  }
}

template <int VEC>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&t);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_float(p[i]);
  }
}

// Streaming stores: the output is written once and not read by this kernel.
template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) __stcs(p + i, v[i]);
  }
}

template <int VEC>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    uint4 t;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&t);
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16_rn(v[i]);
    __stcs(reinterpret_cast<uint4*>(p), t);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// torchvision's LevelMapper in the f32 operations of
// ops/roi_align.py:assign_fpn_levels, which the plain version uses on the
// card: the same correctly rounded sqrt and divide and the same log2f.
__device__ __forceinline__ int fpn_level(float4 box, int num_levels) {
  const float area = (box.z - box.x) * (box.w - box.y);
  const float side = sqrtf(area < 0.0f ? 0.0f : area) / 224.0f;
  const float k = floorf(4.0f + log2f(side + 1e-6f)) - 2.0f;
  return static_cast<int>(fminf(fmaxf(k, 0.0f), static_cast<float>(num_levels - 1)));
}

// The samples along one axis, lane by lane: sample k = i * s + k_s of bin i.
__device__ void axis_taps(float lo, float bin, int out, int s, int size, Tap* taps, int lane) {
  const float sf = static_cast<float>(size);
  for (int k = lane; k < out * s; k += 32) {
    const int i = k / s;
    const int ks = k - i * s;
    const float v = lo + (static_cast<float>(i) +
                          (static_cast<float>(ks) + 0.5f) / static_cast<float>(s)) * bin;
    const float clamped = fminf(fmaxf(v, 0.0f), sf - 1.0f);
    const float f0 = floorf(clamped);
    Tap t;
    t.g0 = static_cast<int>(f0);
    t.g1 = min(t.g0 + 1, size - 1);
    t.f = (v < -1.0f || v > sf) ? -1.0f : clamped - f0;
    t.omf = 1.0f - t.f;
    taps[k] = t;
  }
}

// Lists the distinct rows (columns) the inside taps touch, ascending, and
// numbers each tap's two corners by their places in the list; returns the
// count. One warp, a tap a lane. g0 and g1 never decrease along the taps
// (the positions grow), so a tap's g0 is new exactly when it exceeds the
// last row listed before it, the g1 of the nearest inside tap before it;
// otherwise it is that row or the one before.
__device__ int compact(Tap* taps, int n, int* list, int lane) {
  const unsigned below = (1u << lane) - 1;
  int count = 0, last_listed = -1;  // carried from one 32-tap round to the next
  for (int base = 0; base < n; base += 32) {
    const int k = base + lane;
    const bool in = k < n && taps[k].f >= 0.0f;  // outside the map: reads nothing
    const int g0 = in ? taps[k].g0 : 0;
    const int g1 = in ? taps[k].g1 : 0;
    const unsigned inside = __ballot_sync(kFull, in);
    const unsigned earlier = inside & below;
    const int prev_g1 = __shfl_sync(kFull, g1, earlier ? 31 - __clz(earlier) : 0);
    const int last = earlier ? prev_g1 : last_listed;
    const bool new0 = in && g0 > last;
    const bool new1 = in && g1 > g0 && g1 > last;
    const unsigned b0 = __ballot_sync(kFull, new0);
    const unsigned b1 = __ballot_sync(kFull, new1);
    const int before = count + __popc(b0 & below) + __popc(b1 & below);
    if (in) {
      const int c0 = new0 ? before : (g0 == last ? before - 1 : before - 2);
      if (new0) list[before] = g0;
      if (new1) list[before + new0] = g1;
      taps[k].c0 = c0;
      taps[k].c1 = g1 == g0 ? c0 : (new1 ? before + new0 : before - 1);
    }
    count += __popc(b0) + __popc(b1);
    if (inside) last_listed = __shfl_sync(kFull, g1, 31 - __clz(inside));
  }
  return count;
}

// a / b for 0 <= a < 2^22 and 1 <= b, from b's reciprocal in f32: the
// quotient plus one half lies at least 0.5 / b from an integer, more than
// the rounding moves it
__device__ __forceinline__ int quot(int a, float inv_b) {
  return static_cast<int>((static_cast<float>(a) + 0.5f) * inv_b);
}

// The element offsets of the taps' corners: rows (columns) of the stage, or
// of the map, `step` elements apart.
__device__ void place_taps(Tap* taps, int n, bool staged, int step, int lane) {
  for (int k = lane; k < n; k += 32) {
    taps[k].o0 = (staged ? taps[k].c0 : taps[k].g0) * step;
    taps[k].o1 = (staged ? taps[k].c1 : taps[k].g1) * step;
  }
}

// One output bin for kVecs vectors of VEC channels, vector v at base +
// off[v] where bit v of `valid` is set (the bin's corner offsets come from
// its taps): the mean of its s^2 samples, each the weighted sum of its four
// corners in the order of the plain version's expression. A power-of-two
// count divides as a multiplication by its reciprocal, which rounds the
// same.
template <typename T, int VEC>
__device__ __forceinline__ void pool_bin(const Tap* ty, const Tap* tx, int s, const T* base,
                                         const int (&off)[kVecs], int valid,
                                         float (&acc)[kVecs][VEC]) {
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[v][i] = 0.0f;
  }
  for (int ky = 0; ky < s; ++ky) {
    const Tap a = ty[ky];
    for (int kx = 0; kx < s; ++kx) {
      const Tap b = tx[kx];
      if (a.f < 0.0f || b.f < 0.0f) continue;  // adds 0
      const float w00 = a.omf * b.omf;
      const float w01 = a.omf * b.f;
      const float w10 = a.f * b.omf;
      const float w11 = a.f * b.f;
      const T* p00 = base + a.o0 + b.o0;
      const T* p01 = base + a.o0 + b.o1;
      const T* p10 = base + a.o1 + b.o0;
      const T* p11 = base + a.o1 + b.o1;
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        if ((valid >> v) & 1) {
          float x[VEC], sum[VEC];
          load<VEC>(p00 + off[v], x);
#pragma unroll
          for (int i = 0; i < VEC; ++i) sum[i] = w00 * x[i];
          load<VEC>(p01 + off[v], x);
#pragma unroll
          for (int i = 0; i < VEC; ++i) sum[i] = sum[i] + w01 * x[i];
          load<VEC>(p10 + off[v], x);
#pragma unroll
          for (int i = 0; i < VEC; ++i) sum[i] = sum[i] + w10 * x[i];
          load<VEC>(p11 + off[v], x);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[v][i] += sum[i] + w11 * x[i];
        }
      }
    }
  }
  const int n = s * s;
  const float count = static_cast<float>(n);
  const float inv = 1.0f / count;
  const bool pow2 = (n & (n - 1)) == 0;
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[v][i] = pow2 ? acc[v][i] * inv : acc[v][i] / count;
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_bin(T* out, const int (&off)[kVecs], int valid,
                                          const float (&acc)[kVecs][VEC]) {
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    if ((valid >> v) & 1) store<VEC>(out + off[v], acc[v]);
  }
}

// Staged in shared memory: maps whose channels come in 16-byte vectors.
template <typename T, int VEC>
constexpr bool kStaged = VEC * sizeof(T) == 16;

// Shared memory before the taps: the stage (one slice of a footprint of
// kStagePixels, or two of half that) and the footprint's pixel offsets.
template <typename T, int VEC>
constexpr int kStageBytes = kStaged<T, VEC> ? (kSliceBytes + 4) * kStagePixels : 0;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
roi_align_kernel(Levels levels_in, int num_levels, const float4* __restrict__ boxes,
                 T* __restrict__ out, uint8_t* __restrict__ route, int n, int c, int oh, int ow,
                 int s) {
  constexpr int kSlice = kSliceBytes / static_cast<int>(sizeof(T));  // channels a pass
  constexpr int kGroup = kVecs * VEC;                                // channels a thread
  constexpr int kChunks = kSliceBytes / 16;                          // 16-byte copies a pixel
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);                                // [kStagePixels][kSlice]
  int* pix = reinterpret_cast<int*>(smem + kSliceBytes * kStagePixels);  // [kStagePixels]
  Tap* ty = reinterpret_cast<Tap*>(smem + kStageBytes<T, VEC>);         // [oh * s]
  Tap* tx = ty + oh * s;                                                // [ow * s]
  int* rows = reinterpret_cast<int*>(tx + ow * s);                      // [2 * oh * s]
  int* cols = rows + 2 * oh * s;                                        // [2 * ow * s]
  __shared__ int n_rows, n_cols;

  const int64_t r = blockIdx.x;  // RoI index over B * N
  const int64_t b = r / n;
  const float4 box = boxes[r];
  const int lvl = fpn_level(box, num_levels);
  Level L = levels_in.l[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (lvl == i) L = levels_in.l[i];
  }
  const T* feat = static_cast<const T*>(L.data) + b * L.h * L.w * c;
  const float x1 = box.x * L.scale;
  const float y1 = box.y * L.scale;
  const float x2 = box.z * L.scale;
  const float y2 = box.w * L.scale;
  const float bin_w = fmaxf(x2 - x1, 1.0f) / static_cast<float>(ow);
  const float bin_h = fmaxf(y2 - y1, 1.0f) / static_cast<float>(oh);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == 0) {
    axis_taps(y1, bin_h, oh, s, L.h, ty, lane);
    __syncwarp();
    const int count = compact(ty, oh * s, rows, lane);
    if (lane == 0) n_rows = count;
  } else if (warp == 1) {
    axis_taps(x1, bin_w, ow, s, L.w, tx, lane);
    __syncwarp();
    const int count = compact(tx, ow * s, cols, lane);
    if (lane == 0) n_cols = count;
  }
  __syncthreads();
  const int nc = n_cols;
  const int foot = n_rows * nc;
  const bool stage = kStaged<T, VEC> && foot <= kStagePixels;
  if (route && threadIdx.x == 0) route[r] = static_cast<uint8_t>(lvl * 2 + stage);
  if (warp == 0) place_taps(ty, oh * s, stage, stage ? nc * kSlice : L.w * c, lane);
  if (warp == 1) place_taps(tx, ow * s, stage, stage ? kSlice : c, lane);
  if (stage) {
    const float inv_nc = 1.0f / static_cast<float>(nc);
    for (int p = threadIdx.x; p < foot; p += kThreads) {
      const int y = quot(p, inv_nc);
      pix[p] = rows[y] * L.w + cols[p - y * nc];
    }
  }
  __syncthreads();
  T* out_roi = out + r * oh * ow * c;
  const float inv_ow = 1.0f / static_cast<float>(ow);

  if (!stage) {  // corners straight from global memory
    const int groups = (c + kGroup - 1) / kGroup;
    for (int t = threadIdx.x; t < oh * ow * groups; t += kThreads) {
      const int ch = (t % groups) * kGroup;
      const int p = t / groups;
      const int py = quot(p, inv_ow);
      int off[kVecs], valid = 0;
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        off[v] = v * VEC;
        valid |= (ch + off[v] < c) << v;
      }
      float acc[kVecs][VEC];
      pool_bin<T, VEC>(ty + py * s, tx + (p - py * ow) * s, s, feat + ch, off, valid, acc);
      store_bin<T, VEC>(out_roi + static_cast<int64_t>(p) * c + ch, off, valid, acc);
    }
    return;
  }

  if constexpr (kStaged<T, VEC>) {
    auto copy = [&](int slice, T* dst) {
      for (int e = threadIdx.x; e < foot * kChunks; e += kThreads) {
        const int q = e % kChunks;
        const int p = e / kChunks;
        const int ch = slice * kSlice + q * VEC;
        if (ch < c) {
          cp_async16(dst + p * kSlice + q * VEC, feat + static_cast<int64_t>(pix[p]) * c + ch);
        }
      }
      cp_async_commit();
    };
    // Two slice buffers when two footprints fit in the stage, the next
    // slice's copy in flight while this one is pooled; else one.
    const int slices = (c + kSlice - 1) / kSlice;
    const bool two = 2 * foot <= kStagePixels;
    T* next = buf + (two ? kStagePixels / 2 * kSlice : 0);
    copy(0, buf);
    for (int sl = 0; sl < slices; ++sl) {
      const T* cur = (sl & 1) ? next : buf;
      if (two && sl + 1 < slices) {
        copy(sl + 1, (sl & 1) ? buf : next);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // this slice has landed for every thread
      constexpr int kPer = kSlice / kGroup;  // threads a pixel
      const int base = sl * kSlice;
      for (int t = threadIdx.x; t < oh * ow * kPer; t += kThreads) {
        const int q = t % kPer;
        const int p = t / kPer;
        const int py = quot(p, inv_ow);
        int off[kVecs], valid = 0;
#pragma unroll
        for (int v = 0; v < kVecs; ++v) {
          off[v] = (q * kVecs + v) * VEC;
          valid |= (base + off[v] < c) << v;
        }
        if (!valid) continue;
        float acc[kVecs][VEC];
        pool_bin<T, VEC>(ty + py * s, tx + (p - py * ow) * s, s, cur, off, valid, acc);
        store_bin<T, VEC>(out_roi + static_cast<int64_t>(p) * c + base, off, valid, acc);
      }
      __syncthreads();  // every thread is done with cur before a copy overwrites it
      if (!two && sl + 1 < slices) copy(sl + 1, (sl & 1) ? buf : next);
    }
  }
}

// Raises the dynamic shared memory a kernel may take to `bytes` on the
// current device, unless an earlier launch there already did.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  static int allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && allowed[dev] >= bytes)) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) allowed[dev] = bytes;
  return err;
}

template <typename T, int VEC>
cudaError_t launch(const Levels& lv, int num_levels, const void* boxes, void* out, void* route,
                   int rois, int n, int c, int oh, int ow, int s, cudaStream_t stream) {
  const size_t smem = kStageBytes<T, VEC> +
                      static_cast<size_t>(oh + ow) * s * (sizeof(Tap) + 2 * sizeof(int));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(roi_align_kernel<T, VEC>, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  roi_align_kernel<T, VEC><<<rois, kThreads, smem, stream>>>(
      lv, num_levels, static_cast<const float4*>(boxes), static_cast<T*>(out),
      static_cast<uint8_t*>(route), n, c, oh, ow, s);
  return cudaGetLastError();
}

// The backward of one RoI: every inside sample of every bin adds g / s^2
// times its four bilinear weights to the f32 cotangent of its level map
// (levels_in.l[i].data, [B, H, W, C] f32), whose offsets are int.
template <typename G>
__global__ void __launch_bounds__(kThreads)
roi_align_backward_kernel(Levels levels_in, int num_levels, const float4* __restrict__ boxes,
                          const G* __restrict__ grad, int n, int c, int oh, int ow, int s) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tap* ty = reinterpret_cast<Tap*>(smem);  // [oh * s]
  Tap* tx = ty + oh * s;                   // [ow * s]

  const int64_t r = blockIdx.x;  // RoI index over B * N
  const int64_t b = r / n;
  const float4 box = boxes[r];
  const int lvl = fpn_level(box, num_levels);
  Level L = levels_in.l[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (lvl == i) L = levels_in.l[i];
  }
  float* acc = static_cast<float*>(const_cast<void*>(L.data)) + b * L.h * L.w * c;
  const float x1 = box.x * L.scale;
  const float y1 = box.y * L.scale;
  const float x2 = box.z * L.scale;
  const float y2 = box.w * L.scale;
  const float bin_w = fmaxf(x2 - x1, 1.0f) / static_cast<float>(ow);
  const float bin_h = fmaxf(y2 - y1, 1.0f) / static_cast<float>(oh);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == 0) axis_taps(y1, bin_h, oh, s, L.h, ty, lane);
  if (warp == 1) axis_taps(x1, bin_w, ow, s, L.w, tx, lane);
  __syncthreads();

  // the mean's cotangent: a power-of-two count divides as a multiplication
  // by its reciprocal, which rounds the same
  const int ns = s * s;
  const float count = static_cast<float>(ns);
  const float inv = 1.0f / count;
  const bool pow2 = (ns & (ns - 1)) == 0;
  const G* g_roi = grad + r * oh * ow * c;
  const int elems = oh * ow * c;
  for (int t = threadIdx.x; t < elems; t += kThreads) {
    const int p = t / c;
    const int ch = t - p * c;
    const int py = p / ow;
    const Tap* ry = ty + py * s;
    const Tap* rx = tx + (p - py * ow) * s;
    const float gv = to_float(g_roi[t]);
    const float gs = pow2 ? gv * inv : gv / count;
    for (int ky = 0; ky < s; ++ky) {
      const Tap a = ry[ky];
      if (a.f < 0.0f) continue;  // outside the map: no cotangent
      const int r0 = a.g0 * L.w;
      const int r1 = a.g1 * L.w;
      for (int kx = 0; kx < s; ++kx) {
        const Tap t2 = rx[kx];
        if (t2.f < 0.0f) continue;
        atomicAdd(acc + (r0 + t2.g0) * c + ch, gs * (a.omf * t2.omf));
        atomicAdd(acc + (r0 + t2.g1) * c + ch, gs * (a.omf * t2.f));
        atomicAdd(acc + (r1 + t2.g0) * c + ch, gs * (a.f * t2.omf));
        atomicAdd(acc + (r1 + t2.g1) * c + ch, gs * (a.f * t2.f));
      }
    }
  }
}

// Rounds the f32 cotangents into bf16, element by element.
__global__ void round_to_bf16_kernel(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                                     int64_t count) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    dst[i] = __float2bfloat16_rn(src[i]);
  }
}

template <typename G>
cudaError_t launch_backward(const Levels& lv, int num_levels, const void* boxes,
                            const void* grad, int rois, int n, int c, int oh, int ow, int s,
                            cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(oh + ow) * s * sizeof(Tap);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(roi_align_backward_kernel<G>, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  roi_align_backward_kernel<G><<<rois, kThreads, smem, stream>>>(
      lv, num_levels, static_cast<const float4*>(boxes), static_cast<const G*>(grad), n, c, oh,
      ow, s);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Unused level slots may hold null.
// route, if not null, receives [rois] uint8: the RoI's level times 2, plus
// 1 where its footprint was staged in shared memory (0: its corners were
// read directly).
extern "C" int roi_align_forward(int dtype, int num_levels, const void* f0, int h0, int w0,
                                 float s0, const void* f1, int h1, int w1, float s1,
                                 const void* f2, int h2, int w2, float s2, const void* f3,
                                 int h3, int w3, float s3, const void* boxes, void* out,
                                 void* route, int rois, int n, int c, int oh, int ow,
                                 int sampling_ratio, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || rois < 0 || n <= 0 || c <= 0 ||
      oh <= 0 || ow <= 0 || sampling_ratio <= 0 || (dtype != 0 && dtype != 1) ||
      static_cast<int64_t>(oh) * ow >= (1 << 22)) {  // quot() takes the bins' indices
    return cudaErrorInvalidValue;
  }
  if (rois == 0) return cudaSuccess;
  const Levels lv = {{{f0, h0, w0, s0}, {f1, h1, w1, s1}, {f2, h2, w2, s2}, {f3, h3, w3, s3}}};
  bool aligned = aligned16(out);
  for (int i = 0; i < num_levels; ++i) {
    aligned = aligned && aligned16(lv.l[i].data);
    // a corner's offset in one image's map is an int
    if (static_cast<int64_t>(lv.l[i].h) * lv.l[i].w * c > INT32_MAX) return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (aligned && c % 8 == 0) {
      return launch<__nv_bfloat16, 8>(lv, num_levels, boxes, out, route, rois, n, c, oh, ow,
                                      sampling_ratio, st);
    }
    return launch<__nv_bfloat16, 1>(lv, num_levels, boxes, out, route, rois, n, c, oh, ow,
                                    sampling_ratio, st);
  }
  if (aligned && c % 4 == 0) {
    return launch<float, 4>(lv, num_levels, boxes, out, route, rois, n, c, oh, ow,
                            sampling_ratio, st);
  }
  return launch<float, 1>(lv, num_levels, boxes, out, route, rois, n, c, oh, ow, sampling_ratio,
                          st);
}

// The backward: grad_dtype 0 = float32, 1 = bfloat16 (the output
// cotangent [rois, oh, ow, c]); a0..a3 the f32 cotangents of the level maps,
// [B, H_l, W_l, C] each, zeroed by the caller. When `out` is not null the
// f32 cotangents, `total` elements from a0 on (the levels one after another
// in one buffer), are then rounded into it as bf16.
extern "C" int roi_align_backward(int grad_dtype, int num_levels, void* a0, int h0, int w0,
                                  float s0, void* a1, int h1, int w1, float s1, void* a2,
                                  int h2, int w2, float s2, void* a3, int h3, int w3, float s3,
                                  const void* boxes, const void* grad, void* out, long long total,
                                  int rois, int n, int c, int oh, int ow, int sampling_ratio,
                                  void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || rois < 0 || n <= 0 || c <= 0 ||
      oh <= 0 || ow <= 0 || sampling_ratio <= 0 || (grad_dtype != 0 && grad_dtype != 1) ||
      total < 0 || static_cast<int64_t>(oh) * ow * c > INT32_MAX) {
    return cudaErrorInvalidValue;
  }
  const Levels lv = {{{a0, h0, w0, s0}, {a1, h1, w1, s1}, {a2, h2, w2, s2}, {a3, h3, w3, s3}}};
  for (int i = 0; i < num_levels; ++i) {
    // a corner's offset in one image's map is an int
    if (static_cast<int64_t>(lv.l[i].h) * lv.l[i].w * c > INT32_MAX) return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rois > 0) {
    const cudaError_t err =
        grad_dtype == 1
            ? launch_backward<__nv_bfloat16>(lv, num_levels, boxes, grad, rois, n, c, oh, ow,
                                             sampling_ratio, st)
            : launch_backward<float>(lv, num_levels, boxes, grad, rois, n, c, oh, ow,
                                     sampling_ratio, st);
    if (err != cudaSuccess) return err;
  }
  if (out != nullptr && total > 0) {
    const int64_t blocks = (total + 255) / 256;
    round_to_bf16_kernel<<<static_cast<unsigned>(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0,
                           st>>>(static_cast<const float*>(a0),
                                 static_cast<__nv_bfloat16*>(out), total);
  }
  return cudaGetLastError();
}
