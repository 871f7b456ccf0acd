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
// bf16) and adds, for every inside sample, g / s^2 times each of its four
// bilinear weights into an f32 copy of the level maps, which the caller
// zeroes; for bf16 maps a second kernel then rounds that buffer into the
// maps' dtype. Level, samples, clamps and the outside rule are the
// forward's (roi_geometry); each term is the plain version's product bit for
// bit, and only the order of the f32 sums differs.
// Bound: bytes. At Faster R-CNN training (2 images x 512 RoIs, 7x7, 256
// channels, P2-P5 of 800^2 images) the cotangent is 51 MB in f32 and the
// level maps' cotangents 109 MB: about 0.05 ms at 3.35 TB/s. What costs more
// is the reductions into L2: a plain scatter of every sample's corners
// issues 4 s^2 oh ow C scalar atomics a RoI (200 704 at 7x7, s = 2, C =
// 256), however few pixels the samples share.
// Design. A block of 128 threads takes one RoI and a slice of 64 channels
// (fewer where the pooled output or s is large), the four slices of one
// RoI and the RoIs of one image next to each other in the grid. Its geometry is the
// forward's (roi_geometry: the taps, and the ballot listing of the rows and
// columns the inside samples' corners touch: the footprint, at most 2 oh s
// x 2 ow s pixels). The slice's cotangent is loaded while that geometry is
// built. Then one of two routes, by a rule that
// kernels/roi_align.py:backward_routes states:
// - staged, where the footprint is under half the samples' corners (4 s^2
//   oh ow): each axis gets a table of which taps put a corner on each
//   listed row (column); the corners' places grow with the tap index, so
//   for a row these are two runs of taps, those whose corner 0 lands there
//   and those whose corner 1 does. The slice's cotangent, divided by s^2,
//   is staged in shared memory (12.5 KB at 7x7), and the block gathers: a
//   thread takes one footprint pixel and 4 channels, walks the pairs of a
//   y-tap corner on its row and an x-tap corner on its column (each pair one
//   sample corner of one bin), sums g / s^2 times their weight in
//   registers, and sends the sum to L2 with one atomicAdd(float4*, float4)
//   (red.global.add.v4.f32, compute capability 9.x). Neighbouring threads
//   take neighbouring channels of one pixel, so that each 16-byte load from
//   the stage reads whole rows of banks. A RoI whose samples crowd into 4
//   pixels thus sends 4 reductions a vector of 4 channels where the scatter
//   sent 784 scalars a channel. (Letting up to 8 threads share a small
//   footprint's pixel changed no time beyond the spread, even with every
//   RoI under 4 px, so each pixel has one thread.)
// - direct, where the footprint holds at least half the corners (bins of 2
//   pixels and more, where few samples share a pixel): summing gains too
//   little for the tables and the stage, so a thread takes one sample and
//   4 channels and sends each of its 4 corners with one float4 reduction.
//   With chip_smoke's training RoIs (120 of 1024 direct) the kernel takes
//   0.121 ms against 0.134 with every RoI staged; with RoIs of 200-800 px,
//   most of them direct on the small P4 and P5 maps, 0.217 against 0.183
//   (analysis/roi_bwd_variants.py, H100 80GB HBM3 at 700 W).
// No shared tile holds the footprint, so no footprint is too large for the
// staged route; the largest ones, 28 x 28 at 7x7 and 56 x 56 at 14x14, take
// the direct one by the rule. Channels that are not whole runs of 4, or a
// buffer or cotangent off a 16-byte boundary, take 1 channel a thread and
// scalar reductions on either route. The sums of overlapping RoIs meet in
// L2 in no fixed order, as before.
// What bounds it now: the f32 buffer (109 MB at the training shape) does
// not fit the 50 MB L2, so the zeroing writes it to device memory and the
// reductions read their lines back, then the gather's loads from shared
// memory and its f32 arithmetic, which FMA contraction may not shorten.

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
constexpr int kBwdSlice = 64;      // channels a backward block takes at most
constexpr int kBwdStageBytes = 64 * 1024;  // the most its staged cotangent takes
constexpr int kBwdThreads = 128;   // a backward block's threads
constexpr int kBwdMinBlocks = 8;   // backward blocks an SM: registers are sized for it
constexpr int kBwdLoads = 8;       // cotangent vectors a thread loads at once
// A RoI whose footprint holds at least 1 / kBwdDirect of its samples'
// corners gains too little from summing on the SM: its corners go out
// directly, one reduction each.
constexpr int kBwdDirect = 2;

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

// The geometry of one RoI, computed once for its block: its level (L, the
// level map's entry, and the returned index), the taps along y (ty, oh * s)
// by warp 0 and along x (tx, ow * s) by warp 1, and the distinct rows and
// columns their inside corners touch (rows, cols; their counts in *n_rows and
// *n_cols, shared), each tap's corners numbered by their places in the lists.
// Ends with a block barrier.
__device__ int roi_geometry(const Levels& levels_in, int num_levels, float4 box, int oh, int ow,
                            int s, Tap* ty, Tap* tx, int* rows, int* cols, int* n_rows,
                            int* n_cols, Level& L) {
  const int lvl = fpn_level(box, num_levels);
  L = levels_in.l[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (lvl == i) L = levels_in.l[i];
  }
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
    if (lane == 0) *n_rows = count;
  } else if (warp == 1) {
    axis_taps(x1, bin_w, ow, s, L.w, tx, lane);
    __syncwarp();
    const int count = compact(tx, ow * s, cols, lane);
    if (lane == 0) *n_cols = count;
  }
  __syncthreads();
  return lvl;
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
  Level L;
  const int lvl = roi_geometry(levels_in, num_levels, boxes[r], oh, ow, s, ty, tx, rows, cols,
                               &n_rows, &n_cols, L);
  const T* feat = static_cast<const T*>(L.data) + b * L.h * L.w * c;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
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

// The backward's table of one axis: for each listed row (column) q, the
// inside taps whose corner 0 lands on it, [x, y), and those whose corner 1
// does, [z, w). The corners' places grow with the tap index, so each set is
// one run of taps. One warp, a tap a lane; `step` sets each tap's o0 to its
// bin's offset in the RoI's cotangent, (k / s) * step.
__device__ void contributors(Tap* taps, int n, int s, int step, int4* table, int count,
                             int lane) {
  for (int q = lane; q < count; q += 32) table[q] = make_int4(0, 0, 0, 0);
  __syncwarp();
  for (int k = lane; k < n; k += 32) {
    taps[k].o0 = (k / s) * step;
    const Tap t = taps[k];
    if (t.f < 0.0f) continue;  // outside the map: no cotangent
    const bool first = k == 0 || taps[k - 1].f < 0.0f;
    const bool last = k + 1 == n || taps[k + 1].f < 0.0f;
    if (first || taps[k - 1].c0 != t.c0) table[t.c0].x = k;
    if (last || taps[k + 1].c0 != t.c0) table[t.c0].y = k + 1;
    if (first || taps[k - 1].c1 != t.c1) table[t.c1].z = k;
    if (last || taps[k + 1].c1 != t.c1) table[t.c1].w = k + 1;
  }
}

// VEC cotangent values of one bin: 4 in one 16-byte (f32) or 8-byte (bf16)
// load, else one.
template <typename G, int VEC>
__device__ __forceinline__ void load_grad(const G* p, float (&v)[VEC]) {
  if constexpr (VEC == 4 && sizeof(G) == 2) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __bfloat162float(h[i]);
  } else {
    load<VEC>(p, v);
  }
}

// The floats of a backward block's staged cotangent, rounded up to 16 bytes.
__host__ __device__ __forceinline__ int stage_floats(int oh, int ow, int slice) {
  return (oh * ow * slice + 3) / 4 * 4;
}

// Channels a backward block takes: kBwdSlice, fewer where the pooled output
// is so large that their cotangent would not fit kBwdStageBytes, or where a
// block's items (up to 4 s^2 oh ow footprint pixels or sample corners, each
// with the slice's channels) would reach the 2^22 that quot() takes (0 where
// not even 4 would fit), all of them where there are fewer; a multiple of 4
// unless it is all of them.
int backward_slice(int c, int oh, int ow, int s) {
  const int64_t bins = static_cast<int64_t>(oh) * ow;
  const int64_t by_stage = kBwdStageBytes / (bins * 4);
  const int64_t by_items = ((1 << 22) - 1) / (4 * bins * s * s);
  const int64_t fit = (by_stage < by_items ? by_stage : by_items) / 4 * 4;
  return static_cast<int>(fit < c ? (fit < kBwdSlice ? fit : kBwdSlice)
                                  : (c < kBwdSlice ? c : kBwdSlice));
}

// One RoI's footprint as its backward block sees it once the tables are
// built (all in shared memory but acc, the RoI's image in its level's f32
// cotangent).
struct Footprint {
  const Tap* ty;     // o0: the offset of the tap's bin row in gs
  const Tap* tx;     // o0: the offset of the tap's bin column in gs
  const int4* by;    // [rows]: the runs of y-taps whose corner 0 (x, y) and 1 (z, w) land there
  const int4* bx;    // [cols]: the same for the x-taps
  const int* rows;   // the rows of the level map, ascending
  const int* cols;
  const float* gs;   // [oh * ow][slice]: g / s^2 of the block's channels
  int nr;
  int nc;
  int w;             // the level map's width
  float* acc;
};

// The gather of the block's channels [lo, hi): a thread takes one pixel (a
// listed row and column) and one vector of VEC channels, sums in registers
// g / s^2 times the bilinear weight of every sample corner on the pixel
// (the pairs of a y-tap corner on its row and an x-tap corner on its
// column, from the two tables), and adds the sum to acc with one
// reduction: a float4 one for VEC = 4, else a scalar one. Neighbouring
// threads take neighbouring vectors of one pixel, so that each load from
// the stage reads whole rows of banks.
template <int VEC>
__device__ __forceinline__ void gather(const Footprint& f, int c, int lo, int hi) {
  const int vecs = (hi - lo) / VEC;  // VEC divides the channels
  const float inv_vecs = 1.0f / static_cast<float>(vecs);
  const float inv_nc = 1.0f / static_cast<float>(f.nc);
  const int items = f.nr * f.nc * vecs;  // < 2^22 by backward_slice
  for (int t = threadIdx.x; t < items; t += kBwdThreads) {
    const int rest = quot(t, inv_vecs);
    const int ch = (t - rest * vecs) * VEC;  // from lo
    const int qy = quot(rest, inv_nc);
    const int qx = rest - qy * f.nc;
    const int4 cy = f.by[qy];
    const int4 cx = f.bx[qx];
    const int n0 = cy.y - cy.x;  // the y-taps' corners 0 on this row, then their corners 1
    float sum[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) sum[i] = 0.0f;
    for (int j = 0; j < n0 + cy.w - cy.z; ++j) {
      const bool sy = j >= n0;
      const Tap a = f.ty[sy ? cy.z + j - n0 : cy.x + j];
      const float wy = sy ? a.f : a.omf;
      const float* row = f.gs + a.o0 + ch;
      // adds the pairs of this y-tap corner and x-taps kx (and kx + 1 where
      // two is set, their loads issued together)
      auto add = [&](int kx, bool sx, bool two) {
        const Tap t0 = f.tx[kx];
        const Tap t1 = f.tx[two ? kx + 1 : kx];
        const float w0 = wy * (sx ? t0.f : t0.omf);  // the plain version's weights
        const float w1 = wy * (sx ? t1.f : t1.omf);
        float g0[VEC], g1[VEC];
        load<VEC>(row + t0.o0, g0);
        load<VEC>(row + t1.o0, g1);
#pragma unroll
        for (int i = 0; i < VEC; ++i) sum[i] = sum[i] + g0[i] * w0;
        if (two) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) sum[i] = sum[i] + g1[i] * w1;
        }
      };
      for (int sx = 0; sx < 2; ++sx) {
        const int x_end = sx ? cx.w : cx.y;
        int kx = sx ? cx.z : cx.x;
        for (; kx + 1 < x_end; kx += 2) add(kx, sx, true);
        if (kx < x_end) add(kx, sx, false);
      }
    }
    float* dst = f.acc + (f.rows[qy] * f.w + f.cols[qx]) * c + lo + ch;
    if constexpr (VEC == 4) {
      atomicAdd(reinterpret_cast<float4*>(dst), make_float4(sum[0], sum[1], sum[2], sum[3]));
    } else {
      atomicAdd(dst, sum[0]);
    }
  }
}

// The direct route for channels [lo, hi) (g_roi starts at lo): a thread
// takes one sample and VEC channels and adds g / s^2 times each of its four
// bilinear weights to the corner's pixel, one reduction a corner (float4 for
// VEC = 4).
template <typename G, int VEC>
__device__ __forceinline__ void scatter(const Tap* ty, const Tap* tx, int oh, int ow, int s,
                                        const G* g_roi, float* acc, int w, int c, int lo,
                                        int hi, float inv, float count, bool pow2) {
  const int vecs = (hi - lo) / VEC;  // VEC divides the channels
  const int xs = ow * s;
  const float inv_vecs = 1.0f / static_cast<float>(vecs);
  const float inv_xs = 1.0f / static_cast<float>(xs);
  const float inv_s = 1.0f / static_cast<float>(s);
  for (int t = threadIdx.x; t < oh * s * xs * vecs; t += kBwdThreads) {
    const int k = quot(t, inv_vecs);
    const int ch = (t - k * vecs) * VEC;  // from lo
    const int ky = quot(k, inv_xs);
    const int kx = k - ky * xs;
    const Tap a = ty[ky];
    const Tap t2 = tx[kx];
    if (a.f < 0.0f || t2.f < 0.0f) continue;  // outside the map: no cotangent
    float gv[VEC];
    load_grad<G, VEC>(g_roi + (quot(ky, inv_s) * ow + quot(kx, inv_s)) * c + ch, gv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) gv[i] = pow2 ? gv[i] * inv : gv[i] / count;
    const float wt[4] = {a.omf * t2.omf, a.omf * t2.f, a.f * t2.omf, a.f * t2.f};
    const int at[4] = {a.g0 * w + t2.g0, a.g0 * w + t2.g1, a.g1 * w + t2.g0, a.g1 * w + t2.g1};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float* dst = acc + at[q] * c + lo + ch;
      if constexpr (VEC == 4) {
        atomicAdd(reinterpret_cast<float4*>(dst), make_float4(gv[0] * wt[q], gv[1] * wt[q],
                                                              gv[2] * wt[q], gv[3] * wt[q]));
      } else {
        atomicAdd(dst, gv[0] * wt[q]);
      }
    }
  }
}

// The backward of one RoI and one slice of `slice` channels, block
// r * slices + slice, so that the slices of one RoI, and the RoIs of one
// image, run together. The slice's cotangent is loaded into registers
// first, its loads in flight while the forward's geometry is built. A RoI
// whose footprint holds at least 1 / kBwdDirect of its samples' corners
// takes the direct route. Otherwise the block builds the two tables,
// divides the cotangent by s^2 as the plain version does (a power of two as
// a multiplication by its reciprocal, which rounds the same), stages it in
// shared memory and gathers.
template <typename G, int VEC>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
roi_align_backward_kernel(Levels levels_in, int num_levels, const float4* __restrict__ boxes,
                          const G* __restrict__ grad, uint8_t* __restrict__ route, int n, int c,
                          int oh, int ow, int s, int slice) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* gs = reinterpret_cast<float*>(smem);                 // [oh * ow][slice]
  Tap* ty = reinterpret_cast<Tap*>(gs + stage_floats(oh, ow, slice));  // [oh * s]
  Tap* tx = ty + oh * s;                                      // [ow * s]
  int4* by = reinterpret_cast<int4*>(tx + ow * s);            // [2 * oh * s]
  int4* bx = by + 2 * oh * s;                                 // [2 * ow * s]
  int* rows = reinterpret_cast<int*>(bx + 2 * ow * s);         // [2 * oh * s]
  int* cols = rows + 2 * oh * s;                              // [2 * ow * s]
  __shared__ int n_rows, n_cols;

  const int slices = (c + slice - 1) / slice;
  const int64_t r = blockIdx.x / slices;  // RoI index over B * N
  const int64_t b = r / n;
  const int lo = static_cast<int>(blockIdx.x - r * slices) * slice;
  const int hi = min(c, lo + slice);
  const int vecs = (hi - lo) / VEC;  // VEC divides the channels
  const int staged = oh * ow * vecs;
  const G* g_roi = grad + r * oh * ow * c + lo;
  auto stage = [&](int e0, bool store, float (&v)[kBwdLoads][VEC]) {
#pragma unroll
    for (int k = 0; k < kBwdLoads; ++k) {
      const int e = e0 + k * kBwdThreads;
      if (e < staged) {
        const int bin = e / vecs;
        const int ch = (e - bin * vecs) * VEC;
        if (!store) {
          load_grad<G, VEC>(g_roi + bin * c + ch, v[k]);
        } else if constexpr (VEC == 4) {
          *reinterpret_cast<float4*>(gs + bin * slice + ch) =
              make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
        } else {
          gs[bin * slice + ch] = v[k][0];
        }
      }
    }
  };
  const int ns = s * s;
  const float count = static_cast<float>(ns);
  const float inv = 1.0f / count;
  const bool pow2 = (ns & (ns - 1)) == 0;
  float v[kBwdLoads][VEC];
  stage(threadIdx.x, false, v);  // the first kBwdLoads vectors a thread, in flight

  Level L;
  const int lvl = roi_geometry(levels_in, num_levels, boxes[r], oh, ow, s, ty, tx, rows, cols,
                               &n_rows, &n_cols, L);
  const int corners = 4 * oh * ow * ns;
  const bool direct = n_rows * n_cols * kBwdDirect >= corners;
  if (route && threadIdx.x == 0 && lo == 0) route[r] = static_cast<uint8_t>(lvl * 2 + !direct);
  float* acc = static_cast<float*>(const_cast<void*>(L.data)) + b * L.h * L.w * c;
  if (direct) {
    scatter<G, VEC>(ty, tx, oh, ow, s, g_roi, acc, L.w, c, lo, hi, inv, count, pow2);
    return;
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == 0) contributors(ty, oh * s, s, ow * slice, by, n_rows, lane);
  if (warp == 1) contributors(tx, ow * s, s, slice, bx, n_cols, lane);
  for (int e0 = threadIdx.x;; ) {
#pragma unroll
    for (int k = 0; k < kBwdLoads; ++k) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[k][i] = pow2 ? v[k][i] * inv : v[k][i] / count;
    }
    stage(e0, true, v);
    e0 += kBwdLoads * kBwdThreads;
    if (e0 >= staged) break;
    stage(e0, false, v);
  }
  __syncthreads();

  const Footprint f = {ty, tx, by, bx, rows, cols, gs, n_rows, n_cols, L.w, acc};
  gather<VEC>(f, c, lo, hi);
}

// Rounds the f32 cotangents into bf16, element by element: 4 at a time
// from 16-byte loads where both buffers allow it, then the rest one by one.
__global__ void round_to_bf16_kernel(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                                     int64_t count) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const bool quads =
      ((reinterpret_cast<uintptr_t>(src) & 15) | (reinterpret_cast<uintptr_t>(dst) & 7)) == 0;
  const int64_t done = quads ? count / 4 * 4 : 0;
  for (int64_t i = first; i < done / 4; i += stride) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(src) + i);
    uint2 t;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&t);
    h[0] = __float2bfloat16_rn(v.x);
    h[1] = __float2bfloat16_rn(v.y);
    h[2] = __float2bfloat16_rn(v.z);
    h[3] = __float2bfloat16_rn(v.w);
    __stcs(reinterpret_cast<uint2*>(dst) + i, t);
  }
  for (int64_t i = done + first; i < count; i += stride) dst[i] = __float2bfloat16_rn(src[i]);
}

template <typename G, int VEC>
cudaError_t launch_backward(const Levels& lv, int num_levels, const void* boxes,
                            const void* grad, void* route, int rois, int n, int c, int oh,
                            int ow, int s, int slice, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(stage_floats(oh, ow, slice)) * sizeof(float) +
                      static_cast<size_t>(oh + ow) * s *
                          (sizeof(Tap) + 2 * sizeof(int4) + 2 * sizeof(int));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(roi_align_backward_kernel<G, VEC>, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>(rois) * ((c + slice - 1) / slice);
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  roi_align_backward_kernel<G, VEC><<<static_cast<unsigned>(blocks), kBwdThreads, smem, stream>>>(
      lv, num_levels, static_cast<const float4*>(boxes), static_cast<const G*>(grad),
      static_cast<uint8_t*>(route), n, c, oh, ow, s, slice);
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
// [B, H_l, W_l, C] each, zeroed by the caller. route, if not null, receives
// [rois] uint8: the RoI's level times 2, plus 1 where it took the staged
// route (0: the direct one). When `out` is not null the f32
// cotangents, `total` elements from a0 on (the levels one after another in
// one buffer), are then rounded into it as bf16.
extern "C" int roi_align_backward(int grad_dtype, int num_levels, void* a0, int h0, int w0,
                                  float s0, void* a1, int h1, int w1, float s1, void* a2,
                                  int h2, int w2, float s2, void* a3, int h3, int w3, float s3,
                                  const void* boxes, const void* grad, void* out, void* route,
                                  long long total, int rois, int n, int c, int oh, int ow,
                                  int sampling_ratio, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || rois < 0 || n <= 0 || c <= 0 ||
      oh <= 0 || ow <= 0 || sampling_ratio <= 0 || (grad_dtype != 0 && grad_dtype != 1) ||
      total < 0 || static_cast<int64_t>(oh) * ow * c > INT32_MAX) {
    return cudaErrorInvalidValue;
  }
  const int slice = backward_slice(c, oh, ow, sampling_ratio);
  if (slice < 1) return cudaErrorInvalidValue;
  const Levels lv = {{{a0, h0, w0, s0}, {a1, h1, w1, s1}, {a2, h2, w2, s2}, {a3, h3, w3, s3}}};
  // float4 reductions and cotangent loads: channels in whole runs of 4, the
  // buffer and the cotangent on 16-byte boundaries
  bool vec = c % 4 == 0 && aligned16(grad);
  for (int i = 0; i < num_levels; ++i) {
    vec = vec && aligned16(lv.l[i].data);
    // a corner's offset in one image's map is an int
    if (static_cast<int64_t>(lv.l[i].h) * lv.l[i].w * c > INT32_MAX) return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rois > 0) {
    cudaError_t err;
    if (grad_dtype == 1) {
      err = vec ? launch_backward<__nv_bfloat16, 4>(lv, num_levels, boxes, grad, route, rois, n,
                                                     c, oh, ow, sampling_ratio, slice, st)
                : launch_backward<__nv_bfloat16, 1>(lv, num_levels, boxes, grad, route, rois, n,
                                                     c, oh, ow, sampling_ratio, slice, st);
    } else {
      err = vec ? launch_backward<float, 4>(lv, num_levels, boxes, grad, route, rois, n, c, oh,
                                            ow, sampling_ratio, slice, st)
                : launch_backward<float, 1>(lv, num_levels, boxes, grad, route, rois, n, c, oh,
                                            ow, sampling_ratio, slice, st);
    }
    if (err != cudaSuccess) return err;
  }
  if (out != nullptr && total > 0) {
    const int64_t blocks = (total / 4 + 255) / 256;
    round_to_bf16_kernel<<<static_cast<unsigned>(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1)
                                                                    : 132 * 16),
                           256, 0, st>>>(static_cast<const float*>(a0),
                                         static_cast<__nv_bfloat16*>(out), total);
  }
  return cudaGetLastError();
}
