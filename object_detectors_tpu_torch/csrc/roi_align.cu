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
// xyxy f32 in image coordinates; levels [B, N] int32, the level of each box
// from ops/roi_align.py:assign_fpn_levels, computed by the wrapper so that the
// kernel and the plain version agree on every box. Output [B, N, oh, ow, C]
// in the maps' dtype, accumulated in f32.
//
// Semantics, as ops/roi_align.py:multiscale_roi_align_canvas: the box is
// scaled, roi_w = max(x2 - x1, 1) (and h), bin = roi / out; sample (k_y, k_x)
// of bin (i, j) sits at y1 + (i + (k_y + 0.5) / s) * bin_h; a sample outside
// [-1, H] x [-1, W] counts 0; the rest clamp to [0, H-1] x [0, W-1] and are
// interpolated from their four neighbours; the bin is the mean of its s^2
// samples. Built with -fmad=false, the positions and weights are the plain
// version's bit for bit; only the order of the sums differs.
//
// Design: one block per RoI; a thread owns a run of 16 bytes of channels
// (8 bf16 or 4 f32) of one output pixel, so the four corner reads of a sample
// and the output store are coalesced 16-byte runs across the block's
// threads. C not divisible by that run, or a base that is not 16-byte
// aligned, takes the one-channel-per-thread instantiation.
//
// Bound: bytes. At the Faster R-CNN shape (16 images x 1000 RoIs, 7x7, 256
// channels, bf16, P2-P5 of 640^2 images) the output is 401 MB and the level
// maps, read once, 279 MB: about 0.20 ms at 3.35 TB/s. The kernel reads each
// touched feature row once per sample instead, from L2 where RoIs overlap.
//
// C interface (loaded with ctypes): the entry point launches on `stream` and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 4;

struct Level {
  const void* data;
  int h;
  int w;
  float scale;
};

struct Levels {
  Level l[kMaxLevels];
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

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = v[i];
  }
}

template <int VEC>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    uint4 t;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&t);
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16_rn(v[i]);
    *reinterpret_cast<uint4*>(p) = t;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
roi_align_kernel(Levels levels_in, const float4* __restrict__ boxes,
                 const int32_t* __restrict__ levels, T* __restrict__ out, int n, int c,
                 int oh, int ow, int s) {
  const int64_t r = blockIdx.x;  // RoI index over B * N
  const int64_t b = r / n;
  const int lvl = levels[r];
  Level L = levels_in.l[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (lvl == i) L = levels_in.l[i];
  }
  const T* feat = static_cast<const T*>(L.data) + b * L.h * L.w * c;
  const float4 box = boxes[r];
  const float x1 = box.x * L.scale;
  const float y1 = box.y * L.scale;
  const float x2 = box.z * L.scale;
  const float y2 = box.w * L.scale;
  const float bin_w = fmaxf(x2 - x1, 1.0f) / static_cast<float>(ow);
  const float bin_h = fmaxf(y2 - y1, 1.0f) / static_cast<float>(oh);
  const float hf = static_cast<float>(L.h);
  const float wf = static_cast<float>(L.w);
  const float count = static_cast<float>(s * s);
  const int groups = c / VEC;
  T* out_roi = out + r * oh * ow * c;

  for (int t = threadIdx.x; t < oh * ow * groups; t += blockDim.x) {
    const int ch = (t % groups) * VEC;
    const int pix = t / groups;
    const int py = pix / ow;
    const int px = pix % ow;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
    for (int ky = 0; ky < s; ++ky) {
      const float ys = y1 + (static_cast<float>(py) +
                             (static_cast<float>(ky) + 0.5f) / static_cast<float>(s)) * bin_h;
      for (int kx = 0; kx < s; ++kx) {
        const float xs = x1 + (static_cast<float>(px) +
                               (static_cast<float>(kx) + 0.5f) / static_cast<float>(s)) * bin_w;
        if (ys < -1.0f || ys > hf || xs < -1.0f || xs > wf) continue;  // adds 0
        const float y = fminf(fmaxf(ys, 0.0f), hf - 1.0f);
        const float x = fminf(fmaxf(xs, 0.0f), wf - 1.0f);
        const float fy0 = floorf(y);
        const float fx0 = floorf(x);
        const int y0 = static_cast<int>(fy0);
        const int x0 = static_cast<int>(fx0);
        const int y1i = min(y0 + 1, L.h - 1);
        const int x1i = min(x0 + 1, L.w - 1);
        const float ly = y - fy0;
        const float lx = x - fx0;
        const float w00 = (1.0f - ly) * (1.0f - lx);
        const float w01 = (1.0f - ly) * lx;
        const float w10 = ly * (1.0f - lx);
        const float w11 = ly * lx;
        float v00[VEC], v01[VEC], v10[VEC], v11[VEC];
        load<VEC>(feat + (static_cast<int64_t>(y0) * L.w + x0) * c + ch, v00);
        load<VEC>(feat + (static_cast<int64_t>(y0) * L.w + x1i) * c + ch, v01);
        load<VEC>(feat + (static_cast<int64_t>(y1i) * L.w + x0) * c + ch, v10);
        load<VEC>(feat + (static_cast<int64_t>(y1i) * L.w + x1i) * c + ch, v11);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          acc[i] += w00 * v00[i] + w01 * v01[i] + w10 * v10[i] + w11 * v11[i];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = acc[i] / count;
    store<VEC>(out_roi + static_cast<int64_t>(pix) * c + ch, acc);
  }
}

template <typename T, int VEC>
cudaError_t launch(const Levels& lv, const void* boxes, const void* levels, void* out,
                   int rois, int n, int c, int oh, int ow, int s, cudaStream_t stream) {
  roi_align_kernel<T, VEC><<<rois, kThreads, 0, stream>>>(
      lv, static_cast<const float4*>(boxes), static_cast<const int32_t*>(levels),
      static_cast<T*>(out), n, c, oh, ow, s);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Unused level slots may hold null.
extern "C" int roi_align_forward(int dtype, int num_levels, const void* f0, int h0, int w0,
                                 float s0, const void* f1, int h1, int w1, float s1,
                                 const void* f2, int h2, int w2, float s2, const void* f3,
                                 int h3, int w3, float s3, const void* boxes,
                                 const void* levels, void* out, int rois, int n, int c, int oh,
                                 int ow, int sampling_ratio, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || rois < 0 || n <= 0 || c <= 0 ||
      oh <= 0 || ow <= 0 || sampling_ratio <= 0 || (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  if (rois == 0) return cudaSuccess;
  const Levels lv = {{{f0, h0, w0, s0}, {f1, h1, w1, s1}, {f2, h2, w2, s2}, {f3, h3, w3, s3}}};
  bool aligned = aligned16(out);
  for (int i = 0; i < num_levels; ++i) aligned = aligned && aligned16(lv.l[i].data);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (aligned && c % 8 == 0) {
      return launch<__nv_bfloat16, 8>(lv, boxes, levels, out, rois, n, c, oh, ow,
                                      sampling_ratio, st);
    }
    return launch<__nv_bfloat16, 1>(lv, boxes, levels, out, rois, n, c, oh, ow,
                                    sampling_ratio, st);
  }
  if (aligned && c % 4 == 0) {
    return launch<float, 4>(lv, boxes, levels, out, rois, n, c, oh, ow, sampling_ratio, st);
  }
  return launch<float, 1>(lv, boxes, levels, out, rois, n, c, oh, ow, sampling_ratio, st);
}
