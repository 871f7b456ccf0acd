// Greedy NMS for Hopper: one block per group of up to 4096 boxes.
//
// Replaces the TPU kernel object_detectors_tpu/kernels/nms_pallas.py:_nms_kernel
// (called through nms_pallas), with a group dimension: the port runs it for
// the RPN's per-level NMS (groups = images x FPN levels, 1000 boxes, every
// kept box returned) and for the detection NMS (groups = images, 1000
// candidates, 100 kept).
//
// Contract (the one of nms_pallas and ops/nms.py:_select_max_nms): boxes
// [G, N, 4] xyxy f32, scores [G, N] f32, an optional valid mask [G, N];
// a box whose score is -inf or NaN or whose valid flag is 0 is dead. The
// greedy order is score descending, equal scores lower index first (the
// order of argmax and lax.top_k); a box is kept unless an earlier kept box
// overlaps it with IoU > thr. Outputs keep [G, K] int32 (indices into N,
// padded with -1) and valid [G, K] uint8, K = max_output.
//
// Design: the block copies its group's (score, index) pairs into shared
// memory and sorts them with a bitonic network in the greedy order (the
// index breaks every tie, so the result is that of a stable sort), then
// gathers the boxes and areas into shared memory in that order. The sweep
// walks the sorted boxes: thread 0 finds the next box nobody suppressed,
// it is kept, and all threads mark the later boxes it overlaps, one
// barrier pair per kept box; it stops after K kept boxes or when no box is
// alive. Nothing leaves the chip between steps, so the caller needs no
// host round trip.
//
// Arithmetic: the IoU is that of ops/boxes.py:pairwise_iou,
// inter / (area_kept + area_j - inter + 1e-16) in that order, and the
// library is built with -fmad=false, so every IoU > thr decision equals the
// one of the plain PyTorch version on the CPU or the GPU bit for bit.
//
// Bound: bytes. At the detection NMS shape (16 groups x 1000) the kernel
// reads 16 x 1000 x 20 bytes and writes 16 x 100 x 5; at the RPN shape
// (80 x 1000) 1.6 MB in and 0.4 MB out: under a microsecond at 3.35 TB/s.
// The IoU work is at most N^2/2 per group, 40 M IoUs for the RPN call,
// about 0.006 ms at the card's f32 rate. The kernel is latency-bound by
// its sequential sweep instead; that is the price of an exact greedy order.
//
// C interface (loaded with ctypes): the entry point launches on `stream`
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxN = 4096;

// true when (sa, ia) comes before (sb, ib) in the greedy order
__device__ __forceinline__ bool before(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

__global__ void __launch_bounds__(kThreads)
greedy_nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                  const uint8_t* __restrict__ valid, int n, int p, float thr, int k,
                  int32_t* __restrict__ keep, uint8_t* __restrict__ keep_valid) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* key = reinterpret_cast<float*>(smem);                  // [p]
  int* idx = reinterpret_cast<int*>(key + p);                   // [p]
  float4* box = reinterpret_cast<float4*>(idx + p);             // [n], 8p % 16 == 0
  float* area = reinterpret_cast<float*>(box + n);              // [n]
  uint8_t* dead = reinterpret_cast<uint8_t*>(area + n);         // [n]
  __shared__ int n_alive;
  __shared__ int next;

  const int g = blockIdx.x;
  const float4* gb = boxes + static_cast<int64_t>(g) * n;
  const float* gs = scores + static_cast<int64_t>(g) * n;
  const uint8_t* gv = valid ? valid + static_cast<int64_t>(g) * n : nullptr;
  int32_t* gk = keep + static_cast<int64_t>(g) * k;
  uint8_t* gkv = keep_valid + static_cast<int64_t>(g) * k;

  if (threadIdx.x == 0) n_alive = 0;
  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    float s = -INFINITY;
    if (i < n) {
      s = gs[i];
      if (!(s > -INFINITY) || (gv && !gv[i])) s = -INFINITY;  // NaN is dead too
    }
    key[i] = s;
    idx[i] = i;
  }
  __syncthreads();

  // Bitonic sort of p = 2^m pairs into the greedy order.
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const float si = key[i], sj = key[j];
          const int ii = idx[i], ij = idx[j];
          const bool forward = (i & size) == 0;
          if (forward ? before(sj, ij, si, ii) : before(si, ii, sj, ij)) {
            key[i] = sj;
            key[j] = si;
            idx[i] = ij;
            idx[j] = ii;
          }
        }
      }
      __syncthreads();
    }
  }

  // Sorted boxes and areas; the alive boxes form a prefix of length n_alive.
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float4 b = gb[idx[i]];
    box[i] = b;
    area[i] = (b.z - b.x) * (b.w - b.y);
    const bool alive = key[i] > -INFINITY;
    dead[i] = alive ? 0 : 1;
    if (alive && (i + 1 == n || !(key[i + 1] > -INFINITY))) n_alive = i + 1;
  }
  __syncthreads();

  const int m = n_alive;
  int kept = 0;
  int cur = -1;
  while (true) {
    if (threadIdx.x == 0) {
      int q = cur + 1;
      while (q < m && dead[q]) ++q;
      next = q;
    }
    __syncthreads();
    const int q = next;  // the same on every thread, so is the exit
    if (q >= m || kept >= k) break;
    if (threadIdx.x == 0) {
      gk[kept] = idx[q];
      gkv[kept] = 1;
    }
    ++kept;
    const float4 bq = box[q];
    const float aq = area[q];
    for (int j = q + 1 + threadIdx.x; j < m; j += blockDim.x) {
      if (dead[j]) continue;
      const float4 bj = box[j];
      const float iw = fmaxf(fminf(bq.z, bj.z) - fmaxf(bq.x, bj.x), 0.0f);
      const float ih = fmaxf(fminf(bq.w, bj.w) - fmaxf(bq.y, bj.y), 0.0f);
      const float inter = iw * ih;
      const float iou = inter / (aq + area[j] - inter + 1e-16f);
      if (iou > thr) dead[j] = 1;
    }
    cur = q;
    __syncthreads();
  }
  for (int s = kept + threadIdx.x; s < k; s += blockDim.x) {
    gk[s] = -1;
    gkv[s] = 0;
  }
}

}  // namespace

extern "C" int greedy_nms_max_n() { return kMaxN; }

extern "C" int greedy_nms_f32(const void* boxes, const void* scores, const void* valid,
                              int groups, int n, float thr, int k, void* keep,
                              void* keep_valid, void* stream) {
  if (n < 0 || n > kMaxN || groups < 0 || k < 0) return cudaErrorInvalidValue;
  if (groups == 0 || k == 0) return cudaSuccess;
  int p = 2;
  while (p < n) p <<= 1;
  const size_t smem = static_cast<size_t>(p) * 8 + static_cast<size_t>(n) * 21;
  cudaError_t err = cudaFuncSetAttribute(
      greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  greedy_nms_kernel<<<groups, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(valid), n, p, thr, k, static_cast<int32_t*>(keep),
      static_cast<uint8_t*>(keep_valid));
  return cudaGetLastError();
}
