// Greedy NMS for Hopper over groups of up to 4096 boxes: a sort, a bitmask
// of IoU > thr decisions, and a sweep by one warp a group.
//
// Replaces the TPU kernel object_detectors_tpu/kernels/nms_pallas.py:_nms_kernel
// (called through nms_pallas), with a group dimension: the port runs it for
// the RPN's per-level NMS (groups = images x FPN levels, 1000 boxes, every
// kept box returned), for the detection NMS (groups = images, 1000
// candidates, 100 kept) and for RetinaNet's class-aware NMS (2000
// candidates, 300 kept).
//
// Contract (the one of nms_pallas and ops/nms.py:_select_max_nms): boxes
// [G, N, 4] xyxy f32, scores [G, N] f32, an optional valid mask [G, N];
// a box whose score is -inf or NaN or whose valid flag is 0 is dead. The
// greedy order is score descending, equal scores lower index first (the
// order of argmax and lax.top_k); a box is kept unless an earlier kept box
// overlaps it with IoU > thr. Outputs keep [G, K] int32 (indices into N,
// padded with -1) and valid [G, K] uint8, K = max_output.
//
// Design, three launches on one stream, scratch allocated by the caller:
// 1. sort: one block a group copies its (score, index) pairs into shared
//    memory and sorts them with a bitonic network in the greedy order (the
//    index breaks every tie, so the result is that of a stable sort); it
//    writes the sorted indices, boxes and areas and m, the number of live
//    boxes, which form a prefix of the sorted order.
// 2. mask: a block of 64 threads for each group and each 64 x 64 block of
//    the upper triangle of the first m sorted boxes. Thread i sets bit j of
//    word w of its row when sorted box 64 w + j comes after box i and
//    IoU(i, 64 w + j) > thr: ceil(N / 64) words a row (rounded up to even),
//    10 MB at the RPN call (80 x 1000), 8 MB at RetinaNet's (16 x 2000),
//    both in L2.
// 3. sweep: one warp a group walks the sorted boxes in chunks of 64, their
//    mask rows brought into shared memory by bulk copies two chunks ahead.
//    A chunk's word of removed boxes is final once the chunks before it are
//    done. Its kept set is the one fixed point of "alive and not overlapped
//    by a kept box of the chunk before it": the warp iterates that map from
//    all alive boxes, a round ORing the diagonal rows of the current set
//    (two a lane) with two warp reductions, which settles at least the
//    first box in doubt; the chunk takes as many rounds as its longest chain
//    of suppressions, not one per kept box. It stops at exactly K kept. Each
//    lane then ORs the rows of the chunk's kept boxes into the one or two
//    later words it owns (at most 64 words for N <= 4096). No block barrier
//    is left in the loop.
//
// Arithmetic: the IoU is that of ops/boxes.py:pairwise_iou with the kept
// (earlier sorted) box first, inter / (area_kept + area_j - inter + 1e-16)
// in that order, and the library is built with -fmad=false, so every
// IoU > thr decision equals the one of the plain PyTorch version on the CPU
// or the GPU bit for bit. A pair that does not intersect skips the divide
// and takes the decision the divide would give.
//
// Bound: operations, the IoUs the kept set needs (each kept box against
// the kept boxes before it, each suppressed box against the kept boxes up
// to its first suppressor): under 0.01 ms at the card's f32 rate for the
// RPN call; the bytes in and out take less. The sweep is still sequential
// from chunk to chunk, since whether a box is kept depends on every kept
// box before it; within a chunk it costs a few warp reductions, where the
// block-per-group kernel paid two barriers of 1024 threads per kept box.
// The mask computes every IoU of the triangle, more than the kept set
// needs, in parallel.
//
// C interface (loaded with ctypes): the entry point launches on `stream`
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSortThreads = 1024;
constexpr int kMaxN = 4096;
constexpr int kChunk = 64;  // boxes a mask word covers
constexpr int kSlots = 3;   // chunks of mask rows in shared memory: two in flight
constexpr unsigned kFull = 0xffffffffu;

// true when (sa, ia) comes before (sb, ib) in the greedy order
__device__ __forceinline__ bool before(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

__global__ void __launch_bounds__(kSortThreads)
nms_sort_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                const uint8_t* __restrict__ valid, int n, int p, int32_t* __restrict__ order,
                float4* __restrict__ sorted, float* __restrict__ area,
                int32_t* __restrict__ live) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* key = reinterpret_cast<float*>(smem);  // [p]
  int* idx = reinterpret_cast<int*>(key + p);   // [p]
  __shared__ int n_alive;

  const int g = blockIdx.x;
  const int64_t row = static_cast<int64_t>(g) * n;
  const float* gs = scores + row;
  const uint8_t* gv = valid ? valid + row : nullptr;

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

  // Sorted indices, boxes and areas; the live boxes form a prefix of length m.
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float4 b = boxes[row + idx[i]];
    order[row + i] = idx[i];
    sorted[row + i] = b;
    area[row + i] = (b.z - b.x) * (b.w - b.y);
    if (key[i] > -INFINITY && (i + 1 == n || !(key[i + 1] > -INFINITY))) n_alive = i + 1;
  }
  __syncthreads();
  if (threadIdx.x == 0) live[g] = n_alive;
}

__global__ void __launch_bounds__(kChunk)
nms_mask_kernel(const float4* __restrict__ sorted, const float* __restrict__ area,
                const int32_t* __restrict__ live, int n, int words, int stride, float thr,
                uint64_t* __restrict__ mask) {
  __shared__ float4 col_box[kChunk];
  __shared__ float col_area[kChunk];
  const int g = blockIdx.x;
  int rb = 0, cb = blockIdx.y;  // the y-th block of the upper triangle, row by row
  while (cb >= words - rb) cb -= words - rb++;
  cb += rb;
  const int m = live[g];
  if (cb * kChunk >= m) return;  // past the live boxes (and so is every row of rb <= cb)
  const int64_t row = static_cast<int64_t>(g) * n;
  const int t = threadIdx.x;
  const int j0 = cb * kChunk;
  const int cols = min(kChunk, m - j0);
  if (t < cols) {
    col_box[t] = sorted[row + j0 + t];
    col_area[t] = area[row + j0 + t];
  }
  __syncthreads();
  const int i = rb * kChunk + t;
  if (i >= m) return;
  const float4 bi = sorted[row + i];
  const float ai = area[row + i];
  const bool zero_over = 0.0f > thr;  // the decision for a pair that does not intersect
  uint64_t bits = 0;
  for (int j = cb == rb ? t + 1 : 0; j < cols; ++j) {
    const float4 bj = col_box[j];
    const float iw = fmaxf(fminf(bi.z, bj.z) - fmaxf(bi.x, bj.x), 0.0f);
    const float ih = fmaxf(fminf(bi.w, bj.w) - fmaxf(bi.y, bj.y), 0.0f);
    const float inter = iw * ih;
    const float uni = ai + col_area[j] - inter + 1e-16f;
    // 0 / uni is +-0 unless uni is 0 or NaN, where it is NaN
    const bool over = inter == 0.0f ? zero_over && uni == uni && uni != 0.0f
                                    : inter / uni > thr;
    if (over) bits |= 1ull << j;
  }
  mask[(row + i) * stride + cb] = bits;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` has completed; a wait that never
// ends traps instead of hanging the card.
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

// One bulk copy of `bytes` (a multiple of 16) that completes on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__global__ void __launch_bounds__(32)
nms_sweep_kernel(const uint64_t* __restrict__ mask, const int32_t* __restrict__ order,
                 const int32_t* __restrict__ live, int n, int stride, int k,
                 int32_t* __restrict__ keep, uint8_t* __restrict__ keep_valid) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* rows_buf = reinterpret_cast<uint64_t*>(smem);  // [kSlots][64][stride]
  int32_t* ord = reinterpret_cast<int32_t*>(rows_buf + kSlots * kChunk * stride);  // [n]
  __shared__ __align__(8) uint64_t bar[kSlots];
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const int m = live[g];
  const int chunks = (m + kChunk - 1) / kChunk;
  const int64_t row = static_cast<int64_t>(g) * n;
  const uint64_t* gm = mask + row * stride;
  int32_t* gk = keep + static_cast<int64_t>(g) * k;
  uint8_t* gkv = keep_valid + static_cast<int64_t>(g) * k;

  // Chunk c's mask rows, contiguous in memory, into slot c % kSlots.
  auto fetch = [&](int c) {
    const uint32_t bytes = min(kChunk, m - c * kChunk) * stride * 8;
    bulk_copy(smem_addr(rows_buf + (c % kSlots) * kChunk * stride), gm + c * kChunk * stride,
              bytes, smem_addr(&bar[c % kSlots]));
  };
  if (lane == 0) {
    for (int i = 0; i < kSlots; ++i) mbar_init(smem_addr(&bar[i]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < min(chunks, kSlots - 1); ++c) fetch(c);
  }
  __syncwarp();  // the barriers are initialized before any lane waits on them
  for (int i = lane; i < m; i += 32) ord[i] = order[row + i];

  uint64_t rem0 = 0, rem1 = 0;  // removed boxes of words lane and lane + 32
  int kept = 0;
  int c = 0;
  for (; c < chunks; ++c) {
    const uint64_t* cur = rows_buf + (c % kSlots) * kChunk * stride;
    mbar_wait(smem_addr(&bar[c % kSlots]), (c / kSlots) & 1);
    // the slot of chunk c - 1 was last read a chunk ago: order those reads
    // before the copy that overwrites it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0 && c + kSlots - 1 < chunks) fetch(c + kSlots - 1);

    // Resolve the chunk: its kept set is the one fixed point of "alive and
    // not overlapped by a kept box before it" (a row's diagonal word only
    // holds later boxes). Iterating that map from all alive boxes settles at
    // least the first box still in doubt each round; a round ORs the rows of
    // the current set across the warp (each lane holds two rows).
    const int here = min(kChunk, m - c * kChunk);
    const uint64_t removed = __shfl_sync(kFull, c < 32 ? rem0 : rem1, c & 31);
    const uint64_t alive = ~removed & (here == kChunk ? ~0ull : (1ull << here) - 1);
    const uint64_t diag0 = cur[lane * stride + c];
    const uint64_t diag1 = cur[(lane + 32) * stride + c];
    uint64_t took = alive;
    while (true) {
      const uint64_t rows = (((took >> lane) & 1) ? diag0 : 0) |
                            (((took >> (lane + 32)) & 1) ? diag1 : 0);
      const uint64_t over =
          (static_cast<uint64_t>(__reduce_or_sync(kFull, static_cast<unsigned>(rows >> 32)))
           << 32) |
          __reduce_or_sync(kFull, static_cast<unsigned>(rows));
      const uint64_t next = alive & ~over;
      if (next == took) break;
      took = next;
    }
    while (kept + __popcll(took) > k) took &= ~(1ull << (63 - __clzll(took)));  // exactly K
    kept += __popcll(took);

    // The chunk's kept boxes, in order, after the ones kept before it.
    const int first = kept - __popcll(took);
    const int base = c * kChunk;
    if ((took >> lane) & 1) {
      const int slot = first + __popcll(took & ((1ull << lane) - 1));
      gk[slot] = ord[base + lane];
      gkv[slot] = 1;
    }
    if ((took >> (lane + 32)) & 1) {
      const int slot = first + __popcll(took & ((1ull << (lane + 32)) - 1));
      gk[slot] = ord[base + lane + 32];
      gkv[slot] = 1;
    }
    if (kept >= k) break;

    // The kept boxes remove their overlaps in the later chunks: each lane
    // ORs its words of their rows, all 64 rows at once when more than 8 were
    // kept (the RPN call's dense chunks), one kept row after another
    // otherwise (the postprocess call's sparse ones); each loop alone, or
    // another threshold, sweeps one of those calls slower (PERF.md).
    const bool own0 = lane > c && lane < chunks;
    const bool own1 = lane + 32 > c && lane + 32 < chunks;
    if (__popcll(took) > 8) {
#pragma unroll 16
      for (int t = 0; t < kChunk; ++t) {
        const uint64_t sel = 0ull - ((took >> t) & 1);
        if (own0) rem0 |= cur[t * stride + lane] & sel;
        if (own1) rem1 |= cur[t * stride + lane + 32] & sel;
      }
    } else {
      for (uint64_t b = took; b != 0; b &= b - 1) {
        const uint64_t* r = cur + (__ffsll(static_cast<long long>(b)) - 1) * stride;
        if (own0) rem0 |= r[lane];
        if (own1) rem1 |= r[lane + 32];
      }
    }
  }
  // Reaching K leaves the copies of up to kSlots - 1 later chunks in flight:
  // wait for them, so that none lands after the block has exited.
  for (int d = c + 1; d < min(chunks, c + kSlots); ++d) {
    mbar_wait(smem_addr(&bar[d % kSlots]), (d / kSlots) & 1);
  }
  for (int s = kept + lane; s < k; s += 32) {
    gk[s] = -1;
    gkv[s] = 0;
  }
}

// The sweep's shared memory at N = kMaxN may exceed the default 48 KB: allow
// it once per device.
cudaError_t allow_sweep_smem() {
  constexpr int kSmem = kSlots * kChunk * kChunk * 8 + kMaxN * 4;  // 112 KB
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

}  // namespace

extern "C" int greedy_nms_max_n() { return kMaxN; }

// Scratch, each [groups, n] unless said: order int32, sorted boxes float4,
// areas f32, live [groups] int32, mask uint64 [groups, n, stride] where
// stride is ceil(n / 64) rounded up to even, so that every chunk's rows are
// one 16-byte-aligned bulk copy.
extern "C" int greedy_nms_f32(const void* boxes, const void* scores, const void* valid,
                              int groups, int n, float thr, int k, void* order, void* sorted,
                              void* area, void* live, void* mask, void* keep, void* keep_valid,
                              void* stream) {
  if (n < 0 || n > kMaxN || groups < 0 || k < 0) return cudaErrorInvalidValue;
  if (groups == 0 || k == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int words = (n + kChunk - 1) / kChunk;
  const int stride = words + (words & 1);
  if (n > 0) {
    int p = 2;
    while (p < n) p <<= 1;
    nms_sort_kernel<<<groups, kSortThreads, static_cast<size_t>(p) * 8, st>>>(
        static_cast<const float4*>(boxes), static_cast<const float*>(scores),
        static_cast<const uint8_t*>(valid), n, p, static_cast<int32_t*>(order),
        static_cast<float4*>(sorted), static_cast<float*>(area), static_cast<int32_t*>(live));
    nms_mask_kernel<<<dim3(groups, words * (words + 1) / 2), kChunk, 0, st>>>(
        static_cast<const float4*>(sorted), static_cast<const float*>(area),
        static_cast<const int32_t*>(live), n, words, stride, thr, static_cast<uint64_t*>(mask));
  } else {
    cudaError_t err = cudaMemsetAsync(live, 0, sizeof(int32_t) * groups, st);
    if (err != cudaSuccess) return err;
  }
  const size_t smem =
      static_cast<size_t>(kSlots) * kChunk * stride * 8 + static_cast<size_t>(n) * 4;
  cudaError_t err = allow_sweep_smem();
  if (err != cudaSuccess) return err;
  nms_sweep_kernel<<<groups, 32, smem, st>>>(
      static_cast<const uint64_t*>(mask), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(live), n, stride, k, static_cast<int32_t*>(keep),
      static_cast<uint8_t*>(keep_valid));
  return cudaGetLastError();
}
