// Popcount kernels of the query path, for Hopper (sm_90a).
//
// Words are 32-bit, packed LSB-first (column c = word c >> 5, bit c & 31);
// PyTorch hands them over as int32 tensors and the kernels read them as
// uint32.  Every kernel here is a single stream over device memory with one
// __popc per word, so each is bound by bytes: the least time is the bytes
// it must move (each input read once, each output written once) over the
// H100's 3.35 TB/s.  The designs keep every input word read from device
// memory once, keep intersections and masks in registers or shared memory,
// use 16-byte loads where the row is 16-byte aligned, and launch enough
// blocks (one or more per shard row) to keep all 132 SMs streaming.
//
// Each launcher takes raw pointers, sizes as int64 and the CUDA stream,
// launches on that stream, does not synchronise, and returns
// cudaGetLastError() so that a refused launch reaches the Python wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum of v over the block; the result is valid in thread 0.
__device__ __forceinline__ int block_sum(int v) {
  __shared__ int partial[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? partial[lane] : 0;
    v = warp_sum(v);
  }
  return v;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__device__ __forceinline__ int popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__device__ __forceinline__ int popc4_and(uint4 a, uint4 b) {
  return __popc(a.x & b.x) + __popc(a.y & b.y) + __popc(a.z & b.z) + __popc(a.w & b.w);
}

// popcount(x) of one row of w words, summed over the block's threads.
__device__ __forceinline__ int row_popcount(const uint32_t* x, int64_t w) {
  int acc = 0;
  int64_t nvec = aligned16(x) ? w / 4 : 0;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  for (int64_t i = threadIdx.x; i < nvec; i += kThreads) acc += popc4(__ldg(xv + i));
  for (int64_t i = 4 * nvec + threadIdx.x; i < w; i += kThreads) acc += __popc(__ldg(x + i));
  return acc;
}

// popcount(a & b) of one row of w words, summed over the block's threads.
__device__ __forceinline__ int row_pair_popcount(const uint32_t* a, const uint32_t* b, int64_t w) {
  int acc = 0;
  int64_t nvec = (aligned16(a) && aligned16(b)) ? w / 4 : 0;
  const uint4* av = reinterpret_cast<const uint4*>(a);
  const uint4* bv = reinterpret_cast<const uint4*>(b);
  for (int64_t i = threadIdx.x; i < nvec; i += kThreads)
    acc += popc4_and(__ldg(av + i), __ldg(bv + i));
  for (int64_t i = 4 * nvec + threadIdx.x; i < w; i += kThreads)
    acc += __popc(__ldg(a + i) & __ldg(b + i));
  return acc;
}

// ---------------------------------------------------------------------------
// popcount_rows: (N, W) -> (N,)
// Replaces pilosa_tpu/ops/kernels.py popcount_rows (Pallas).
// Bound: N*W*4 + N*4 bytes over 3.35 TB/s (37.3 us for N = 954 shards of
// 32768 words).  One block per row streams the row once with 16-byte loads;
// the (8, 128) row and lane padding of the TPU kernel has no counterpart.
// ---------------------------------------------------------------------------
__global__ void popcount_rows_kernel(const uint32_t* __restrict__ x, int* __restrict__ out,
                                     int64_t w) {
  const int64_t row = blockIdx.x;
  int acc = block_sum(row_popcount(x + row * w, w));
  if (threadIdx.x == 0) out[row] = acc;
}

// ---------------------------------------------------------------------------
// pair_popcount: (N, W) & (N, W) -> (N,)
// Replaces pilosa_tpu/ops/kernels.py pair_popcount (Pallas).
// Bound: 2*N*W*4 + N*4 bytes over 3.35 TB/s (74.6 us at N = 954).  The AND
// lives only in registers: each operand stream is read once.
// ---------------------------------------------------------------------------
__global__ void pair_popcount_kernel(const uint32_t* __restrict__ a,
                                     const uint32_t* __restrict__ b, int* __restrict__ out,
                                     int64_t w) {
  const int64_t row = blockIdx.x;
  int acc = block_sum(row_pair_popcount(a + row * w, b + row * w, w));
  if (threadIdx.x == 0) out[row] = acc;
}

// ---------------------------------------------------------------------------
// rows_filter_counts: rows (R, S, W) & filt (S, W) -> (R, S)
// Replaces pilosa_tpu/ops/kernels.py rows_filter_counts (Pallas).
// Bound: (R+1)*S*W*4 + R*S*4 bytes over 3.35 TB/s (335.9 us at R = 8,
// S = 954).  One block per (r, s), flattened shard-major as s*R + r so the
// grid spans R directly (no 16-row chunking) and the R blocks that read one
// 128 KiB filter row run next to each other: the filter comes from HBM once
// and from L2 for the other R-1 rows.  Flattening keeps any R*S within
// gridDim.x.
// ---------------------------------------------------------------------------
__global__ void rows_filter_counts_kernel(const uint32_t* __restrict__ rows,
                                          const uint32_t* __restrict__ filt,
                                          int* __restrict__ out, int64_t r, int64_t s,
                                          int64_t w) {
  const int64_t shard = blockIdx.x / r;
  const int64_t rs = (blockIdx.x % r) * s + shard;  // row-major (R, S) index
  int acc = block_sum(row_pair_popcount(rows + rs * w, filt + shard * w, w));
  if (threadIdx.x == 0) out[rs] = acc;
}

// ---------------------------------------------------------------------------
// masked_popcount: x (N, W) & mask (W,) -> out (N,), zeroed by the caller.
// Replaces pilosa_tpu/ops/kernels.py masked_popcount (Pallas), the per-shard
// TopN/TopK candidate count under a filter.
// Bound: (N+1)*W*4 + N*4 bytes over 3.35 TB/s (0.35 us at N = 8, 10.1 us at
// N = 256, W = 32768).  The per-shard shape is small, so one block per row
// would leave most SMs idle: the grid splits W into 1024-word chunks and N
// into pairs of rows (128 blocks for (8, 32768)).  A block keeps its mask
// chunk in registers (one 16-byte word group a thread), counts each of its
// rows against it, and adds the block's count to out[row] with one atomic.
// ---------------------------------------------------------------------------
constexpr int kMaskChunk = kThreads * 4;  // words per block
constexpr int kMaskRows = 2;              // rows per block

__global__ void masked_popcount_kernel(const uint32_t* __restrict__ x,
                                       const uint32_t* __restrict__ mask,
                                       int* __restrict__ out, int64_t n, int64_t w) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kMaskChunk + 4 * threadIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kMaskRows;
  // with W % 4 == 0 every row starts 16-byte aligned and k < w covers k..k+3
  const bool vec = (w & 3) == 0 && aligned16(x) && aligned16(mask);
  uint4 m = make_uint4(0u, 0u, 0u, 0u);
  if (vec) {
    if (k < w) m = __ldg(reinterpret_cast<const uint4*>(mask + k));
  } else {
    if (k < w) m.x = __ldg(mask + k);
    if (k + 1 < w) m.y = __ldg(mask + k + 1);
    if (k + 2 < w) m.z = __ldg(mask + k + 2);
    if (k + 3 < w) m.w = __ldg(mask + k + 3);
  }
  for (int r = 0; r < kMaskRows; ++r) {
    const int64_t row = r0 + r;
    if (row >= n) break;  // uniform across the block
    const uint32_t* xr = x + row * w;
    int acc = 0;
    if (vec) {
      if (k < w) acc = popc4_and(__ldg(reinterpret_cast<const uint4*>(xr + k)), m);
    } else {
      if (k < w) acc += __popc(__ldg(xr + k) & m.x);
      if (k + 1 < w) acc += __popc(__ldg(xr + k + 1) & m.y);
      if (k + 2 < w) acc += __popc(__ldg(xr + k + 2) & m.z);
      if (k + 3 < w) acc += __popc(__ldg(xr + k + 3) & m.w);
    }
    acc = block_sum(acc);
    if (threadIdx.x == 0 && acc) atomicAdd(out + row, acc);
    __syncthreads();  // block_sum's shared partials are reused by the next row
  }
}

// ---------------------------------------------------------------------------
// bsi_sum_counts: planes (S, 2+d, W), filt (S, W) or null ->
//   cnt (S,), pos (S, d), neg (S, d), each zeroed by the caller.
// Replaces pilosa_tpu/ops/kernels.py bsi_sum_counts (Pallas, vmapped over S).
// Bound: S*(2+d)*W*4 (+ S*W*4 with a filter) + S*(1+2d)*4 bytes over
// 3.35 TB/s (373.3 us filtered at S = 954, d = 7).  The planes may have any
// shard stride pl_ss (0 repeats one shard's planes against S filters: the
// per-shard GroupBy's combo masks); a contiguous stack keeps its own
// instance, since a runtime stride made it 23% slower on the H100.  The grid is
// (S x word chunks), flattened.  A block first builds its chunk's
// pos = exists & filt & ~sign and neg = exists & filt & sign masks in shared
// memory (one read of exists, sign and filt), then streams each magnitude
// plane once against them.  Per plane the block's counts are warp-reduced
// into 2d+1 shared counters (dynamic shared memory), and the block adds those
// to the per-shard outputs with one atomicAdd each.  Per-shard counts stay
// below 2^20, so int32 is exact.
// ---------------------------------------------------------------------------
constexpr int kBsiChunk = 2048;  // words per block

template <bool CONTIG>
__global__ void bsi_sum_counts_kernel(const uint32_t* __restrict__ planes,
                                      const uint32_t* __restrict__ filt, int* __restrict__ cnt,
                                      int* __restrict__ pos, int* __restrict__ neg, int64_t pl_ss,
                                      int64_t p, int64_t w, int64_t chunks) {
  extern __shared__ int smem[];
  const int d = static_cast<int>(p - 2);
  int* counters = smem;                                        // [0]=cnt, [1..d]=pos, [1+d..2d]=neg
  uint32_t* spos = reinterpret_cast<uint32_t*>(smem + 2 * d + 1);
  uint32_t* sneg = spos + kBsiChunk;
  const int64_t shard = blockIdx.x / chunks;
  const int64_t base = (blockIdx.x % chunks) * kBsiChunk;
  const uint32_t* sp = planes + shard * (CONTIG ? p * w : pl_ss);
  const uint32_t* exists = sp;
  const uint32_t* sign = sp + w;
  const uint32_t* fl = filt ? filt + shard * w : nullptr;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < 2 * d + 1; i += kThreads) counters[i] = 0;
  int c = 0;
  for (int i = threadIdx.x; i < kBsiChunk; i += kThreads) {
    const int64_t k = base + i;
    uint32_t consider = 0, sg = 0;
    if (k < w) {
      consider = __ldg(exists + k);
      if (fl) consider &= __ldg(fl + k);
      sg = __ldg(sign + k);
    }
    spos[i] = consider & ~sg;
    sneg[i] = consider & sg;
    c += __popc(consider);
  }
  __syncthreads();  // counters zeroed, masks staged
  c = warp_sum(c);
  if (lane == 0 && c) atomicAdd(&counters[0], c);
  for (int pl = 0; pl < d; ++pl) {
    const uint32_t* mag = sp + (2 + pl) * w;
    int ap = 0, an = 0;
    for (int i = threadIdx.x; i < kBsiChunk; i += kThreads) {
      const int64_t k = base + i;
      if (k < w) {
        const uint32_t m = __ldg(mag + k);
        ap += __popc(m & spos[i]);
        an += __popc(m & sneg[i]);
      }
    }
    ap = warp_sum(ap);
    an = warp_sum(an);
    if (lane == 0) {
      if (ap) atomicAdd(&counters[1 + pl], ap);
      if (an) atomicAdd(&counters[1 + d + pl], an);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * d + 1; i += kThreads) {
    const int v = counters[i];
    if (!v) continue;
    if (i == 0) atomicAdd(cnt + shard, v);
    else if (i <= d) atomicAdd(pos + shard * d + (i - 1), v);
    else atomicAdd(neg + shard * d + (i - 1 - d), v);
  }
}

}  // namespace

extern "C" {

int pt_popcount_rows(const void* x, void* out, int64_t n, int64_t w, void* stream) {
  popcount_rows_kernel<<<static_cast<unsigned>(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<int*>(out), w);
  return static_cast<int>(cudaGetLastError());
}

int pt_pair_popcount(const void* a, const void* b, void* out, int64_t n, int64_t w,
                     void* stream) {
  pair_popcount_kernel<<<static_cast<unsigned>(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b), static_cast<int*>(out),
      w);
  return static_cast<int>(cudaGetLastError());
}

int pt_rows_filter_counts(const void* rows, const void* filt, void* out, int64_t r, int64_t s,
                          int64_t w, void* stream) {
  rows_filter_counts_kernel<<<static_cast<unsigned>(r * s), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const uint32_t*>(filt),
      static_cast<int*>(out), r, s, w);
  return static_cast<int>(cudaGetLastError());
}

int pt_masked_popcount(const void* x, const void* mask, void* out, int64_t n, int64_t w,
                       void* stream) {
  const dim3 grid(static_cast<unsigned>((w + kMaskChunk - 1) / kMaskChunk),
                  static_cast<unsigned>((n + kMaskRows - 1) / kMaskRows));
  masked_popcount_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(mask), static_cast<int*>(out),
      n, w);
  return static_cast<int>(cudaGetLastError());
}

int pt_bsi_sum_counts(const void* planes, int64_t pl_ss, const void* filt, void* cnt, void* pos,
                      void* neg, int64_t s, int64_t p, int64_t w, void* stream) {
  const int64_t chunks = (w + kBsiChunk - 1) / kBsiChunk;
  const size_t smem = (2 * (p - 2) + 1) * sizeof(int) + 2 * kBsiChunk * sizeof(uint32_t);
  auto kern = pl_ss == p * w ? bsi_sum_counts_kernel<true> : bsi_sum_counts_kernel<false>;
  kern<<<static_cast<unsigned>(s * chunks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(planes), static_cast<const uint32_t*>(filt),
      static_cast<int*>(cnt), static_cast<int*>(pos), static_cast<int*>(neg), pl_ss, p, w,
      chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
