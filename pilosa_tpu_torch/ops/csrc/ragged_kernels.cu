// Page-table kernels of the ragged serving program, for Hopper (sm_90a).
//
// A ragged program (executor/ragged.py) answers a batch of queries over
// different indexes and shard subsets from one bucket of dense pages: every
// page is a (page_lanes, W) block of 32-bit words, the bucket's pages viewed
// as one concatenated (P * page_lanes, W) array that is never built.  Both
// kernels read lanes of that array through a device table of the pages'
// base addresses (int64, one a page): lane l is row l % page_lanes of page
// l / page_lanes.  A lane index outside [0, P * page_lanes) reads as a lane
// of zeros (the wrapper checks host indices before they reach the card).
//
// Both kernels are single streams over device memory, so each is bound by
// bytes over the H100's 3.35 TB/s.  Rows are copied or counted with 16-byte
// loads where both ends are 16-byte aligned, a word loop otherwise.
//
// Each launcher takes raw pointers, sizes as int64 and the CUDA stream,
// launches on that stream, does not synchronise, and returns
// cudaGetLastError() so that a refused launch reaches the Python wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// words of a lane row one block copies (4 x 16 B a thread) or counts
// (8 x 16 B a thread)
constexpr int64_t kGatherChunk = 4 * 4 * kThreads;
constexpr int64_t kCountChunk = 8 * 4 * kThreads;
constexpr int64_t kGridYMax = 65535;

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

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

// The address of bucket lane `li`, or nullptr for a lane outside the bucket.
__device__ __forceinline__ const uint32_t* lane_row(const int64_t* __restrict__ pages,
                                                    int64_t n_pages, int64_t page_lanes,
                                                    int64_t w, int64_t li) {
  if (li < 0 || li >= n_pages * page_lanes) return nullptr;
  const uint32_t* base = reinterpret_cast<const uint32_t*>(pages[li / page_lanes]);
  return base + (li % page_lanes) * w;
}

// ---------------------------------------------------------------------------
// concat_gather: out[i] = bucket lane lane_idx[i], (L,) -> (L, W)
// Replaces the jnp concat_gather of pilosa_tpu/ops/bitmap.py:290 (and the
// concatenate + gather the JAX ragged plan inlines, executor/stacked.py
// :1562-1570): no Pallas kernel.  The concatenation is never built.
// Bound: 2*L*W*4 bytes over 3.35 TB/s (74.7 us at L = 954, W = 32768).
// Block (i, c) copies words [c*kGatherChunk, (c+1)*kGatherChunk) of row i:
// each thread loads its four 16-byte vectors before it stores any.
// ---------------------------------------------------------------------------
__global__ void concat_gather_kernel(const int64_t* __restrict__ pages, int64_t n_pages,
                                     int64_t page_lanes, const int* __restrict__ lane_idx,
                                     uint32_t* __restrict__ out, int64_t w) {
  const int64_t i = blockIdx.x;
  const uint32_t* src = lane_row(pages, n_pages, page_lanes, w, lane_idx[i]);
  uint32_t* dst = out + i * w;
  for (int64_t lo = blockIdx.y * kGatherChunk; lo < w; lo += gridDim.y * kGatherChunk) {
    const int64_t hi = min(w, lo + kGatherChunk);
    if (src != nullptr && aligned16(src + lo) && aligned16(dst + lo)) {
      const int64_t nvec = (hi - lo) / 4;
      const uint4* sv = reinterpret_cast<const uint4*>(src + lo);
      uint4* dv = reinterpret_cast<uint4*>(dst + lo);
      uint4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t j = threadIdx.x + k * kThreads;
        if (j < nvec) v[k] = __ldg(sv + j);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t j = threadIdx.x + k * kThreads;
        if (j < nvec) dv[j] = v[k];
      }
      for (int64_t j = lo + 4 * nvec + threadIdx.x; j < hi; j += kThreads) dst[j] = __ldg(src + j);
    } else {
      for (int64_t j = lo + threadIdx.x; j < hi; j += kThreads)
        dst[j] = src != nullptr ? __ldg(src + j) : 0u;
    }
  }
}

// ---------------------------------------------------------------------------
// segment_count: out[s] += popcount(bucket lane lane_idx[i]) for every i with
// seg_ids[i] == s in [0, nseg); ids outside it are dropped, as
// jax.ops.segment_sum drops them.  (L,) -> (nseg,) int64.
// Replaces the jnp segment_count of pilosa_tpu/ops/bitmap.py:306 (popcount +
// jax.ops.segment_sum): no Pallas kernel.  No operand is materialised.
// Bound: L*W*4 bytes over 3.35 TB/s (74.7 us at L = 1908, W = 32768).
// Block (i, c) counts words [c*kCountChunk, ...) of row i, reduces in shared
// memory and makes one 64-bit atomic add to its segment.
// ---------------------------------------------------------------------------
__global__ void segment_count_kernel(const int64_t* __restrict__ pages, int64_t n_pages,
                                     int64_t page_lanes, const int* __restrict__ lane_idx,
                                     const int* __restrict__ seg_ids, int64_t nseg,
                                     unsigned long long* __restrict__ out, int64_t w) {
  const int64_t i = blockIdx.x;
  const int64_t seg = seg_ids[i];
  if (seg < 0 || seg >= nseg) return;  // uniform across the block
  const uint32_t* src = lane_row(pages, n_pages, page_lanes, w, lane_idx[i]);
  if (src == nullptr) return;
  int acc = 0;
  for (int64_t lo = blockIdx.y * kCountChunk; lo < w; lo += gridDim.y * kCountChunk) {
    const int64_t hi = min(w, lo + kCountChunk);
    int64_t done = lo;
    if (aligned16(src + lo)) {
      const int64_t nvec = (hi - lo) / 4;
      const uint4* sv = reinterpret_cast<const uint4*>(src + lo);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int64_t j = threadIdx.x + k * kThreads;
        if (j < nvec) {
          const uint4 v = __ldg(sv + j);
          acc += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
        }
      }
      done = lo + 4 * nvec;
    }
    for (int64_t j = done + threadIdx.x; j < hi; j += kThreads) acc += __popc(__ldg(src + j));
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0 && acc != 0)
    atomicAdd(out + seg, static_cast<unsigned long long>(acc));
}

dim3 grid_of(int64_t n, int64_t w, int64_t chunk) {
  const int64_t chunks = (w + chunk - 1) / chunk;
  return dim3((unsigned)n, (unsigned)(chunks < kGridYMax ? chunks : kGridYMax));
}

}  // namespace

extern "C" int pt_concat_gather(const void* pages, int64_t n_pages, int64_t page_lanes,
                                const void* lane_idx, int64_t n, void* out, int64_t w,
                                void* stream) {
  if (n <= 0 || w <= 0) return 0;
  concat_gather_kernel<<<grid_of(n, w, kGatherChunk), kThreads, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int64_t*>(pages), n_pages, page_lanes,
      reinterpret_cast<const int*>(lane_idx), reinterpret_cast<uint32_t*>(out), w);
  return (int)cudaGetLastError();
}

extern "C" int pt_segment_count(const void* pages, int64_t n_pages, int64_t page_lanes,
                                const void* lane_idx, const void* seg_ids, int64_t n,
                                int64_t nseg, void* out, int64_t w, void* stream) {
  if (n <= 0 || w <= 0 || nseg <= 0) return 0;
  segment_count_kernel<<<grid_of(n, w, kCountChunk), kThreads, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int64_t*>(pages), n_pages, page_lanes,
      reinterpret_cast<const int*>(lane_idx), reinterpret_cast<const int*>(seg_ids), nseg,
      reinterpret_cast<unsigned long long*>(out), w);
  return (int)cudaGetLastError();
}
