// Page assembly of the paged stack cache, for Hopper (sm_90a).
//
// Replaces the JAX package's jitted assemble_pages, expand_coords and
// expand_runs (pilosa_tpu/ops/bitmap.py:263, :352, :374; no Pallas kernel):
// one launch writes a stack's whole (lanes, W) word operand from a device
// table of its pages, where JAX expands each encoded page on its own and then
// concatenates.  A page is one of three kinds:
//
// - dense:  (page_lanes, W) words, copied with 16-byte loads and stores,
//           four loads in flight a thread;
// - packed: the sorted flat bit offsets of its set bits, uint32 coordinates;
//           a block finds its chunk's range of coordinates, then each thread
//           owns four output words and finds their bits by a binary search
//           for 32*w inside that range, then a walk up to 32*(w+4), so every
//           word is written once, with no atomics and no memset;
// - run:    sorted word runs of all-ones (int32 starts and lengths) plus the
//           residual bits as coordinates; the same walk, then the runs that
//           cover the word.
//
// Payloads are padded to a power of two with sentinels: a coordinate equal to
// the page's bit count, a run start equal to its word count (length 0).  A
// page writes only its lanes below the stack's end, so the last page's padding
// lanes and every sentinel drop out.  Coordinates are compared as unsigned
// 64-bit values: a 2^28-byte page holds 2^31 bits, past int32.
//
// Bound: bytes.  Each dense page is read once and each output word written
// once; a sparse page reads its payload (from L2 for the repeated binary
// searches).  The least time is those bytes over the card's 3.35 TB/s.
//
// The launcher takes raw pointers, sizes as int64 and the stream, launches on
// that stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 4;                              // uint4 groups a thread a step
constexpr int64_t kChunk = (int64_t)kThreads * kGroups * 4;  // words a block a step
constexpr int kBlocksPerSm = 4;

// One row of the page table (ten int64, filled by ops/kernels.py).
struct PageDesc {
  int64_t kind;      // 0 dense, 1 packed, 2 run
  int64_t dense;     // const uint32_t*: (page_lanes, W) words
  int64_t coords;    // const uint32_t*: sorted coordinates, sentinel-padded
  int64_t n_coords;
  int64_t starts;    // const int32_t*: sorted run starts, sentinel-padded
  int64_t lens;      // const int32_t*: run lengths (0 for a sentinel)
  int64_t n_runs;
  int64_t lane0;     // first output lane
  int64_t n_lanes;   // lanes this page writes
  int64_t pad;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// First i in [0, n) with a[i] >= key, or n.
__device__ __forceinline__ int64_t lower_bound_u32(const uint32_t* a, int64_t n, uint64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if ((uint64_t)__ldg(a + mid) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// First i in [0, n) with a[i] > key, or n.
__device__ __forceinline__ int64_t upper_bound_i32(const int32_t* a, int64_t n, int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if ((int64_t)__ldg(a + mid) <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Words [w0, w0 + k) of an encoded page into v.  [c_lo, c_hi) are the
// coordinates and [r_lo, r_hi) the runs that can fall in the thread's chunk
// (found once a chunk), so each search here is over a few entries.
__device__ __forceinline__ void sparse_words(const PageDesc& d, int64_t w0, int k, uint32_t v[4],
                                             int64_t c_lo, int64_t c_hi, int64_t r_lo,
                                             int64_t r_hi) {
  v[0] = v[1] = v[2] = v[3] = 0u;
  const uint32_t* coords = reinterpret_cast<const uint32_t*>(d.coords);
  const uint64_t lo = (uint64_t)w0 * 32u;
  const uint64_t hi = lo + 32u * (uint64_t)k;
  for (int64_t i = c_lo + lower_bound_u32(coords + c_lo, c_hi - c_lo, lo); i < c_hi; ++i) {
    const uint64_t c = (uint64_t)__ldg(coords + i);
    if (c >= hi) break;
    v[(c - lo) >> 5] |= 1u << (unsigned)(c & 31u);
  }
  if (d.kind != 2) return;
  const int32_t* starts = reinterpret_cast<const int32_t*>(d.starts);
  const int32_t* lens = reinterpret_cast<const int32_t*>(d.lens);
  // the last run starting at or before w0, then the runs starting inside
  int64_t j = r_lo + upper_bound_i32(starts + r_lo, r_hi - r_lo, w0) - 1;
  if (j < r_lo) j = r_lo;
  for (; j < r_hi; ++j) {
    const int64_t s = __ldg(starts + j);
    if (s >= w0 + k) break;
    const int64_t e = s + (int64_t)__ldg(lens + j);
    for (int q = 0; q < k; ++q) {
      const int64_t w = w0 + q;
      if (w >= s && w < e) v[q] = 0xffffffffu;
    }
  }
}

// One task is a chunk of kChunk words of one page; a block walks tasks
// (page, chunk) in a grid-stride loop over a few blocks an SM.  A dense page
// keeps kGroups 16-byte loads in flight a thread before it stores them.  For
// an encoded page, every thread of the block finds the same chunk
// range of coordinates and runs (warp-uniform loads, served from L1), then
// searches only inside it for its own words.
__global__ void __launch_bounds__(kThreads)
assemble_pages_kernel(const PageDesc* __restrict__ table, int64_t n_pages,
                      int64_t chunks_per_page, uint32_t* __restrict__ out, int64_t w) {
  const int64_t tasks = n_pages * chunks_per_page;
  for (int64_t t = blockIdx.x; t < tasks; t += gridDim.x) {
    const int64_t p = t / chunks_per_page;
    const int64_t base = (t - p * chunks_per_page) * kChunk;
    const PageDesc d = table[p];
    const int64_t n_words = d.n_lanes * w;
    if (base >= n_words) continue;
    uint32_t* dst = out + d.lane0 * w;
    const int64_t end = base + kChunk < n_words ? base + kChunk : n_words;
    if (d.kind == 0) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(d.dense);
      if ((w & 3) == 0 && aligned16(dst) && aligned16(src)) {
        // n_words is a multiple of 4 here: whole uint4 groups only
        uint4 x[kGroups];
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const int64_t w0 = base + ((int64_t)g * kThreads + threadIdx.x) * 4;
          if (w0 < n_words) x[g] = __ldg(reinterpret_cast<const uint4*>(src + w0));
        }
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const int64_t w0 = base + ((int64_t)g * kThreads + threadIdx.x) * 4;
          if (w0 < n_words) *reinterpret_cast<uint4*>(dst + w0) = x[g];
        }
      } else {
        for (int64_t i = base + threadIdx.x; i < end; i += kThreads) dst[i] = __ldg(src + i);
      }
      continue;
    }
    const uint32_t* coords = reinterpret_cast<const uint32_t*>(d.coords);
    const int64_t c_lo = lower_bound_u32(coords, d.n_coords, (uint64_t)base * 32u);
    const int64_t c_hi = c_lo + lower_bound_u32(coords + c_lo, d.n_coords - c_lo,
                                                (uint64_t)end * 32u);
    int64_t r_lo = 0, r_hi = 0;
    if (d.kind == 2) {
      const int32_t* starts = reinterpret_cast<const int32_t*>(d.starts);
      r_lo = upper_bound_i32(starts, d.n_runs, base) - 1;
      if (r_lo < 0) r_lo = 0;
      r_hi = upper_bound_i32(starts, d.n_runs, end - 1);
    }
    const bool vec_dst = aligned16(dst) && (w & 3) == 0;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int64_t w0 = base + ((int64_t)g * kThreads + threadIdx.x) * 4;
      if (w0 >= n_words) break;
      const int k = n_words - w0 < 4 ? (int)(n_words - w0) : 4;
      uint32_t v[4];
      sparse_words(d, w0, k, v, c_lo, c_hi, r_lo, r_hi);
      if (vec_dst && k == 4) {
        *reinterpret_cast<uint4*>(dst + w0) = make_uint4(v[0], v[1], v[2], v[3]);
      } else {
        for (int q = 0; q < k; ++q) dst[w0 + q] = v[q];
      }
    }
  }
}

}  // namespace

extern "C" int pt_assemble_pages(const void* table, int64_t n_pages, void* out, int64_t w,
                                 int64_t page_lanes, void* stream) {
  if (n_pages <= 0 || w <= 0) return 0;
  const int64_t chunks = (page_lanes * w + kChunk - 1) / kChunk;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t grid = n_pages * chunks;
  if (grid > (int64_t)sms * kBlocksPerSm) grid = (int64_t)sms * kBlocksPerSm;
  const PageDesc* tab = reinterpret_cast<const PageDesc*>(table);
  uint32_t* dst = reinterpret_cast<uint32_t*>(out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  assemble_pages_kernel<<<(unsigned)grid, kThreads, 0, st>>>(tab, n_pages, chunks, dst, w);
  return (int)cudaGetLastError();
}
