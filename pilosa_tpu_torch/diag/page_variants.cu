// The bulk-copy ring form of assemble_pages, kept beside the query path's
// kernel (ops/csrc/page_kernels.cu) for diag/page_variants.py, which times
// the two: not on the query path.
//
// The work is a list of tasks, one a tile of kTileWords words of one page;
// the host (page_variants.py ring_plan) deals runs of tiles to a persistent
// grid of SMs x kBlocksPerSm blocks by bytes, or gives one block a run, and
// appends each block's list of tasks (page << 32 | tile) to the page table.
// A block's tiles pass through a ring of kStages tiles in shared memory:
//
// - a dense tile is moved by the bulk copy engine: one thread loads it with
//   cp.async.bulk (completion counted on the stage's mbarrier), and kLook
//   tiles later, once the barrier's phase has flipped, stores it with a bulk
//   store; a stage is loaded again only after cp.async.bulk.wait_group.read
//   says its store has read it.  So kLook loads and kStoresInFlight stores
//   are in flight a block, with no register spent on the data;
// - an encoded tile is zeroed by the block, its runs filled (a warp a run)
//   and its coordinates scattered with shared atomicOr, then stored by the
//   same bulk store, with the query path's kernel's cursors (a run that
//   starts inside a page finds them with one thread's binary search);
// - a page whose address or size is not a multiple of 16 bytes is copied, or
//   its tile written out, by a word loop of the whole block.
//
// page_variants.py builds copies with other ring shapes (kTileWords,
// kStages, kStoresInFlight, kBlocksPerSm, an L2 hint on the loads).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// words a task and blocks an SM: page_variants.py's ring_plan is given both
constexpr int64_t kTileWords = 4096;
constexpr uint32_t kTileBytes = (uint32_t)kTileWords * 4u;
constexpr int kBlocksPerSm = 2;
constexpr int kStages = 6;
constexpr int kStoresInFlight = 2;
constexpr int kLook = kStages - kStoresInFlight;  // tasks filled ahead of their store
constexpr int kDescWords = 10;
// a barrier wait that outlasts this many clocks (~17 s) traps: a fault in
// the ring then fails the launch instead of hanging the card
constexpr long long kSpinClocks = 1ll << 35;

// One row of the page table (ten int64, filled by ops/kernels.py page_table).
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

// What a stage's store does, set where the stage is filled.
enum : uint32_t { kNoStore = 0, kLoaded = 1, kFilled = 2 };
struct StageInfo {
  uint32_t* dst;
  uint32_t bytes;
  uint32_t mode;
};

// Shared memory after the kStages tiles.
struct RingState {
  unsigned long long bar[kStages];
  StageInfo info[kStages];
  long long seek_coord;  // a run's first coordinate and run in its page
  long long seek_run;
  long long run_stop;    // first run at or past a tile's end
};

constexpr size_t kSmemBytes = (size_t)kStages * kTileBytes + sizeof(RingState);

// ---- PTX: mbarriers and bulk copies -----------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kSpinClocks) __trap();
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// the stores committed before the last kStoresInFlight have read their stages
__device__ __forceinline__ void bulk_wait_stage_free() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kStoresInFlight) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// generic-proxy writes to shared memory, seen by a later bulk store
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- the encoded arm ----------------------------------------------------------

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// First i in [0, n) with a[i] >= key, or n.
__device__ int64_t lower_bound_u32(const uint32_t* a, int64_t n, uint64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if ((uint64_t)__ldg(a + mid) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// First i in [0, n) with a[i] > key, or n.
__device__ int64_t upper_bound_i32(const int32_t* a, int64_t n, int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if ((int64_t)__ldg(a + mid) <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Words [a, b) of a tile set to all-ones by one warp.
__device__ __forceinline__ void fill_ones(uint32_t* t, int64_t a, int64_t b, int lane) {
  const int64_t a4 = (a + 3) & ~(int64_t)3, b4 = b & ~(int64_t)3;
  if (a4 >= b4) {
    for (int64_t q = a + lane; q < b; q += 32) t[q] = 0xffffffffu;
    return;
  }
  for (int64_t q = a + lane; q < a4; q += 32) t[q] = 0xffffffffu;
  uint4* t4 = reinterpret_cast<uint4*>(t);
  const uint4 ones = make_uint4(0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu);
  for (int64_t q = a4 / 4 + lane; q < b4 / 4; q += 32) t4[q] = ones;
  for (int64_t q = b4 + lane; q < b; q += 32) t[q] = 0xffffffffu;
}

// A thread's first loads for an encoded tile, issued before the block waits
// for its stage so that their latency passes under the barriers: the
// coordinate c_cur + tid, and the first run its warp reads (r_cur + warp).
struct TileHead {
  uint64_t coord;  // ~0 past the payload
  int64_t run_start, run_end;
};

__device__ __forceinline__ TileHead tile_head(const PageDesc& d, int64_t c_cur, int64_t r_cur) {
  TileHead h;
  const int64_t i = c_cur + threadIdx.x;
  h.coord = i < d.n_coords ? (uint64_t)__ldg(reinterpret_cast<const uint32_t*>(d.coords) + i)
                           : ~(uint64_t)0;
  const int64_t j = r_cur + (threadIdx.x >> 5);
  h.run_start = INT64_MAX;
  h.run_end = 0;
  if (d.kind == 2 && j < d.n_runs) {
    h.run_start = __ldg(reinterpret_cast<const int32_t*>(d.starts) + j);
    h.run_end = h.run_start + __ldg(reinterpret_cast<const int32_t*>(d.lens) + j);
  }
  return h;
}

// Words [base, end) of an encoded page into `tile`, by the whole block.
// c_cur is the first coordinate at or past bit 32*base and r_cur a run
// (the first that can end past base); both advance past the tile.  `h` holds
// the thread's loads at c_cur and r_cur.
__device__ void expand_tile(const PageDesc& d, int64_t base, int64_t end, uint32_t* tile,
                            RingState& rs, int64_t& c_cur, int64_t& r_cur, const TileHead& h) {
  const int tid = threadIdx.x;
  const int64_t nw = end - base;
  uint4* t4 = reinterpret_cast<uint4*>(tile);
  for (int64_t q = tid; q < (nw + 3) / 4; q += kThreads) t4[q] = make_uint4(0u, 0u, 0u, 0u);
  if (d.kind == 2 && tid == 0) rs.run_stop = d.n_runs;
  __syncthreads();
  if (d.kind == 2) {
    // a warp a run: the runs that start before the tile's end, from r_cur
    const int32_t* starts = reinterpret_cast<const int32_t*>(d.starts);
    const int32_t* lens = reinterpret_cast<const int32_t*>(d.lens);
    const int warp = tid >> 5, lane = tid & 31;
    int64_t s = h.run_start, e = h.run_end;
    for (int64_t j = r_cur + warp; j < d.n_runs; j += kWarps) {
      if (j != r_cur + warp) {
        s = __ldg(starts + j);
        e = s + (int64_t)__ldg(lens + j);
      }
      if (s >= end) {
        if (lane == 0) atomicMin(&rs.run_stop, (long long)j);
        break;
      }
      const int64_t a = (s > base ? s : base) - base;
      const int64_t b = (e < end ? e : end) - base;
      if (a < b) fill_ones(tile, a, b, lane);
    }
    __syncthreads();
    // runs are disjoint and sorted: only the last one starting inside the
    // tile can reach past it
    const int64_t stop = rs.run_stop;
    if (stop > r_cur) r_cur = stop - 1;
  }
  // the coordinates inside the tile are the next ones from c_cur (sorted):
  // each round reads kThreads of them, and counts how many fell inside
  const uint32_t* coords = reinterpret_cast<const uint32_t*>(d.coords);
  const uint64_t lo = (uint64_t)base * 32u, hi = (uint64_t)end * 32u;
  uint64_t c = h.coord;
  for (;;) {
    int inside = 0;
    if (c >= lo && c < hi) {
      inside = 1;
      atomicOr(tile + ((int64_t)(c >> 5) - base), 1u << (unsigned)(c & 31u));
    }
    const int n = __syncthreads_count(inside);
    c_cur += n;
    if (n < kThreads) break;
    const int64_t i = c_cur + tid;
    c = i < d.n_coords ? (uint64_t)__ldg(coords + i) : ~(uint64_t)0;
  }
}

// ---- the kernel -------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
ring_pages_kernel(const int64_t* __restrict__ table, int64_t n_pages,
                      uint32_t* __restrict__ out, int64_t w) {
  // this block's tasks, each (page << 32 | tile)
  const int64_t* offsets = table + n_pages * kDescWords;
  const int64_t* tasks = offsets + gridDim.x + 1 + offsets[blockIdx.x];
  const int64_t n = offsets[blockIdx.x + 1] - offsets[blockIdx.x];
  if (n <= 0) return;

  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* tiles = reinterpret_cast<uint32_t*>(smem);
  RingState& rs = *reinterpret_cast<RingState*>(smem + (size_t)kStages * kTileBytes);
  const int tid = threadIdx.x;
  const PageDesc* descs = reinterpret_cast<const PageDesc*>(table);
  const bool out16 = aligned16(out) && (w & 3) == 0;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&rs.bar[s]));
  }
  __syncthreads();

  PageDesc d;
  int64_t p = -1, k = -1, n_words = 0;
  uint32_t* dst = out;
  int64_t c_cur = 0, r_cur = 0;  // valid for tile k + 1 of an encoded page p
  int64_t next = tasks[0];
  uint32_t parity = 0;  // thread 0: bit s, the phase stage s's barrier completes next
  for (int64_t i = 0; i < n + kLook; ++i) {
    if (tid == 0 && i >= kLook) {
      // store task i - kLook
      const int s = (int)((i - kLook) % kStages);
      const StageInfo st = rs.info[s];
      if (st.mode == kLoaded) {
        mbar_wait(smem_u32(&rs.bar[s]), (parity >> s) & 1u);
        parity ^= 1u << s;
      }
      if (st.mode != kNoStore) bulk_store(st.dst, smem_u32(tiles + s * kTileWords), st.bytes);
      bulk_commit();  // one group a task, empty or not
    }
    if (i >= n) continue;

    // fill task i (its entry loaded an iteration ahead)
    const int64_t pi = next >> 32, ki = next & 0xffffffffll;
    if (i + 1 < n) next = tasks[i + 1];
    const bool carried = pi == p && ki == k + 1;
    if (pi != p) {
      p = pi;
      d = descs[p];
      n_words = d.n_lanes * w;
      dst = out + d.lane0 * w;
    }
    k = ki;
    const int s = (int)(i % kStages);
    uint32_t* tile = tiles + s * kTileWords;
    const int64_t base = k * kTileWords;
    const int64_t end = base + kTileWords < n_words ? base + kTileWords : n_words;
    if (d.kind == 0) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(d.dense);
      if (out16 && aligned16(src)) {
        if (tid == 0) {
          const uint32_t bytes = (uint32_t)(end - base) * 4u;
          const uint32_t bar = smem_u32(&rs.bar[s]);
          bulk_wait_stage_free();
          mbar_expect_tx(bar, bytes);
          bulk_load(smem_u32(tile), src + base, bytes, bar);
          rs.info[s] = StageInfo{dst + base, bytes, kLoaded};
        }
      } else {
        for (int64_t q = base + tid; q < end; q += kThreads) dst[q] = __ldg(src + q);
        if (tid == 0) rs.info[s].mode = kNoStore;
      }
      continue;
    }
    // an encoded tile: its cursors are carried from the run's last tile, or
    // 0 at a page's first, or found by thread 0 where a run starts inside
    const bool known = carried || k == 0;
    if (!carried && k == 0) c_cur = r_cur = 0;
    TileHead head;
    if (known) head = tile_head(d, c_cur, r_cur);
    if (tid == 0) {
      bulk_wait_stage_free();
      if (!known) {
        rs.seek_coord = lower_bound_u32(reinterpret_cast<const uint32_t*>(d.coords), d.n_coords,
                                        (uint64_t)base * 32u);
        const int64_t r = d.kind == 2 ? upper_bound_i32(reinterpret_cast<const int32_t*>(d.starts),
                                                        d.n_runs, base) - 1
                                      : 0;
        rs.seek_run = r > 0 ? r : 0;
      }
    }
    __syncthreads();
    if (!known) {
      c_cur = rs.seek_coord;
      r_cur = rs.seek_run;
      head = tile_head(d, c_cur, r_cur);
    }
    expand_tile(d, base, end, tile, rs, c_cur, r_cur, head);
    if (out16) {
      fence_async_shared();
      __syncthreads();
      if (tid == 0) rs.info[s] = StageInfo{dst + base, (uint32_t)(end - base) * 4u, kFilled};
    } else {
      __syncthreads();
      for (int64_t q = tid; q < end - base; q += kThreads) dst[base + q] = tile[q];
      if (tid == 0) rs.info[s].mode = kNoStore;
    }
  }
  if (tid == 0) bulk_wait_all();
}

}  // namespace

extern "C" int pt_diag_ring(const void* table, int64_t n_pages, int64_t n_blocks, void* out,
                                 int64_t w, void* stream) {
  if (n_pages <= 0 || n_blocks <= 0 || w <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(ring_pages_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  ring_pages_kernel<<<(unsigned)n_blocks, kThreads, kSmemBytes,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int64_t*>(table), n_pages, reinterpret_cast<uint32_t*>(out), w);
  return (int)cudaGetLastError();
}
