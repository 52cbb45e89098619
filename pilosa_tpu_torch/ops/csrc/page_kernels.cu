// Page assembly of the paged stack cache, for Hopper (sm_90a).
//
// Replaces the JAX package's jitted assemble_pages, expand_coords and
// expand_runs (pilosa_tpu/ops/bitmap.py:263, :352, :374; no Pallas kernel):
// one launch writes a stack's whole (lanes, W) word operand from a device
// table of its pages, where JAX expands each encoded page on its own and then
// concatenates.  A page is one of three kinds:
//
// - dense:  (page_lanes, W) words;
// - packed: the sorted flat bit offsets of its set bits, uint32 coordinates;
// - run:    sorted, disjoint word runs of all-ones (int32 starts and lengths)
//           plus the residual bits as coordinates.
//
// Payloads are padded to a power of two with sentinels: a coordinate equal to
// the page's bit count, a run start equal to its word count (length 0).  A
// page writes only its lanes below the stack's end, so the last page's padding
// lanes and every sentinel drop out.  Coordinates are compared as unsigned
// 64-bit values: a 2^28-byte page holds 2^31 bits, past int32.
//
// Bound: bytes.  Each dense page is read once and each output word written
// once; an encoded page reads its payload once.  The least time is those
// bytes over the card's 3.35 TB/s.
//
// Design.  A page is cut into tiles of kTileWords words (32 KiB), and its
// tiles into runs: a block a run (ops/kernels.py page_plan appends one
// (page, first tile, tiles) row a block to the page table), so a block reads
// one descriptor, and the card hands the blocks out as its SMs free up, as it
// does a copy's.  A persistent grid of SMs x 2 blocks, each dealt a share of
// the tiles, moving dense tiles through a ring of bulk copies in shared
// memory, stayed 3-6% behind torch.cat in every ring shape and deal tried
// (diag/page_variants.py keeps that form and times it beside this one).
//
// - a dense run moves through registers: each thread loads kGroups 16-byte
//   words of a tile, and loads the next tile before it stores the last, so a
//   block of two tiles keeps its 64 KiB in flight;
// - an encoded run passes through a ring of kStages tiles in shared memory:
//   the block zeroes a tile, fills its word runs (a warp a run) and scatters
//   its coordinates with shared atomicOr, and one thread stores it with a
//   bulk copy (cp.async.bulk) while the block fills the next; a stage is
//   filled again only after cp.async.bulk.wait_group.read says its store has
//   read it.  The block keeps a cursor into the page's coordinates and word
//   runs from one tile to the next, so a tile reads each of its coordinates
//   once (256 a round, counted with __syncthreads_count) and no search is
//   made for a word; a run of tiles that starts inside a page finds its
//   cursors with one warp's 32-way search.  A tile's first coordinate and
//   word-run loads are issued before its barriers, so their latency passes
//   under them;
// - a page whose address or size is not a multiple of 16 bytes (W % 4 != 0,
//   or a view one word in) is copied, or its tile written out, by a word
//   loop of the whole block: a branch of this kernel.
//
// The launcher takes raw pointers, sizes as int64 and the stream, launches on
// that stream, does not synchronise, and returns the first CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 8;  // 16-byte words a thread a dense tile
// words a tile (ops/kernels.py _PAGE_TILE_WORDS): the host's rows count them
constexpr int64_t kTileWords = (int64_t)kThreads * kGroups * 4;
constexpr uint32_t kTileBytes = (uint32_t)kTileWords * 4u;
constexpr int kStages = 3;  // encoded tiles in shared memory a block
constexpr int kBlocksPerSm = 2;
constexpr int kDescWords = 10;

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

// Shared memory after the kStages tiles.
struct Scratch {
  long long seek_coord;  // the block's first coordinate and word run
  long long seek_run;
  long long run_stop;    // first word run at or past a tile's end
};

constexpr size_t kSmemBytes = (size_t)kStages * kTileBytes + sizeof(Scratch);

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// ---- PTX: bulk stores from shared memory ------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// generic-proxy writes to shared memory (the block's fill), made visible to
// the bulk copy: every writing thread fences, then the block meets
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(src),
               "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// every store but the last kStages - 1 has read its stage
__device__ __forceinline__ void bulk_wait_stage_free() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kStages - 1) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ---- the dense arm ----------------------------------------------------------

__device__ __forceinline__ void load_tile(uint4 (&x)[kGroups], const uint4* src, int64_t t,
                                          int64_t e4) {
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int64_t q = t + (int64_t)g * kThreads + threadIdx.x;
    if (q < e4) x[g] = __ldg(src + q);
  }
}

// Words [base, end) of a dense page, by the whole block; `vec` when both
// sides and the length are multiples of 16 bytes.
__device__ void copy_dense(const uint32_t* src, uint32_t* dst, int64_t base, int64_t end,
                           bool vec) {
  if (!vec) {
    for (int64_t q = base + threadIdx.x; q < end; q += kThreads) dst[q] = __ldg(src + q);
    return;
  }
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  constexpr int64_t kTile4 = kTileWords / 4;
  const int64_t e4 = end / 4;
  uint4 cur[kGroups], nxt[kGroups];
  load_tile(cur, s4, base / 4, e4);
  for (int64_t t = base / 4; t < e4; t += kTile4) {
    if (t + kTile4 < e4) load_tile(nxt, s4, t + kTile4, e4);
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int64_t q = t + (int64_t)g * kThreads + threadIdx.x;
      if (q < e4) d4[q] = cur[g];
    }
#pragma unroll
    for (int g = 0; g < kGroups; ++g) cur[g] = nxt[g];
  }
}

// ---- the encoded arm ----------------------------------------------------------

// First i in [0, n) with a[i] >= key_u (kUpper: a[i] > key_i), or n, by one
// warp: each round its 32 lanes probe 32 evenly spaced entries of the range.
template <bool kUpper, typename T>
__device__ int64_t warp_search(const T* a, int64_t n, int64_t key_i, uint64_t key_u) {
  const int lane = threadIdx.x & 31;
  auto before = [&](int64_t at) {
    if constexpr (kUpper) return (int64_t)__ldg(a + at) <= key_i;
    else return (uint64_t)(uint32_t)__ldg(a + at) < key_u;
  };
  int64_t lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t at = lo + step * lane;
    const int c = __popc(__ballot_sync(0xffffffffu, at < hi && before(at)));
    const int64_t top = lo + step * c < hi ? lo + step * c : hi;
    lo = c ? lo + step * (c - 1) + 1 : lo;
    hi = top;
  }
  const int64_t at = lo + lane;
  return lo + __popc(__ballot_sync(0xffffffffu, at < hi && before(at)));
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

// A thread's first loads for an encoded tile: the coordinate c_cur + tid,
// and the first word run its warp reads (r_cur + warp).
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
// c_cur is the first coordinate at or past bit 32*base and r_cur a word run
// (the first that can end past base); both advance past the tile.  `h` holds
// the thread's loads at c_cur and r_cur.
__device__ void expand_tile(const PageDesc& d, int64_t base, int64_t end, uint32_t* tile,
                            Scratch& sc, int64_t& c_cur, int64_t& r_cur, const TileHead& h) {
  const int tid = threadIdx.x;
  const int64_t nw = end - base;
  uint4* t4 = reinterpret_cast<uint4*>(tile);
  for (int64_t q = tid; q < (nw + 3) / 4; q += kThreads) t4[q] = make_uint4(0u, 0u, 0u, 0u);
  if (d.kind == 2 && tid == 0) sc.run_stop = d.n_runs;
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
        if (lane == 0) atomicMin(&sc.run_stop, (long long)j);
        break;
      }
      const int64_t a = (s > base ? s : base) - base;
      const int64_t b = (e < end ? e : end) - base;
      if (a < b) fill_ones(tile, a, b, lane);
    }
    __syncthreads();
    // runs are disjoint and sorted: only the last one starting inside the
    // tile can reach past it
    const int64_t stop = sc.run_stop;
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

// Tiles [k0, k0 + count) of an encoded page, through the shared-memory ring;
// `vec` when the output's tiles are 16-byte aligned and sized.
__device__ void expand_run(const PageDesc& d, int64_t k0, int64_t count, int64_t n_words,
                           uint32_t* dst, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* tiles = reinterpret_cast<uint32_t*>(smem);
  Scratch& sc = *reinterpret_cast<Scratch*>(smem + (size_t)kStages * kTileBytes);
  const int tid = threadIdx.x;
  int64_t c_cur = 0, r_cur = 0;
  if (k0 > 0) {
    // the run starts inside the page: warp 0 finds its cursors
    const int64_t base = k0 * kTileWords;
    if (tid < 32) {
      const int64_t c = warp_search<false>(reinterpret_cast<const uint32_t*>(d.coords),
                                           d.n_coords, 0, (uint64_t)base * 32u);
      const int64_t r =
          d.kind == 2
              ? warp_search<true>(reinterpret_cast<const int32_t*>(d.starts), d.n_runs, base, 0) - 1
              : 0;
      if (tid == 0) {
        sc.seek_coord = c;
        sc.seek_run = r > 0 ? r : 0;
      }
    }
    __syncthreads();
    c_cur = sc.seek_coord;
    r_cur = sc.seek_run;
  }
  for (int64_t i = 0; i < count; ++i) {
    uint32_t* tile = tiles + (i % kStages) * kTileWords;
    const int64_t base = (k0 + i) * kTileWords;
    const int64_t end = base + kTileWords < n_words ? base + kTileWords : n_words;
    const TileHead head = tile_head(d, c_cur, r_cur);
    if (tid == 0) bulk_wait_stage_free();
    __syncthreads();
    expand_tile(d, base, end, tile, sc, c_cur, r_cur, head);
    if (vec) {
      fence_async_shared();
      __syncthreads();
      if (tid == 0) bulk_store(dst + base, smem_u32(tile), (uint32_t)(end - base) * 4u);
    } else {
      __syncthreads();
      for (int64_t q = tid; q < end - base; q += kThreads) dst[base + q] = tile[q];
    }
  }
  if (tid == 0) bulk_wait_all();
}

// ---- the kernel -------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
assemble_pages_kernel(const int64_t* __restrict__ table, int64_t n_pages,
                      uint32_t* __restrict__ out, int64_t w) {
  // this block's run of tiles: page, first tile, tiles
  const int64_t* row = table + n_pages * kDescWords + 3 * (int64_t)blockIdx.x;
  const int64_t p = row[0], k0 = row[1], count = row[2];
  if (count <= 0) return;
  const PageDesc d = reinterpret_cast<const PageDesc*>(table)[p];
  const int64_t n_words = d.n_lanes * w;
  uint32_t* dst = out + d.lane0 * w;
  const bool vec = aligned16(out) && (w & 3) == 0;
  if (d.kind == 0) {
    const int64_t base = k0 * kTileWords;
    const int64_t end = (k0 + count) * kTileWords < n_words ? (k0 + count) * kTileWords : n_words;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(d.dense);
    copy_dense(src, dst, base, end, vec && aligned16(src));
    return;
  }
  expand_run(d, k0, count, n_words, dst, vec);
}

}  // namespace

extern "C" int pt_assemble_pages(const void* table, int64_t n_pages, int64_t n_blocks, void* out,
                                 int64_t w, void* stream) {
  if (n_pages <= 0 || n_blocks <= 0 || w <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(assemble_pages_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  assemble_pages_kernel<<<(unsigned)n_blocks, kThreads, kSmemBytes,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int64_t*>(table), n_pages, reinterpret_cast<uint32_t*>(out), w);
  return (int)cudaGetLastError();
}
