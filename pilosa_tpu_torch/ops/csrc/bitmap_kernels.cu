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

#include <cuda_pipeline.h>
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

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
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
// masked_popcount, over a table of shards:
//   out[r] = sum over shards s of popcount((OR over views v of tile[s][v][r]) & mask[s])
// Replaces pilosa_tpu/ops/kernels.py masked_popcount (Pallas), which the JAX
// per-shard TopN/TopK calls once a shard (one (R, W) & (W,) call each); here
// one launch counts every shard's candidate rows against that shard's filter.
// The tiles are read where the per-shard engine's tile cache holds them:
// tiles is an (S, V, R) table of row addresses, masks an (S,) table of filter
// addresses; an address of 0 is an absent tile (it reads the zero tile the
// caller passes) or no filter (every word counts).  TABLE = false is the
// single (N, W) & (W,) call, row r at x + r*w, as one table-free shard.
// Bound: bytes, (S*V*R + S)*W*4 (+ the tables, + R*8 out) over 3.35 TB/s
// (0.336 ms at S = 954, V = 1, R = 8, W = 32768, filtered).  One launch of a
// shard's 8 rows moves 1.2 MB, less than the launch floor can stream, so the
// design is one launch over all shards: a block takes (shard, slab of row
// groups, chunk of 1024*J words); each thread holds its J 16-byte mask words
// in registers for every row of the block and keeps 8 rows' counts in
// registers between reductions.  The loads carry the time, so nothing stands
// between them: a group's 8 addresses are read first, an absent tile or a
// row past R reads the zero tile rather than branching, alignment is decided
// once a table (VEC: every address 16-byte aligned and W % 4 == 0, else 4-byte
// loads), and with one view (ONE_VIEW) a group is straight-line code whose
// 8*J loads the compiler may keep in flight at once (2 blocks an SM of
// registers).  More views are ORed in registers by a loop over them.  A
// group of 8 rows is reduced with __reduce_add_sync in each warp and across
// the warps in shared memory, then one atomicAdd a (block, row) adds it to
// out[r] (int64 totals for the table form).  Rows past a group loop in the
// block; the launcher spreads row groups over blocks (slabs) only when the
// shards and chunks alone give too few blocks.
// ---------------------------------------------------------------------------
constexpr int kMpGroup = 8;                // rows counted between reductions
constexpr int64_t kMpTargetBlocks = 2048;  // ~8 waves of 2 blocks on 132 SMs

// words k..k+3 of p, zero past w; VEC: p 16-byte aligned and w % 4 == 0
template <bool VEC>
__device__ __forceinline__ uint4 mp_load4(const uint32_t* p, int64_t k, int64_t w) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (VEC) {
    if (k < w) v = __ldg(reinterpret_cast<const uint4*>(p + k));
  } else {
    if (k < w) v.x = __ldg(p + k);
    if (k + 1 < w) v.y = __ldg(p + k + 1);
    if (k + 2 < w) v.z = __ldg(p + k + 2);
    if (k + 3 < w) v.w = __ldg(p + k + 3);
  }
  return v;
}

__device__ __forceinline__ uint4 or4(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}

// the tile at table entry e of row `row` (the zero tile when absent or past r)
__device__ __forceinline__ const uint32_t* tile_at(const unsigned long long* e, int64_t row,
                                                   int64_t r, const uint32_t* zero) {
  const unsigned long long a = row < r ? __ldg(e + row) : 0ull;
  return a ? reinterpret_cast<const uint32_t*>(static_cast<uintptr_t>(a)) : zero;
}

template <bool TABLE, bool ONE_VIEW, bool VEC, int J, typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
    masked_popcount_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ mask,
                           const unsigned long long* __restrict__ tiles,
                           const unsigned long long* __restrict__ masks,
                           const uint32_t* __restrict__ zero, OutT* __restrict__ out, int64_t v,
                           int64_t r, int64_t w, int64_t chunks, int64_t slabs, int64_t gpb) {
  const int64_t b = blockIdx.x;
  const int64_t chunk = b % chunks;
  const int64_t slab = (b / chunks) % slabs;
  const int64_t shard = b / (chunks * slabs);
  const int64_t k0 = chunk * (kThreads * 4 * J) + 4 * threadIdx.x;  // + 4*kThreads*j
  const uint32_t* mp =
      TABLE ? reinterpret_cast<const uint32_t*>(static_cast<uintptr_t>(__ldg(masks + shard)))
            : mask;
  uint4 m[J];
  if (mp) {
#pragma unroll
    for (int j = 0; j < J; ++j) m[j] = mp_load4<VEC>(mp, k0 + 4 * kThreads * j, w);
  } else {
#pragma unroll
    for (int j = 0; j < J; ++j) m[j] = make_uint4(~0u, ~0u, ~0u, ~0u);
  }
  // this shard's row addresses, view 0 (the table's (S, V, R) layout)
  const unsigned long long* trow = TABLE ? tiles + shard * v * r : nullptr;
  __shared__ int red[kWarps][kMpGroup];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t groups = (r + kMpGroup - 1) / kMpGroup;
  const int64_t g_end = (slab + 1) * gpb < groups ? (slab + 1) * gpb : groups;
  for (int64_t g = slab * gpb; g < g_end; ++g) {
    const int64_t row0 = g * kMpGroup;
    const uint32_t* p0[kMpGroup];
#pragma unroll
    for (int i = 0; i < kMpGroup; ++i)
      p0[i] = TABLE ? tile_at(trow, row0 + i, r, zero) : x + (row0 + i < r ? row0 + i : 0) * w;
    int cnt[kMpGroup];
#pragma unroll
    for (int i = 0; i < kMpGroup; ++i) {
      uint4 acc[J];
#pragma unroll
      for (int j = 0; j < J; ++j) acc[j] = mp_load4<VEC>(p0[i], k0 + 4 * kThreads * j, w);
      if (!ONE_VIEW) {
        for (int64_t vi = 1; vi < v; ++vi) {
          const uint32_t* p = tile_at(trow + vi * r, row0 + i, r, zero);
#pragma unroll
          for (int j = 0; j < J; ++j)
            acc[j] = or4(acc[j], mp_load4<VEC>(p, k0 + 4 * kThreads * j, w));
        }
      }
      cnt[i] = 0;
#pragma unroll
      for (int j = 0; j < J; ++j) cnt[i] += popc4_and(acc[j], m[j]);
    }
#pragma unroll
    for (int i = 0; i < kMpGroup; ++i) {
      const int s = static_cast<int>(__reduce_add_sync(0xffffffffu, static_cast<unsigned>(cnt[i])));
      if (lane == 0) red[warp][i] = s;
    }
    __syncthreads();
    if (threadIdx.x < kMpGroup && row0 + threadIdx.x < r) {
      int s = 0;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) s += red[q][threadIdx.x];
      if (s) atomicAdd(out + row0 + threadIdx.x, static_cast<OutT>(s));
    }
    __syncthreads();  // red is reused by the next group
  }
}

// Grid of masked_popcount: J (16-byte words a thread a row) and the row
// slabs.  J = 4 (4096-word chunks) when the loads are 16-byte and the
// shards, chunks and row groups give kMpTargetBlocks or more; else J = 1
// (the 4-byte path at J = 4 spilled registers).  Slabs spread the row groups
// over blocks only as far as the shards and chunks leave the grid short of
// kMpTargetBlocks, so the grid never passes S * ceil(W / 1024) +
// kMpTargetBlocks blocks.
template <bool TABLE, bool ONE_VIEW, bool VEC, typename OutT>
cudaError_t launch_masked_popcount(const uint32_t* x, const uint32_t* mask,
                                   const unsigned long long* tiles,
                                   const unsigned long long* masks, const uint32_t* zero,
                                   OutT* out, int64_t s, int64_t v, int64_t r, int64_t w,
                                   cudaStream_t st) {
  const int64_t groups = (r + kMpGroup - 1) / kMpGroup;
  const int64_t wide = (w + 4 * kThreads * 4 - 1) / (4 * kThreads * 4);
  const bool big = VEC && s * wide * groups >= kMpTargetBlocks;
  const int64_t span = 4 * kThreads * (big ? 4 : 1);
  const int64_t chunks = (w + span - 1) / span;
  int64_t slabs = (kMpTargetBlocks + s * chunks - 1) / (s * chunks);
  slabs = slabs < 1 ? 1 : slabs > groups ? groups : slabs;
  const int64_t gpb = (groups + slabs - 1) / slabs;
  slabs = (groups + gpb - 1) / gpb;
  const unsigned grid = static_cast<unsigned>(s * chunks * slabs);
  auto kern = big ? masked_popcount_kernel<TABLE, ONE_VIEW, VEC, VEC ? 4 : 1, OutT>
                  : masked_popcount_kernel<TABLE, ONE_VIEW, VEC, 1, OutT>;
  kern<<<grid, kThreads, 0, st>>>(x, mask, tiles, masks, zero, out, v, r, w, chunks, slabs, gpb);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bsi_sum_counts: planes (S, 2+d, W), filt (S, W) or null ->
//   cnt (S,), pos (S, d), neg (S, d), each zeroed by the caller.
// Replaces pilosa_tpu/ops/kernels.py bsi_sum_counts (Pallas, vmapped over S).
// Bound: S*(2+d)*W*4 (+ S*W*4 with a filter) + S*(1+2d)*4 bytes over
// 3.35 TB/s (373.3 us filtered at S = 954, d = 7).  The planes may have any
// shard stride pl_ss; a contiguous stack keeps its own instance, since a
// runtime stride made it 23% slower on the H100, and stride 0 with a filter
// (one shard's planes against S filters: the per-shard GroupBy's combo
// masks) takes bsi_sum_counts_kernel_stride0 below.  The grid is
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

// ---------------------------------------------------------------------------
// bsi_sum_counts, stride-0 instance: one shard's planes (2+d, W) against C
// filters (C, W) -> cnt (C,), pos (C, d), neg (C, d), zeroed by the caller.
// The per-shard GroupBy Sum's shape (executor/advanced.py _groupby_loop: a
// launch a shard, C = the combos of a chunk, 8 to 256).
// The function is (1+2d) popcounts a word a filter: C*W*(1+2d) of them, 7.1
// us at C = 60, d = 7, W = 32768 at __popc's 16 a clock an SM.  On the H100
// the strided instance's grid of C x 16 blocks, which re-read the one
// shard's planes for every filter and walked them a plane at a time, took
// 26.9 us there (15.5 us at C = 8, on 128 blocks), and a form that staged
// the planes once a chunk and streamed the filters through __popc still
// took 15.6 us, held by the __popc rate.  So the popcounts run on the tensor
// cores (7.7 us at C = 60, 4.1 us at C = 8):
// mma.sync m16n8k256 .b1 with .and.popc adds popc(A row & B column) over
// 256 bits, and one instruction counts 8 filters' positive and negative
// masks (A: rows q = exists & filter & ~sign, q + 8 = exists & filter & sign)
// against 8 columns (B: the magnitude planes, then an all-ones column whose
// two counts sum to the filter's cnt) over 8 words.  What is left is bytes:
// the filters, C*W*4 (2.3 us at C = 60), and the planes once.
// The grid is 256-word chunks x groups of 8-filter m-tiles, sized to about 4
// blocks an SM.  A block stages its chunk of exists, sign and the d planes in
// shared memory once (cp.async, a word a thread a plane; the plane rows are
// padded by 4 words so a B load by 8 columns x 4 words is conflict-free),
// then each warp takes 4 of the chunk's 32 k-steps for every m-tile of its
// group, its lanes loading their filter words straight into the A fragments
// (lane 4q + r: filter q, words 8k + r and 8k + r + 4).  The k-sum of a warp
// stays in the accumulators; the 8 warps add them into the block's shared
// counters (16 x 8 a tile), which reach the outputs with one global atomic
// each at the end.  PTX fragment layout (ISA, mma.m16n8k256 .b1, as
// m16n8k32 .s8 with 32 elements a register): a0 = row q, k 32r..32r+31;
// a1 = row q+8, same k; a2, a3 = the same rows, k + 128; b0 = k 32r..32r+31,
// column q; b1 = k + 128; c0, c1 = row q, columns 2r, 2r+1; c2, c3 = row
// q+8.  k is summed over, so the word each k-slot holds only has to be the
// same in A and B.
// ---------------------------------------------------------------------------
constexpr int kS0Words = 256;                   // words a block stages, a word a thread
constexpr int kS0Stride = kS0Words + 4;         // a staged plane's row, padded
constexpr int kS0Steps = kS0Words / 8 / kWarps;  // k-steps of 8 words, a warp an m-tile
constexpr int kS0CounterBytes = 48 * 1024;      // the block's counters, at most
static_assert(kS0Words == kThreads, "the stage takes a word a thread a plane");

__device__ __forceinline__ void mma_b1(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// NT n-tiles of 8 columns: the d planes and the count column, padded
template <int NT>
__global__ void bsi_sum_counts_kernel_stride0(const uint32_t* __restrict__ planes,
                                              const uint32_t* __restrict__ filt,
                                              int* __restrict__ cnt, int* __restrict__ pos,
                                              int* __restrict__ neg, int64_t c, int64_t p,
                                              int64_t w, int64_t chunks, int mtb) {
  extern __shared__ uint32_t stage[];  // p staged planes, then mtb x 16 x NC counters
  constexpr int NC = NT * 8;
  const int d = static_cast<int>(p - 2);
  int* counters = reinterpret_cast<int*>(stage + p * kS0Stride);
  const int64_t base = (blockIdx.x % chunks) * kS0Words;
  const int64_t f0 = (blockIdx.x / chunks) * 8 * static_cast<int64_t>(mtb);
  const int t = threadIdx.x, warp = t >> 5, q = (t & 31) >> 2, r = t & 3;

  const int64_t k = base + t;
  for (int pl = 0; pl < p; ++pl) {
    uint32_t* dst = stage + pl * kS0Stride + t;
    if (k < w) __pipeline_memcpy_async(dst, planes + pl * w + k, sizeof(uint32_t));
    else *dst = 0u;
  }
  __pipeline_commit();
  for (int i = t; i < mtb * 16 * NC; i += kThreads) counters[i] = 0;
  __pipeline_wait_prior(0);
  __syncthreads();  // the stage and the zeroed counters are the block's

  for (int mt = 0; mt < mtb; ++mt) {
    const int64_t f = f0 + 8 * mt + q;  // this lane's filter
    int acc[NT][4] = {};
#pragma unroll
    for (int i = 0; i < kS0Steps; ++i) {
      const int wa = (warp + kWarps * i) * 8 + r, wb = wa + 4;  // words of the chunk
      uint32_t fa = 0u, fb = 0u;
      if (f < c) {
        if (base + wa < w) fa = __ldg(filt + f * w + base + wa);
        if (base + wb < w) fb = __ldg(filt + f * w + base + wb);
      }
      const uint32_t ea = stage[wa] & fa, eb = stage[wb] & fb;
      const uint32_t sa = stage[kS0Stride + wa], sb = stage[kS0Stride + wb];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = 8 * nt + q;  // this lane's B column
        uint32_t b0 = 0u, b1 = 0u;
        if (col < d) {
          b0 = stage[(2 + col) * kS0Stride + wa];
          b1 = stage[(2 + col) * kS0Stride + wb];
        } else if (col == d) {
          b0 = b1 = ~0u;
        }
        mma_b1(acc[nt], ea & ~sa, ea & sa, eb & ~sb, eb & sb, b0, b1);
      }
    }
    int* ctr = counters + mt * 16 * NC;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (acc[nt][j]) atomicAdd(ctr + (q + 8 * (j >> 1)) * NC + 8 * nt + 2 * r + (j & 1), acc[nt][j]);
  }
  __syncthreads();
  for (int i = t; i < mtb * 8 * (d + 1); i += kThreads) {
    const int ff = i / (d + 1), col = i % (d + 1);
    const int64_t f = f0 + ff;
    if (f >= c) continue;
    const int* row = counters + (ff >> 3) * 16 * NC + (ff & 7) * NC + col;
    const int pv = row[0], nv = row[8 * NC];  // rows q and q + 8
    if (col == d) {
      if (pv + nv) atomicAdd(cnt + f, pv + nv);
    } else {
      if (pv) atomicAdd(pos + f * d + col, pv);
      if (nv) atomicAdd(neg + f * d + col, nv);
    }
  }
}

template <int NT>
cudaError_t launch_bsi_sum_counts_stride0(const uint32_t* planes, const uint32_t* filt, int* cnt,
                                          int* pos, int* neg, int64_t c, int64_t p, int64_t w,
                                          cudaStream_t stream) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const int64_t chunks = (w + kS0Words - 1) / kS0Words;
  const int64_t mtiles = (c + 7) / 8;
  // about 4 blocks an SM: the m-tile groups wanted, and the m-tiles a group
  const int64_t groups = (4 * static_cast<int64_t>(sms) + chunks - 1) / chunks;
  const int64_t cap = kS0CounterBytes / (16 * NT * 8 * static_cast<int64_t>(sizeof(int)));
  int64_t mtb = (mtiles + groups - 1) / groups;
  mtb = mtb > cap ? cap : mtb;
  const int64_t blocks = chunks * ((mtiles + mtb - 1) / mtb);
  const size_t smem = (p * kS0Stride + mtb * 16 * NT * 8) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(bsi_sum_counts_kernel_stride0<NT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  bsi_sum_counts_kernel_stride0<NT><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      planes, filt, cnt, pos, neg, c, p, w, chunks, static_cast<int>(mtb));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bsi_range: planes (S, 2+d, W) at shard stride pl_ss -> out (S, W), the
// columns whose value satisfies op against the predicate(s).
// Replaces the BSI comparator of pilosa_tpu/ops/bsi.py (cmp_unsigned and
// range_eq/neq/lt/gt/between, bsi.py:199-305).  That is pure jnp, which XLA
// fuses into one pass under the stacked plan's jit
// (pilosa_tpu/executor/stacked.py:1477-1488), so it has no Pallas kernel;
// eager torch ran it as d steps of ~7 full-stack ops.
// Bound: S*(2+d)*W*4 + S*W*4 bytes over 3.35 TB/s (0.373 ms at S = 954,
// d = 7, W = 32768); the ~6 bit operations a plane a word a predicate are far
// below that at 67 TOP/s.  One pass: the grid is shards x 1024-word chunks; a
// thread owns 4 consecutive words (one 16-byte load a plane where the rows
// are 16-byte aligned), loads exists and sign once, walks the magnitude
// planes MSB first with lt/eq in registers (for between, both predicates'
// lt/eq from the same single read of the planes), and writes its words once.
// The predicate bit of plane i, (p >> i) & 1, is expanded to a word mask; d
// is a runtime loop bound.  The sign regime (op, p_neg, q_neg) is uniform
// over the launch, as the JAX package's jnp.where on the plan's flags.
// ---------------------------------------------------------------------------
constexpr int kRangeChunk = kThreads * 4;  // words per block
enum RangeOp { kEq = 0, kNeq, kLt, kLte, kGt, kGte, kBetween };

template <bool VEC>
__device__ __forceinline__ uint4 load4(const uint32_t* x, int64_t k, int64_t w) {
  if (VEC) return __ldg(reinterpret_cast<const uint4*>(x + k));  // W % 4 == 0, k < w
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  v.x = __ldg(x + k);
  if (k + 1 < w) v.y = __ldg(x + k + 1);
  if (k + 2 < w) v.z = __ldg(x + k + 2);
  if (k + 3 < w) v.w = __ldg(x + k + 3);
  return v;
}

// lt/eq of one word against the predicate bit's mask pm (0 or ~0),
// cmp_unsigned's step
__device__ __forceinline__ void cmp_step(uint32_t& lt, uint32_t& eq, uint32_t m, uint32_t pm) {
  lt |= eq & ~m & pm;
  eq &= ~(m ^ pm);
}

// range_eq/neq/lt/gt/between of one word from exists, sign and the walk's
// lt/eq against p (and lt_q/eq_q against q for between)
__device__ __forceinline__ uint32_t range_word(int op, uint32_t e, uint32_t s, uint32_t lt,
                                               uint32_t eq, uint32_t lt_q, uint32_t eq_q,
                                               bool p_neg, bool q_neg) {
  const uint32_t neg = e & s, pos = e & ~s;
  switch (op) {
    case kEq:
      return (p_neg ? neg : pos) & eq;
    case kNeq:
      return e & ~((p_neg ? neg : pos) & eq);
    case kLt:
    case kLte: {
      const bool allow_eq = op == kLte;
      const uint32_t ltu = allow_eq ? (lt | eq) : lt, gtu = allow_eq ? ~lt : ~(lt | eq);
      return p_neg ? (neg & gtu) : (neg | (pos & ltu));
    }
    case kGt:
    case kGte: {
      const bool allow_eq = op == kGte;
      const uint32_t ltu = allow_eq ? (lt | eq) : lt, gtu = allow_eq ? ~lt : ~(lt | eq);
      return p_neg ? (pos | (neg & ltu)) : (pos & gtu);
    }
    default: {  // between: p <= value <= q
      if (!p_neg && q_neg) return 0u;  // inverted range: empty
      const uint32_t lte_p = lt | eq, lte_q = lt_q | eq_q;
      if (!p_neg) return pos & ~lt & lte_q;
      if (q_neg) return neg & ~lt_q & lte_p;
      return (neg & lte_p) | (pos & lte_q);
    }
  }
}

template <bool VEC, bool TWO>
__global__ void bsi_range_kernel(const uint32_t* __restrict__ planes, uint32_t* __restrict__ out,
                                 int64_t pl_ss, int64_t p, int64_t w, int64_t chunks, int op,
                                 uint64_t pa, uint64_t qa, bool p_neg, bool q_neg) {
  const int64_t shard = blockIdx.x / chunks;
  const int64_t k = (blockIdx.x % chunks) * kRangeChunk + 4 * threadIdx.x;
  if (k >= w) return;
  const uint32_t* sp = planes + shard * pl_ss;
  const uint4 e = load4<VEC>(sp, k, w);
  const uint4 s = load4<VEC>(sp + w, k, w);
  uint4 lt = make_uint4(0u, 0u, 0u, 0u), eq = make_uint4(~0u, ~0u, ~0u, ~0u);
  uint4 lt_q = lt, eq_q = eq;
#pragma unroll 4
  for (int i = static_cast<int>(p - 3); i >= 0; --i) {
    const uint4 m = load4<VEC>(sp + (2 + i) * w, k, w);
    const uint32_t pm = 0u - static_cast<uint32_t>((pa >> i) & 1u);
    cmp_step(lt.x, eq.x, m.x, pm);
    cmp_step(lt.y, eq.y, m.y, pm);
    cmp_step(lt.z, eq.z, m.z, pm);
    cmp_step(lt.w, eq.w, m.w, pm);
    if (TWO) {
      const uint32_t qm = 0u - static_cast<uint32_t>((qa >> i) & 1u);
      cmp_step(lt_q.x, eq_q.x, m.x, qm);
      cmp_step(lt_q.y, eq_q.y, m.y, qm);
      cmp_step(lt_q.z, eq_q.z, m.z, qm);
      cmp_step(lt_q.w, eq_q.w, m.w, qm);
    }
  }
  uint4 r;
  r.x = range_word(op, e.x, s.x, lt.x, eq.x, lt_q.x, eq_q.x, p_neg, q_neg);
  r.y = range_word(op, e.y, s.y, lt.y, eq.y, lt_q.y, eq_q.y, p_neg, q_neg);
  r.z = range_word(op, e.z, s.z, lt.z, eq.z, lt_q.z, eq_q.z, p_neg, q_neg);
  r.w = range_word(op, e.w, s.w, lt.w, eq.w, lt_q.w, eq_q.w, p_neg, q_neg);
  uint32_t* o = out + shard * w;
  if (VEC) {
    *reinterpret_cast<uint4*>(o + k) = r;
  } else {
    o[k] = r.x;
    if (k + 1 < w) o[k + 1] = r.y;
    if (k + 2 < w) o[k + 2] = r.z;
    if (k + 3 < w) o[k + 3] = r.w;
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
  const uint32_t* xp = static_cast<const uint32_t*>(x);
  const uint32_t* mp = static_cast<const uint32_t*>(mask);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  // with W % 4 == 0 every row of an aligned x is aligned
  const bool vec = (w & 3) == 0 && aligned16(xp) && aligned16(mp);
  return static_cast<int>(
      vec ? launch_masked_popcount<false, true, true>(xp, mp, nullptr, nullptr, nullptr, o, 1, 1,
                                                      n, w, st)
          : launch_masked_popcount<false, true, false>(xp, mp, nullptr, nullptr, nullptr, o, 1,
                                                       1, n, w, st));
}

// vec: the caller found every address of both tables 16-byte aligned and
// W % 4 == 0; zero: W zero words, read for an absent tile
int pt_masked_popcount_shards(const void* tiles, const void* masks, const void* zero, void* out,
                              int64_t s, int64_t v, int64_t r, int64_t w, int64_t vec,
                              void* stream) {
  const unsigned long long* t = static_cast<const unsigned long long*>(tiles);
  const unsigned long long* m = static_cast<const unsigned long long*>(masks);
  const uint32_t* z = static_cast<const uint32_t*>(zero);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the kernel reads view 0 of every shard: no shard, view, row or word
  // leaves nothing to count, and the caller must not launch
  if (s < 1 || v < 1 || r < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (v == 1)
    e = vec ? launch_masked_popcount<true, true, true>(nullptr, nullptr, t, m, z, o, s, v, r, w, st)
            : launch_masked_popcount<true, true, false>(nullptr, nullptr, t, m, z, o, s, v, r, w,
                                                        st);
  else
    e = vec ? launch_masked_popcount<true, false, true>(nullptr, nullptr, t, m, z, o, s, v, r, w,
                                                        st)
            : launch_masked_popcount<true, false, false>(nullptr, nullptr, t, m, z, o, s, v, r, w,
                                                         st);
  return static_cast<int>(e);
}

int pt_bsi_sum_counts(const void* planes, int64_t pl_ss, const void* filt, void* cnt, void* pos,
                      void* neg, int64_t s, int64_t p, int64_t w, void* stream) {
  const int64_t chunks = (w + kBsiChunk - 1) / kBsiChunk;
  const size_t smem = (2 * (p - 2) + 1) * sizeof(int) + 2 * kBsiChunk * sizeof(uint32_t);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pl_ss == 0 && filt && p - 1 <= 72) {  // up to 9 n-tiles: d <= 71
    const uint32_t* pl = static_cast<const uint32_t*>(planes);
    const uint32_t* fl = static_cast<const uint32_t*>(filt);
    int* c = static_cast<int*>(cnt);
    int* ps = static_cast<int*>(pos);
    int* ng = static_cast<int*>(neg);
    // n-tiles for the d plane columns and the count column
    const int64_t cols = p - 1;
    cudaError_t e;
    if (cols <= 8) e = launch_bsi_sum_counts_stride0<1>(pl, fl, c, ps, ng, s, p, w, st);
    else if (cols <= 16) e = launch_bsi_sum_counts_stride0<2>(pl, fl, c, ps, ng, s, p, w, st);
    else if (cols <= 32) e = launch_bsi_sum_counts_stride0<4>(pl, fl, c, ps, ng, s, p, w, st);
    else e = launch_bsi_sum_counts_stride0<9>(pl, fl, c, ps, ng, s, p, w, st);
    return static_cast<int>(e);
  }
  auto kern = pl_ss == p * w ? bsi_sum_counts_kernel<true> : bsi_sum_counts_kernel<false>;
  kern<<<static_cast<unsigned>(s * chunks), kThreads, smem, st>>>(
      static_cast<const uint32_t*>(planes), static_cast<const uint32_t*>(filt),
      static_cast<int*>(cnt), static_cast<int*>(pos), static_cast<int*>(neg), pl_ss, p, w,
      chunks);
  return static_cast<int>(cudaGetLastError());
}

int pt_bsi_range(const void* planes, int64_t pl_ss, void* out, int64_t s, int64_t p, int64_t w,
                 int64_t op, uint64_t pa, uint64_t qa, int64_t p_neg, int64_t q_neg, void* stream) {
  const int64_t chunks = (w + kRangeChunk - 1) / kRangeChunk;
  const bool vec = (w & 3) == 0 && (pl_ss & 3) == 0 && aligned16(planes) && aligned16(out);
  const bool two = op == kBetween;
  auto kern = vec ? (two ? bsi_range_kernel<true, true> : bsi_range_kernel<true, false>)
                  : (two ? bsi_range_kernel<false, true> : bsi_range_kernel<false, false>);
  kern<<<static_cast<unsigned>(s * chunks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(planes), static_cast<uint32_t*>(out), pl_ss, p, w, chunks,
      static_cast<int>(op), pa, qa, p_neg != 0, q_neg != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
