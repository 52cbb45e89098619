// GroupBy kernels of the query path, for Hopper (sm_90a).
//
// Words are 32-bit, packed LSB-first (column c = word c >> 5, bit c & 31);
// PyTorch hands them over as int32 tensors and the kernels read them as
// uint32.  Each launcher takes raw pointers, sizes as int64 and the CUDA
// stream, launches on that stream, does not synchronise, and returns
// cudaGetLastError() so that a refused launch reaches the Python wrapper.
// Outputs are allocated and initialised by the wrapper (zeros, or the Min/Max
// identities); the kernels only add into them.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemMax = 227 * 1024;  // dynamic shared memory a block may opt into

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int lowest_bit(uint32_t m) { return __ffs(m) - 1; }
__device__ __forceinline__ int lowest_bit(uint64_t m) {
  return __ffsll(static_cast<long long>(m)) - 1;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// The grid of a persistent kernel: the blocks an SM holds at `smem` bytes of
// dynamic shared memory, times the SMs, and at most one block a tile.
template <class Kernel>
cudaError_t persistent_grid(Kernel kern, int threads, size_t smem, int64_t tiles,
                            int64_t* grid) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (e != cudaSuccess) return e;
  const int64_t g = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sm_count();
  *grid = g < tiles ? g : tiles;
  return cudaSuccess;
}

// Byte j of eight plane words p0..p7 as an 8x8 bit matrix, transposed with
// three delta swaps (Hacker's Delight, 7-3): byte c of the result (lo for
// c < 4, hi for c >= 4) holds in bit b plane b's bit at column 8j + c.
__device__ __forceinline__ void transpose8(uint32_t p0, uint32_t p1, uint32_t p2, uint32_t p3,
                                           uint32_t p4, uint32_t p5, uint32_t p6, uint32_t p7,
                                           int j, uint32_t& lo, uint32_t& hi) {
  const uint32_t sel = static_cast<uint32_t>(j | ((j + 4) << 4));
  lo = __byte_perm(__byte_perm(p0, p1, sel), __byte_perm(p2, p3, sel), 0x5410);
  hi = __byte_perm(__byte_perm(p4, p5, sel), __byte_perm(p6, p7, sel), 0x5410);
  uint32_t t = (lo ^ (lo >> 7)) & 0x00AA00AAu;
  lo ^= t ^ (t << 7);
  t = (hi ^ (hi >> 7)) & 0x00AA00AAu;
  hi ^= t ^ (t << 7);
  t = (lo ^ (lo >> 14)) & 0x0000CCCCu;
  lo ^= t ^ (t << 14);
  t = (hi ^ (hi >> 14)) & 0x0000CCCCu;
  hi ^= t ^ (t << 14);
  t = (lo ^ (hi << 4)) & 0xF0F0F0F0u;
  lo ^= t;
  hi ^= t >> 4;
}

// transpose8 of words p[o .. o+7] of a register array.
#define PT_TRANSPOSE8(p, o, j, lo, hi) \
  transpose8(p[o], p[o + 1], p[o + 2], p[o + 3], p[o + 4], p[o + 5], p[o + 6], p[o + 7], j, lo, hi)

// Byte c of x[0 .. N) as bits 0-7, 8-15, ... of the result.
template <int N>
__device__ __forceinline__ uint64_t col_bits(const uint32_t (&x)[N], int c) {
  uint64_t r = 0;
#pragma unroll
  for (int t = 0; t < N; ++t)
    r |= static_cast<uint64_t>(__byte_perm(x[t], 0u, static_cast<uint32_t>(c | 0x4440))) << (8 * t);
  return r;
}

// A column's key from NT transposed words x0, x1, x2 (their lo or hi
// halves): byte c of each, as bits 0-7, 8-15 and 16-23.
template <int NT>
__device__ __forceinline__ uint32_t key_of(uint32_t x0, uint32_t x1, uint32_t x2, int c) {
  if constexpr (NT == 1) {
    return __byte_perm(x0, 0u, static_cast<uint32_t>(c | 0x4440));
  } else {
    const uint32_t k01 = __byte_perm(x0, x1, static_cast<uint32_t>(c | ((c + 4) << 4)));
    if constexpr (NT == 2) {
      return k01 & 0xFFFFu;
    } else {
      return __byte_perm(k01, x2, static_cast<uint32_t>(0x0010 | ((c + 4) << 8))) & 0xFFFFFFu;
    }
  }
}

// ---------------------------------------------------------------------------
// groupby_fused: one-pass group-code histogram.
//   code planes (S, CB, W), valid (S, W), BSI planes (S, 2+d, W) or null ->
//   hist (K, G) [counts, nn, pos x d, neg x d] (K = 1 without planes,
//   2 + 2d signed, 2 + d unsigned) and optionally mm (4, G)
//   [max_mag_pos, min_mag_pos, max_mag_neg, min_mag_neg].
// Every input may have any shard stride; within a shard the planes are W words
// apart and the words contiguous, so the engine's (S, CB+1, W) group-code
// stack and a BSI stack's sign+magnitude planes go in as views, uncopied.
// Replaces pilosa_tpu/ops/kernels.py groupby_fused (Pallas, int8 MXU dots).
// Bound: each input word read once (CB + 1 + 1 + d planes of S*W words, plus
// the sign plane when signed) over 3.35 TB/s.  Each valid column must update
// the histogram at least once, so the per-column work, not the bytes, is
// what a design can lose time on: the first port composed each column's code
// and magnitude bit by bit and added 1 + [exists] + popcount(magnitude)
// shared-memory atomics, which measured 4x the byte bound (PERF.md).
//
// The arm is chosen by shape alone, in pt_groupby_fused:
// 1. Joint table (groupby_joint_kernel), wherever it fits shared memory: one
//    counter per (code, value) bin, value = (sign, magnitude) or a no-value
//    bin for columns whose exists bit is clear, 2^CB x (2^(d + signed) + 1)
//    counters (132 KB at the able shape signed).  Each valid column adds 1
//    to one bin, one shared atomic.  The block's epilogue expands the table
//    into the (K, G) rows: counts and nn are sums over bins, pos[p] / neg[p]
//    sum the bins whose magnitude has bit p set, and the Min/Max table is
//    the highest and lowest nonzero magnitude per code and side (no
//    atomicMax/atomicMin per column).  Where 2^(CB + d) is too large, the
//    magnitude splits into two chunks with a table each (a present column
//    then adds 2 atomics).  Without BSI planes (a count-only GroupBy, the
//    value histogram) the table is 2^CB counters; when it is small (the
//    value histogram's 256), each lane has its own copy, interleaved so lane
//    l's counters sit in bank l: no two lanes of a warp meet on a bank or an
//    address.
//    Composition: a thread owns one word (32 columns) of a tile and loads its
//    key planes, code bits first, then the sign, the magnitude and a
//    no-value bit, at most 24 (values masked by exists).  Per 8 columns it
//    transposes each group of 8 planes as an 8x8 bit matrix (transpose8,
//    ~27 instructions), so a column's key is 1-3 byte selects, and the table
//    is laid out so that the key is the bin: about 10 instructions a column
//    at 16 key bits, against ~45 bit by bit.  The column loop is unrolled
//    with no per-lane trip count (predicated atomics), so lanes do not
//    diverge.  Blocks are 1024 threads, so that an SM keeps 32 warps in
//    flight even when the table leaves room for one block, and each thread
//    holds two words in registers, loading one while it counts the other.
// 2. (K, G) table (groupby_table_kernel), for the shapes the joint table does
//    not fit (Min/Max past one chunk, depth past 16, more than 24 key bits):
//    1 + [exists] + popcount(magnitude) atomics a column, composed by the
//    same transposes, into shared memory up to 100 KB and as global atomics
//    past that (G = 4096 at depth 16, a 2^20-code value histogram).
// Columns with valid = 0 never form an index, and codes >= G are dropped
// (masked out of the valid word by a bit-sliced compare of the code planes).
// ---------------------------------------------------------------------------
constexpr int kJointThreads = 1024;
constexpr int kJointSlots = 24;       // key bits: code, sign, magnitude, no-value
constexpr int kJointMaxBits = 16;     // magnitude bits of a chunk (epilogue registers)
constexpr int64_t kJointMaxBins = (kSmemMax - 1024) / sizeof(int);
constexpr int64_t kJointStripeBins = 512;  // lane copies up to 64 KB a block

struct JointArgs {
  const uint32_t* plane[kJointSlots];  // key bit q's plane in shard 0; null: none or no-value
  int64_t ss[kJointSlots];             // its shard stride
  const uint32_t* valid;
  int64_t va_ss;
  const uint32_t* exists;  // null without BSI planes
  int64_t ex_ss;
  int cb;         // code bits: key bits [0, cb)
  int s;          // 1 when signed: key bit cb is the sign
  int d;          // magnitude bits: key bits [cb + s, cb + s + d); then the no-value bit
  int np;         // key bits
  int g;          // codes
  int all_codes;  // g >= 2^cb: no code is dropped
  int w;          // magnitude bits of a chunk
  int parts_log2; // the epilogue splits each chunk's magnitudes into 2^parts_log2 ranges
  int64_t base1;  // bins before the second chunk's table
  int64_t bins;   // table bins (each RF counters)
};

// One word of a joint-table tile: v its valid bits, ex its exists bits and
// q the key planes' words.  tiles < 2^31 (S * W * 32 < 2^31), so the tile
// splits into (shard, chunk) by 32-bit division.
template <int NS>
__device__ __forceinline__ void joint_load(const JointArgs& a, int64_t t, int64_t chunks,
                                           int64_t w, uint32_t (&q)[NS], uint32_t& v,
                                           uint32_t& ex) {
  const uint32_t shard = static_cast<uint32_t>(t) / static_cast<uint32_t>(chunks);
  const int64_t i =
      static_cast<int64_t>(static_cast<uint32_t>(t) - shard * static_cast<uint32_t>(chunks)) *
          kJointThreads + threadIdx.x;
  const bool in = i < w;
  v = in ? __ldg(a.valid + shard * a.va_ss + i) : 0u;
  ex = in && a.exists ? __ldg(a.exists + shard * a.ex_ss + i) : 0u;
#pragma unroll
  for (int b = 0; b < NS; ++b)
    q[b] = in && a.plane[b] ? __ldg(a.plane[b] + shard * a.ss[b] + i) : 0u;
}

// Add the word's valid columns to the table: one atomic each into its
// (code, value) bin, two with two magnitude chunks.
template <int NT, int NCH, int RF>
__device__ __forceinline__ void joint_count(const JointArgs& a, uint32_t (&q)[NT * 8],
                                            uint32_t v, uint32_t ex, int* tab) {
  constexpr int NS = NT * 8;
  if (!a.all_codes) {  // keep the columns whose code < g (bit-sliced compare)
    uint32_t lt = 0, eq = ~0u;
#pragma unroll
    for (int b = NS - 1; b >= 0; --b) {
      if (b >= a.cb) continue;
      if ((a.g >> b) & 1) {
        lt |= eq & ~q[b];
        eq &= q[b];
      } else {
        eq &= ~q[b];
      }
    }
    v &= lt;
  }
  if (!v) return;
  if (a.exists) {
    // value bits count only where the value exists, and the no-value bit is
    // ~exists; written as one select a word (a conditional store to the
    // no-value slot alone compiles to an indexed store, and the words then
    // live in local memory)
#pragma unroll
    for (int b = 0; b < NS; ++b) {
      const uint32_t keep = b < a.cb ? ~0u : 0u;
      const uint32_t none = b == a.np - 1 ? ~0u : 0u;
      q[b] = (q[b] & (ex | keep)) | (~ex & none);
    }
  }
  // the table is key-indexed: bin (code, row) = code + 2^cb * row, so a
  // one-chunk column's bin is its key
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t vb = (v >> (8 * j)) & 0xFFu;
    if (!vb) continue;
    uint32_t lo[3] = {}, hi[3] = {};
    PT_TRANSPOSE8(q, 0, j, lo[0], hi[0]);
    if constexpr (NT > 1) PT_TRANSPOSE8(q, 8, j, lo[1], hi[1]);
    if constexpr (NT > 2) PT_TRANSPOSE8(q, 16, j, lo[2], hi[2]);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (!((vb >> c) & 1u)) continue;
      const uint32_t key = c < 4 ? key_of<NT>(lo[0], lo[1], lo[2], c)
                                 : key_of<NT>(hi[0], hi[1], hi[2], c - 4);
      if constexpr (NCH < 2) {
        atomicAdd(tab + key * RF, 1);
      } else {
        const uint32_t vrow = key >> a.cb;
        const uint32_t code = key & ((1u << a.cb) - 1u);
        const uint32_t nex = vrow >> (a.s + a.d);
        const uint32_t row0 = (vrow & ((1u << (a.s + a.w)) - 1u)) | (nex << (a.s + a.w));
        atomicAdd(tab + (code | (row0 << a.cb)) * RF, 1);
        if (!nex) {
          const uint32_t row1 =
              (vrow & a.s) | (((vrow >> (a.s + a.w)) & ((1u << a.w) - 1u)) << a.s);
          atomicAdd(tab + (a.base1 + (code | (row1 << a.cb))) * RF, 1);
        }
      }
    }
  }
}

template <int NT, int NCH, bool STRIPE>
__global__ void __launch_bounds__(kJointThreads)
groupby_joint_kernel(const JointArgs a, int64_t w, int64_t chunks, int64_t tiles,
                     int* __restrict__ hist, int* __restrict__ mm) {
  constexpr int NS = NT * 8;
  constexpr int RF = STRIPE ? 32 : 1;  // copies of each bin
  extern __shared__ int smem[];
  for (int64_t i = threadIdx.x; i < a.bins * RF; i += kJointThreads) smem[i] = 0;
  __syncthreads();
  int* tab = smem + (STRIPE ? (threadIdx.x & 31) : 0);

  // two words in registers, counted in turn: one tile's loads are in flight
  // while the other is counted
  const int64_t step = gridDim.x;
  uint32_t qa[NS], qb[NS], va, vb, ea, eb;
  int64_t t = blockIdx.x;
  if (t < tiles) joint_load(a, t, chunks, w, qa, va, ea);
  while (t < tiles) {
    if (t + step < tiles) joint_load(a, t + step, chunks, w, qb, vb, eb);
    joint_count<NT, NCH, RF>(a, qa, va, ea, tab);
    t += step;
    if (t >= tiles) break;
    if (t + step < tiles) joint_load(a, t + step, chunks, w, qa, va, ea);
    joint_count<NT, NCH, RF>(a, qb, vb, eb, tab);
    t += step;
  }
  __syncthreads();

  // epilogue: the block's table into hist (and mm), one global atomic per
  // nonzero output of each item; codes past 2^cb never occur (their hist
  // entries stay 0)
  const int ncodes = a.g < (1 << a.cb) ? a.g : (1 << a.cb);
  auto bin = [&](int64_t b, int64_t rot) {
    int x = 0;
#pragma unroll
    for (int l = 0; l < RF; ++l) x += smem[b * RF + ((l + rot) & (RF - 1))];
    return x;
  };
  if (NCH == 0) {
    for (int code = threadIdx.x; code < ncodes; code += kJointThreads) {
      const int x = bin(code, code);
      if (x) atomicAdd(hist + code, x);
    }
    return;
  }
  const int wb = NCH == 1 ? a.d : a.w;  // magnitude bits of a chunk
  const int sides = 1 + a.s;
  const int64_t vrows = int64_t{1} << (a.s + wb);
  const int span = (1 << wb) >> a.parts_log2;
  const int64_t items = int64_t{NCH} * sides * ncodes << a.parts_log2;
  for (int64_t it = threadIdx.x; it < items; it += kJointThreads) {
    const int code = static_cast<int>(it % ncodes);
    int64_t r = it / ncodes;
    const int part = static_cast<int>(r & ((1 << a.parts_log2) - 1));
    r >>= a.parts_log2;
    const int side = static_cast<int>(r % sides);
    const int j = static_cast<int>(r / sides);
    const int64_t tb = j == 0 ? 0 : a.base1;
    int cnt = 0, mx = -1, mn = -1;
    int acc[kJointMaxBits];
#pragma unroll
    for (int b = 0; b < kJointMaxBits; ++b) acc[b] = 0;
    for (int m = part * span; m < (part + 1) * span; ++m) {
      const int x = bin(tb + (((static_cast<int64_t>(m) << a.s) | side) << a.cb) + code, it);
      if (!x) continue;
      cnt += x;
#pragma unroll
      for (int b = 0; b < kJointMaxBits; ++b)
        if (b < wb && ((m >> b) & 1)) acc[b] += x;
      mx = m;
      if (mn < 0) mn = m;
    }
    if (j == 0) {
      const int all = cnt + (side == 0 && part == 0 ? bin((vrows << a.cb) + code, it) : 0);
      if (all) atomicAdd(hist + code, all);
      if (cnt) atomicAdd(hist + a.g + code, cnt);
    }
#pragma unroll
    for (int b = 0; b < kJointMaxBits; ++b) {
      const int p = j * wb + b;
      if (b < wb && p < a.d && acc[b])
        atomicAdd(hist + static_cast<int64_t>(2 + side * a.d + p) * a.g + code, acc[b]);
    }
    if (NCH == 1 && mm && mx >= 0) {  // one chunk: m is the whole magnitude
      atomicMax(mm + (2 * side) * a.g + code, mx);
      atomicMin(mm + (2 * side + 1) * a.g + code, mn);
    }
  }
}

template <int NT, int NCH, bool STRIPE>
int launch_joint(const JointArgs& a, int64_t s, int64_t w, int* hist, int* mm,
                 cudaStream_t stream) {
  auto kern = groupby_joint_kernel<NT, NCH, STRIPE>;
  const size_t smem = static_cast<size_t>(a.bins) * (STRIPE ? 32 : 1) * sizeof(int);
  const int64_t chunks = (w + kJointThreads - 1) / kJointThreads;
  const int64_t tiles = s * chunks;
  int64_t grid = 0;
  cudaError_t e = persistent_grid(kern, kJointThreads, smem, tiles, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<static_cast<unsigned>(grid), kJointThreads, smem, stream>>>(a, w, chunks, tiles, hist,
                                                                      mm);
  return static_cast<int>(cudaGetLastError());
}

template <int NCH, bool STRIPE>
int dispatch_joint_nt(const JointArgs& a, int64_t s, int64_t w, int* hist, int* mm,
                      cudaStream_t stream) {
  if (a.np <= 8) return launch_joint<1, NCH, STRIPE>(a, s, w, hist, mm, stream);
  if (a.np <= 16) return launch_joint<2, NCH, STRIPE>(a, s, w, hist, mm, stream);
  return launch_joint<3, NCH, STRIPE>(a, s, w, hist, mm, stream);
}

// The joint arm's layout for a shape, or false where it does not fit.  Rows
// are 2^cb bins apart (codes >= g, dropped, leave their bins empty).
bool joint_layout(JointArgs& a, int64_t cb, int64_t d, int64_t g, bool has_planes, bool is_signed,
                  bool minmax, int* nch) {
  a.cb = static_cast<int>(cb);
  a.s = has_planes && is_signed ? 1 : 0;
  a.d = has_planes ? static_cast<int>(d) : 0;
  a.np = has_planes ? a.cb + a.s + a.d + 1 : a.cb;
  a.g = static_cast<int>(g);
  a.w = a.d;
  a.base1 = 0;
  if (a.np > kJointSlots) return false;
  const int64_t gp = int64_t{1} << cb;
  if (!has_planes) {
    *nch = 0;
    a.bins = gp;
    return gp <= kJointMaxBins;
  }
  for (int n = 1; n <= (minmax ? 1 : 2); ++n) {
    const int wb = (a.d + n - 1) / n;
    if (wb > kJointMaxBits) continue;
    const int64_t vrows = int64_t{1} << (a.s + wb);
    const int64_t bins = gp * (vrows + 1) + (n - 1) * gp * vrows;
    if (bins > kJointMaxBins) continue;
    *nch = n;
    a.w = wb;
    a.base1 = gp * (vrows + 1);
    a.bins = bins;
    return true;
  }
  return false;
}

// ---------------------------------------------------------------------------
// groupby_table_kernel: the (K, G)-table arm of groupby_fused (see above).
// One thread per word: it skips the word when no column is valid, loads the
// code, exists, sign and magnitude words once into registers, composes the
// codes and magnitudes of 8 columns at a time by 8x8 bit transposes, and
// adds each valid column's payload to a (K, G) table (1 + [exists] +
// popcount(magnitude) atomics), in shared memory when the table fits 100 KB
// (zeroed once per block and added into the output with one atomic per
// nonzero entry at the end) and as global atomics straight into the output
// otherwise.  CBMAX and DMAX bound the register arrays; the launcher picks
// the smallest instance that holds CB and d.
// ---------------------------------------------------------------------------
constexpr int kFusedChunk = 2048;                 // words per tile
constexpr size_t kFusedSharedMax = 100 * 1024;    // larger tables go global

template <int DMAX>
struct MagType { using T = uint32_t; };
template <>
struct MagType<64> { using T = uint64_t; };

template <int CBMAX, int DMAX, bool SHARED>
__global__ void __launch_bounds__(kThreads)
groupby_table_kernel(const uint32_t* __restrict__ cp, int64_t cp_ss, int cb,
                     const uint32_t* __restrict__ valid, int64_t va_ss,
                     const uint32_t* __restrict__ planes, int64_t pl_ss, int d,
                     int64_t w, int64_t chunks, int64_t tiles, int g, int k,
                     int is_signed, int* __restrict__ hist, int* __restrict__ mm) {
  using Mag = typename MagType<DMAX>::T;
  extern __shared__ int smem[];
  const bool do_mm = mm != nullptr;
  const int big = do_mm ? (1 << d) : 0;  // the wrapper keeps d <= 30 with mm
  int* tab = hist;
  int* mmt = mm;
  if (SHARED) {
    tab = smem;
    mmt = smem + static_cast<int64_t>(k) * g;
    for (int i = threadIdx.x; i < k * g; i += kThreads) tab[i] = 0;
    if (do_mm)
      for (int i = threadIdx.x; i < 4 * g; i += kThreads) mmt[i] = ((i / g) & 1) ? big : -1;
    __syncthreads();
  }
  const int64_t neg_row = static_cast<int64_t>(2 + d) * g;

  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t shard = t / chunks;
    const int64_t base = (t % chunks) * kFusedChunk;
    const int64_t end = base + kFusedChunk < w ? base + kFusedChunk : w;
    const uint32_t* cps = cp + shard * cp_ss;
    const uint32_t* vas = valid + shard * va_ss;
    const uint32_t* pls = planes ? planes + shard * pl_ss : nullptr;
    for (int64_t i = base + threadIdx.x; i < end; i += kThreads) {
      uint32_t v = __ldg(vas + i);
      if (!v) continue;
      uint32_t cw[CBMAX];
#pragma unroll
      for (int b = 0; b < CBMAX; ++b) cw[b] = b < cb ? __ldg(cps + b * w + i) : 0u;
      uint32_t ex = 0, sg = 0;
      uint32_t mw[DMAX > 0 ? DMAX : 1] = {};
      if (DMAX > 0 && pls) {
        ex = __ldg(pls + i) & v;
        sg = is_signed ? __ldg(pls + w + i) : 0u;
#pragma unroll
        for (int p = 0; p < DMAX; ++p) mw[p] = p < d ? __ldg(pls + (2 + p) * w + i) : 0u;
      }
      constexpr int NC = CBMAX / 8, NM = DMAX > 0 ? DMAX / 8 : 1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // codes and magnitudes 8 columns at a time
        const uint32_t vb = (v >> (8 * j)) & 0xFFu;
        if (!vb) continue;
        uint32_t clo[NC], chi[NC], mlo[NM], mhi[NM];
#pragma unroll
        for (int g8 = 0; g8 < NC; ++g8) PT_TRANSPOSE8(cw, 8 * g8, j, clo[g8], chi[g8]);
        if constexpr (DMAX > 0) {
#pragma unroll
          for (int g8 = 0; g8 < NM; ++g8) PT_TRANSPOSE8(mw, 8 * g8, j, mlo[g8], mhi[g8]);
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (!((vb >> c) & 1u)) continue;
          const int bit = 8 * j + c;
          const uint32_t code = static_cast<uint32_t>(c < 4 ? col_bits(clo, c) : col_bits(chi, c - 4));
          if (code >= static_cast<uint32_t>(g)) continue;
          atomicAdd(tab + code, 1);
          if (DMAX == 0 || !((ex >> bit) & 1u)) continue;
          atomicAdd(tab + g + code, 1);
          const Mag mag = static_cast<Mag>(c < 4 ? col_bits(mlo, c) : col_bits(mhi, c - 4));
          const bool neg = (sg >> bit) & 1u;
          int* row = tab + (neg ? neg_row : 2 * static_cast<int64_t>(g)) + code;
          for (Mag m = mag; m; m &= m - 1)
            atomicAdd(row + static_cast<int64_t>(lowest_bit(m)) * g, 1);
          if (do_mm) {
            const int side = neg ? 2 : 0;
            atomicMax(mmt + side * g + code, static_cast<int>(mag));
            atomicMin(mmt + (side + 1) * g + code, static_cast<int>(mag));
          }
        }
      }
    }
  }

  if (SHARED) {
    __syncthreads();
    for (int i = threadIdx.x; i < k * g; i += kThreads) {
      const int x = tab[i];
      if (x) atomicAdd(hist + i, x);
    }
    if (do_mm) {
      for (int i = threadIdx.x; i < 4 * g; i += kThreads) {
        const int x = mmt[i];
        if ((i / g) & 1) {
          if (x != big) atomicMin(mm + i, x);
        } else if (x >= 0) {
          atomicMax(mm + i, x);
        }
      }
    }
  }
}

template <int CBMAX, int DMAX, bool SHARED>
int launch_table(const uint32_t* cp, int64_t cp_ss, int cb, const uint32_t* valid,
                 int64_t va_ss, const uint32_t* planes, int64_t pl_ss, int d, int64_t s,
                 int64_t w, int g, int k, int is_signed, int* hist, int* mm, size_t smem,
                 cudaStream_t stream) {
  auto kern = groupby_table_kernel<CBMAX, DMAX, SHARED>;
  const int64_t chunks = (w + kFusedChunk - 1) / kFusedChunk;
  const int64_t tiles = s * chunks;
  int64_t grid = 0;
  cudaError_t e = persistent_grid(kern, kThreads, smem, tiles, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      cp, cp_ss, cb, valid, va_ss, planes, pl_ss, d, w, chunks, tiles, g, k, is_signed, hist,
      mm);
  return static_cast<int>(cudaGetLastError());
}

template <int CBMAX, bool SHARED>
int dispatch_depth(const uint32_t* cp, int64_t cp_ss, int cb, const uint32_t* valid,
                   int64_t va_ss, const uint32_t* planes, int64_t pl_ss, int d, int64_t s,
                   int64_t w, int g, int k, int is_signed, int* hist, int* mm, size_t smem,
                   cudaStream_t stream) {
#define PT_TABLE(DM)                                                                        \
  return launch_table<CBMAX, DM, SHARED>(cp, cp_ss, cb, valid, va_ss, planes, pl_ss, d, s, w, \
                                         g, k, is_signed, hist, mm, smem, stream)
  if (!planes) PT_TABLE(0);
  if (d <= 8) PT_TABLE(8);
  if (d <= 16) PT_TABLE(16);
  if (d <= 32) PT_TABLE(32);
  PT_TABLE(64);
#undef PT_TABLE
}


// ---------------------------------------------------------------------------
// groupby_onehot: the one-pass histogram on the int8 tensor cores.
//   Inputs as groupby_fused (any shard stride), without the Min/Max table;
//   G <= 4096, d <= 16 (K <= 34) -> hist (K, G), zeroed by the caller.
// Replaces pilosa_tpu/ops/kernels.py groupby_onehot (Pallas, f32 MXU one-hot
// matmuls): hist = payload (K, columns) x one-hot (columns, G), a sum of 0/1
// products, accumulated exactly in int32 by wmma m16n16k16 s8 x s8 -> s32.
// Bound: the larger of the bytes groupby_fused reads and the tensor work,
// 2*K*G operations a column at 1979 TOP/s (int8, dense).  Design: a
// persistent grid walks (shard, 256-column) tiles; gridDim.y splits G into
// groups of 128*SPW codes, and each of the 8 warps owns SPW 16-code slices
// of its group, with MT x SPW accumulator fragments (MT = ceil(K/16) payload
// tiles) resident in registers across all of its tiles.  Per tile:
// 1. one thread per column reads its bit of each plane word, composes the
//    column's code and its 0/1 payload rows [valid, nn, pos x d, neg x d]
//    (the row order of _gc_payload_rows; an invalid column's payload is all
//    zero) and stores them to shared memory as an int8 (columns x 16)
//    column-major A tile per 16 payload rows, one 16-byte store each;
// 2. each warp, per slice, writes the (columns x 16) one-hot of the tile's
//    codes into its own shared B buffer (one 16-byte row a column), skips
//    the slice when no code falls in it, and runs 16 k-steps of mma per
//    payload tile.
// At the end each warp stores its fragments through shared memory and adds
// them to hist with one atomic per nonzero (k, g).  A tile with no valid
// column is skipped whole; codes >= G, and columns with valid = 0, add
// nothing.  The K = 1 value histogram pads A to 16 rows, so its tensor work
// is 16x what it needs.
// ---------------------------------------------------------------------------
constexpr int kOhCols = kThreads;  // columns per tile: one a thread (8 words)

__device__ __forceinline__ uint32_t spread4(uint64_t bits) {
  // bits 0..3 -> bytes 0..3 of a word, each 0 or 1
  const uint32_t n = static_cast<uint32_t>(bits) & 0xFu;
  return (n & 1u) | ((n & 2u) << 7) | ((n & 4u) << 14) | ((n & 8u) << 21);
}

template <int MT, int SPW>
__global__ void __launch_bounds__(kThreads)
groupby_onehot_kernel(const uint32_t* __restrict__ cp, int64_t cp_ss, int cb,
                      const uint32_t* __restrict__ valid, int64_t va_ss,
                      const uint32_t* __restrict__ planes, int64_t pl_ss, int d,
                      int64_t w, int64_t chunks, int64_t tiles, int g, int k,
                      int is_signed, int* __restrict__ hist) {
  using namespace nvcuda;
  __shared__ __align__(32) signed char sa[MT * kOhCols * 16];
  __shared__ __align__(32) signed char sb[kWarps * kOhCols * 16];
  __shared__ int scode[kOhCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g_group = blockIdx.y * (kWarps * SPW * 16);
  signed char* mb = sb + warp * (kOhCols * 16);

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[MT][SPW];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < SPW; ++j) wmma::fill_fragment(acc[mt][j], 0);

  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t shard = t / chunks;
    const int64_t word = (t % chunks) * (kOhCols / 32) + warp;
    uint32_t va = 0;
    int code = -1;
    uint64_t rows = 0;  // bit r = payload row r of this column
    if (word < w) {
      va = (__ldg(valid + shard * va_ss + word) >> lane) & 1u;
      if (va) {
        const uint32_t* cps = cp + shard * cp_ss + word;
        code = 0;
        for (int b = 0; b < cb; ++b) code |= static_cast<int>((__ldg(cps + b * w) >> lane) & 1u) << b;
        rows = 1;
        if (planes) {
          const uint32_t* pls = planes + shard * pl_ss + word;
          if ((__ldg(pls) >> lane) & 1u) {
            const bool neg = is_signed && ((__ldg(pls + w) >> lane) & 1u);
            uint64_t mag = 0;
            for (int p = 0; p < d; ++p) mag |= static_cast<uint64_t>((__ldg(pls + (2 + p) * w) >> lane) & 1u) << p;
            rows |= 2u | (mag << (neg ? 2 + d : 2));
          }
        }
      }
    }
    __syncthreads();  // the previous tile's products are done with sa and scode
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint64_t r = rows >> (16 * mt);
      reinterpret_cast<uint4*>(sa + mt * kOhCols * 16)[threadIdx.x] =
          make_uint4(spread4(r), spread4(r >> 4), spread4(r >> 8), spread4(r >> 12));
    }
    scode[threadIdx.x] = code;
    if (!__syncthreads_or(va)) continue;  // no valid column in the tile

#pragma unroll
    for (int j = 0; j < SPW; ++j) {
      const int gs = g_group + (warp + kWarps * j) * 16;
      if (gs < g) {  // warp-uniform
        __syncwarp();  // the previous slice's loads are done with mb
        bool any = false;
        for (int c = lane; c < kOhCols; c += 32) {
          const int rel = scode[c] - gs;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (rel >= 0 && rel < 16) {
            any = true;
            const uint32_t one = 1u << ((rel & 3) * 8);
            const int q = rel >> 2;
            v = make_uint4(q == 0 ? one : 0u, q == 1 ? one : 0u, q == 2 ? one : 0u,
                           q == 3 ? one : 0u);
          }
          reinterpret_cast<uint4*>(mb)[c] = v;
        }
        if (__any_sync(0xffffffffu, any)) {
          __syncwarp();
          for (int ks = 0; ks < kOhCols / 16; ++ks) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, mb + ks * 256, 16);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::col_major> fa;
              wmma::load_matrix_sync(fa, sa + mt * kOhCols * 16 + ks * 256, 16);
              wmma::mma_sync(acc[mt][j], fa, fb, acc[mt][j]);
            }
          }
        }
      }
    }
  }

  int* scratch = reinterpret_cast<int*>(mb);  // 256 ints of the warp's own B buffer
#pragma unroll
  for (int j = 0; j < SPW; ++j) {
    const int gs = g_group + (warp + kWarps * j) * 16;
    if (gs >= g) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      __syncwarp();
      wmma::store_matrix_sync(scratch, acc[mt][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int i = lane; i < 256; i += 32) {
        const int kk = mt * 16 + (i >> 4);
        const int gg = gs + (i & 15);
        const int v = scratch[i];
        if (v && kk < k && gg < g) atomicAdd(hist + static_cast<int64_t>(kk) * g + gg, v);
      }
    }
  }
}

template <int MT, int SPW>
int launch_onehot(const uint32_t* cp, int64_t cp_ss, int cb, const uint32_t* valid,
                  int64_t va_ss, const uint32_t* planes, int64_t pl_ss, int d, int64_t s,
                  int64_t w, int g, int k, int is_signed, int* hist, cudaStream_t stream) {
  auto kern = groupby_onehot_kernel<MT, SPW>;
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t chunks = (w + kOhCols / 32 - 1) / (kOhCols / 32);
  const int64_t tiles = s * chunks;
  const int groups = (g + kWarps * SPW * 16 - 1) / (kWarps * SPW * 16);
  int64_t gx = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sm_count() / groups;
  if (gx < 1) gx = 1;
  if (gx > tiles) gx = tiles;
  kern<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(groups)), kThreads, 0, stream>>>(
      cp, cp_ss, cb, valid, va_ss, planes, pl_ss, d, w, chunks, tiles, g, k, is_signed, hist);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// groupby_sum: per-combo GroupBy count and BSI Sum partials.
//   nf stacks (R_f, S, W), sel (C, nf) row indices, planes (S, 2+d, W) or
//   null -> counts (C,), nn (C,), pos (C, d), neg (C, d), zeroed by the caller.
// For combo c, m = AND_f stack_f[sel[c, f]]; counts = popcount(m),
// nn = popcount(m & exists), pos[p] = popcount(mag_p & m & exists & ~sign),
// neg[p] = popcount(mag_p & m & exists & sign) (unsigned: pos takes every
// exists column and neg stays zero).
// Replaces pilosa_tpu/ops/kernels.py groupby_sum (Pallas, combos innermost).
// Bound: the larger of the bytes (each distinct stack row that sel
// references, plus the planes, the sign plane only when signed, read once;
// S*W words each, over 3.35 TB/s) and the popcounts (C x (2 + d) a word, or
// C x (2 + 2d) signed, at the card's __popc rate).  The first port staged
// each (shard, chunk) tile's planes with a chain of dependent loads and then
// paid a block barrier and 2 + 2d warp reductions for every combo: 1.04 ms
// of staging and 0.35 ms a combo, latency rather than either bound.
// Design: a persistent grid (SMs x resident blocks) walks (shard, 256*WPT
// word) tiles through a ring in shared memory, filled by cp.async
// (__pipeline_memcpy_async, 16 bytes a copy where the rows are 16-byte
// aligned, zero-filled past W) while the block counts an earlier tile: 2
// stages where two blocks then fit an SM, else up to 4 in one block.  A
// stage holds the exists plane, the sign plane when signed and the d
// magnitude planes, and, when the fields have at most kMaxStagedRows rows
// in all, each field's rows, so a row shared by several combos (the `a` row
// of GroupBy(Rows(t), Rows(a))) is read from device memory once a tile;
// otherwise each combo reads its rows from global memory.  sel, as ring slots
// or row indices, sits in shared memory for the pass.  Each thread owns WPT
// words of a tile, holds their exists, sign and (d <= 16) magnitude words in
// registers across the combos, and keeps its own partials in shared memory, two 16-bit
// counters a word, [combo][pair][thread]: adding a combo's counts is one load,
// add and store a pair, with no barrier and no reduction; the pairs are
// flushed (one warp reduction a pair and one global atomic an output) at the
// end of the walk, and after every 65535 / (32 * WPT) tiles before a 16-bit
// counter could overflow.  Combos that do not fit shared memory in one pass
// take further passes over the tiles.  `signed` is a template parameter:
// the unsigned instance neither stages the sign plane nor counts a neg side.
// ---------------------------------------------------------------------------
constexpr int kSumThreads = 256;
constexpr int kMaxFields = 8;
constexpr int kMaxStagedRows = 16;
constexpr int kSumStages = 4;

struct SumArgs {
  const uint32_t* stack[kMaxFields];  // field f's (R_f, S, W) rows
  int row_base[kMaxFields];           // field f's first row slot (staged rows)
  int rows[kMaxFields];               // R_f
  int nf;
  const int* sel;                     // (C, nf)
  int64_t c;
  int cc;                             // combos a pass
  const uint32_t* planes;             // (S, 2+d, W) or null
  int d;
  int k2;                             // partial pairs a combo
  int npl;                            // plane slots a stage: exists, [sign], magnitudes
  int nslot;                          // slots a stage: planes, then staged rows
  int vec;                            // 16-byte copies
  int nstage;                         // ring stages
  int64_t s, w;
  int* counts;
  int* nn;
  int* pos;
  int* neg;
};

template <int PER>
__device__ __forceinline__ void copy_words(uint32_t* dst, const uint32_t* src, int64_t left) {
  if (left >= PER) {
    __pipeline_memcpy_async(dst, src, PER * sizeof(uint32_t));
  } else if (left > 0) {
    __pipeline_memcpy_async(dst, src, PER * sizeof(uint32_t),
                            static_cast<size_t>(PER - left) * sizeof(uint32_t));
  } else {
#pragma unroll
    for (int k = 0; k < PER; ++k) dst[k] = 0u;
  }
}

// The per-combo pass over ring stage b: each of the ncur combos' counts
// on the thread's WPT words, added into its 16-bit partial pairs.  DMAX > 0
// holds the d <= DMAX magnitude words in registers across the combos;
// DMAX = 0 reads them from the stage for each combo.
template <bool SIGNED, bool STAGED, int WPT, int DMAX>
__device__ __forceinline__ void sum_tile(const SumArgs& a, const uint32_t* b, int64_t shard,
                                         int64_t base, int ncur, const int* ssel,
                                         uint32_t* part) {
  constexpr int TW = kSumThreads * WPT;
  const int tid = threadIdx.x;
  const int off = tid * WPT;
  auto words = [&](int q, uint32_t (&x)[WPT]) {
    if (WPT == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(b + q * TW + off);
      x[0] = v.x;
      x[WPT - 1] = v.y;
    } else {
      x[0] = b[q * TW + off];
    }
  };
  auto popc = [](const uint32_t (&x)[WPT]) {
    int n = 0;
#pragma unroll
    for (int k = 0; k < WPT; ++k) n += __popc(x[k]);
    return n;
  };
  // plane slots: exists, [sign], then magnitude p at mag0 + p
  constexpr int mag0 = SIGNED ? 2 : 1;
  uint32_t ex[WPT] = {}, sg[WPT] = {};
  uint32_t mg[DMAX > 0 ? DMAX : 1][WPT];
  if (a.planes) {
    words(0, ex);
    if (SIGNED) words(1, sg);
#pragma unroll
    for (int p = 0; p < DMAX; ++p) {
      if (p < a.d) {
        words(mag0 + p, mg[p]);
      } else {
#pragma unroll
        for (int k = 0; k < WPT; ++k) mg[p][k] = 0u;
      }
    }
  }
  for (int ci = 0; ci < ncur; ++ci) {
    uint32_t x[WPT];
#pragma unroll
    for (int k = 0; k < WPT; ++k) x[k] = ~0u;
#pragma unroll
    for (int f = 0; f < kMaxFields; ++f) {
      if (f >= a.nf) break;
      const int r = ssel[ci * a.nf + f];
      uint32_t y[WPT];
      if (STAGED) {
        words(r, y);
      } else {
        const uint32_t* src = a.stack[f] + (static_cast<int64_t>(r) * a.s + shard) * a.w + base;
#pragma unroll
        for (int k = 0; k < WPT; ++k) y[k] = base + k < a.w ? __ldg(src + k) : 0u;
      }
#pragma unroll
      for (int k = 0; k < WPT; ++k) x[k] &= y[k];
    }
    uint32_t* pp = part + static_cast<int64_t>(ci) * a.k2 * kSumThreads + tid;
    const int n = popc(x);
    if (!a.planes) {
      pp[0] += static_cast<uint32_t>(n);
      continue;
    }
    uint32_t xp[WPT], xn[WPT];
#pragma unroll
    for (int k = 0; k < WPT; ++k) {
      x[k] &= ex[k];
      xp[k] = SIGNED ? x[k] & ~sg[k] : x[k];
      xn[k] = SIGNED ? x[k] & sg[k] : 0u;
    }
    pp[0] += static_cast<uint32_t>(n) | (static_cast<uint32_t>(popc(x)) << 16);
    // pair (lo, hi): signed (pos p, neg p) at 1 + p; unsigned (pos p, pos p+1) at 1 + p/2
    auto pair = [&](int p, const uint32_t (&m0)[WPT], const uint32_t (&m1)[WPT]) {
      uint32_t y0[WPT], y1[WPT];
#pragma unroll
      for (int k = 0; k < WPT; ++k) {
        y0[k] = xp[k] & m0[k];
        y1[k] = (SIGNED ? xn[k] : xp[k]) & m1[k];
      }
      pp[(SIGNED ? 1 + p : 1 + p / 2) * kSumThreads] +=
          static_cast<uint32_t>(popc(y0)) | (static_cast<uint32_t>(popc(y1)) << 16);
    };
    if constexpr (DMAX > 0) {
#pragma unroll
      for (int p = 0; p < (DMAX > 0 ? DMAX : 1); p += SIGNED ? 1 : 2) {
        if (p >= a.d) break;
        pair(p, mg[p], SIGNED ? mg[p] : mg[p + 1 < DMAX ? p + 1 : p]);
      }
    } else {
      for (int p = 0; p < a.d; p += SIGNED ? 1 : 2) {
        uint32_t m0[WPT], m1[WPT] = {};
        words(mag0 + p, m0);
        if (SIGNED) {
          pair(p, m0, m0);
        } else {
          if (p + 1 < a.d) words(mag0 + p + 1, m1);
          pair(p, m0, m1);
        }
      }
    }
  }
}

template <bool SIGNED, bool STAGED, int WPT, int DMAX>
__global__ void __launch_bounds__(kSumThreads)
groupby_sum_kernel(const SumArgs a, int64_t chunks, int64_t tiles) {
  constexpr int TW = kSumThreads * WPT;                 // words a tile
  constexpr int kFlushTiles = 65535 / (32 * WPT);       // before a 16-bit counter overflows
  extern __shared__ uint32_t smem_u[];
  const int64_t stage_words = static_cast<int64_t>(a.nslot) * TW;
  uint32_t* ring = smem_u;                                      // nstage x nslot x TW
  uint32_t* part = ring + a.nstage * stage_words;               // cc x k2 x threads
  // each ring slot's words in shard 0 and its shard stride
  const uint32_t** slot_src = reinterpret_cast<const uint32_t**>(
      part + static_cast<int64_t>(a.cc) * a.k2 * kSumThreads);
  int64_t* slot_ss = reinterpret_cast<int64_t*>(slot_src + a.nslot);
  int* ssel = reinterpret_cast<int*>(slot_ss + a.nslot);     // cc x nf
  const int tid = threadIdx.x;

  for (int q = tid; q < a.nslot; q += kSumThreads) {
    if (q < a.npl) {  // exists, [sign], magnitudes
      slot_src[q] = a.planes + (q == 0 ? 0 : (SIGNED ? q : q + 1)) * a.w;
      slot_ss[q] = (2 + a.d) * a.w;
      continue;
    }
    const int r = q - a.npl;
#pragma unroll
    for (int f = 0; f < kMaxFields; ++f)
      if (f < a.nf && r >= a.row_base[f] && r < a.row_base[f] + a.rows[f])
        slot_src[q] = a.stack[f] + static_cast<int64_t>(r - a.row_base[f]) * a.s * a.w;
    slot_ss[q] = a.w;
  }

  // cp.async of tile t into ring stage `stage`, zero past W
  auto fill = [&](int64_t t, int stage) {
    const int64_t shard = t / chunks;
    const int64_t base = (t % chunks) * TW;
    uint32_t* dst = ring + stage * stage_words;
    if (a.vec) {
      for (int it = tid; it < a.nslot * (TW / 4); it += kSumThreads) {
        const int q = it / (TW / 4);
        const int k = (it % (TW / 4)) * 4;
        copy_words<4>(dst + q * TW + k, slot_src[q] + shard * slot_ss[q] + base + k,
                      a.w - base - k);
      }
    } else {
      for (int it = tid; it < a.nslot * TW; it += kSumThreads) {
        const int q = it / TW;
        const int k = it % TW;
        copy_words<1>(dst + q * TW + k, slot_src[q] + shard * slot_ss[q] + base + k,
                      a.w - base - k);
      }
    }
  };

  auto add = [](int* out, int v) {
    if (v) atomicAdd(out, v);
  };

  // sum each partial pair over the threads into the outputs, and zero it
  auto flush = [&](int64_t c0, int ncur) {
    const int lane = tid & 31;
    for (int row = tid >> 5; row < ncur * a.k2; row += kSumThreads / 32) {
      uint32_t* pr = part + static_cast<int64_t>(row) * kSumThreads;
      int lo = 0, hi = 0;
      for (int i = lane; i < kSumThreads; i += 32) {
        const uint32_t v = pr[i];
        lo += static_cast<int>(v & 0xFFFFu);
        hi += static_cast<int>(v >> 16);
        pr[i] = 0u;
      }
      lo = warp_sum(lo);
      hi = warp_sum(hi);
      if (lane) continue;
      const int64_t ci = c0 + row / a.k2;
      const int kk = row % a.k2;
      if (kk == 0) {
        add(a.counts + ci, lo);
        if (a.planes) add(a.nn + ci, hi);
      } else if (SIGNED) {
        add(a.pos + ci * a.d + kk - 1, lo);
        add(a.neg + ci * a.d + kk - 1, hi);
      } else {
        const int p = 2 * (kk - 1);
        add(a.pos + ci * a.d + p, lo);
        if (p + 1 < a.d) add(a.pos + ci * a.d + p + 1, hi);
      }
    }
  };

  for (int64_t c0 = 0; c0 < a.c; c0 += a.cc) {
    const int ncur = static_cast<int>(a.c - c0 < a.cc ? a.c - c0 : a.cc);
    for (int i = tid; i < ncur * a.nf; i += kSumThreads) {
      const int f = i % a.nf;
      int r = __ldg(a.sel + c0 * a.nf + i);
      if (STAGED) {
#pragma unroll
        for (int ff = 0; ff < kMaxFields; ++ff)
          if (ff == f) r += a.npl + a.row_base[ff];
      }
      ssel[i] = r;
    }
    for (int64_t i = tid; i < static_cast<int64_t>(ncur) * a.k2 * kSumThreads; i += kSumThreads)
      part[i] = 0u;
    __syncthreads();
    // nstage - 1 tiles in flight ahead of the one counted; one commit group
    // a tile (empty past the last), so wait_prior(nstage - 1) finds tile t's
    const int64_t step = gridDim.x;
    for (int k = 0; k < a.nstage - 1; ++k) {
      const int64_t tk = blockIdx.x + k * step;
      if (tk < tiles) fill(tk, k);
      __pipeline_commit();
    }
    int stage = 0, since = 0;
    for (int64_t t = blockIdx.x; t < tiles; t += step) {
      const int64_t ahead = t + (a.nstage - 1) * step;
      if (ahead < tiles) fill(ahead, (stage + a.nstage - 1) % a.nstage);
      __pipeline_commit();
      __pipeline_wait_prior(a.nstage - 1);
      __syncthreads();
      sum_tile<SIGNED, STAGED, WPT, DMAX>(a, ring + stage * stage_words, t / chunks,
                                          (t % chunks) * TW + tid * WPT, ncur, ssel, part);
      __syncthreads();  // the stage is refilled next, and a flush reads every thread's partials
      if (++since == kFlushTiles) {
        flush(c0, ncur);
        __syncthreads();
        since = 0;
      }
      stage = (stage + 1) % a.nstage;
    }
    __pipeline_wait_prior(0);
    flush(c0, ncur);
    __syncthreads();
  }
}

// The per-combo kernel's shared memory at WPT words a thread, or 0 where not
// even two stages and one combo fit.  Sets the combos a pass (a.cc: all in
// one pass where they fit) and the ring's stages (a.nstage): two where two
// blocks then fit an SM (16 warps), else as many as fit one block, up to
// kSumStages.
template <int WPT>
size_t sum_smem(SumArgs& a) {
  const size_t stage = static_cast<size_t>(a.nslot) * kSumThreads * WPT * sizeof(uint32_t);
  const size_t slots = static_cast<size_t>(a.nslot) * (sizeof(void*) + sizeof(int64_t));
  const size_t per_combo = static_cast<size_t>(a.k2) * kSumThreads * sizeof(uint32_t) +
                           static_cast<size_t>(a.nf) * sizeof(int);
  if (2 * stage + slots + per_combo > kSmemMax) return 0;
  const int64_t fit = static_cast<int64_t>((kSmemMax - 2 * stage - slots) / per_combo);
  a.cc = static_cast<int>(a.c < fit ? a.c : fit);
  const size_t fixed = slots + a.cc * per_combo;
  a.nstage = 2;
  if (2 * (2 * stage + fixed + 1024) > kSmemMax + 1024)
    while (a.nstage < kSumStages && (a.nstage + 1) * stage + fixed <= kSmemMax) ++a.nstage;
  return a.nstage * stage + fixed;
}

template <bool SIGNED, bool STAGED, int WPT, int DMAX>
int launch_sum(SumArgs a, size_t smem, cudaStream_t stream) {
  auto kern = groupby_sum_kernel<SIGNED, STAGED, WPT, DMAX>;
  const int64_t chunks = (a.w + kSumThreads * WPT - 1) / (kSumThreads * WPT);
  const int64_t tiles = a.s * chunks;
  int64_t grid = 0;
  cudaError_t e = persistent_grid(kern, kSumThreads, smem, tiles, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<static_cast<unsigned>(grid), kSumThreads, smem, stream>>>(a, chunks, tiles);
  return static_cast<int>(cudaGetLastError());
}

// Two words a thread with the magnitudes in registers where d <= 16; one
// word a thread, magnitudes read from the ring, where that is all that fits.
template <bool SIGNED, bool STAGED>
int dispatch_sum(SumArgs a, cudaStream_t stream) {
  size_t smem = sum_smem<2>(a);
  if (smem && a.d <= 8) return launch_sum<SIGNED, STAGED, 2, 8>(a, smem, stream);
  if (smem && a.d <= 16) return launch_sum<SIGNED, STAGED, 2, 16>(a, smem, stream);
  if (smem) return launch_sum<SIGNED, STAGED, 2, 0>(a, smem, stream);
  smem = sum_smem<1>(a);
  if (smem) return launch_sum<SIGNED, STAGED, 1, 0>(a, smem, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int pt_groupby_fused(const void* cp, int64_t cp_ss, int64_t cb, const void* valid,
                     int64_t va_ss, const void* planes, int64_t pl_ss, int64_t d, int64_t s,
                     int64_t w, int64_t g, int64_t is_signed, void* hist, void* mm,
                     void* stream) {
  if (cb > 24 || d > 63 || (mm && d > 30) || g < 1) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t* cpu = static_cast<const uint32_t*>(cp);
  const uint32_t* vau = static_cast<const uint32_t*>(valid);
  const uint32_t* plu = static_cast<const uint32_t*>(planes);
  int* h = static_cast<int*>(hist);
  int* m = static_cast<int*>(mm);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  JointArgs a{};
  int nch = 0;
  if (joint_layout(a, cb, d, g, plu != nullptr, is_signed != 0, m != nullptr, &nch)) {
    for (int b = 0; b < a.cb; ++b) {
      a.plane[b] = cpu + b * w;
      a.ss[b] = cp_ss;
    }
    for (int b = a.cb; b < a.np - 1 && plu; ++b) {  // sign, then magnitudes
      const int row = a.s && b == a.cb ? 1 : 2 + (b - a.cb - a.s);
      a.plane[b] = plu + row * w;
      a.ss[b] = pl_ss;
    }
    a.valid = vau;
    a.va_ss = va_ss;
    a.exists = plu;
    a.ex_ss = pl_ss;
    a.all_codes = g >= (int64_t{1} << cb);
    const int wb = nch == 1 ? a.d : a.w;
    const int64_t ncodes = g < (int64_t{1} << cb) ? g : (int64_t{1} << cb);
    const int64_t items = static_cast<int64_t>(nch) * (1 + a.s) * ncodes;
    a.parts_log2 = 0;
    while (nch && items << a.parts_log2 < kJointThreads && a.parts_log2 < wb) ++a.parts_log2;
    const bool stripe = a.bins <= kJointStripeBins;
    if (nch == 0)
      return stripe ? dispatch_joint_nt<0, true>(a, s, w, h, m, st)
                    : dispatch_joint_nt<0, false>(a, s, w, h, m, st);
    if (nch == 1)
      return stripe ? dispatch_joint_nt<1, true>(a, s, w, h, m, st)
                    : dispatch_joint_nt<1, false>(a, s, w, h, m, st);
    return dispatch_joint_nt<2, false>(a, s, w, h, m, st);
  }

  const int k = planes ? static_cast<int>(2 + (is_signed ? 2 : 1) * d) : 1;
  const size_t table = (static_cast<size_t>(k) + (mm ? 4 : 0)) * g * sizeof(int);
  const bool shared = table <= kFusedSharedMax;
  const int ci = static_cast<int>(cb), di = static_cast<int>(d), gi = static_cast<int>(g);
  const int sg = static_cast<int>(is_signed);
  const size_t smem = shared ? table : 0;
  if (cb <= 8) {
    if (shared)
      return dispatch_depth<8, true>(cpu, cp_ss, ci, vau, va_ss, plu, pl_ss, di, s, w, gi, k, sg,
                                     h, m, smem, st);
    return dispatch_depth<8, false>(cpu, cp_ss, ci, vau, va_ss, plu, pl_ss, di, s, w, gi, k, sg,
                                    h, m, smem, st);
  }
  if (shared)
    return dispatch_depth<24, true>(cpu, cp_ss, ci, vau, va_ss, plu, pl_ss, di, s, w, gi, k, sg,
                                    h, m, smem, st);
  return dispatch_depth<24, false>(cpu, cp_ss, ci, vau, va_ss, plu, pl_ss, di, s, w, gi, k, sg,
                                   h, m, smem, st);
}

int pt_groupby_onehot(const void* cp, int64_t cp_ss, int64_t cb, const void* valid,
                      int64_t va_ss, const void* planes, int64_t pl_ss, int64_t d, int64_t s,
                      int64_t w, int64_t g, int64_t is_signed, void* hist, void* stream) {
  if (cb > 24 || d > 16 || g < 1 || g > 4096) return static_cast<int>(cudaErrorInvalidValue);
  const int k = planes ? static_cast<int>(2 + (is_signed ? 2 : 1) * d) : 1;
  const uint32_t* cpu = static_cast<const uint32_t*>(cp);
  const uint32_t* vau = static_cast<const uint32_t*>(valid);
  const uint32_t* plu = static_cast<const uint32_t*>(planes);
  int* h = static_cast<int*>(hist);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ci = static_cast<int>(cb), di = planes ? static_cast<int>(d) : 0;
  const int gi = static_cast<int>(g), sg = static_cast<int>(is_signed);
  if (k <= 16)
    return launch_onehot<1, 8>(cpu, cp_ss, ci, vau, va_ss, plu, pl_ss, di, s, w, gi, k, sg, h, st);
  if (k <= 32)
    return launch_onehot<2, 4>(cpu, cp_ss, ci, vau, va_ss, plu, pl_ss, di, s, w, gi, k, sg, h, st);
  return launch_onehot<3, 2>(cpu, cp_ss, ci, vau, va_ss, plu, pl_ss, di, s, w, gi, k, sg, h, st);
}

int pt_groupby_sum(const void* const* stacks, const int64_t* rows, int64_t nf, const void* sel,
                   int64_t c, const void* planes, int64_t d, int64_t s, int64_t w,
                   int64_t is_signed, void* counts, void* nn, void* pos, void* neg,
                   void* stream) {
  if (nf < 1 || nf > kMaxFields || d > 63 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  SumArgs a{};
  a.nf = static_cast<int>(nf);
  bool aligned = w % 4 == 0;
  int64_t total_rows = 0;
  for (int f = 0; f < nf; ++f) {
    a.stack[f] = static_cast<const uint32_t*>(stacks[f]);
    a.rows[f] = static_cast<int>(rows[f]);
    a.row_base[f] = static_cast<int>(total_rows);
    total_rows += rows[f];
    aligned = aligned && reinterpret_cast<uintptr_t>(stacks[f]) % 16 == 0;
  }
  a.sel = static_cast<const int*>(sel);
  a.c = c;
  a.planes = static_cast<const uint32_t*>(planes);
  a.d = planes ? static_cast<int>(d) : 0;
  const bool sgn = planes && is_signed;
  a.k2 = !planes ? 1 : sgn ? 1 + a.d : 1 + (a.d + 1) / 2;
  a.npl = !planes ? 0 : (sgn ? 2 : 1) + a.d;
  aligned = aligned && reinterpret_cast<uintptr_t>(planes) % 16 == 0;
  const bool staged = total_rows <= kMaxStagedRows;
  a.nslot = a.npl + (staged ? static_cast<int>(total_rows) : 0);
  a.vec = aligned ? 1 : 0;
  a.s = s;
  a.w = w;
  a.counts = static_cast<int*>(counts);
  a.nn = static_cast<int*>(nn);
  a.pos = static_cast<int*>(pos);
  a.neg = static_cast<int*>(neg);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sgn) return staged ? dispatch_sum<true, true>(a, st) : dispatch_sum<true, false>(a, st);
  return staged ? dispatch_sum<false, true>(a, st) : dispatch_sum<false, false>(a, st);
}

}  // extern "C"
