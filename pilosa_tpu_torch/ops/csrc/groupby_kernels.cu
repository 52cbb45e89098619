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

// The columns of a word whose code (CBM planes q, cb of them) is < g:
// a bit-sliced compare.
template <int CBM>
__device__ __forceinline__ uint32_t below_g(const uint32_t (&q)[CBM], int cb, int g) {
  uint32_t lt = 0, eq = ~0u;
#pragma unroll
  for (int b = CBM - 1; b >= 0; --b) {
    if (b >= cb) continue;
    if ((g >> b) & 1) {
      lt |= eq & ~q[b];
      eq &= q[b];
    } else {
      eq &= ~q[b];
    }
  }
  return lt;
}

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
  if (!a.all_codes) v &= below_g(q, a.cb, a.g);  // keep the columns whose code < g
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

// ---------------------------------------------------------------------------
// groupby_onehot: the one-pass histogram on the int8 tensor cores.
//   Inputs as groupby_fused (any shard stride), without the Min/Max table;
//   G <= 4096, d <= 16 (K <= 34) -> hist (K, G), zeroed by the caller.
// Replaces pilosa_tpu/ops/kernels.py groupby_onehot (Pallas, f32 MXU one-hot
// matmuls): hist = payload (K, columns) x one-hot (columns, G), a sum of 0/1
// products, accumulated exactly in int32 by mma.sync m16n8k32 s8 x s8 -> s32.
// The payload rows are [valid, nn, pos x d, neg x d] (the row order of
// _gc_payload_rows; pos takes every exists column when unsigned); a column
// whose valid bit is clear or whose code is >= G has an all-zero payload.
//
// Bound: groupby_fused's, as it computes the same function: the larger of
// the bytes it reads and one operation a word read plus one a histogram
// increment; the bytes bind.  The one-hot form's own tensor work is not the
// function's: a warp takes one 32-column word at a time, and 32 columns
// touch at most 32 of the 8-code slices, so it is at most 2 * K *
// min(G, 256) int8 operations a column at 1979 TOP/s (the first port's
// dense 2 * K * G counted every slice of every tile): below the byte term
// for the value histogram (K = 1), 2-3.3x it at the able shapes (K = 9,
// 16).  The kernel is held by neither: by the instructions that build the
// fragments, ~170 a lane a word at the able shape (PERF.md).
//
// Design.  The first port staged a 256-column tile through shared memory,
// wrote a one-hot and a payload tile there for every slice and ran wmma on
// them behind two block barriers a tile: its loads, build and mma each take
// a fraction of its time, and their chain the rest (PERF.md).  Here:
// 1. Staging: a persistent grid walks (shard, kOhTile-word) tiles through a
//    kOhStages-deep cp.async ring (copy_words, as groupby_sum) holding every
//    plane a column needs: the code planes, valid, exists, [sign], the d
//    magnitudes.  No thread waits on a global load.
// 2. Words in batches of 8: lane group q loads word i0 + q's valid and code
//    words and transposes byte t of them once (transpose8: lo = the low code
//    bytes of columns 8t..8t+3, hi = those of 8t+4..8t+7, four to a
//    register; glo, ghi the second code byte where G > 256); each word of the
//    batch is then counted by the whole warp, its lanes shuffling the bytes
//    in from the owner.
// 3. Fragments are built in registers, never in shared memory.  A lane
//    (group q = lane / 4, thread t = lane % 4) owns the k-slots 4t..4t+3 and
//    16+4t..16+4t+3 of the m16n8k32 fragments; the kernel maps them to the
//    word's columns 8t..8t+3 and 8t+4..8t+7 (k is summed over, so any
//    permutation of it that A and B share is exact), which are the columns
//    of lo and hi.  PTX fragment layout (ISA, mma.m16n8k32 .s8): A (16x32,
//    row) a0 = row q, k 4t..4t+3; a1 = row q+8, same k; a2 = row q, k
//    16+4t..16+4t+3; a3 = row q+8, those k; B (32x8, col) b0 = k 4t..4t+3,
//    column q; b1 = k 16+4t..16+4t+3, column q; C/D (16x8) c0, c1 = row q,
//    columns 2t, 2t+1; c2, c3 = row q+8, the same columns.  Byte i of a
//    register is element i.  Two forms, by K:
//    - K > 8, the payload as A: m-tile mt holds payload rows 16mt..16mt+15,
//      a0 = spread4(P[16mt+q] >> 8t), a1 = spread4(P[16mt+q+8] >> 8t), a2, a3
//      the same >> (8t + 4), where P[r] is payload row r's 32 column bits
//      (whole-word ANDs of the planes).  B is the one-hot of the word's
//      columns against the 8 codes of a slice: byte j of b0 is 1 where
//      column 8t+j's code is slice base + q.  __vseteq4 would build it but
//      is no instruction on sm_90 (about 5 a register); instead the code
//      bits below the slice (= q) and above it (the range, the 256-code
//      group) are matched once a word by one byte-wise zero test, the two
//      low slice bits give 4 masks and the rest up to 8, and a slice's B is
//      one AND of two masks a register.  acc[s][mt]: c = (payload row, code
//      8s + 2t (+1)).  Where G spans several ranges, only the slices
//      present: each lane takes column 8t+q, and __reduce_or_sync of 1 <<
//      its slice (its code in the warp's range, valid) is the warp-uniform
//      mask of the slices the word touches; a word with none in the range
//      is skipped.  Where G fits one range (G <= 128, 8 or 16 slices) every
//      slice runs: a random word touches most of them, and the test cost
//      more than it saved.
//    - K <= 8 (the value histogram, a count-only GroupBy), factored: code =
//      128 * block + 16 * n + low.  A is the one-hot of the low nibble (a0 =
//      low == q over lo, a1 = low == q+8, a2, a3 the same over hi), built
//      once a word; B for payload row r and block b is the payload times
//      the one-hot of code bits 4..6 (== q) and of bits 7..11 (== b); the
//      owner lanes transpose the payload rows like the codes, so B is one
//      AND a register.  One mma covers 128 codes of one payload row: the
//      value histogram takes 2 mma a word where 16-code slices took ~10.
//      acc[b][r]: c = (code 128b + 16 * (2t (+1)) + q (+8), row r).
// 4. The accumulators stay in registers across all of a warp's words: a
//    warp holds a range of NS slices or blocks (64 registers a thread, 128
//    with 32 slices).  G past one range splits into ranges over the block's
//    warps (warps of one range take alternate batches of the tile) and, past
//    8 ranges, over gridDim.y.  At the end each warp adds its nonzero counts
//    to hist with one global atomic each.
// ---------------------------------------------------------------------------
constexpr int kOhThreads = 256;
constexpr int kOhWarps = kOhThreads / 32;
constexpr int kOhTile = 256;             // words of each plane a ring stage holds
constexpr int kOhPitch = kOhTile + 4;    // a plane's row in a stage: 16-byte aligned, 4 banks on
constexpr int kOhStages = 4;
constexpr int kOhMaxCodeBits = 24;
constexpr int kOhSlots = kOhMaxCodeBits + 3 + 16;  // code planes, valid, exists, sign, magnitudes

struct OnehotArgs {
  const uint32_t* src[kOhSlots];  // slot q's words in shard 0
  int64_t ss[kOhSlots];           // and its shard stride
  int nslot;
  int cb;          // code planes in slots [0, cb), valid in slot cb
  int has_planes;  // exists in slot cb + 1, then the sign when signed, then the magnitudes
  int is_signed;
  int d;
  int k;           // payload rows
  int g;           // codes
  int all_codes;   // g >= 2^cb: no code is dropped
  int ranges;      // code ranges of the instance's width
  int ranges_blk;  // ranges a block; gridDim.y = ceil(ranges / ranges_blk)
  int vec;         // 16-byte copies
  int64_t w, chunks, tiles;
  int* hist;
};

// bits 0..3 of x as bytes 0..3, each 0 or 1
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 1 in each byte of z that is zero, else 0
__device__ __forceinline__ uint32_t bytes_zero(uint32_t z) {
  return (~(((z & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | z) & 0x80808080u) >> 7;
}

// f (1 or 0 a byte) where bits 0..L-1 of the slice index in each byte
// (bit 0 of p[b], above it anything) equal those of s
template <int L>
__device__ __forceinline__ uint32_t slice_bytes(uint32_t f, const uint32_t (&p)[L], int s) {
#pragma unroll
  for (int b = 0; b < L; ++b) f &= ((s >> b) & 1) ? p[b] : ~p[b];
  return f;
}

// Payload row r of a word as masks on its planes' words:
// P = v & (ex | eo) & (m | mo) & ((sg ^ sx) | so) & kz, m read from `slot`.
struct PayRow {
  int slot;
  uint32_t eo, mo, sx, so, kz;
};

__device__ __forceinline__ PayRow pay_row(const OnehotArgs& a, int r) {
  PayRow p{a.cb, ~0u, ~0u, 0u, ~0u, 0u};  // absent: kz = 0
  if (r >= a.k) return p;
  p.kz = ~0u;
  if (r == 0) return p;  // valid
  p.eo = 0u;
  if (r == 1) return p;  // nn: valid & exists
  const int q = r - 2;   // pos q, or neg q - d
  p.slot = a.cb + 2 + a.is_signed + q % a.d;
  p.mo = 0u;
  if (a.is_signed) {
    p.so = 0u;
    p.sx = q < a.d ? ~0u : 0u;
  }
  return p;
}

template <bool FACT, int MT, int NS, int CBM, bool MULTI, bool ONE>
__global__ void __launch_bounds__(kOhThreads)
groupby_onehot_kernel(const OnehotArgs a) {
  // FACT: MT payload rows and NS 128-code blocks a warp; else MT payload
  // m-tiles and NS 8-code slices a warp.  ONE: G fits one range of slices
  constexpr int RC = FACT ? NS * 128 : NS * 8;  // codes a range
  constexpr int NR = FACT ? MT : 2 * MT;        // payload rows a lane builds
  constexpr int NPT = FACT ? (MT + 7) / 8 : 1;  // FACT: transposes of 8 payload rows
  constexpr int LNS = NS == 32 ? 5 : NS == 16 ? 4 : NS == 8 ? 3 : NS == 4 ? 2 : NS == 2 ? 1 : 0;
  constexpr int LQ = LNS < 2 ? LNS : 2;  // slice bits resolved by the q masks, the rest by r
  constexpr int LR = LNS - LQ;
  constexpr uint32_t kRangeBits = (0xFFu << (3 + LNS)) & 0xFFu;
  // the code bits that match once a word: the lane's code within a slice,
  // and the range
  constexpr uint32_t kFixed = (7u | kRangeBits) * 0x01010101u;
  static_assert(FACT || (256 % RC == 0 && NS >= 4), "a range lies in one 256-code group");
  extern __shared__ __align__(16) uint32_t oh_smem[];
  const int64_t stage_words = static_cast<int64_t>(a.nslot) * kOhPitch;
  const uint32_t** slot_src =
      reinterpret_cast<const uint32_t**>(oh_smem + kOhStages * stage_words);
  int64_t* slot_ss = reinterpret_cast<int64_t*>(slot_src + a.nslot);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  for (int q = tid; q < a.nslot; q += kOhThreads) {
    slot_src[q] = a.src[q];
    slot_ss[q] = a.ss[q];
  }

  // the warp's code range, and which of the tile's words it takes
  const int parts = kOhWarps / a.ranges_blk;
  const int part = warp / a.ranges_blk;
  const int range = blockIdx.y * a.ranges_blk + warp % a.ranges_blk;
  const bool active = part < parts && range < a.ranges;
  const int code0 = range * RC;
  const uint32_t grp = static_cast<uint32_t>(code0 >> 8);
  // a code byte's range bits, and the lane's code within a slice (the B
  // fragment column it owns), in each byte
  const uint32_t rkey = static_cast<uint32_t>((code0 & 255) + gq) * 0x01010101u;
  const uint32_t grep = static_cast<uint32_t>(gq) * 0x01010101u;
  const int col = 8 * tq + gq;  // the column whose presence this lane reports
  const int blocks = (a.g + 127) >> 7;  // 128-code blocks (FACT)

  // FACT: the owner lanes' payload rows 0..MT-1; else the lane's own A rows
  PayRow pr[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) pr[i] = pay_row(a, FACT ? i : 16 * (i >> 1) + 8 * (i & 1) + gq);

  int acc[NS][MT][4];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][mt][e] = 0;

  // cp.async of tile t into ring stage `stage`, zero past W
  auto fill = [&](int64_t t, int stage) {
    const int64_t shard = t / a.chunks;
    const int64_t base = (t % a.chunks) * kOhTile;
    uint32_t* dst = oh_smem + stage * stage_words;
    if (a.vec) {
      for (int it = tid; it < a.nslot * (kOhTile / 4); it += kOhThreads) {
        const int q = it / (kOhTile / 4);
        const int k = (it % (kOhTile / 4)) * 4;
        copy_words<4>(dst + q * kOhPitch + k, slot_src[q] + shard * slot_ss[q] + base + k,
                      a.w - base - k);
      }
    } else {
      for (int it = tid; it < a.nslot * kOhTile; it += kOhThreads) {
        const int q = it / kOhTile;
        const int k = it % kOhTile;
        copy_words<1>(dst + q * kOhPitch + k, slot_src[q] + shard * slot_ss[q] + base + k,
                      a.w - base - k);
      }
    }
  };

  // A warp takes its words in batches of 8: lane group q loads word i0 + q's
  // valid and code words and transposes byte t of them (each transpose done
  // once, not by all 8 lanes of a t), then the batch's words are counted one
  // at a time, each lane shuffling in its 8 columns' code bytes.
  auto count = [&](const uint32_t* stg) {
    for (int i0 = 8 * part; i0 < kOhTile; i0 += 8 * parts) {
      const uint32_t* so = stg + i0 + gq;
      uint32_t vo = so[a.cb * kOhPitch];
      uint32_t q[CBM];
#pragma unroll
      for (int b = 0; b < CBM; ++b) q[b] = b < a.cb ? so[b * kOhPitch] : 0u;
      if (!a.all_codes) vo &= below_g(q, a.cb, a.g);
      uint32_t lo_o, hi_o, glo_o = 0u, ghi_o = 0u, plo_o[NPT] = {}, phi_o[NPT] = {};
      PT_TRANSPOSE8(q, 0, tq, lo_o, hi_o);
      if constexpr (MULTI) PT_TRANSPOSE8(q, 8, tq, glo_o, ghi_o);
      if constexpr (FACT) {  // the word's payload rows, transposed: byte bit r = row r
        uint32_t ex = 0u, sg = 0u;
        if (a.has_planes) {
          ex = so[(a.cb + 1) * kOhPitch];
          if (a.is_signed) sg = so[(a.cb + 2) * kOhPitch];
        }
        uint32_t p[8 * NPT];
#pragma unroll
        for (int r = 0; r < 8 * NPT; ++r) {
          const uint32_t m = r < NR ? so[pr[r < NR ? r : 0].slot * kOhPitch] : 0u;
          const PayRow& d = pr[r < NR ? r : 0];
          p[r] = r < NR ? vo & (ex | d.eo) & (m | d.mo) & ((sg ^ d.sx) | d.so) & d.kz : 0u;
        }
        if constexpr (MT == 1) {
          plo_o[0] = spread4(p[0] >> (8 * tq));
          phi_o[0] = spread4(p[0] >> (8 * tq + 4));
        } else {
#pragma unroll
          for (int j = 0; j < NPT; ++j) PT_TRANSPOSE8(p, 8 * j, tq, plo_o[j], phi_o[j]);
        }
      }
      const uint32_t live = __ballot_sync(~0u, vo != 0u);
#pragma unroll 1
      for (int w = 0; w < 8; ++w) {
        if (!((live >> (4 * w)) & 1u)) continue;  // warp-uniform
        const int src = 4 * w + tq;
        const uint32_t v = __shfl_sync(~0u, vo, src);
        const uint32_t lo = __shfl_sync(~0u, lo_o, src), hi = __shfl_sync(~0u, hi_o, src);
        uint32_t glo = 0u, ghi = 0u;
        if constexpr (MULTI) {
          glo = __shfl_sync(~0u, glo_o, src);
          ghi = __shfl_sync(~0u, ghi_o, src);
        }
        const uint32_t byte = __byte_perm(lo, hi, static_cast<uint32_t>(gq)) & 0xFFu;
        const uint32_t gbyte = __byte_perm(glo, ghi, static_cast<uint32_t>(gq)) & 0xFu;
        uint32_t in = (v >> col) & 1u;  // lane (q, t) reports column 8t + q
        if constexpr (FACT) {
          // A: the one-hot of the low code nibble, rows q and q + 8; B
          // (per payload row and 128-code block): the payload times the
          // one-hot of code bits 4..6 (column q) and of bits 7..11 (the block)
          uint32_t plo[NPT], phi[NPT];
#pragma unroll
          for (int j = 0; j < NPT; ++j) {
            plo[j] = __shfl_sync(~0u, plo_o[j], src);
            phi[j] = __shfl_sync(~0u, phi_o[j], src);
          }
          if (a.ranges > 1) {  // skip a word with no column in the warp's blocks
            const uint32_t blk = (gbyte << 1 | byte >> 7) - static_cast<uint32_t>(range * NS);
            if (!__any_sync(~0u, in && blk < NS)) continue;
          }
          const uint32_t el = bytes_zero((lo ^ grep) & 0x07070707u);
          const uint32_t eh = bytes_zero((hi ^ grep) & 0x07070707u);
          const uint32_t a0 = el & ~(lo >> 3), a1 = el & (lo >> 3);
          const uint32_t a2 = eh & ~(hi >> 3), a3 = eh & (hi >> 3);
          const uint32_t nl = bytes_zero(((lo >> 4) ^ grep) & 0x07070707u);
          const uint32_t nh = bytes_zero(((hi >> 4) ^ grep) & 0x07070707u);
          const uint32_t bl = ((lo >> 7) & 0x01010101u) | ((glo << 1) & 0x1E1E1E1Eu);
          const uint32_t bh = ((hi >> 7) & 0x01010101u) | ((ghi << 1) & 0x1E1E1E1Eu);
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const int blk = range * NS + s;
            if (blk >= blocks) break;
            const uint32_t brep = static_cast<uint32_t>(blk) * 0x01010101u;
            const uint32_t hl = nl & bytes_zero(bl ^ brep), hh = nh & bytes_zero(bh ^ brep);
#pragma unroll
            for (int r = 0; r < MT; ++r) {
              if (r >= a.k) break;
              mma_s8(acc[s][r], a0, a1, a2, a3, hl & (plo[r >> 3] >> (r & 7)),
                     hh & (phi[r >> 3] >> (r & 7)));
            }
          }
        } else {
          // the slices present, where G spans several ranges; with one
          // range every slice runs (a random word touches most of them,
          // and the test cost more than the mma it saved; slices past G
          // add zeros, their columns' payload being zero)
          uint32_t pm = NS >= 32 ? ~0u : (1u << NS) - 1u;
          if constexpr (!ONE) {
            if constexpr (MULTI) in &= gbyte == grp;
            in &= (byte & kRangeBits) == (rkey & kRangeBits);
            pm = __reduce_or_sync(~0u, in << ((byte >> 3) & (NS - 1)));
            if (!pm) continue;
          }

          const uint32_t* st = stg + i0 + w;
          uint32_t ex = 0u, sg = 0u;
          if (a.has_planes) {
            ex = st[(a.cb + 1) * kOhPitch];
            if (a.is_signed) sg = st[(a.cb + 2) * kOhPitch];
          }
          // A: the payload rows 16mt + q and 16mt + q + 8, as bytes
          uint32_t fa[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t x[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const PayRow& d = pr[2 * mt + h];
              const uint32_t m = st[d.slot * kOhPitch];
              x[h] = (v & (ex | d.eo) & (m | d.mo) & ((sg ^ d.sx) | d.so) & d.kz) >> (8 * tq);
            }
            fa[mt][0] = spread4(x[0]);
            fa[mt][1] = spread4(x[1]);
            fa[mt][2] = spread4(x[0] >> 4);
            fa[mt][3] = spread4(x[1] >> 4);
          }
          // B: bytes 1 where a column's code is the slice's code q.  The
          // code bits below the slice (q) and above it (range, 256-code
          // group) match once a word; the slice bits split into q masks
          // (the low two) and r masks (the rest), one AND a slice.
          const uint32_t fl = bytes_zero(((lo ^ rkey) & kFixed) |
                                         (MULTI ? (glo ^ grp * 0x01010101u) & 0x0F0F0F0Fu : 0u));
          const uint32_t fh = bytes_zero(((hi ^ rkey) & kFixed) |
                                         (MULTI ? (ghi ^ grp * 0x01010101u) & 0x0F0F0F0Fu : 0u));
          uint32_t ql[1 << LQ], qh[1 << LQ], rl[1 << LR], rh[1 << LR];
#pragma unroll
          for (int c = 0; c < (1 << LQ); ++c) {
            ql[c] = fl;
            qh[c] = fh;
#pragma unroll
            for (int b = 0; b < LQ; ++b) {
              ql[c] &= ((c >> b) & 1) ? lo >> (3 + b) : ~(lo >> (3 + b));
              qh[c] &= ((c >> b) & 1) ? hi >> (3 + b) : ~(hi >> (3 + b));
            }
          }
#pragma unroll
          for (int c = 0; c < (1 << LR); ++c) {
            rl[c] = ~0u;
            rh[c] = ~0u;
#pragma unroll
            for (int b = 0; b < LR; ++b) {
              rl[c] &= ((c >> b) & 1) ? lo >> (3 + LQ + b) : ~(lo >> (3 + LQ + b));
              rh[c] &= ((c >> b) & 1) ? hi >> (3 + LQ + b) : ~(hi >> (3 + LQ + b));
            }
          }
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            if (!((pm >> s) & 1u)) continue;
            const uint32_t b0 = ql[s & ((1 << LQ) - 1)] & rl[s >> LQ];
            const uint32_t b1 = qh[s & ((1 << LQ) - 1)] & rh[s >> LQ];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma_s8(acc[s][mt], fa[mt][0], fa[mt][1], fa[mt][2], fa[mt][3], b0, b1);
          }
        }
      }
    }
  };

  // kOhStages - 1 tiles in flight ahead of the one counted; one commit group
  // a tile (empty past the last), so wait_prior(kOhStages - 1) finds tile t's
  const int64_t step = gridDim.x;
  __syncthreads();  // the slot table
  for (int k = 0; k < kOhStages - 1; ++k) {
    const int64_t tk = blockIdx.x + k * step;
    if (tk < a.tiles) fill(tk, k);
    __pipeline_commit();
  }
  int stage = 0;
  for (int64_t t = blockIdx.x; t < a.tiles; t += step) {
    const int64_t ahead = t + (kOhStages - 1) * step;
    if (ahead < a.tiles) fill(ahead, (stage + kOhStages - 1) % kOhStages);
    __pipeline_commit();
    __pipeline_wait_prior(kOhStages - 1);
    __syncthreads();
    if (active) count(oh_smem + stage * stage_words);
    __syncthreads();  // the stage is refilled next
    stage = (stage + 1) % kOhStages;
  }
  __pipeline_wait_prior(0);
  if (!active) return;

#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int val = acc[s][mt][e];
        if (!val) continue;
        const int hi8 = 8 * (e >> 1), odd = e & 1;
        // FACT: row = low nibble, column = code bits 4..6, acc[s][r] = row r
        // of block s; else row = payload row, column = code within slice s
        const int kk = FACT ? mt : 16 * mt + gq + hi8;
        const int code = code0 + (FACT ? 128 * s + 16 * (2 * tq + odd) + gq + hi8
                                       : 8 * s + 2 * tq + odd);
        if (kk < a.k && code < a.g) atomicAdd(a.hist + static_cast<int64_t>(kk) * a.g + code, val);
      }
}

// The ring and the slot table of an instance.
inline size_t onehot_smem(const OnehotArgs& a) {
  return static_cast<size_t>(kOhStages) * a.nslot * kOhPitch * sizeof(uint32_t) +
         static_cast<size_t>(a.nslot) * (sizeof(void*) + sizeof(int64_t));
}

template <bool FACT, int MT, int NS, int CBM, bool MULTI, bool ONE = false>
int launch_onehot(OnehotArgs a, int64_t s, cudaStream_t stream) {
  auto kern = groupby_onehot_kernel<FACT, MT, NS, CBM, MULTI, ONE>;
  constexpr int RC = FACT ? NS * 128 : NS * 8;
  a.ranges = (a.g + RC - 1) / RC;
  a.ranges_blk = a.ranges < kOhWarps ? a.ranges : kOhWarps;
  const int gy = (a.ranges + a.ranges_blk - 1) / a.ranges_blk;
  a.chunks = (a.w + kOhTile - 1) / kOhTile;
  a.tiles = s * a.chunks;
  const size_t smem = onehot_smem(a);
  int64_t grid = 0;
  cudaError_t e = persistent_grid(kern, kOhThreads, smem, a.tiles * gy, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  int64_t gx = grid / gy;
  if (gx < 1) gx = 1;
  if (gx > a.tiles) gx = a.tiles;
  kern<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)), kOhThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The slots and flags of pt_groupby_onehot's arguments.
inline OnehotArgs onehot_args(const uint32_t* cp, int64_t cp_ss, int cb, const uint32_t* valid,
                              int64_t va_ss, const uint32_t* planes, int64_t pl_ss, int d,
                              int64_t w, int g, int is_signed, int* hist) {
  OnehotArgs a{};
  a.cb = cb;
  a.has_planes = planes ? 1 : 0;
  a.is_signed = planes && is_signed ? 1 : 0;
  a.d = planes ? d : 0;
  a.k = planes ? 2 + (a.is_signed ? 2 : 1) * a.d : 1;
  a.g = g;
  a.all_codes = static_cast<int64_t>(g) >= (int64_t{1} << cb);
  a.w = w;
  a.hist = hist;
  int q = 0;
  auto slot = [&](const uint32_t* p, int64_t ss) {
    a.src[q] = p;
    a.ss[q++] = ss;
  };
  for (int b = 0; b < cb; ++b) slot(cp + b * w, cp_ss);
  slot(valid, va_ss);
  if (planes) {
    slot(planes, pl_ss);
    if (a.is_signed) slot(planes + w, pl_ss);
    for (int p = 0; p < a.d; ++p) slot(planes + (2 + p) * w, pl_ss);
  }
  a.nslot = q;
  bool vec = w % 4 == 0;
  for (int i = 0; i < q; ++i)
    vec = vec && reinterpret_cast<uintptr_t>(a.src[i]) % 16 == 0 && a.ss[i] % 4 == 0;
  a.vec = vec ? 1 : 0;
  return a;
}

// The instance by K and G, as measured (PERF.md): K = 1 and
// K <= 8 the factored form (one mma a payload row and 128-code block);
// K <= 16 the payload as one A m-tile, G <= 128 in one range of slices that
// all run (8 slices up to G = 64: 28% faster there than 16), past it 32
// slices a warp (two ranges at G = 512, not four) with the present-slice
// test; K <= 32 two m-tiles, K <= 34 three, 64 accumulator registers a
// thread.
template <int CBM, bool MULTI>
int dispatch_onehot(const OnehotArgs& a, int64_t s, cudaStream_t stream) {
  if (a.k == 1) return launch_onehot<true, 1, 16, CBM, MULTI>(a, s, stream);
  if (a.k <= 8) return launch_onehot<true, 8, 2, CBM, MULTI>(a, s, stream);
  if (a.k <= 16 && a.g <= 64) return launch_onehot<false, 1, 8, CBM, MULTI, true>(a, s, stream);
  if (a.k <= 16 && a.g <= 128) return launch_onehot<false, 1, 16, CBM, MULTI, true>(a, s, stream);
  if (a.k <= 16) return launch_onehot<false, 1, 32, CBM, MULTI>(a, s, stream);
  if (a.k <= 32) return launch_onehot<false, 2, 8, CBM, MULTI>(a, s, stream);
  return launch_onehot<false, 3, 4, CBM, MULTI>(a, s, stream);
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
  if (cb > kOhMaxCodeBits || d > 16 || (planes && d < 1) || g < 1 || g > 4096)
    return static_cast<int>(cudaErrorInvalidValue);
  const OnehotArgs a = onehot_args(
      static_cast<const uint32_t*>(cp), cp_ss, static_cast<int>(cb),
      static_cast<const uint32_t*>(valid), va_ss, static_cast<const uint32_t*>(planes), pl_ss,
      static_cast<int>(d), w, static_cast<int>(g), static_cast<int>(is_signed),
      static_cast<int*>(hist));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // codes past 256 only where there are more than 8 code planes
  return cb <= 8 ? dispatch_onehot<8, false>(a, s, st) : dispatch_onehot<24, true>(a, s, st);
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
