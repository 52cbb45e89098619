// GroupBy kernels of the query path, for Hopper (sm_90a).
//
// Words are 32-bit, packed LSB-first (column c = word c >> 5, bit c & 31);
// PyTorch hands them over as int32 tensors and the kernels read them as
// uint32.  Each launcher takes raw pointers, sizes as int64 and the CUDA
// stream, launches on that stream, does not synchronise, and returns
// cudaGetLastError() so that a refused launch reaches the Python wrapper.
// Outputs are allocated and initialised by the wrapper (zeros, or the Min/Max
// identities); the kernels only add into them.

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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
// the sign plane when signed) over 3.35 TB/s.  What it costs instead is the histogram update per valid column
// (1 + [exists] + popcount(magnitude) shared-memory atomics), so it runs above
// that bound; the one-hot MXU dots and presence-bit walks of the TPU kernel
// were workarounds for Mosaic's lack of dynamic stores and have no place here.
// Design: a persistent grid (SMs x resident blocks) walks (shard, 2048-word)
// tiles.  One thread per word: it skips the word when no column is valid,
// loads the code, exists, sign and magnitude words once into registers, then
// for each valid column composes its code and magnitude bit by bit and adds
// its payload to a (K, G) table.  The table lives in shared memory, zeroed
// once per block and added into the output with one atomic per nonzero entry
// at the end; a table too large for shared memory (G = 4096 at depth 16, or a
// 2^20-code value histogram) takes the same updates as global atomics
// straight into the output.  Columns with valid = 0 never form an index, and
// codes >= G are dropped.  CBMAX and DMAX bound the register arrays; the
// launcher picks the smallest instance that holds CB and d.
// ---------------------------------------------------------------------------
constexpr int kFusedChunk = 2048;                 // words per tile
constexpr size_t kFusedSharedMax = 100 * 1024;    // larger tables go global

template <int DMAX>
struct MagType { using T = uint32_t; };
template <>
struct MagType<64> { using T = uint64_t; };

template <int CBMAX, int DMAX, bool SHARED>
__global__ void __launch_bounds__(kThreads)
groupby_fused_kernel(const uint32_t* __restrict__ cp, int64_t cp_ss, int cb,
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
      while (v) {
        const int bit = lowest_bit(v);
        v &= v - 1;
        uint32_t code = 0;
#pragma unroll
        for (int b = 0; b < CBMAX; ++b) code |= ((cw[b] >> bit) & 1u) << b;
        if (code >= static_cast<uint32_t>(g)) continue;
        atomicAdd(tab + code, 1);
        if (DMAX == 0 || !((ex >> bit) & 1u)) continue;
        atomicAdd(tab + g + code, 1);
        Mag mag = 0;
#pragma unroll
        for (int p = 0; p < (DMAX > 0 ? DMAX : 1); ++p)
          mag |= static_cast<Mag>((mw[p] >> bit) & 1u) << p;
        const bool neg = (sg >> bit) & 1u;
        int* row = tab + (neg ? neg_row : 2 * static_cast<int64_t>(g)) + code;
        for (Mag m = mag; m; m &= m - 1) atomicAdd(row + static_cast<int64_t>(lowest_bit(m)) * g, 1);
        if (do_mm) {
          const int side = neg ? 2 : 0;
          atomicMax(mmt + side * g + code, static_cast<int>(mag));
          atomicMin(mmt + (side + 1) * g + code, static_cast<int>(mag));
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
int launch_fused(const uint32_t* cp, int64_t cp_ss, int cb, const uint32_t* valid,
                 int64_t va_ss, const uint32_t* planes, int64_t pl_ss, int d, int64_t s,
                 int64_t w, int g, int k, int is_signed, int* hist, int* mm, size_t smem,
                 cudaStream_t stream) {
  auto kern = groupby_fused_kernel<CBMAX, DMAX, SHARED>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t chunks = (w + kFusedChunk - 1) / kFusedChunk;
  const int64_t tiles = s * chunks;
  int64_t grid = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sm_count();
  if (grid > tiles) grid = tiles;
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
#define PT_FUSED(DM)                                                                        \
  return launch_fused<CBMAX, DM, SHARED>(cp, cp_ss, cb, valid, va_ss, planes, pl_ss, d, s, w, \
                                         g, k, is_signed, hist, mm, smem, stream)
  if (!planes) PT_FUSED(0);
  if (d <= 8) PT_FUSED(8);
  if (d <= 16) PT_FUSED(16);
  if (d <= 32) PT_FUSED(32);
  PT_FUSED(64);
#undef PT_FUSED
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
// Bound: each distinct stack row that sel references plus the planes (the
// sign plane only when signed) once, S*W words each, over 3.35 TB/s.  Design: one block per (shard, chunk of 256*WPT words).  The
// block stages its chunk of exists, the two sign-split masks and the d
// magnitude planes in shared memory once, then walks every combo: each thread
// ANDs the nf selected row words into registers (WPT words), counts them
// against the staged planes, the block reduces through warp shuffles into a
// double-buffered shared partial (one barrier per combo), and 2 + 2d threads
// add the block's totals to out[c] with one atomic each.  The nf stack
// pointers travel by value (at most kMaxFields); any C is taken.
// ---------------------------------------------------------------------------
constexpr int kMaxFields = 8;
constexpr size_t kSumSharedMax = 96 * 1024;

struct Stacks {
  const uint32_t* p[kMaxFields];
};

template <int WPT>
__global__ void __launch_bounds__(kThreads)
groupby_sum_kernel(Stacks st, int nf, const int* __restrict__ sel, int64_t c,
                   const uint32_t* __restrict__ planes, int d, int64_t s, int64_t w,
                   int64_t chunks, int is_signed, int* __restrict__ counts,
                   int* __restrict__ nn, int* __restrict__ pos, int* __restrict__ neg) {
  constexpr int kChunk = kThreads * WPT;
  extern __shared__ uint32_t smem_u[];
  const int np = planes ? 2 + 2 * d : 1;         // partials per warp
  const int64_t shard = blockIdx.x / chunks;
  const int64_t base = (blockIdx.x % chunks) * kChunk;
  uint32_t* sex = smem_u;                        // exists
  uint32_t* spos = sex + kChunk;                 // exists & ~sign (or exists)
  uint32_t* sneg = spos + kChunk;                // exists & sign (or 0)
  uint32_t* smag = sneg + kChunk;                // d x kChunk
  int* part = reinterpret_cast<int*>(planes ? smag + static_cast<int64_t>(d) * kChunk : smem_u);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (planes) {
    const uint32_t* sp = planes + shard * (2 + d) * w;
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int idx = threadIdx.x + j * kThreads;
      const int64_t k = base + idx;
      uint32_t ex = 0, sg = 0;
      if (k < w) {
        ex = __ldg(sp + k);
        sg = is_signed ? __ldg(sp + w + k) : 0u;
      }
      sex[idx] = ex;
      spos[idx] = ex & ~sg;
      sneg[idx] = ex & sg;
      for (int p = 0; p < d; ++p) smag[p * kChunk + idx] = k < w ? __ldg(sp + (2 + p) * w + k) : 0u;
    }
    __syncthreads();
  }

  for (int64_t ci = 0; ci < c; ++ci) {
    int* buf = part + (ci & 1) * kWarps * np;
    uint32_t m[WPT];
    int cnt = 0, nnc = 0;
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int idx = threadIdx.x + j * kThreads;
      const int64_t k = base + idx;
      uint32_t x = 0;
      if (k < w) {
        x = 0xffffffffu;
        for (int f = 0; f < nf; ++f) {
          const int64_t r = sel[ci * nf + f];
          x &= __ldg(st.p[f] + (r * s + shard) * w + k);
        }
      }
      m[j] = x;
      cnt += __popc(x);
      if (planes) nnc += __popc(x & sex[idx]);
    }
    cnt = warp_sum(cnt);
    nnc = warp_sum(nnc);
    if (lane == 0) {
      buf[warp * np] = cnt;
      if (planes) buf[warp * np + 1] = nnc;
    }
    for (int p = 0; p < d; ++p) {
      int ap = 0, an = 0;
#pragma unroll
      for (int j = 0; j < WPT; ++j) {
        const int idx = threadIdx.x + j * kThreads;
        const uint32_t mm = m[j] & smag[p * kChunk + idx];
        ap += __popc(mm & spos[idx]);
        an += __popc(mm & sneg[idx]);
      }
      ap = warp_sum(ap);
      an = warp_sum(an);
      if (lane == 0) {
        buf[warp * np + 2 + p] = ap;
        buf[warp * np + 2 + d + p] = an;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < np; i += kThreads) {
      int v = 0;
      for (int q = 0; q < kWarps; ++q) v += buf[q * np + i];
      if (!v) continue;
      if (i == 0) atomicAdd(counts + ci, v);
      else if (i == 1) atomicAdd(nn + ci, v);
      else if (i < 2 + d) atomicAdd(pos + ci * d + (i - 2), v);
      else atomicAdd(neg + ci * d + (i - 2 - d), v);
    }
  }
}

template <int WPT>
int launch_sum(const Stacks& st, int nf, const int* sel, int64_t c, const uint32_t* planes,
               int d, int64_t s, int64_t w, int is_signed, int* counts, int* nn, int* pos,
               int* neg, cudaStream_t stream) {
  constexpr int kChunk = kThreads * WPT;
  const int np = planes ? 2 + 2 * d : 1;
  const size_t smem = (planes ? static_cast<size_t>(3 + d) * kChunk * sizeof(uint32_t) : 0) +
                      2 * kWarps * np * sizeof(int);
  auto kern = groupby_sum_kernel<WPT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t chunks = (w + kChunk - 1) / kChunk;
  kern<<<static_cast<unsigned>(s * chunks), kThreads, smem, stream>>>(
      st, nf, sel, c, planes, d, s, w, chunks, is_signed, counts, nn, pos, neg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pt_groupby_fused(const void* cp, int64_t cp_ss, int64_t cb, const void* valid,
                     int64_t va_ss, const void* planes, int64_t pl_ss, int64_t d, int64_t s,
                     int64_t w, int64_t g, int64_t is_signed, void* hist, void* mm,
                     void* stream) {
  if (cb > 24 || d > 63 || (mm && d > 30)) return static_cast<int>(cudaErrorInvalidValue);
  const int k = planes ? static_cast<int>(2 + (is_signed ? 2 : 1) * d) : 1;
  const size_t table = (static_cast<size_t>(k) + (mm ? 4 : 0)) * g * sizeof(int);
  const bool shared = table <= kFusedSharedMax;
  const uint32_t* cpu = static_cast<const uint32_t*>(cp);
  const uint32_t* vau = static_cast<const uint32_t*>(valid);
  const uint32_t* plu = static_cast<const uint32_t*>(planes);
  int* h = static_cast<int*>(hist);
  int* m = static_cast<int*>(mm);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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

int pt_groupby_sum(const void* const* stacks, int64_t nf, const void* sel, int64_t c,
                   const void* planes, int64_t d, int64_t s, int64_t w, int64_t is_signed,
                   void* counts, void* nn, void* pos, void* neg, void* stream) {
  if (nf < 1 || nf > kMaxFields || d > 63) return static_cast<int>(cudaErrorInvalidValue);
  Stacks st{};
  for (int f = 0; f < nf; ++f) st.p[f] = static_cast<const uint32_t*>(stacks[f]);
  const uint32_t* pl = static_cast<const uint32_t*>(planes);
  const int di = planes ? static_cast<int>(d) : 0;
  const int nfi = static_cast<int>(nf), sg = static_cast<int>(is_signed);
  const int* se = static_cast<const int*>(sel);
  int* co = static_cast<int*>(counts);
  int* n = static_cast<int*>(nn);
  int* p = static_cast<int*>(pos);
  int* g = static_cast<int*>(neg);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const size_t per_word = pl ? (3 + di) * sizeof(uint32_t) : 0;
  const size_t parts = 2 * kWarps * (pl ? 2 + 2 * di : 1) * sizeof(int);
  if (per_word * kThreads * 8 + parts <= kSumSharedMax)
    return launch_sum<8>(st, nfi, se, c, pl, di, s, w, sg, co, n, p, g, strm);
  if (per_word * kThreads * 4 + parts <= kSumSharedMax)
    return launch_sum<4>(st, nfi, se, c, pl, di, s, w, sg, co, n, p, g, strm);
  if (per_word * kThreads * 2 + parts <= kSumSharedMax)
    return launch_sum<2>(st, nfi, se, c, pl, di, s, w, sg, co, n, p, g, strm);
  return launch_sum<1>(st, nfi, se, c, pl, di, s, w, sg, co, n, p, g, strm);
}

}  // extern "C"
