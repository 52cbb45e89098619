// Timing variants of the GroupBy kernels as they stood before their
// redesigns, for diagnosis only (run by groupby_variants.py; the query path
// never loads this file): the per-column histogram and per-combo kernels
// before the joint-table redesign, and, at the end, the first port's one-hot
// histogram.
//
// fused_variant(v):
//   0 full       the per-column kernel: bit-by-bit composition, then
//                1 + [exists] + popcount(magnitude) shared atomics
//                (+ atomicMax/atomicMin with Min/Max)
//   1 compose    the same loads and composition, no atomics (the codes
//                and magnitudes fold into a register)
//   2 atomics    the same atomics, with code and magnitude cut from two
//                words by one funnel shift each instead of composed
//   3 loads      the same loads, no per-column work
//   4 joint      one shared atomic per valid column into a table of
//                `tsize` (a power of two) counters, index by funnel shift
// sum_variant(v): 0 full, 1 without the global atomics of each combo.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 2048;

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
fused_variant(const uint32_t* __restrict__ cp, int cb, const uint32_t* __restrict__ valid,
              const uint32_t* __restrict__ planes, int d, int64_t w, int64_t chunks,
              int64_t tiles, int g, int k, int is_signed, int do_mm, int tsize,
              int* __restrict__ hist, int* __restrict__ sink) {
  extern __shared__ int smem[];
  constexpr int CBMAX = 8, DMAX = 8;
  const int big = 1 << d;
  const int tab_n = V == 4 ? tsize : k * g + (do_mm ? 4 * g : 0);
  int* tab = smem;
  int* mmt = smem + k * g;
  for (int i = threadIdx.x; i < tab_n; i += kThreads) tab[i] = 0;
  __syncthreads();
  const int64_t neg_row = static_cast<int64_t>(2 + d) * g;
  uint32_t acc = 0;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t shard = t / chunks;
    const int64_t base = (t % chunks) * kChunk;
    const int64_t end = base + kChunk < w ? base + kChunk : w;
    const uint32_t* cps = cp + shard * cb * w;
    const uint32_t* vas = valid + shard * w;
    const uint32_t* pls = planes ? planes + shard * (2 + d) * w : nullptr;
    for (int64_t i = base + threadIdx.x; i < end; i += kThreads) {
      uint32_t v = __ldg(vas + i);
      if (!v) continue;
      uint32_t cw[CBMAX], mw[DMAX];
#pragma unroll
      for (int b = 0; b < CBMAX; ++b) cw[b] = b < cb ? __ldg(cps + b * w + i) : 0u;
      const uint32_t ex = pls ? __ldg(pls + i) & v : 0u;
      const uint32_t sg = pls && is_signed ? __ldg(pls + w + i) : 0u;
#pragma unroll
      for (int p = 0; p < DMAX; ++p) mw[p] = pls && p < d ? __ldg(pls + (2 + p) * w + i) : 0u;
      if (V == 3) {
#pragma unroll
        for (int b = 0; b < CBMAX; ++b) acc ^= cw[b] ^ mw[b];
        acc ^= ex ^ sg;
        continue;
      }
      while (v) {
        const int bit = __ffs(v) - 1;
        v &= v - 1;
        uint32_t code = 0, mag = 0;
        if (V == 2 || V == 4) {
          code = __funnelshift_r(cw[0], cw[1], bit) & static_cast<uint32_t>(g - 1);
          mag = __funnelshift_r(mw[0], mw[1], bit) & static_cast<uint32_t>(big - 1);
        } else {
#pragma unroll
          for (int b = 0; b < CBMAX; ++b) code |= ((cw[b] >> bit) & 1u) << b;
        }
        if (V == 4) {
          const uint32_t idx = (code | (__funnelshift_r(mw[2], mw[3], bit) << 7)) &
                               static_cast<uint32_t>(tsize - 1);
          atomicAdd(tab + idx, 1);
          continue;
        }
        if (code >= static_cast<uint32_t>(g)) continue;
        const bool has = (ex >> bit) & 1u;
        const bool neg = (sg >> bit) & 1u;
        if (V == 1) {
          if (has) {
#pragma unroll
            for (int p = 0; p < DMAX; ++p) mag |= ((mw[p] >> bit) & 1u) << p;
          }
          acc += code ^ (mag << 8) ^ (neg ? 1u << 20 : 0u);
          continue;
        }
        atomicAdd(tab + code, 1);
        if (!has) continue;
        atomicAdd(tab + g + code, 1);
        if (V != 2) {
#pragma unroll
          for (int p = 0; p < DMAX; ++p) mag |= ((mw[p] >> bit) & 1u) << p;
        }
        int* row = tab + (neg ? neg_row : 2 * static_cast<int64_t>(g)) + code;
        for (uint32_t m = mag; m; m &= m - 1) atomicAdd(row + (__ffs(m) - 1) * g, 1);
        if (do_mm) {
          const int side = neg ? 2 : 0;
          atomicMax(mmt + side * g + code, static_cast<int>(mag));
          atomicMin(mmt + (side + 1) * g + code, static_cast<int>(mag));
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tab_n; i += kThreads) {
    const int x = tab[i];
    if (x && i < k * g) atomicAdd(hist + i, x);
  }
  if (acc == 0x9e3779b9u) sink[threadIdx.x] = static_cast<int>(acc);
}

template <int V>
int launch_fused_variant(const uint32_t* cp, int cb, const uint32_t* valid,
                         const uint32_t* planes, int d, int64_t s, int64_t w, int g,
                         int is_signed, int do_mm, int tsize, int* hist, int* sink,
                         cudaStream_t stream) {
  const int k = planes ? 2 + (is_signed ? 2 : 1) * d : 1;
  const size_t smem = (V == 4 ? static_cast<size_t>(tsize) : (k + (do_mm ? 4 : 0)) *
                                                                 static_cast<size_t>(g)) *
                      sizeof(int);
  auto kern = fused_variant<V>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t chunks = (w + kChunk - 1) / kChunk;
  const int64_t tiles = s * chunks;
  int64_t grid = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  if (grid > tiles) grid = tiles;
  kern<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      cp, cb, valid, planes, d, w, chunks, tiles, g, k, is_signed, do_mm, tsize, hist, sink);
  return static_cast<int>(cudaGetLastError());
}

template <bool ATOMICS>
__global__ void __launch_bounds__(kThreads)
sum_variant(const uint32_t* __restrict__ rows, const uint32_t* __restrict__ arow,
            const int* __restrict__ sel, int64_t c, const uint32_t* __restrict__ planes,
            int d, int64_t s, int64_t w, int64_t chunks, int* __restrict__ out) {
  constexpr int WPT = 8;
  constexpr int kC = kThreads * WPT;
  extern __shared__ uint32_t smem_u[];
  const int np = 2 + 2 * d;
  const int64_t shard = blockIdx.x / chunks;
  const int64_t base = (blockIdx.x % chunks) * kC;
  uint32_t* sex = smem_u;
  uint32_t* spos = sex + kC;
  uint32_t* sneg = spos + kC;
  uint32_t* smag = sneg + kC;
  int* part = reinterpret_cast<int*>(smag + static_cast<int64_t>(d) * kC);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t* sp = planes + shard * (2 + d) * w;
#pragma unroll
  for (int j = 0; j < WPT; ++j) {
    const int idx = threadIdx.x + j * kThreads;
    const int64_t kk = base + idx;
    const uint32_t ex = kk < w ? __ldg(sp + kk) : 0u;
    sex[idx] = ex;
    spos[idx] = ex;
    sneg[idx] = 0u;
    for (int p = 0; p < d; ++p) smag[p * kC + idx] = kk < w ? __ldg(sp + (2 + p) * w + kk) : 0u;
  }
  __syncthreads();
  for (int64_t ci = 0; ci < c; ++ci) {
    int* buf = part + (ci & 1) * kWarps * np;
    uint32_t m[WPT];
    int cnt = 0, nnc = 0;
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int idx = threadIdx.x + j * kThreads;
      const int64_t kk = base + idx;
      uint32_t x = 0;
      if (kk < w) {
        const int64_t r = sel[ci * 2];
        x = __ldg(rows + (r * s + shard) * w + kk) & __ldg(arow + shard * w + kk);
      }
      m[j] = x;
      cnt += __popc(x);
      nnc += __popc(x & sex[idx]);
    }
    cnt = warp_sum(cnt);
    nnc = warp_sum(nnc);
    if (lane == 0) {
      buf[warp * np] = cnt;
      buf[warp * np + 1] = nnc;
    }
    for (int p = 0; p < d; ++p) {
      int ap = 0, an = 0;
#pragma unroll
      for (int j = 0; j < WPT; ++j) {
        const int idx = threadIdx.x + j * kThreads;
        const uint32_t mm = m[j] & smag[p * kC + idx];
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
      if (ATOMICS && v) atomicAdd(out + ci * np + i, v);
      if (!ATOMICS && v == 0x7fffffff) out[i] = v;
    }
  }
}

}  // namespace

extern "C" {

int pt_diag_fused(int64_t variant, const void* cp, int64_t cb, const void* valid,
                  const void* planes, int64_t d, int64_t s, int64_t w, int64_t g,
                  int64_t is_signed, int64_t do_mm, int64_t tsize, void* hist, void* sink,
                  void* stream) {
  if (cb > 8 || d > 8 || (planes && d < 4)) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t* c = static_cast<const uint32_t*>(cp);
  const uint32_t* v = static_cast<const uint32_t*>(valid);
  const uint32_t* p = static_cast<const uint32_t*>(planes);
  int* h = static_cast<int*>(hist);
  int* k = static_cast<int*>(sink);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ci = static_cast<int>(cb), di = static_cast<int>(d), gi = static_cast<int>(g);
  const int sg = static_cast<int>(is_signed), mm = static_cast<int>(do_mm);
  const int ts = static_cast<int>(tsize);
  switch (variant) {
    case 0: return launch_fused_variant<0>(c, ci, v, p, di, s, w, gi, sg, mm, ts, h, k, st);
    case 1: return launch_fused_variant<1>(c, ci, v, p, di, s, w, gi, sg, mm, ts, h, k, st);
    case 2: return launch_fused_variant<2>(c, ci, v, p, di, s, w, gi, sg, mm, ts, h, k, st);
    case 3: return launch_fused_variant<3>(c, ci, v, p, di, s, w, gi, sg, mm, ts, h, k, st);
    case 4: return launch_fused_variant<4>(c, ci, v, p, di, s, w, gi, sg, mm, ts, h, k, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int pt_diag_sum(int64_t variant, const void* rows, const void* arow, const void* sel,
                int64_t c, const void* planes, int64_t d, int64_t s, int64_t w, void* out,
                void* stream) {
  constexpr int kC = kThreads * 8;
  const size_t smem = static_cast<size_t>(3 + d) * kC * 4 + 2 * kWarps * (2 + 2 * d) * 4;
  const int64_t chunks = (w + kC - 1) / kC;
  const uint32_t* r = static_cast<const uint32_t*>(rows);
  const uint32_t* a = static_cast<const uint32_t*>(arow);
  const int* se = static_cast<const int*>(sel);
  const uint32_t* p = static_cast<const uint32_t*>(planes);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int di = static_cast<int>(d);
  auto run = [&](auto kern) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<static_cast<unsigned>(s * chunks), kThreads, smem, st>>>(r, a, se, c, p, di, s, w,
                                                                    chunks, o);
    return static_cast<int>(cudaGetLastError());
  };
  return variant == 0 ? run(sum_variant<true>) : run(sum_variant<false>);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// groupby_onehot.  onehot_variant<V, MT, SPW> is the first port's wmma kernel
// (payload and one-hot tiles built in shared memory for every slice of every
// 256-column tile) with one part of the work dropped:
//   0 full        the kernel as it stood
//   1 loads       the per-column loads and composition only (no shared
//                 memory, no barrier, no mma)
//   2 build       loads, payload tile and per-slice one-hot build, no mma
//   3 mma         the mma of every slice of every tile on constant
//                 fragments (no loads, no build; every slice counted present)
// and, through pt_diag_onehot_old's `spw`, the template trimmed to the
// slices G needs (spw = ceil(G / 128) instead of 8 / 4 / 2).
// pt_diag_onehot_new launches instances of the query path's kernel
// (ops/csrc/groupby_kernels.cu, included below) that it does not pick.
// ---------------------------------------------------------------------------
#include <cuda_pipeline.h>
#include <mma.h>

namespace onehot_diag {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kOhCols = kThreads;

__device__ __forceinline__ uint32_t spread4(uint64_t bits) {
  const uint32_t n = static_cast<uint32_t>(bits) & 0xFu;
  return (n & 1u) | ((n & 2u) << 7) | ((n & 4u) << 14) | ((n & 8u) << 21);
}

template <int V, int MT, int SPW>
__global__ void __launch_bounds__(kThreads)
onehot_variant(const uint32_t* __restrict__ cp, int64_t cp_ss, int cb,
               const uint32_t* __restrict__ valid, int64_t va_ss,
               const uint32_t* __restrict__ planes, int64_t pl_ss, int d, int64_t w,
               int64_t chunks, int64_t tiles, int g, int k, int is_signed,
               int* __restrict__ hist, int* __restrict__ sink) {
  using namespace nvcuda;
  __shared__ __align__(32) signed char sa[MT * kOhCols * 16];
  __shared__ __align__(32) signed char sb[kWarps * kOhCols * 16];
  __shared__ int scode[kOhCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g_group = blockIdx.y * (kWarps * SPW * 16);
  signed char* mb = sb + warp * (kOhCols * 16);
  uint64_t fold = 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[MT][SPW];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < SPW; ++j) wmma::fill_fragment(acc[mt][j], 0);
  wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> cfb;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::col_major> cfa;
  if (V == 3) {
    for (int i = threadIdx.x; i < kOhCols * 16; i += kThreads) sb[i] = static_cast<signed char>(i & 1);
    __syncthreads();
    wmma::load_matrix_sync(cfb, sb, 16);
    wmma::load_matrix_sync(cfa, sb + 256, 16);
  }

  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    if (V == 3) {
#pragma unroll
      for (int j = 0; j < SPW; ++j) {
        const int gs = g_group + (warp + kWarps * j) * 16;
        if (gs >= g) continue;
        for (int ks = 0; ks < kOhCols / 16; ++ks)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) wmma::mma_sync(acc[mt][j], cfa, cfb, acc[mt][j]);
      }
      continue;
    }
    const int64_t shard = t / chunks;
    const int64_t word = (t % chunks) * (kOhCols / 32) + warp;
    uint32_t va = 0;
    int code = -1;
    uint64_t rows = 0;
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
    if (V == 1) {
      fold += rows ^ static_cast<uint64_t>(code);
      continue;
    }
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint64_t r = rows >> (16 * mt);
      reinterpret_cast<uint4*>(sa + mt * kOhCols * 16)[threadIdx.x] =
          make_uint4(spread4(r), spread4(r >> 4), spread4(r >> 8), spread4(r >> 12));
    }
    scode[threadIdx.x] = code;
    if (!__syncthreads_or(va)) continue;

#pragma unroll
    for (int j = 0; j < SPW; ++j) {
      const int gs = g_group + (warp + kWarps * j) * 16;
      if (gs < g) {
        __syncwarp();
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
        if (V == 0 && __any_sync(0xffffffffu, any)) {
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
  if (fold == 0x0123456789ABCDEFull) sink[0] = 1;
  if (V == 1 || V == 2) return;

  __syncthreads();
  int* scratch = reinterpret_cast<int*>(mb);
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

template <int V, int MT, int SPW>
int launch_old(const uint32_t* cp, int64_t cp_ss, int cb, const uint32_t* valid, int64_t va_ss,
               const uint32_t* planes, int64_t pl_ss, int d, int64_t s, int64_t w, int g, int k,
               int is_signed, int* hist, int* sink, cudaStream_t stream) {
  auto kern = onehot_variant<V, MT, SPW>;
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t chunks = (w + kOhCols / 32 - 1) / (kOhCols / 32);
  const int64_t tiles = s * chunks;
  const int groups = (g + kWarps * SPW * 16 - 1) / (kWarps * SPW * 16);
  int64_t gx = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms / groups;
  if (gx < 1) gx = 1;
  if (gx > tiles) gx = tiles;
  kern<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(groups)), kThreads, 0, stream>>>(
      cp, cp_ss, cb, valid, va_ss, planes, pl_ss, d, w, chunks, tiles, g, k, is_signed, hist, sink);
  return static_cast<int>(cudaGetLastError());
}

template <int MT, int SPW>
int dispatch_old(int v, const uint32_t* cp, int64_t cp_ss, int cb, const uint32_t* valid,
                 int64_t va_ss, const uint32_t* planes, int64_t pl_ss, int d, int64_t s,
                 int64_t w, int g, int k, int is_signed, int* hist, int* sink,
                 cudaStream_t stream) {
#define PT_OLD(V)                                                                          \
  return launch_old<V, MT, SPW>(cp, cp_ss, cb, valid, va_ss, planes, pl_ss, d, s, w, g, k, \
                                is_signed, hist, sink, stream)
  if (v == 1) PT_OLD(1);
  if (v == 2) PT_OLD(2);
  if (v == 3) PT_OLD(3);
  PT_OLD(0);
#undef PT_OLD
}

}  // namespace onehot_diag

namespace prod {
#include "../ops/csrc/groupby_kernels.cu"
}  // namespace prod

extern "C" {

// The first port's kernel, variant `variant` (0-3 above), spw 16-code
// slices a warp (0: the first port's 8 / 4 / 2 by K).
int pt_diag_onehot_old(int64_t variant, int64_t spw, const void* cp, int64_t cp_ss, int64_t cb,
                       const void* valid, int64_t va_ss, const void* planes, int64_t pl_ss,
                       int64_t d, int64_t s, int64_t w, int64_t g, int64_t is_signed, void* hist,
                       void* sink, void* stream) {
  using namespace onehot_diag;
  const int k = planes ? static_cast<int>(2 + (is_signed ? 2 : 1) * d) : 1;
  const int mt = (k + 15) / 16;
  const int v = static_cast<int>(variant);
#define PT_OLD_ARGS                                                                           \
  v, static_cast<const uint32_t*>(cp), cp_ss, static_cast<int>(cb),                          \
      static_cast<const uint32_t*>(valid), va_ss, static_cast<const uint32_t*>(planes), pl_ss, \
      planes ? static_cast<int>(d) : 0, s, w, static_cast<int>(g), k,                         \
      static_cast<int>(is_signed), static_cast<int*>(hist), static_cast<int*>(sink),          \
      static_cast<cudaStream_t>(stream)
  if (mt == 1 && spw == 1) return dispatch_old<1, 1>(PT_OLD_ARGS);
  if (mt == 1 && spw == 2) return dispatch_old<1, 2>(PT_OLD_ARGS);
  if (mt == 1 && spw == 4) return dispatch_old<1, 4>(PT_OLD_ARGS);
  if (mt == 1) return dispatch_old<1, 8>(PT_OLD_ARGS);
  if (mt == 2) return dispatch_old<2, 4>(PT_OLD_ARGS);
  return dispatch_old<3, 2>(PT_OLD_ARGS);
#undef PT_OLD_ARGS
}

// An instance of the query path's kernel: 0 payload A, one m-tile, 32
// slices a warp (128 accumulator registers; the pick for 8 < K <= 16 past
// G = 128); 1 payload A, one m-tile, 16 slices with the present-slice test
// (the pick for 8 < K <= 16 up to G = 128 runs every slice); 2 factored (one-hot of the low code nibble as A), 16 payload
// rows and one 128-code block a warp; 3 factored, 8 payload rows and two
// blocks (the pick for 1 < K <= 8); 4 payload A, one m-tile, G in one range
// of 16 slices that all run (the pick for 8 < K <= 16 up to G = 128); 5 the
// same with 8 slices (G <= 64).
int pt_diag_onehot_new(int64_t variant, const void* cp, int64_t cp_ss, int64_t cb,
                       const void* valid, int64_t va_ss, const void* planes, int64_t pl_ss,
                       int64_t d, int64_t s, int64_t w, int64_t g, int64_t is_signed, void* hist,
                       void* stream) {
  using namespace prod;
  const OnehotArgs a = onehot_args(
      static_cast<const uint32_t*>(cp), cp_ss, static_cast<int>(cb),
      static_cast<const uint32_t*>(valid), va_ss, static_cast<const uint32_t*>(planes), pl_ss,
      static_cast<int>(d), w, static_cast<int>(g), static_cast<int>(is_signed),
      static_cast<int*>(hist));
  if (a.k > (variant == 3 ? 8 : 16) || cb > 24 || (variant == 4 && g > 128) ||
      (variant == 5 && g > 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_NEW(FACT, MT, NS, ONE)                                              \
  return cb > 8 ? launch_onehot<FACT, MT, NS, 24, true, ONE>(a, s, st)        \
                : launch_onehot<FACT, MT, NS, 8, false, ONE>(a, s, st)
  if (variant == 0) PT_NEW(false, 1, 32, false);
  if (variant == 1) PT_NEW(false, 1, 16, false);
  if (variant == 2) PT_NEW(true, 16, 1, false);
  if (variant == 3) PT_NEW(true, 8, 2, false);
  if (variant == 4) PT_NEW(false, 1, 16, true);
  PT_NEW(false, 1, 8, true);
#undef PT_NEW
}

}  // extern "C"
