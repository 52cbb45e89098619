// Host ingest scatters of the PyTorch port: its own copy of the JAX
// package's native/ingest/scatter.cc, with pt_groupcode_minmax added.
//
// The columnar import path (ingest/, API.import_columns) is host-bound
// on scatters that numpy vectorizes poorly: np.bitwise_or.at (~40 ns a
// bit) and the per-plane BSI column selection.  The reference's loops
// are Go word writes (fragment.go importValue, roaring container ops);
// these are the same loops in C.  Built by storage/_build.py with g++
// and loaded with ctypes (storage/native_ingest.py, which checks every
// index against its array before a call); there is no other path.

#include <cstdint>

extern "C" {

// OR a 1-bit at each column id into the packed word array.
// cols must be < width; words has width/32 entries.
void pt_or_bits(uint32_t *words, const int64_t *cols, int64_t n) {
    for (int64_t j = 0; j < n; j++) {
        int64_t c = cols[j];
        words[c >> 5] |= (uint32_t)1 << (c & 31);
    }
}

// BSI plane fill, word-major (transposed) layout with built-in
// last-write-wins: scratch_t is (plane_words x n_planes) so one
// value's exists/sign/magnitude writes land in ONE cache line
// instead of n_planes planes 128KB apart (~2x on wide BSI columns);
// the caller transposes back to plane-major with a single vectorized
// copy.  Values are scanned in REVERSE; a column whose exists bit is
// already set was written by a later entry and is skipped, so
// callers need no sort-based dedup.  Layout per word:
// [exists, sign, bit0..bitN] (fragment.go BSI layout: bsiExistsBit,
// bsiSignBit, bsiOffsetBit).  n_planes is 2 + depth; magnitude bits
// at or beyond `depth` are dropped here as a hard bound (the Python
// caller raises on out-of-depth values BEFORE calling, but this
// kernel must never scribble past its scratch row even if handed a
// bad value).
void pt_bsi_fill_t(uint32_t *scratch_t, int64_t n_planes,
                   const int64_t *cols, const int64_t *vals,
                   int64_t n) {
    int64_t depth = n_planes - 2;
    for (int64_t j = n - 1; j >= 0; j--) {
        int64_t c = cols[j];
        uint32_t *cell = scratch_t + (c >> 5) * n_planes;
        uint32_t bit = (uint32_t)1 << (c & 31);
        if (cell[0] & bit) continue;  // a later write won
        int64_t v = vals[j];
        // unsigned negation: -v overflows (UB) at INT64_MIN, whose
        // magnitude 2^63 only exists in uint64
        uint64_t mag = v < 0 ? ~(uint64_t)v + 1 : (uint64_t)v;
        cell[0] |= bit;
        if (v < 0) cell[1] |= bit;
        while (mag) {
            int i = __builtin_ctzll(mag);
            if (i >= depth) break;  // bits ascend: all later ones OOB
            cell[2 + i] |= bit;
            mag &= mag - 1;
        }
    }
}

// Mutex/bool fill with built-in last-write-wins: rowidx[j] is the
// dense index (0..n_rows-1) of entry j's row id; scratch is
// (n_rows x plane_words) zeroed planes and written is one zeroed
// plane that ends up holding every touched column (the
// clear-then-set mask).  Reverse scan + skip gives last-write-wins
// without the np.unique sort.
void pt_mutex_fill(uint32_t *written, uint32_t *scratch,
                   int64_t plane_words, const int64_t *rowidx,
                   const int64_t *cols, int64_t n) {
    for (int64_t j = n - 1; j >= 0; j--) {
        int64_t c = cols[j];
        int64_t w = c >> 5;
        uint32_t bit = (uint32_t)1 << (c & 31);
        if (written[w] & bit) continue;  // a later write won
        written[w] |= bit;
        scratch[rowidx[j] * plane_words + w] |= bit;
    }
}

// One-pass GroupBy histogram over composed group codes (the host twin
// of ops/kernels.py groupby_onehot).  code_planes is (cb x w) packed
// bit-planes of the per-column group code; valid masks the columns
// belonging to some combo (AND of field unions, AND the filter); bsi
// (may be null) is the aggregate field's (2+depth x w) plane stack.
// Accumulates counts/nn (n_codes) and the sign-split per-plane
// popcount partials pos/neg (n_codes x depth) — identical layout to
// every other GroupBy path, so host combination stays bit-exact.
// Each input word is read exactly once regardless of combo count.
// Schedule: words are processed in PAIRS as uint64 lanes with every
// plane word hoisted into locals before the per-column loop — the
// hoist halves the loop setups and lets the compiler keep the plane
// bits in registers across the bit-scan (measured ~1.5x over the
// straightforward per-column gather on the dev box).
void pt_groupcode_hist(const uint32_t *__restrict code_planes,
                       int64_t cb,
                       const uint32_t *__restrict valid,
                       const uint32_t *__restrict bsi, int64_t depth,
                       int64_t sign_split,
                       int64_t w, int64_t n_codes,
                       int64_t *__restrict counts,
                       int64_t *__restrict nn,
                       int64_t *__restrict pos,
                       int64_t *__restrict neg) {
    uint64_t cpw[64], magw[64];
    if (cb > 64 || depth > 64) return;  // caller bounds both far lower
    for (int64_t i = 0; i < w; i += 2) {
        uint64_t hi_ok = (i + 1 < w);
        uint64_t v = valid[i] |
                     (hi_ok ? (uint64_t)valid[i + 1] << 32 : 0);
        if (!v) continue;
        for (int64_t b = 0; b < cb; b++) {
            const uint32_t *p = code_planes + b * w;
            cpw[b] = p[i] | (hi_ok ? (uint64_t)p[i + 1] << 32 : 0);
        }
        uint64_t ew = 0, sw = 0;
        if (bsi) {
            ew = bsi[i] | (hi_ok ? (uint64_t)bsi[i + 1] << 32 : 0);
            if (sign_split)
                sw = bsi[w + i] |
                     (hi_ok ? (uint64_t)bsi[w + i + 1] << 32 : 0);
            for (int64_t p = 0; p < depth; p++) {
                const uint32_t *m = bsi + (2 + p) * w;
                magw[p] = m[i] | (hi_ok ? (uint64_t)m[i + 1] << 32 : 0);
            }
        }
        while (v) {
            int j = __builtin_ctzll(v);
            v &= v - 1;
            int64_t code = 0;
            for (int64_t b = 0; b < cb; b++)
                code |= (int64_t)((cpw[b] >> j) & 1) << b;
            if (code >= n_codes) continue;  // padded digits: unreachable
            counts[code]++;
            if (!bsi || !((ew >> j) & 1)) continue;  // null value
            nn[code]++;
            int64_t *tgt = ((sw >> j) & 1) ? neg + code * depth
                                           : pos + code * depth;
            for (int64_t p = 0; p < depth; p++)
                tgt[p] += (magw[p] >> j) & 1;
        }
    }
}

// The per-group Min/Max magnitude table of one shard (the host twin of
// the fused kernel's presence walk): mm is (4 x n_codes) int64 rows
// [max_mag_pos, min_mag_pos, max_mag_neg, min_mag_neg], pre-filled by
// the caller with the identities -1 and 1 << depth, and updated in
// place for every column that is valid, holds a value (the exists
// plane) and has a code below n_codes.  Without sign_split every value
// counts as non-negative.
void pt_groupcode_minmax(const uint32_t *__restrict code_planes,
                         int64_t cb,
                         const uint32_t *__restrict valid,
                         const uint32_t *__restrict bsi, int64_t depth,
                         int64_t sign_split, int64_t w, int64_t n_codes,
                         int64_t *__restrict mm) {
    if (cb > 64 || depth > 63) return;  // caller bounds both far lower
    for (int64_t i = 0; i < w; i++) {
        uint32_t v = valid[i] & bsi[i];
        if (!v) continue;
        uint32_t sw = sign_split ? bsi[w + i] : 0;
        while (v) {
            int j = __builtin_ctz(v);
            v &= v - 1;
            int64_t code = 0;
            for (int64_t b = 0; b < cb; b++)
                code |= (int64_t)((code_planes[b * w + i] >> j) & 1) << b;
            if (code >= n_codes) continue;
            int64_t mag = 0;
            for (int64_t p = 0; p < depth; p++)
                mag |= (int64_t)((bsi[(2 + p) * w + i] >> j) & 1) << p;
            int64_t *mx = mm + (((sw >> j) & 1) ? 2 : 0) * n_codes;
            int64_t *mn = mx + n_codes;
            if (mag > mx[code]) mx[code] = mag;
            if (mag < mn[code]) mn[code] = mag;
        }
    }
}

}  // extern "C"
