/* rbf_tpu — host-side storage engine for the TPU bitmap framework.
 *
 * A from-scratch, TPU-serving-oriented equivalent of the reference's
 * RBF storage engine (rbf/rbf.go:25-60, rbf/db.go, rbf/tx.go — a
 * single-file "roaring B-tree" with 8KB pages, WAL + checkpointing and
 * one-writer/N-reader MVCC).  Behavior parity, new design:
 *
 *  - pages are only ever written to the main file during checkpoint;
 *    commits append full page images to a WAL and publish an immutable
 *    page-map snapshot, so readers never block and page-number reuse
 *    is race-free by construction;
 *  - a bitmap-container page (1024 x u64 = 8KB) is exactly one page
 *    and decodes 1:1 into the dense uint32 device tile the JAX/Pallas
 *    kernels consume (array/run encodings are host-side compression
 *    only, per SURVEY §2.1 "TPU equivalent");
 *  - the catalog maps bitmap names -> per-bitmap B-tree of containers
 *    keyed by ckey = bit >> 16 (roaring/roaring.go:232 key scheme).
 *
 * C API (extern "C") consumed from Python via ctypes.
 */
#ifndef RBF_TPU_H
#define RBF_TPU_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct rbf_db rbf_db;
typedef struct rbf_tx rbf_tx;
typedef struct rbf_iter rbf_iter;

enum {
  RBF_OK = 0,
  RBF_ERR = -1,          /* generic error; see rbf_errmsg */
  RBF_NOTFOUND = -2,
  RBF_BUSY = -3,         /* writer already active */
  RBF_READONLY = -4,     /* write op on read tx */
  RBF_CORRUPT = -5,
};

/* Container encodings (payload layouts):
 *   ARRAY: n x u16 sorted bit offsets
 *   RUNS:  n x (u16 start, u16 last) inclusive runs
 *   BITMAP: 1024 x u64 dense
 * The page size / dense tile size in bytes is RBF_TILE_BYTES. */
enum { RBF_ENC_ARRAY = 1, RBF_ENC_RUNS = 2, RBF_ENC_BITMAP = 3 };

#define RBF_PAGE_SIZE 8192
#define RBF_TILE_BYTES 8192     /* dense 2^16-bit container */

const char *rbf_errmsg(void);

/* -- database ---------------------------------------------------------- */
rbf_db *rbf_open(const char *path);
int rbf_close(rbf_db *db);
/* Fold committed WAL state into the main file and truncate the WAL.
 * Returns RBF_BUSY if read snapshots are still pinned. */
int rbf_checkpoint(rbf_db *db);
int64_t rbf_wal_size(rbf_db *db);
int64_t rbf_page_count(rbf_db *db);

/* -- transactions ------------------------------------------------------ */
rbf_tx *rbf_begin(rbf_db *db, int writable);
int rbf_commit(rbf_tx *tx);     /* read tx: releases snapshot */
int rbf_rollback(rbf_tx *tx);

/* -- bitmap catalog ---------------------------------------------------- */
int rbf_create_bitmap(rbf_tx *tx, const char *name);
int rbf_delete_bitmap(rbf_tx *tx, const char *name);
int rbf_has_bitmap(rbf_tx *tx, const char *name);
/* Names joined by '\n' into buf (cap bytes); returns total length
 * needed (call twice to size), or <0 on error. */
int64_t rbf_list_bitmaps(rbf_tx *tx, char *buf, int64_t cap);

/* -- containers -------------------------------------------------------- */
/* Store a container from a DENSE 8KB tile; the engine picks the
 * smallest encoding (array/runs/bitmap) exactly like the reference's
 * Container.optimize.  A zero tile removes the container. */
int rbf_put_container(rbf_tx *tx, const char *name, uint64_t ckey,
                      const void *dense8k);
/* Read a container into a DENSE 8KB tile. RBF_NOTFOUND -> tile zeroed. */
int rbf_get_container(rbf_tx *tx, const char *name, uint64_t ckey,
                      void *dense8k);
int rbf_remove_container(rbf_tx *tx, const char *name, uint64_t ckey);
/* Number of containers in the bitmap, or <0. */
int64_t rbf_container_count(rbf_tx *tx, const char *name);
/* Popcount over the whole bitmap, or <0. */
int64_t rbf_bitmap_count(rbf_tx *tx, const char *name);

/* Bulk: read containers ckey in [base, base+n) into n consecutive
 * dense 8KB tiles (missing -> zeros).  This is the HBM upload path. */
int rbf_get_range(rbf_tx *tx, const char *name, uint64_t base, int64_t n,
                  void *dense_tiles);

/* -- iteration --------------------------------------------------------- */
rbf_iter *rbf_iter_open(rbf_tx *tx, const char *name);
/* Advance; fills *ckey and the dense tile. Returns 1, 0 at end, <0 err. */
int rbf_iter_next(rbf_iter *it, uint64_t *ckey, void *dense8k);
void rbf_iter_close(rbf_iter *it);

/* -- standalone container codecs (also used by roaring file import) --- */
/* Encode dense tile -> smallest encoding. Returns payload length,
 * sets *enc. out must hold RBF_TILE_BYTES. */
int32_t rbf_container_encode(const void *dense8k, void *out, int32_t *enc);
/* Decode payload -> dense tile. */
int rbf_container_decode(int32_t enc, const void *payload, int32_t len,
                         void *dense8k);

#ifdef __cplusplus
}
#endif
#endif /* RBF_TPU_H */
