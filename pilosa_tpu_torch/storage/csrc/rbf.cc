// rbf_tpu storage engine — see rbf.h for the design overview.
//
// Parity map (behavior, not code) against the reference engine:
//   - page/WAL/MVCC lifecycle ............ rbf/db.go, rbf/wal.go
//   - bitmap catalog ("root records") .... rbf/tx.go:304 RootRecords
//   - per-bitmap container B-tree ........ rbf/tx.go:487 container ops,
//                                          rbf/cursor.go leaf/branch walk
//   - container encodings array/run/bitmap roaring container_stash.go:46
//   - smallest-encoding choice ........... roaring Container.optimize
//
// Everything here is a fresh C++ design around one invariant the
// reference does not have: the main file is immutable outside
// checkpoint, so snapshot readers only ever need (main file, WAL
// offset map) and never lock.

#include "rbf.h"

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x52424654;  // "RBFT"
constexpr uint32_t kVersion = 1;
constexpr uint32_t kPageSize = RBF_PAGE_SIZE;
constexpr uint32_t kMetaPgno = 0;
constexpr uint32_t kWalCommit = 0xFFFFFFFFu;
constexpr size_t kInlineMax = 2048;   // payloads above this get own page
constexpr int64_t kWordsPerTile = 1024;  // u64 words per dense tile

// page types
enum : uint8_t {
  PT_FREE = 0,
  PT_META = 1,
  PT_CATALOG = 2,
  PT_FREELIST = 3,
  PT_BRANCH = 4,
  PT_LEAF = 5,
  PT_BLOB = 6,
};

thread_local std::string g_err;

int fail(const char *msg) {
  g_err = msg;
  return RBF_ERR;
}

struct Page {
  uint8_t b[kPageSize];
};
using PagePtr = std::shared_ptr<Page>;

// little-endian field access (x86/arm64 hosts; files are LE on disk)
template <typename T>
T rd(const uint8_t *p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;
}
template <typename T>
void wr(uint8_t *p, T v) {
  std::memcpy(p, &v, sizeof(T));
}

// ----- meta page layout ----------------------------------------------------
// [0]  u32 magic       [4]  u32 version
// [8]  u64 page_count  [16] u32 catalog_head  [20] u32 freelist_head
// [24] u64 commit_seq
struct Meta {
  uint64_t page_count = 1;
  uint32_t catalog_head = 0;
  uint32_t freelist_head = 0;
  uint64_t commit_seq = 0;
};

void meta_store(const Meta &m, uint8_t *p) {
  std::memset(p, 0, kPageSize);
  wr<uint32_t>(p, kMagic);
  wr<uint32_t>(p + 4, kVersion);
  wr<uint64_t>(p + 8, m.page_count);
  wr<uint32_t>(p + 16, m.catalog_head);
  wr<uint32_t>(p + 20, m.freelist_head);
  wr<uint64_t>(p + 24, m.commit_seq);
  p[kPageSize - 1] = PT_META;
}

bool meta_load(const uint8_t *p, Meta *m) {
  if (rd<uint32_t>(p) != kMagic || rd<uint32_t>(p + 4) != kVersion)
    return false;
  m->page_count = rd<uint64_t>(p + 8);
  m->catalog_head = rd<uint32_t>(p + 16);
  m->freelist_head = rd<uint32_t>(p + 20);
  m->commit_seq = rd<uint64_t>(p + 24);
  return true;
}

// ----- snapshot ------------------------------------------------------------

struct Snapshot {
  Meta meta;
  // pgno -> byte offset of the page image inside the WAL file
  std::shared_ptr<const std::unordered_map<uint32_t, uint64_t>> walmap;
  std::shared_ptr<const std::map<std::string, uint32_t>> catalog;
};

struct Db;

int64_t file_size(int fd) {
  struct stat st;
  if (fstat(fd, &st) != 0) return -1;
  return st.st_size;
}

}  // namespace

// ----- db ------------------------------------------------------------------

struct rbf_db {
  std::string path;
  int fd = -1;      // main file
  int wal_fd = -1;  // WAL file
  bool nosync = false;

  std::mutex mu;               // guards everything below
  std::shared_ptr<Snapshot> current;
  bool writer_active = false;
  std::atomic<int64_t> pinned_readers{0};
  int64_t wal_bytes = 0;
};

namespace {

bool read_page_at(rbf_db *db, const Snapshot &snap, uint32_t pgno,
                  uint8_t *out) {
  auto it = snap.walmap->find(pgno);
  if (it != snap.walmap->end())
    return pread(db->wal_fd, out, kPageSize, (off_t)it->second) ==
           (ssize_t)kPageSize;
  ssize_t n = pread(db->fd, out, kPageSize, (off_t)pgno * kPageSize);
  if (n == (ssize_t)kPageSize) return true;
  if (n == 0 || n == -1) return false;
  return false;
}

// ----- catalog (de)serialization ------------------------------------------
// CATALOG page: [0] u32 next_pgno, [4] u16 n, entries:
//   u16 name_len, u32 root_pgno, name bytes

using Catalog = std::map<std::string, uint32_t>;

bool catalog_read(rbf_db *db, const Snapshot &snap, Catalog *out) {
  uint32_t pg = snap.meta.catalog_head;
  uint8_t buf[kPageSize];
  while (pg) {
    if (!read_page_at(db, snap, pg, buf)) return false;
    uint32_t next = rd<uint32_t>(buf);
    uint16_t n = rd<uint16_t>(buf + 4);
    size_t off = 6;
    for (uint16_t i = 0; i < n; i++) {
      if (off + 6 > kPageSize) return false;
      uint16_t nl = rd<uint16_t>(buf + off);
      uint32_t root = rd<uint32_t>(buf + off + 2);
      off += 6;
      if (off + nl > kPageSize) return false;
      out->emplace(std::string((const char *)buf + off, nl), root);
      off += nl;
    }
    pg = next;
  }
  return true;
}

// ----- container codecs ----------------------------------------------------

int32_t enc_encode(const uint64_t *tile, uint8_t *out, int32_t *enc) {
  int32_t n = 0;
  int32_t runs = 0;
  bool prev = false;
  for (int64_t w = 0; w < kWordsPerTile; w++) {
    uint64_t v = tile[w];
    n += __builtin_popcountll(v);
    // count 0->1 transitions incl. across word boundary
    uint64_t starts = v & ~((v << 1) | (prev ? 1ull : 0ull));
    runs += __builtin_popcountll(starts);
    prev = v >> 63;
  }
  if (n == 0) {
    *enc = 0;
    return 0;
  }
  int32_t asz = 2 * n, rsz = 4 * runs, bsz = RBF_TILE_BYTES;
  if (asz <= rsz && asz <= bsz) {
    *enc = RBF_ENC_ARRAY;
    uint16_t *a = (uint16_t *)out;
    int32_t k = 0;
    for (int64_t w = 0; w < kWordsPerTile; w++) {
      uint64_t v = tile[w];
      while (v) {
        int b = __builtin_ctzll(v);
        a[k++] = (uint16_t)(w * 64 + b);
        v &= v - 1;
      }
    }
    return asz;
  }
  if (rsz <= bsz) {
    *enc = RBF_ENC_RUNS;
    uint16_t *r = (uint16_t *)out;
    int32_t k = 0;
    int32_t start = -1;
    for (int32_t bit = 0; bit < 65536; bit++) {
      bool set = (tile[bit >> 6] >> (bit & 63)) & 1;
      if (set && start < 0) start = bit;
      if (!set && start >= 0) {
        r[k++] = (uint16_t)start;
        r[k++] = (uint16_t)(bit - 1);
        start = -1;
      }
    }
    if (start >= 0) {
      r[k++] = (uint16_t)start;
      r[k++] = 65535;
    }
    return rsz;
  }
  *enc = RBF_ENC_BITMAP;
  std::memcpy(out, tile, RBF_TILE_BYTES);
  return bsz;
}

int enc_decode(int32_t enc, const uint8_t *payload, int32_t len,
               uint64_t *tile) {
  std::memset(tile, 0, RBF_TILE_BYTES);
  switch (enc) {
    case RBF_ENC_ARRAY: {
      if (len % 2) return RBF_CORRUPT;
      const uint16_t *a = (const uint16_t *)payload;
      for (int32_t i = 0; i < len / 2; i++)
        tile[a[i] >> 6] |= 1ull << (a[i] & 63);
      return RBF_OK;
    }
    case RBF_ENC_RUNS: {
      if (len % 4) return RBF_CORRUPT;
      const uint16_t *r = (const uint16_t *)payload;
      for (int32_t i = 0; i < len / 4; i++) {
        uint32_t s = r[2 * i], e = r[2 * i + 1];
        if (e < s) return RBF_CORRUPT;
        for (uint32_t w = s >> 6; w <= (e >> 6); w++) {
          uint64_t m = ~0ull;
          if (w == (s >> 6)) m &= ~0ull << (s & 63);
          if (w == (e >> 6)) m &= ~0ull >> (63 - (e & 63));
          tile[w] |= m;
        }
      }
      return RBF_OK;
    }
    case RBF_ENC_BITMAP:
      if (len != RBF_TILE_BYTES) return RBF_CORRUPT;
      std::memcpy(tile, payload, RBF_TILE_BYTES);
      return RBF_OK;
    default:
      return RBF_CORRUPT;
  }
}

int64_t payload_popcount(int32_t enc, const uint8_t *payload, int32_t len) {
  switch (enc) {
    case RBF_ENC_ARRAY:
      return len / 2;
    case RBF_ENC_RUNS: {
      const uint16_t *r = (const uint16_t *)payload;
      int64_t n = 0;
      for (int32_t i = 0; i < len / 4; i++)
        n += (int64_t)r[2 * i + 1] - r[2 * i] + 1;
      return n;
    }
    case RBF_ENC_BITMAP: {
      const uint64_t *t = (const uint64_t *)payload;
      int64_t n = 0;
      for (int64_t w = 0; w < kWordsPerTile; w++)
        n += __builtin_popcountll(t[w]);
      return n;
    }
  }
  return 0;
}

}  // namespace

// ----- transaction ---------------------------------------------------------

// LEAF page:   [0] u8 type, [1..2] u16 n, [4] u16 used(bytes incl header)
//   cells (sorted by ckey): u64 ckey, u8 enc, u8 flags, u16 len, payload
//   flags bit0: payload is u32 pgno of a PT_BLOB page holding `len` bytes
// BRANCH page: [0] u8 type, [1..2] u16 n
//   entries: u64 min_key, u32 child   (n entries, sorted)
// BLOB page:   raw payload bytes (len tracked by the leaf cell)

namespace {
constexpr size_t kLeafHdr = 6;
constexpr size_t kCellHdr = 12;
constexpr size_t kBranchHdr = 4;
constexpr size_t kBranchEntry = 12;
constexpr uint8_t kCellRef = 1;
}  // namespace

struct rbf_tx {
  rbf_db *db = nullptr;
  std::shared_ptr<Snapshot> snap;
  bool writable = false;
  bool done = false;

  // write state
  std::unordered_map<uint32_t, PagePtr> dirty;
  Catalog catalog;  // private copy (writable tx)
  std::vector<uint32_t> freelist;
  uint64_t page_count = 0;
  bool catalog_dirty = false;

  // read-only access to a page: returns pointer valid until tx end
  const uint8_t *page(uint32_t pgno) {
    auto it = dirty.find(pgno);
    if (it != dirty.end()) return it->second->b;
    auto c = cache.find(pgno);
    if (c != cache.end()) return c->second->b;
    auto p = std::make_shared<Page>();
    if (!read_page_at(db, *snap, pgno, p->b)) return nullptr;
    cache.emplace(pgno, p);
    return p->b;
  }
  // writable copy of a page
  uint8_t *wpage(uint32_t pgno) {
    auto it = dirty.find(pgno);
    if (it != dirty.end()) return it->second->b;
    auto p = std::make_shared<Page>();
    auto c = cache.find(pgno);
    if (c != cache.end()) {
      // keep the cache entry alive: callers may hold pointers into it
      // (page() checks `dirty` first, so it is shadowed from now on)
      std::memcpy(p->b, c->second->b, kPageSize);
    } else if (pgno < page_count) {
      if (!read_page_at(db, *snap, pgno, p->b))
        std::memset(p->b, 0, kPageSize);
    } else {
      std::memset(p->b, 0, kPageSize);
    }
    dirty.emplace(pgno, p);
    return p->b;
  }
  uint32_t alloc() {
    uint32_t pg;
    if (!freelist.empty()) {
      pg = freelist.back();
      freelist.pop_back();
    } else {
      pg = (uint32_t)page_count++;
    }
    auto p = std::make_shared<Page>();
    std::memset(p->b, 0, kPageSize);
    dirty[pg] = p;
    return pg;
  }
  void free_page(uint32_t pgno) {
    dirty.erase(pgno);
    freelist.push_back(pgno);
  }

 private:
  std::unordered_map<uint32_t, PagePtr> cache;
};

namespace {

// ----- freelist persistence ------------------------------------------------
// FREELIST page: [0] u32 next, [4] u32 n, n x u32 pgnos

bool freelist_read(rbf_tx *tx, uint32_t head, std::vector<uint32_t> *out,
                   std::vector<uint32_t> *own_pages) {
  while (head) {
    const uint8_t *p = tx->page(head);
    if (!p) return false;
    own_pages->push_back(head);
    uint32_t next = rd<uint32_t>(p);
    uint32_t n = rd<uint32_t>(p + 4);
    if (8 + 4ull * n > kPageSize) return false;
    for (uint32_t i = 0; i < n; i++)
      out->push_back(rd<uint32_t>(p + 8 + 4 * i));
    head = next;
  }
  return true;
}

// ----- leaf/branch cell helpers -------------------------------------------

struct LeafCell {
  uint64_t ckey;
  uint8_t enc;
  uint8_t flags;
  uint16_t len;
  const uint8_t *payload;  // inline payload or 4-byte pgno
};

uint16_t leaf_n(const uint8_t *p) { return rd<uint16_t>(p + 1); }

// scan cells sequentially (variable size)
void leaf_cells(const uint8_t *p, std::vector<LeafCell> *out) {
  uint16_t n = leaf_n(p);
  size_t off = kLeafHdr;
  out->clear();
  out->reserve(n);
  for (uint16_t i = 0; i < n; i++) {
    LeafCell c;
    c.ckey = rd<uint64_t>(p + off);
    c.enc = p[off + 8];
    c.flags = p[off + 9];
    c.len = rd<uint16_t>(p + off + 10);
    c.payload = p + off + kCellHdr;
    off += kCellHdr + ((c.flags & kCellRef) ? 4 : c.len);
    out->push_back(c);
  }
}

size_t cell_size(const LeafCell &c) {
  return kCellHdr + ((c.flags & kCellRef) ? 4 : c.len);
}

void leaf_write(uint8_t *p, const std::vector<LeafCell> &cells) {
  uint8_t tmp[kPageSize];
  size_t off = kLeafHdr;
  for (auto &c : cells) {
    wr<uint64_t>(tmp + off, c.ckey);
    tmp[off + 8] = c.enc;
    tmp[off + 9] = c.flags;
    wr<uint16_t>(tmp + off + 10, c.len);
    std::memcpy(tmp + off + kCellHdr, c.payload,
                (c.flags & kCellRef) ? 4 : c.len);
    off += cell_size(c);
  }
  tmp[0] = PT_LEAF;
  wr<uint16_t>(tmp + 1, (uint16_t)cells.size());
  tmp[3] = 0;
  wr<uint16_t>(tmp + 4, (uint16_t)off);
  std::memset(tmp + off, 0, kPageSize - off);
  std::memcpy(p, tmp, kPageSize);
}

uint16_t branch_n(const uint8_t *p) { return rd<uint16_t>(p + 1); }

void branch_entry(const uint8_t *p, uint16_t i, uint64_t *key,
                  uint32_t *child) {
  const uint8_t *e = p + kBranchHdr + (size_t)i * kBranchEntry;
  *key = rd<uint64_t>(e);
  *child = rd<uint32_t>(e + 8);
}

void branch_write(uint8_t *p,
                  const std::vector<std::pair<uint64_t, uint32_t>> &es) {
  uint8_t tmp[kPageSize];
  std::memset(tmp, 0, kPageSize);
  tmp[0] = PT_BRANCH;
  wr<uint16_t>(tmp + 1, (uint16_t)es.size());
  size_t off = kBranchHdr;
  for (auto &e : es) {
    wr<uint64_t>(tmp + off, e.first);
    wr<uint32_t>(tmp + off + 8, e.second);
    off += kBranchEntry;
  }
  std::memcpy(p, tmp, kPageSize);
}

// choose child index for key in a branch (last entry with min_key <= key,
// clamped to 0)
int branch_child_idx(const uint8_t *p, uint64_t key) {
  uint16_t n = branch_n(p);
  int lo = 0, hi = n - 1, ans = 0;
  while (lo <= hi) {
    int mid = (lo + hi) / 2;
    uint64_t k;
    uint32_t ch;
    branch_entry(p, (uint16_t)mid, &k, &ch);
    if (k <= key) {
      ans = mid;
      lo = mid + 1;
    } else {
      hi = mid - 1;
    }
  }
  return ans;
}

// ----- B-tree operations ---------------------------------------------------

struct PathEl {
  uint32_t pgno;
  int idx;  // child index taken (branch only)
};

// descend to the leaf that would hold ckey; fills path (branches) and
// returns leaf pgno, or 0 on error
uint32_t btree_descend(rbf_tx *tx, uint32_t root, uint64_t ckey,
                       std::vector<PathEl> *path) {
  uint32_t pg = root;
  for (int depth = 0; depth < 64; depth++) {
    const uint8_t *p = tx->page(pg);
    if (!p) return 0;
    if (p[0] == PT_LEAF) return pg;
    if (p[0] != PT_BRANCH) return 0;
    int i = branch_child_idx(p, ckey);
    uint64_t k;
    uint32_t child;
    branch_entry(p, (uint16_t)i, &k, &child);
    if (path) path->push_back({pg, i});
    pg = child;
  }
  return 0;
}

int btree_find(rbf_tx *tx, uint32_t root, uint64_t ckey, LeafCell *out,
               const uint8_t **leaf_page) {
  uint32_t leaf = btree_descend(tx, root, ckey, nullptr);
  if (!leaf) return fail("btree descend failed"), RBF_CORRUPT;
  const uint8_t *p = tx->page(leaf);
  if (!p) return RBF_CORRUPT;
  std::vector<LeafCell> cells;
  leaf_cells(p, &cells);
  for (auto &c : cells) {
    if (c.ckey == ckey) {
      *out = c;
      if (leaf_page) *leaf_page = p;
      return RBF_OK;
    }
  }
  return RBF_NOTFOUND;
}

// update parents after a child split: insert (key,new_child) after idx
// in each parent, splitting branches as needed; may grow a new root.
int btree_insert_up(rbf_tx *tx, std::vector<PathEl> &path, uint64_t key,
                    uint32_t child, uint32_t *root) {
  while (!path.empty()) {
    PathEl el = path.back();
    path.pop_back();
    const uint8_t *p = tx->page(el.pgno);
    if (!p) return RBF_CORRUPT;
    std::vector<std::pair<uint64_t, uint32_t>> es(branch_n(p));
    for (uint16_t i = 0; i < es.size(); i++)
      branch_entry(p, i, &es[i].first, &es[i].second);
    es.insert(es.begin() + el.idx + 1, {key, child});
    size_t cap = (kPageSize - kBranchHdr) / kBranchEntry;
    if (es.size() <= cap) {
      branch_write(tx->wpage(el.pgno), es);
      return RBF_OK;
    }
    // split branch
    size_t half = es.size() / 2;
    std::vector<std::pair<uint64_t, uint32_t>> left(es.begin(),
                                                    es.begin() + half);
    std::vector<std::pair<uint64_t, uint32_t>> right(es.begin() + half,
                                                     es.end());
    uint32_t rpg = tx->alloc();
    branch_write(tx->wpage(el.pgno), left);
    branch_write(tx->wpage(rpg), right);
    key = right.front().first;
    child = rpg;
  }
  // grew past the root
  uint32_t nr = tx->alloc();
  const uint8_t *oldr = tx->page(*root);
  if (!oldr) return RBF_CORRUPT;
  uint64_t lmin = 0;
  if (oldr[0] == PT_BRANCH) {
    uint32_t ch;
    branch_entry(oldr, 0, &lmin, &ch);
  } else {
    std::vector<LeafCell> cells;
    leaf_cells(oldr, &cells);
    lmin = cells.empty() ? 0 : cells.front().ckey;
  }
  branch_write(tx->wpage(nr), {{lmin, *root}, {key, child}});
  *root = nr;
  return RBF_OK;
}

int btree_put(rbf_tx *tx, uint32_t *root, uint64_t ckey, uint8_t enc,
              const uint8_t *payload, uint16_t len) {
  std::vector<PathEl> path;
  uint32_t leaf = btree_descend(tx, *root, ckey, &path);
  if (!leaf) return fail("btree descend failed"), RBF_CORRUPT;
  const uint8_t *p = tx->page(leaf);
  if (!p) return RBF_CORRUPT;
  std::vector<LeafCell> cells;
  leaf_cells(p, &cells);

  // build the new cell (blob-backed when large)
  LeafCell nc;
  nc.ckey = ckey;
  nc.enc = enc;
  uint8_t refbuf[4];
  if (len > kInlineMax) {
    uint32_t bp = tx->alloc();
    uint8_t *bpg = tx->wpage(bp);
    std::memcpy(bpg, payload, len);
    if (len < kPageSize) std::memset(bpg + len, 0, kPageSize - len);
    wr<uint32_t>(refbuf, bp);
    nc.flags = kCellRef;
    nc.len = len;
    nc.payload = refbuf;
  } else {
    nc.flags = 0;
    nc.len = len;
    nc.payload = payload;
  }

  // replace or insert sorted
  auto it = std::lower_bound(
      cells.begin(), cells.end(), ckey,
      [](const LeafCell &c, uint64_t k) { return c.ckey < k; });
  if (it != cells.end() && it->ckey == ckey) {
    if (it->flags & kCellRef) tx->free_page(rd<uint32_t>(it->payload));
    *it = nc;
  } else {
    it = cells.insert(it, nc);
  }

  size_t used = kLeafHdr;
  for (auto &c : cells) used += cell_size(c);
  if (used <= kPageSize) {
    leaf_write(tx->wpage(leaf), cells);
    return RBF_OK;
  }
  // split leaf: left half stays, right half to a new page
  size_t half = cells.size() / 2;
  if (half == 0) return fail("cell too large for page"), RBF_ERR;
  // Half the cells by count keeps the page images of the JAX package's
  // copy of this file.  Cells differ in size (inline payloads up to
  // kInlineMax), so that half can still overflow a page: then split
  // where the bytes balance, which always fits two pages.
  size_t left_bytes = kLeafHdr;
  for (size_t i = 0; i < half; i++) left_bytes += cell_size(cells[i]);
  if (left_bytes > kPageSize || used - left_bytes + kLeafHdr > kPageSize) {
    size_t best = 0, best_max = SIZE_MAX;
    left_bytes = kLeafHdr;
    for (size_t i = 1; i < cells.size(); i++) {
      left_bytes += cell_size(cells[i - 1]);
      size_t m = std::max(left_bytes, used - left_bytes + kLeafHdr);
      if (m < best_max) {
        best_max = m;
        best = i;
      }
    }
    if (best_max > kPageSize) return fail("cell too large for page"), RBF_ERR;
    half = best;
  }
  std::vector<LeafCell> left(cells.begin(), cells.begin() + half);
  std::vector<LeafCell> right(cells.begin() + half, cells.end());
  // cell payload pointers may point into the old page image; copy
  // the old page before overwriting
  uint8_t old[kPageSize];
  std::memcpy(old, p, kPageSize);
  auto rebase = [&](std::vector<LeafCell> &v) {
    for (auto &c : v)
      if (c.payload >= p && c.payload < p + kPageSize)
        c.payload = old + (c.payload - p);
  };
  rebase(left);
  rebase(right);
  uint32_t rpg = tx->alloc();
  leaf_write(tx->wpage(leaf), left);
  leaf_write(tx->wpage(rpg), right);
  return btree_insert_up(tx, path, right.front().ckey, rpg, root);
}

int btree_remove(rbf_tx *tx, uint32_t *root, uint64_t ckey, bool *removed) {
  *removed = false;
  std::vector<PathEl> path;
  uint32_t leaf = btree_descend(tx, *root, ckey, &path);
  if (!leaf) return fail("btree descend failed"), RBF_CORRUPT;
  const uint8_t *p = tx->page(leaf);
  if (!p) return RBF_CORRUPT;
  std::vector<LeafCell> cells;
  leaf_cells(p, &cells);
  auto it = std::lower_bound(
      cells.begin(), cells.end(), ckey,
      [](const LeafCell &c, uint64_t k) { return c.ckey < k; });
  if (it == cells.end() || it->ckey != ckey) return RBF_OK;
  if (it->flags & kCellRef) tx->free_page(rd<uint32_t>(it->payload));
  cells.erase(it);
  *removed = true;
  if (!cells.empty() || path.empty()) {
    leaf_write(tx->wpage(leaf), cells);
    return RBF_OK;
  }
  // empty non-root leaf: unlink from parents (allow underfull branches;
  // only empty pages are reclaimed — same tolerance as the reference)
  tx->free_page(leaf);
  while (!path.empty()) {
    PathEl el = path.back();
    path.pop_back();
    const uint8_t *bp = tx->page(el.pgno);
    if (!bp) return RBF_CORRUPT;
    std::vector<std::pair<uint64_t, uint32_t>> es(branch_n(bp));
    for (uint16_t i = 0; i < es.size(); i++)
      branch_entry(bp, i, &es[i].first, &es[i].second);
    es.erase(es.begin() + el.idx);
    if (!es.empty()) {
      if (es.size() == 1 && path.empty() && el.pgno == *root) {
        // collapse single-child root
        *root = es[0].second;
        tx->free_page(el.pgno);
      } else {
        branch_write(tx->wpage(el.pgno), es);
      }
      return RBF_OK;
    }
    tx->free_page(el.pgno);
    if (path.empty() && el.pgno == *root) {
      // whole tree empty: recreate an empty leaf root
      uint32_t nl = tx->alloc();
      leaf_write(tx->wpage(nl), {});
      *root = nl;
      return RBF_OK;
    }
  }
  return RBF_OK;
}

// free every page of a b-tree (bitmap deletion)
int btree_free(rbf_tx *tx, uint32_t root) {
  const uint8_t *p = tx->page(root);
  if (!p) return RBF_CORRUPT;
  if (p[0] == PT_BRANCH) {
    uint16_t n = branch_n(p);
    std::vector<uint32_t> children(n);
    for (uint16_t i = 0; i < n; i++) {
      uint64_t k;
      branch_entry(p, i, &k, &children[i]);
    }
    for (uint32_t c : children) {
      int rc = btree_free(tx, c);
      if (rc != RBF_OK) return rc;
    }
  } else if (p[0] == PT_LEAF) {
    std::vector<LeafCell> cells;
    leaf_cells(p, &cells);
    for (auto &c : cells)
      if (c.flags & kCellRef) tx->free_page(rd<uint32_t>(c.payload));
  } else {
    return RBF_CORRUPT;
  }
  tx->free_page(root);
  return RBF_OK;
}

// in-order walk of leaves, calling fn(cell). fn returns false to stop.
template <typename F>
int btree_walk(rbf_tx *tx, uint32_t pgno, F &&fn) {
  const uint8_t *p = tx->page(pgno);
  if (!p) return RBF_CORRUPT;
  if (p[0] == PT_BRANCH) {
    uint16_t n = branch_n(p);
    std::vector<uint32_t> children(n);
    for (uint16_t i = 0; i < n; i++) {
      uint64_t k;
      branch_entry(p, i, &k, &children[i]);
    }
    for (uint32_t c : children) {
      int rc = btree_walk(tx, c, fn);
      if (rc != RBF_OK) return rc;
    }
    return RBF_OK;
  }
  if (p[0] != PT_LEAF) return RBF_CORRUPT;
  std::vector<LeafCell> cells;
  leaf_cells(p, &cells);
  for (auto &c : cells)
    if (!fn(c)) return RBF_OK;
  return RBF_OK;
}

// resolve a cell's payload (follows blob refs); buf must hold a page
const uint8_t *cell_payload(rbf_tx *tx, const LeafCell &c) {
  if (!(c.flags & kCellRef)) return c.payload;
  uint32_t bp = rd<uint32_t>(c.payload);
  return tx->page(bp);
}

int tx_check(rbf_tx *tx, bool need_write) {
  if (!tx || tx->done) return fail("tx finished"), RBF_ERR;
  if (need_write && !tx->writable) return RBF_READONLY;
  return RBF_OK;
}

int catalog_root(rbf_tx *tx, const char *name, uint32_t *root) {
  const Catalog &cat =
      tx->writable ? tx->catalog : *tx->snap->catalog;
  auto it = cat.find(name);
  if (it == cat.end()) return RBF_NOTFOUND;
  *root = it->second;
  return RBF_OK;
}

}  // namespace

// ----- public API ----------------------------------------------------------

const char *rbf_errmsg(void) { return g_err.c_str(); }

static bool wal_replay(rbf_db *db, Meta *meta,
                       std::unordered_map<uint32_t, uint64_t> *map) {
  int64_t sz = file_size(db->wal_fd);
  if (sz < 0) return false;
  std::unordered_map<uint32_t, uint64_t> pending;
  int64_t off = 0, committed_end = 0;
  uint8_t hdr[8];
  uint8_t page[kPageSize];
  while (off + 8 <= sz) {
    if (pread(db->wal_fd, hdr, 8, off) != 8) break;
    uint32_t pgno = rd<uint32_t>(hdr);
    if (pgno == kWalCommit) {
      // commit frame: u32 marker, u32 len(unused), then meta page image
      if (off + 8 + kPageSize > sz) break;
      if (pread(db->wal_fd, page, kPageSize, off + 8) != kPageSize) break;
      Meta m;
      if (!meta_load(page, &m)) break;
      for (auto &kv : pending) (*map)[kv.first] = kv.second;
      pending.clear();
      *meta = m;
      off += 8 + kPageSize;
      committed_end = off;
      continue;
    }
    if (off + 8 + kPageSize > sz) break;
    pending[pgno] = (uint64_t)(off + 8);
    off += 8 + kPageSize;
  }
  db->wal_bytes = committed_end;
  // drop any torn tail so future appends start at a clean boundary
  if (committed_end < sz) {
    if (ftruncate(db->wal_fd, committed_end) != 0) return false;
  }
  return true;
}

rbf_db *rbf_open(const char *path) {
  auto db = std::make_unique<rbf_db>();
  db->path = path;
  db->nosync = getenv("RBF_NOSYNC") != nullptr;
  db->fd = open(path, O_RDWR | O_CREAT, 0644);
  if (db->fd < 0) {
    g_err = std::string("open failed: ") + strerror(errno);
    return nullptr;
  }
  std::string wal = std::string(path) + ".wal";
  db->wal_fd = open(wal.c_str(), O_RDWR | O_CREAT, 0644);
  if (db->wal_fd < 0) {
    g_err = std::string("wal open failed: ") + strerror(errno);
    close(db->fd);
    return nullptr;
  }

  Meta meta;
  int64_t main_sz = file_size(db->fd);
  if (main_sz >= (int64_t)kPageSize) {
    uint8_t b[kPageSize];
    if (pread(db->fd, b, kPageSize, 0) != (ssize_t)kPageSize ||
        !meta_load(b, &meta)) {
      g_err = "bad meta page";
      close(db->fd);
      close(db->wal_fd);
      return nullptr;
    }
  } else {
    // fresh file: write initial meta
    uint8_t b[kPageSize];
    meta_store(meta, b);
    if (pwrite(db->fd, b, kPageSize, 0) != (ssize_t)kPageSize) {
      g_err = "init write failed";
      close(db->fd);
      close(db->wal_fd);
      return nullptr;
    }
  }

  auto map = std::make_shared<std::unordered_map<uint32_t, uint64_t>>();
  if (!wal_replay(db.get(), &meta, map.get())) {
    g_err = "wal replay failed";
    close(db->fd);
    close(db->wal_fd);
    return nullptr;
  }

  auto snap = std::make_shared<Snapshot>();
  snap->meta = meta;
  snap->walmap = map;
  auto cat = std::make_shared<Catalog>();
  {
    // bootstrap a throwaway tx-less read of the catalog
    rbf_tx tmp;
    tmp.db = db.get();
    tmp.snap = snap;
    tmp.done = false;
    Catalog c;
    rbf_tx *tp = &tmp;
    (void)tp;
    if (!catalog_read(db.get(), *snap, &c)) {
      g_err = "catalog read failed";
      close(db->fd);
      close(db->wal_fd);
      return nullptr;
    }
    *cat = std::move(c);
    tmp.done = true;
  }
  snap->catalog = cat;
  db->current = snap;
  return db.release();
}

int rbf_close(rbf_db *db) {
  if (!db) return RBF_OK;
  {
    std::lock_guard<std::mutex> g(db->mu);
    if (db->writer_active) return fail("writer active"), RBF_BUSY;
    if (db->pinned_readers.load() > 0)
      return fail("read transactions still open"), RBF_BUSY;
  }
  close(db->fd);
  close(db->wal_fd);
  delete db;
  return RBF_OK;
}

int64_t rbf_wal_size(rbf_db *db) { return db->wal_bytes; }
int64_t rbf_page_count(rbf_db *db) {
  std::lock_guard<std::mutex> g(db->mu);
  return (int64_t)db->current->meta.page_count;
}

rbf_tx *rbf_begin(rbf_db *db, int writable) {
  std::lock_guard<std::mutex> g(db->mu);
  if (writable) {
    if (db->writer_active) {
      g_err = "another write tx is active";
      return nullptr;
    }
    db->writer_active = true;
  } else {
    db->pinned_readers.fetch_add(1);
  }
  auto tx = new rbf_tx();
  tx->db = db;
  tx->snap = db->current;
  tx->writable = writable != 0;
  if (writable) {
    tx->catalog = *db->current->catalog;
    tx->page_count = db->current->meta.page_count;
    std::vector<uint32_t> own;
    if (!freelist_read(tx, db->current->meta.freelist_head, &tx->freelist,
                       &own)) {
      // freelist pages themselves become free once loaded
      g_err = "freelist read failed";
      db->writer_active = false;
      delete tx;
      return nullptr;
    }
    for (uint32_t pg : own) tx->freelist.push_back(pg);
  }
  return tx;
}

int rbf_rollback(rbf_tx *tx) {
  if (!tx || tx->done) return RBF_OK;
  std::lock_guard<std::mutex> g(tx->db->mu);
  if (tx->writable)
    tx->db->writer_active = false;
  else
    tx->db->pinned_readers.fetch_sub(1);
  tx->done = true;
  delete tx;
  return RBF_OK;
}

int rbf_commit(rbf_tx *tx) {
  if (!tx || tx->done) return fail("tx finished"), RBF_ERR;
  rbf_db *db = tx->db;
  if (!tx->writable) {
    std::lock_guard<std::mutex> g(db->mu);
    db->pinned_readers.fetch_sub(1);
    tx->done = true;
    delete tx;
    return RBF_OK;
  }

  // serialize catalog into fresh pages
  {
    // free old catalog chain
    uint32_t pg = tx->snap->meta.catalog_head;
    while (pg) {
      const uint8_t *p = tx->page(pg);
      if (!p) {
        rbf_rollback(tx);
        return RBF_CORRUPT;
      }
      uint32_t next = rd<uint32_t>(p);
      tx->free_page(pg);
      pg = next;
    }
    uint32_t head = 0;
    // write entries, chaining pages as needed (reverse order so each
    // page can point at the already-written next one)
    std::vector<std::vector<std::pair<std::string, uint32_t>>> chunks;
    chunks.emplace_back();
    size_t used = 6;
    for (auto &kv : tx->catalog) {
      size_t need = 6 + kv.first.size();
      if (used + need > kPageSize) {
        chunks.emplace_back();
        used = 6;
      }
      chunks.back().push_back({kv.first, kv.second});
      used += need;
    }
    for (auto it = chunks.rbegin(); it != chunks.rend(); ++it) {
      if (it->empty() && chunks.size() > 1) continue;
      uint32_t pg2 = tx->alloc();
      uint8_t *p = tx->wpage(pg2);
      std::memset(p, 0, kPageSize);
      wr<uint32_t>(p, head);
      wr<uint16_t>(p + 4, (uint16_t)it->size());
      size_t off = 6;
      for (auto &kv : *it) {
        wr<uint16_t>(p + off, (uint16_t)kv.first.size());
        wr<uint32_t>(p + off + 2, kv.second);
        off += 6;
        std::memcpy(p + off, kv.first.data(), kv.first.size());
        off += kv.first.size();
      }
      p[kPageSize - 1] = PT_CATALOG;
      head = pg2;
    }
    if (tx->catalog.empty()) head = 0;
    // persist freelist into fresh pages (allocated from page_count so
    // they don't consume themselves)
    uint32_t fhead = 0;
    if (!tx->freelist.empty()) {
      size_t per = (kPageSize - 8) / 4;
      std::vector<uint32_t> fl = tx->freelist;
      std::vector<std::vector<uint32_t>> fchunks;
      for (size_t i = 0; i < fl.size(); i += per)
        fchunks.emplace_back(fl.begin() + i,
                             fl.begin() + std::min(fl.size(), i + per));
      for (auto it = fchunks.rbegin(); it != fchunks.rend(); ++it) {
        uint32_t pg2 = (uint32_t)tx->page_count++;
        auto pp = std::make_shared<Page>();
        std::memset(pp->b, 0, kPageSize);
        wr<uint32_t>(pp->b, fhead);
        wr<uint32_t>(pp->b + 4, (uint32_t)it->size());
        for (size_t i = 0; i < it->size(); i++)
          wr<uint32_t>(pp->b + 8 + 4 * i, (*it)[i]);
        tx->dirty[pg2] = pp;
        fhead = pg2;
      }
    }
    Meta nm;
    nm.page_count = tx->page_count;
    nm.catalog_head = head;
    nm.freelist_head = fhead;
    nm.commit_seq = tx->snap->meta.commit_seq + 1;

    // append dirty pages + commit frame to the WAL
    std::vector<uint8_t> buf;
    buf.reserve(tx->dirty.size() * (kPageSize + 8) + kPageSize + 8);
    std::unordered_map<uint32_t, uint64_t> offsets;
    int64_t base = db->wal_bytes;
    for (auto &kv : tx->dirty) {
      uint8_t hdr[8] = {0};
      wr<uint32_t>(hdr, kv.first);
      offsets[kv.first] = (uint64_t)(base + buf.size() + 8);
      buf.insert(buf.end(), hdr, hdr + 8);
      buf.insert(buf.end(), kv.second->b, kv.second->b + kPageSize);
    }
    uint8_t chdr[8] = {0};
    wr<uint32_t>(chdr, kWalCommit);
    buf.insert(buf.end(), chdr, chdr + 8);
    uint8_t mp[kPageSize];
    meta_store(nm, mp);
    buf.insert(buf.end(), mp, mp + kPageSize);

    if (pwrite(db->wal_fd, buf.data(), buf.size(), base) !=
        (ssize_t)buf.size()) {
      rbf_rollback(tx);
      return fail("wal write failed"), RBF_ERR;
    }
    if (!db->nosync && fsync(db->wal_fd) != 0) {
      rbf_rollback(tx);
      return fail("wal fsync failed"), RBF_ERR;
    }

    // publish the new snapshot
    std::lock_guard<std::mutex> g(db->mu);
    db->wal_bytes = base + (int64_t)buf.size();
    auto nmap = std::make_shared<std::unordered_map<uint32_t, uint64_t>>(
        *db->current->walmap);
    for (auto &kv : offsets) (*nmap)[kv.first] = kv.second;
    auto nsnap = std::make_shared<Snapshot>();
    nsnap->meta = nm;
    nsnap->walmap = nmap;
    nsnap->catalog = std::make_shared<Catalog>(std::move(tx->catalog));
    db->current = nsnap;
    db->writer_active = false;
  }
  tx->done = true;
  delete tx;
  return RBF_OK;
}

int rbf_checkpoint(rbf_db *db) {
  std::lock_guard<std::mutex> g(db->mu);
  if (db->writer_active) return RBF_BUSY;
  if (db->pinned_readers.load() > 0) return RBF_BUSY;
  auto snap = db->current;
  if (snap->walmap->empty() && db->wal_bytes == 0) return RBF_OK;
  uint8_t page[kPageSize];
  for (auto &kv : *snap->walmap) {
    if (pread(db->wal_fd, page, kPageSize, (off_t)kv.second) !=
        (ssize_t)kPageSize)
      return fail("checkpoint read failed"), RBF_ERR;
    if (pwrite(db->fd, page, kPageSize, (off_t)kv.first * kPageSize) !=
        (ssize_t)kPageSize)
      return fail("checkpoint write failed"), RBF_ERR;
  }
  meta_store(snap->meta, page);
  if (pwrite(db->fd, page, kPageSize, 0) != (ssize_t)kPageSize)
    return fail("checkpoint meta write failed"), RBF_ERR;
  if (!db->nosync && fsync(db->fd) != 0)
    return fail("checkpoint fsync failed"), RBF_ERR;
  if (ftruncate(db->wal_fd, 0) != 0)
    return fail("wal truncate failed"), RBF_ERR;
  if (!db->nosync) fsync(db->wal_fd);
  db->wal_bytes = 0;
  auto nsnap = std::make_shared<Snapshot>();
  nsnap->meta = snap->meta;
  nsnap->walmap =
      std::make_shared<std::unordered_map<uint32_t, uint64_t>>();
  nsnap->catalog = snap->catalog;
  db->current = nsnap;
  return RBF_OK;
}

// ----- catalog ops ---------------------------------------------------------

int rbf_create_bitmap(rbf_tx *tx, const char *name) {
  int rc = tx_check(tx, true);
  if (rc != RBF_OK) return rc;
  if (tx->catalog.count(name)) return RBF_OK;
  uint32_t leaf = tx->alloc();
  leaf_write(tx->wpage(leaf), {});
  tx->catalog[name] = leaf;
  return RBF_OK;
}

int rbf_delete_bitmap(rbf_tx *tx, const char *name) {
  int rc = tx_check(tx, true);
  if (rc != RBF_OK) return rc;
  auto it = tx->catalog.find(name);
  if (it == tx->catalog.end()) return RBF_NOTFOUND;
  rc = btree_free(tx, it->second);
  if (rc != RBF_OK) return rc;
  tx->catalog.erase(it);
  return RBF_OK;
}

int rbf_has_bitmap(rbf_tx *tx, const char *name) {
  int rc = tx_check(tx, false);
  if (rc != RBF_OK) return rc;
  const Catalog &cat = tx->writable ? tx->catalog : *tx->snap->catalog;
  return cat.count(name) ? 1 : 0;
}

int64_t rbf_list_bitmaps(rbf_tx *tx, char *buf, int64_t cap) {
  int rc = tx_check(tx, false);
  if (rc != RBF_OK) return rc;
  const Catalog &cat = tx->writable ? tx->catalog : *tx->snap->catalog;
  int64_t need = 0;
  for (auto &kv : cat) need += (int64_t)kv.first.size() + 1;
  if (buf && cap >= need) {
    char *p = buf;
    for (auto &kv : cat) {
      std::memcpy(p, kv.first.data(), kv.first.size());
      p += kv.first.size();
      *p++ = '\n';
    }
  }
  return need;
}

// ----- container ops -------------------------------------------------------

int rbf_put_container(rbf_tx *tx, const char *name, uint64_t ckey,
                      const void *dense8k) {
  int rc = tx_check(tx, true);
  if (rc != RBF_OK) return rc;
  uint32_t root;
  rc = catalog_root(tx, name, &root);
  if (rc != RBF_OK) return fail("no such bitmap"), rc;
  uint8_t payload[RBF_TILE_BYTES];
  int32_t enc;
  int32_t len = enc_encode((const uint64_t *)dense8k, payload, &enc);
  if (len == 0) {
    bool removed;
    rc = btree_remove(tx, &root, ckey, &removed);
    if (rc == RBF_OK) tx->catalog[name] = root;
    return rc;
  }
  rc = btree_put(tx, &root, ckey, (uint8_t)enc, payload, (uint16_t)len);
  if (rc == RBF_OK) tx->catalog[name] = root;
  return rc;
}

int rbf_get_container(rbf_tx *tx, const char *name, uint64_t ckey,
                      void *dense8k) {
  int rc = tx_check(tx, false);
  if (rc != RBF_OK) return rc;
  uint32_t root;
  rc = catalog_root(tx, name, &root);
  if (rc == RBF_NOTFOUND) {
    std::memset(dense8k, 0, RBF_TILE_BYTES);
    return RBF_NOTFOUND;
  }
  LeafCell c;
  rc = btree_find(tx, root, ckey, &c, nullptr);
  if (rc == RBF_NOTFOUND) {
    std::memset(dense8k, 0, RBF_TILE_BYTES);
    return RBF_NOTFOUND;
  }
  if (rc != RBF_OK) return rc;
  const uint8_t *pl = cell_payload(tx, c);
  if (!pl) return RBF_CORRUPT;
  return enc_decode(c.enc, pl, c.len, (uint64_t *)dense8k);
}

int rbf_remove_container(rbf_tx *tx, const char *name, uint64_t ckey) {
  int rc = tx_check(tx, true);
  if (rc != RBF_OK) return rc;
  uint32_t root;
  rc = catalog_root(tx, name, &root);
  if (rc != RBF_OK) return rc;
  bool removed;
  rc = btree_remove(tx, &root, ckey, &removed);
  if (rc == RBF_OK) tx->catalog[name] = root;
  return rc == RBF_OK ? (removed ? RBF_OK : RBF_NOTFOUND) : rc;
}

int64_t rbf_container_count(rbf_tx *tx, const char *name) {
  int rc = tx_check(tx, false);
  if (rc != RBF_OK) return rc;
  uint32_t root;
  rc = catalog_root(tx, name, &root);
  if (rc == RBF_NOTFOUND) return 0;
  int64_t n = 0;
  rc = btree_walk(tx, root, [&](const LeafCell &) {
    n++;
    return true;
  });
  return rc == RBF_OK ? n : rc;
}

int64_t rbf_bitmap_count(rbf_tx *tx, const char *name) {
  int rc = tx_check(tx, false);
  if (rc != RBF_OK) return rc;
  uint32_t root;
  rc = catalog_root(tx, name, &root);
  if (rc == RBF_NOTFOUND) return 0;
  int64_t n = 0;
  int inner_rc = RBF_OK;
  rc = btree_walk(tx, root, [&](const LeafCell &c) {
    const uint8_t *pl = cell_payload(tx, c);
    if (!pl) {
      inner_rc = RBF_CORRUPT;
      return false;
    }
    n += payload_popcount(c.enc, pl, c.len);
    return true;
  });
  if (rc != RBF_OK) return rc;
  if (inner_rc != RBF_OK) return inner_rc;
  return n;
}

int rbf_get_range(rbf_tx *tx, const char *name, uint64_t base, int64_t n,
                  void *dense_tiles) {
  int rc = tx_check(tx, false);
  if (rc != RBF_OK) return rc;
  uint8_t *out = (uint8_t *)dense_tiles;
  std::memset(out, 0, (size_t)n * RBF_TILE_BYTES);
  uint32_t root;
  rc = catalog_root(tx, name, &root);
  if (rc == RBF_NOTFOUND) return RBF_OK;
  int inner_rc = RBF_OK;
  rc = btree_walk(tx, root, [&](const LeafCell &c) {
    if (c.ckey < base) return true;
    if (c.ckey >= base + (uint64_t)n) return false;
    const uint8_t *pl = cell_payload(tx, c);
    if (!pl) {
      inner_rc = RBF_CORRUPT;
      return false;
    }
    inner_rc = enc_decode(c.enc, pl, c.len,
                          (uint64_t *)(out + (c.ckey - base) * RBF_TILE_BYTES));
    return inner_rc == RBF_OK;
  });
  if (rc != RBF_OK) return rc;
  return inner_rc;
}

// ----- iterator ------------------------------------------------------------

// The iterator snapshots (ckey, enc, payload) in ONE tree walk at
// open — a second per-container descend would double page reads on
// the startup-critical fragment reload path.  Mutating the bitmap
// after open does not affect an open iterator.
struct rbf_iter {
  struct Item {
    uint64_t ckey;
    uint8_t enc;
    uint32_t len;
    std::vector<uint8_t> payload;
  };
  std::vector<Item> items;
  size_t pos = 0;
  bool corrupt = false;
};

rbf_iter *rbf_iter_open(rbf_tx *tx, const char *name) {
  if (tx_check(tx, false) != RBF_OK) return nullptr;
  auto it = new rbf_iter();
  uint32_t root;
  if (catalog_root(tx, name, &root) == RBF_OK) {
    int rc = btree_walk(tx, root, [&](const LeafCell &c) {
      const uint8_t *pl = cell_payload(tx, c);
      if (!pl) {
        it->corrupt = true;
        return false;
      }
      it->items.push_back({c.ckey, c.enc, c.len,
                           std::vector<uint8_t>(pl, pl + c.len)});
      return true;
    });
    if (rc != RBF_OK) it->corrupt = true;
  }
  return it;
}

int rbf_iter_next(rbf_iter *it, uint64_t *ckey, void *dense8k) {
  if (it->corrupt) return RBF_CORRUPT;
  if (it->pos >= it->items.size()) return 0;
  auto &item = it->items[it->pos++];
  *ckey = item.ckey;
  int rc = enc_decode(item.enc, item.payload.data(), (int32_t)item.len,
                      (uint64_t *)dense8k);
  return rc == RBF_OK ? 1 : rc;
}

void rbf_iter_close(rbf_iter *it) { delete it; }

// ----- standalone codecs ---------------------------------------------------

int32_t rbf_container_encode(const void *dense8k, void *out, int32_t *enc) {
  return enc_encode((const uint64_t *)dense8k, (uint8_t *)out, enc);
}

int rbf_container_decode(int32_t enc, const void *payload, int32_t len,
                         void *dense8k) {
  return enc_decode(enc, (const uint8_t *)payload, len, (uint64_t *)dense8k);
}
