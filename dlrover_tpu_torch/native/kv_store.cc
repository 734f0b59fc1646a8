// Host-side dynamic-capacity sparse embedding store ("KvVariable").
//
// Reference capability: TFPlus KvVariable custom-op set
// (tfplus/tfplus/kv_variable/ops/kv_variable_ops.cc:37-536 — Gather/
// GatherOrInsert/GatherOrZeros, ScatterAdd/Sub/Mul, Import/Export,
// frequency counts, under/overflow policies) and its sparse training
// kernels (kernels/training_ops.cc: group Adam/Adagrad/FTRL applying
// updates only to touched keys).
//
// TPU-native shape: the table lives on the host (embedding tables are
// far larger than HBM); lookups produce a dense [n, dim] batch that
// jax feeds to the device; gradient scatter and the sparse group
// optimizers run here, touching only the gathered keys.  Exposed as a
// C ABI consumed via ctypes (dlrover_tpu/ops/kv_variable.py) — no
// pybind dependency.
//
// Implementation: open-addressing hash table (power-of-two capacity,
// linear probing) storing row indices into a slab of embedding rows;
// per-key update counters back frequency-based eviction.

// Hybrid two-tier storage (reference: tfplus hybrid_embedding/
// table_manager.h + storage_table.h + embedding_context.h): DRAM
// holds the hot rows; frequency-cold rows spill to an on-disk record
// file and are transparently promoted back on gather miss.  The key
// index of the disk tier stays in DRAM (16-32 B/key vs dim*4 B/row).

#include <fcntl.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <random>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr int64_t kEmptyKey = INT64_MIN;

// Consecutive spill-write failures (disk full, dead mount) that trip
// the cold tier off.  Without the breaker every gather/scatter on an
// over-budget table retries the FULL O(used*dim) slab rebuild only
// for each row's pwrite to fail again — a hot loop of wasted work on
// a disk that is not coming back by itself.
constexpr long kMaxConsecutiveSpillFailures = 8;

// On-disk cold tier: fixed-size records [dim*f32 values][u64 freq]
// addressed by slot, with an in-DRAM key->slot index and a free list.
struct SpillTier {
  int fd = -1;
  std::string path;
  std::unordered_map<int64_t, int64_t> index;  // key -> slot
  std::vector<int64_t> free_slots;
  int64_t next_slot = 0;
  size_t rec_bytes = 0;
  long spills = 0;       // rows written out (cumulative)
  long promotions = 0;   // rows read back on miss (cumulative)
  long write_failures = 0;       // short/failed pwrites (cumulative)
  long consecutive_failures = 0; // resets on any successful write
  bool disabled = false;         // tripped after repeated failures

  ~SpillTier() {
    if (fd >= 0) ::close(fd);
    if (!path.empty()) ::unlink(path.c_str());
  }
};

struct Table {
  int dim = 0;
  // hash slots -> row index (-1 empty)
  std::vector<int64_t> keys;
  std::vector<int64_t> rows;
  // slab of rows: values, per-row key (for export), frequency
  std::vector<float> values;
  std::vector<int64_t> row_keys;
  std::vector<uint64_t> freq;
  size_t used = 0;
  uint64_t seed = 0x9e3779b97f4a7c15ull;
  std::mutex mu;
  std::unique_ptr<SpillTier> spill;
  size_t max_dram_rows = 0;  // 0 = unbounded (no spilling)

  // Dirty-row tracking (serving-plane delta exports, reference:
  // tfplus checkpoint_manager.py:72 delta checkpoints): keys whose
  // VALUE or FREQUENCY changed since the last kv_export_dirty(clear)
  // / kv_clear_dirty, and keys DELETED since then (eviction
  // tombstones a delta consumer must replay).  Keyed by key, not row
  // index, so spill passes and promotions — residence moves, not
  // logical mutations — never touch either set.  OPT-IN
  // (kv_dirty_enable, armed by the serving publisher): a job that
  // never publishes deltas must not pay per-key set inserts on the
  // optimizer hot path, nor accumulate a never-drained dirty set
  // that converges to the full key space (~40-50 B/key of permanent
  // overhead on a multi-GB table).
  //
  // PER-CONSUMER baselines: the serving publisher (consumer 0), the
  // delta flash checkpointer (consumer 1) and the paged shm tier
  // (consumer 2) drain their deltas on independent cadences — one
  // shared set would let any plane silently clear rows out of
  // another's next delta.  Each consumer arms and clears only its
  // own slot; mutations mark every armed slot.
  static constexpr int kDirtyConsumers = 3;
  bool track_dirty[kDirtyConsumers] = {false, false, false};
  std::unordered_set<int64_t> dirty[kDirtyConsumers];
  std::unordered_set<int64_t> dead[kDirtyConsumers];

  void mark_dirty(int64_t key) {
    for (int c = 0; c < kDirtyConsumers; ++c) {
      if (!track_dirty[c]) continue;
      dirty[c].insert(key);
      dead[c].erase(key);
    }
  }

  void mark_dead(int64_t key) {
    for (int c = 0; c < kDirtyConsumers; ++c) {
      if (!track_dirty[c]) continue;
      dirty[c].erase(key);
      dead[c].insert(key);
    }
  }

  explicit Table(int d, size_t capacity) : dim(d) {
    size_t cap = 64;
    while (cap < capacity * 2) cap <<= 1;
    keys.assign(cap, kEmptyKey);
    rows.assign(cap, -1);
  }

  size_t mask() const { return keys.size() - 1; }

  static uint64_t hash_key(int64_t k) {
    uint64_t x = static_cast<uint64_t>(k);
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdull;
    x ^= x >> 33;
    x *= 0xc4ceb9fe1a85ec53ull;
    x ^= x >> 33;
    return x;
  }

  void grow() {
    std::vector<int64_t> old_keys = std::move(keys);
    std::vector<int64_t> old_rows = std::move(rows);
    keys.assign(old_keys.size() * 2, kEmptyKey);
    rows.assign(old_rows.size() * 2, -1);
    for (size_t i = 0; i < old_keys.size(); ++i) {
      if (old_keys[i] == kEmptyKey) continue;
      size_t slot = hash_key(old_keys[i]) & mask();
      while (keys[slot] != kEmptyKey) slot = (slot + 1) & mask();
      keys[slot] = old_keys[i];
      rows[slot] = old_rows[i];
    }
  }

  // find slot for key; returns row index or -1
  int64_t find(int64_t key) const {
    size_t slot = hash_key(key) & mask();
    while (true) {
      if (keys[slot] == key) return rows[slot];
      if (keys[slot] == kEmptyKey) return -1;
      slot = (slot + 1) & mask();
    }
  }

  // insert key with given init; returns row index
  int64_t insert(int64_t key, const float* init_row, bool random_init) {
    if ((used + 1) * 2 > keys.size()) grow();
    size_t slot = hash_key(key) & mask();
    while (true) {
      if (keys[slot] == key) return rows[slot];
      if (keys[slot] == kEmptyKey) break;
      slot = (slot + 1) & mask();
    }
    int64_t row = static_cast<int64_t>(row_keys.size());
    keys[slot] = key;
    rows[slot] = row;
    row_keys.push_back(key);
    freq.push_back(0);
    size_t off = values.size();
    values.resize(off + dim);
    if (init_row != nullptr) {
      std::memcpy(values.data() + off, init_row, sizeof(float) * dim);
    } else if (random_init) {
      // per-key deterministic init: splitmix on (seed ^ key)
      uint64_t s = seed ^ hash_key(key);
      float scale = 1.0f / std::sqrt(static_cast<float>(dim));
      for (int i = 0; i < dim; ++i) {
        s += 0x9e3779b97f4a7c15ull;
        uint64_t z = s;
        z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
        z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
        z = z ^ (z >> 31);
        // uniform [-scale, scale)
        float u = static_cast<float>(z >> 11) * (1.0f / 9007199254740992.0f);
        values[off + i] = (2.0f * u - 1.0f) * scale;
      }
    } else {
      std::memset(values.data() + off, 0, sizeof(float) * dim);
    }
    ++used;
    return row;
  }

  float* row_ptr(int64_t row) { return values.data() + row * dim; }

  // -- cold tier ------------------------------------------------------

  // write one record to the spill file; key must not be in the
  // index.  Returns false (and registers nothing) when the write
  // does not land whole — the caller must then KEEP the DRAM row,
  // or the key's trained state would silently reset to re-init on
  // its next gather.
  bool spill_write(int64_t key, const float* vals, uint64_t fq) {
    int64_t slot;
    if (!spill->free_slots.empty()) {
      slot = spill->free_slots.back();
      spill->free_slots.pop_back();
    } else {
      slot = spill->next_slot++;
    }
    std::vector<char> buf(spill->rec_bytes);
    std::memcpy(buf.data(), vals, sizeof(float) * dim);
    std::memcpy(buf.data() + sizeof(float) * dim, &fq, sizeof(fq));
    ssize_t wrote = ::pwrite(spill->fd, buf.data(), spill->rec_bytes,
                             static_cast<off_t>(slot) * spill->rec_bytes);
    if (wrote != static_cast<ssize_t>(spill->rec_bytes)) {
      spill->free_slots.push_back(slot);  // disk full / IO error
      ++spill->write_failures;
      if (++spill->consecutive_failures >=
          kMaxConsecutiveSpillFailures) {
        if (!spill->disabled) {
          std::fprintf(stderr,
                       "kv_store: %ld consecutive spill-write "
                       "failures on %s; disabling the cold tier "
                       "(re-call kv_spill_enable to re-arm)\n",
                       spill->consecutive_failures,
                       spill->path.c_str());
        }
        spill->disabled = true;
      }
      return false;
    }
    spill->consecutive_failures = 0;
    spill->index[key] = slot;
    ++spill->spills;
    return true;
  }

  // read a record without removing it (export paths)
  bool spill_read(int64_t slot, float* vals_out, uint64_t* freq_out) {
    std::vector<char> buf(spill->rec_bytes);
    ssize_t got = ::pread(spill->fd, buf.data(), spill->rec_bytes,
                          static_cast<off_t>(slot) * spill->rec_bytes);
    if (got != static_cast<ssize_t>(spill->rec_bytes)) return false;
    if (vals_out) std::memcpy(vals_out, buf.data(), sizeof(float) * dim);
    if (freq_out) {
      std::memcpy(freq_out, buf.data() + sizeof(float) * dim,
                  sizeof(uint64_t));
    }
    return true;
  }

  // disk -> DRAM on gather miss; returns DRAM row or -1
  int64_t promote(int64_t key) {
    if (!spill) return -1;
    auto it = spill->index.find(key);
    if (it == spill->index.end()) return -1;
    std::vector<float> vals(dim);
    uint64_t fq = 0;
    if (!spill_read(it->second, vals.data(), &fq)) return -1;
    spill->free_slots.push_back(it->second);
    spill->index.erase(it);
    ++spill->promotions;
    int64_t row = insert(key, vals.data(), false);
    freq[row] = fq;
    return row;
  }

  int64_t find_or_promote(int64_t key) {
    int64_t row = find(key);
    if (row < 0) row = promote(key);
    return row;
  }

  // Remove one key from WHICHEVER tier holds it; returns whether it
  // existed.  O(1) amortized: the hash slot is freed with
  // backward-shift deletion (probe chains stay intact without
  // tombstones) and the slab hole is filled by swap-remove — a
  // delta consumer applying a handful of eviction tombstones must
  // not pay an O(table) rebuild per delta the way kv_evict_below
  // (a full-table policy sweep) legitimately does.
  bool erase_key(int64_t key) {
    if (spill) {
      auto it = spill->index.find(key);
      if (it != spill->index.end()) {
        spill->free_slots.push_back(it->second);
        spill->index.erase(it);
        return true;
      }
    }
    size_t slot = hash_key(key) & mask();
    while (true) {
      if (keys[slot] == key) break;
      if (keys[slot] == kEmptyKey) return false;
      slot = (slot + 1) & mask();
    }
    int64_t row = rows[slot];
    // backward-shift: each following occupied slot moves into the
    // hole iff the hole lies cyclically within its probe path
    size_t hole = slot;
    size_t next = (hole + 1) & mask();
    while (keys[next] != kEmptyKey) {
      size_t home = hash_key(keys[next]) & mask();
      if (((next - home) & mask()) >= ((next - hole) & mask())) {
        keys[hole] = keys[next];
        rows[hole] = rows[next];
        hole = next;
      }
      next = (next + 1) & mask();
    }
    keys[hole] = kEmptyKey;
    rows[hole] = -1;
    // swap-remove the slab row; re-point the moved row's hash slot
    int64_t last = static_cast<int64_t>(row_keys.size()) - 1;
    if (row != last) {
      row_keys[row] = row_keys[last];
      freq[row] = freq[last];
      std::memcpy(row_ptr(row), values.data() + last * dim,
                  sizeof(float) * dim);
      size_t ms = hash_key(row_keys[row]) & mask();
      while (keys[ms] != row_keys[row]) ms = (ms + 1) & mask();
      rows[ms] = row;
    }
    row_keys.pop_back();
    freq.pop_back();
    values.resize(values.size() - dim);
    --used;
    return true;
  }

  // Read one key's row without promoting it: DRAM first, then the
  // cold tier in place — delta exports must cover spilled dirty
  // rows without churning residence.
  bool read_row(int64_t key, float* vals_out, uint64_t* freq_out) {
    int64_t row = find(key);
    if (row >= 0) {
      std::memcpy(vals_out, row_ptr(row), sizeof(float) * dim);
      *freq_out = freq[row];
      return true;
    }
    if (spill) {
      auto it = spill->index.find(key);
      if (it != spill->index.end()) {
        return spill_read(it->second, vals_out, freq_out);
      }
    }
    return false;
  }

  // DRAM over budget -> move the coldest rows to disk.  10%
  // hysteresis amortizes the O(used*dim) slab rebuild across
  // ~max/10 inserts.
  void maybe_spill_cold() {
    // disabled = the breaker tripped: DRAM stays over budget (rows
    // are never dropped) instead of rebuilding the slab per op just
    // to watch every pwrite fail again
    if (!spill || spill->disabled || max_dram_rows == 0 ||
        used <= max_dram_rows) {
      return;
    }
    size_t target = max_dram_rows - max_dram_rows / 10;
    size_t n_spill = used - target;
    // frequency threshold: the n_spill coldest rows go out
    std::vector<uint64_t> fr(freq);
    std::nth_element(fr.begin(), fr.begin() + n_spill - 1, fr.end());
    uint64_t cutoff = fr[n_spill - 1];
    // strictly-below-cutoff rows all spill (there are < n_spill of
    // them by construction); rows AT the cutoff fill the remaining
    // quota — quota must never be eaten by the tie class while a
    // strictly colder row stays resident
    size_t n_below = 0;
    for (uint64_t f : freq) n_below += (f < cutoff);
    size_t at_quota = n_spill - n_below;
    std::vector<int64_t> keep_keys;
    std::vector<float> keep_values;
    std::vector<uint64_t> keep_freq;
    keep_keys.reserve(target);
    keep_freq.reserve(target);
    keep_values.reserve(target * dim);
    size_t at_spilled = 0;
    for (size_t i = 0; i < row_keys.size(); ++i) {
      bool cold = freq[i] < cutoff ||
                  (freq[i] == cutoff && at_spilled < at_quota);
      if (cold && spill_write(row_keys[i], row_ptr(i), freq[i])) {
        if (freq[i] == cutoff) ++at_spilled;
      } else {
        keep_keys.push_back(row_keys[i]);
        keep_freq.push_back(freq[i]);
        size_t off = keep_values.size();
        keep_values.resize(off + dim);
        std::memcpy(keep_values.data() + off, row_ptr(i),
                    sizeof(float) * dim);
      }
    }
    row_keys = std::move(keep_keys);
    values = std::move(keep_values);
    freq = std::move(keep_freq);
    used = row_keys.size();
    std::fill(keys.begin(), keys.end(), kEmptyKey);
    std::fill(rows.begin(), rows.end(), -1);
    for (size_t i = 0; i < row_keys.size(); ++i) {
      size_t slot = hash_key(row_keys[i]) & mask();
      while (keys[slot] != kEmptyKey) slot = (slot + 1) & mask();
      keys[slot] = row_keys[i];
      rows[slot] = static_cast<int64_t>(i);
    }
  }
};

// Stable chunked-export cursor: a snapshot of the KEY COLUMN taken
// under the table lock at creation.  Iterating by key (8 B/row, the
// same O(rows) footprint class as kv_export_freq) instead of by slab
// position is what keeps the cursor valid across spill residence
// moves, promotions, slab swap-removes and hash growth between chunk
// calls — the value/freq window handed back per chunk is the only
// O(window * dim) allocation the caller ever holds.  Keys that
// vanish between snapshot and read (evicted, deleted) are skipped;
// rows inserted after the snapshot are not part of this export (the
// snapshot IS the export's consistency point for membership; row
// CONTENT is read at chunk time, matching kv_export's semantics of
// reading live state under the lock).
struct ExportCursor {
  std::vector<int64_t> keys;
  size_t pos = 0;
};

}  // namespace

extern "C" {

void* kv_create(int dim, long initial_capacity, unsigned long seed) {
  auto* t = new Table(dim, static_cast<size_t>(initial_capacity));
  if (seed) t->seed = seed;
  return t;
}

void kv_destroy(void* handle) { delete static_cast<Table*>(handle); }

// Logical row count: DRAM + spilled (the table's full key set).
long kv_size(void* handle) {
  Table* t = static_cast<Table*>(handle);
  std::lock_guard<std::mutex> lock(t->mu);
  size_t n = t->used;
  if (t->spill) n += t->spill->index.size();
  return static_cast<long>(n);
}

// Enable the on-disk cold tier: rows beyond max_dram_rows spill to
// `path` coldest-first and promote back on access.  Returns 0 on
// success, -1 if the file cannot be opened.
int kv_spill_enable(void* handle, const char* path, long max_dram_rows) {
  Table* t = static_cast<Table*>(handle);
  std::lock_guard<std::mutex> lock(t->mu);
  if (t->spill) {
    // already enabled: replacing the tier would free the only index
    // of the disk-resident rows (and ~SpillTier would unlink the
    // file).  Same path = a budget adjustment; different path is an
    // error the caller must see.
    if (t->spill->path != path) return -2;
    t->max_dram_rows =
        max_dram_rows > 0 ? static_cast<size_t>(max_dram_rows) : 0;
    // explicit re-enable re-arms a tripped failure breaker (the
    // caller is asserting the disk is healthy again)
    t->spill->disabled = false;
    t->spill->consecutive_failures = 0;
    t->maybe_spill_cold();
    return 0;
  }
  auto tier = std::unique_ptr<SpillTier>(new SpillTier());
  tier->fd = ::open(path, O_RDWR | O_CREAT | O_TRUNC, 0600);
  if (tier->fd < 0) return -1;
  tier->path = path;
  tier->rec_bytes = sizeof(float) * t->dim + sizeof(uint64_t);
  t->spill = std::move(tier);
  t->max_dram_rows =
      max_dram_rows > 0 ? static_cast<size_t>(max_dram_rows) : 0;
  t->maybe_spill_cold();  // an already-over-budget table spills now
  return 0;
}

// out[0]=rows on disk, out[1]=cumulative spills, out[2]=cumulative
// promotions, out[3]=DRAM rows, out[4]=cumulative write failures,
// out[5]=1 when the failure breaker disabled spilling.
void kv_spill_stats(void* handle, long* out) {
  Table* t = static_cast<Table*>(handle);
  std::lock_guard<std::mutex> lock(t->mu);
  out[0] = t->spill ? static_cast<long>(t->spill->index.size()) : 0;
  out[1] = t->spill ? t->spill->spills : 0;
  out[2] = t->spill ? t->spill->promotions : 0;
  out[3] = static_cast<long>(t->used);
  out[4] = t->spill ? t->spill->write_failures : 0;
  out[5] = (t->spill && t->spill->disabled) ? 1 : 0;
}

int kv_dim(void* handle) { return static_cast<Table*>(handle)->dim; }

// Drop every row on BOTH tiers (checkpoint import replaces, never
// merges: a resharded restore must import exactly the owned subset,
// and rows left over from a previous world would be phantom
// duplicates the key-hash partition already assigned elsewhere).
// Spill-tier failure accounting is preserved — a tripped breaker
// stays tripped across an import (the disk did not heal because the
// table was reloaded).
void kv_clear(void* handle) {
  Table* t = static_cast<Table*>(handle);
  std::lock_guard<std::mutex> lock(t->mu);
  t->row_keys.clear();
  t->values.clear();
  t->freq.clear();
  t->used = 0;
  std::fill(t->keys.begin(), t->keys.end(), kEmptyKey);
  std::fill(t->rows.begin(), t->rows.end(), -1);
  if (t->spill) {
    t->spill->index.clear();
    t->spill->free_slots.clear();
    t->spill->next_slot = 0;
  }
  // a replace-import starts a fresh delta baseline FOR EVERY
  // consumer: whatever is imported next marks itself dirty, and
  // tombstones for the old contents would be wrong (the importer
  // owns the new truth)
  for (int c = 0; c < Table::kDirtyConsumers; ++c) {
    t->dirty[c].clear();
    t->dead[c].clear();
  }
}

// Pre-size the hash table (and slab vectors) for ~n total rows so a
// chunked import does not pay repeated O(rows) rehash/realloc storms
// mid-stream.  Never shrinks.
void kv_reserve(void* handle, long n) {
  Table* t = static_cast<Table*>(handle);
  std::lock_guard<std::mutex> lock(t->mu);
  size_t want = t->used + static_cast<size_t>(n > 0 ? n : 0);
  while ((want + 1) * 2 > t->keys.size()) t->grow();
  t->row_keys.reserve(want);
  t->freq.reserve(want);
  t->values.reserve(want * t->dim);
}

// Chaos/test hook: make the spill tier's backing device fail like a
// dead disk — every subsequent pwrite fails (EBADF), every pread
// comes back short.  The write-failure breaker then trips through
// its production path, export skips the stranded records, and DRAM
// rows are untouched.  Re-arming requires kv_spill_enable (which
// reopens nothing here — the fd stays dead until the table is
// rebuilt), exactly like a disk that is not coming back.
void kv_spill_break(void* handle) {
  Table* t = static_cast<Table*>(handle);
  std::lock_guard<std::mutex> lock(t->mu);
  if (!t->spill || t->spill->fd < 0) return;
  ::close(t->spill->fd);
  // /dev/null opened read-only: pwrite -> EBADF, pread -> 0 bytes
  // (short read); keeps the fd slot valid for the destructor.
  t->spill->fd = ::open("/dev/null", O_RDONLY);
  std::fprintf(stderr,
               "kv_store: spill tier on %s broken by fault injection\n",
               t->spill->path.c_str());
}

// ---------------------------------------------------------------------
// Dirty-row delta surface (serving-plane incremental publication;
// reference: tfplus checkpoint_manager.py:72 delta checkpoints).
// ---------------------------------------------------------------------

static int clamp_consumer(int consumer) {
  return (consumer < 0 || consumer >= Table::kDirtyConsumers)
             ? 0 : consumer;
}

// Arm dirty/dead tracking for one consumer slot.  Mutations BEFORE
// arming are not tracked — the caller baselines with a full snapshot
// (the publisher's first publish / the delta checkpointer's first
// export is always a base).
void kv_dirty_enable_c(void* handle, int consumer) {
  Table* t = static_cast<Table*>(handle);
  std::lock_guard<std::mutex> lock(t->mu);
  t->track_dirty[clamp_consumer(consumer)] = true;
}

void kv_dirty_enable(void* handle) { kv_dirty_enable_c(handle, 0); }

int kv_dirty_enabled_c(void* handle, int consumer) {
  Table* t = static_cast<Table*>(handle);
  std::lock_guard<std::mutex> lock(t->mu);
  return t->track_dirty[clamp_consumer(consumer)] ? 1 : 0;
}

int kv_dirty_enabled(void* handle) {
  return kv_dirty_enabled_c(handle, 0);
}

long kv_dirty_count_c(void* handle, int consumer) {
  Table* t = static_cast<Table*>(handle);
  std::lock_guard<std::mutex> lock(t->mu);
  return static_cast<long>(t->dirty[clamp_consumer(consumer)].size());
}

long kv_dirty_count(void* handle) {
  return kv_dirty_count_c(handle, 0);
}

long kv_dead_count_c(void* handle, int consumer) {
  Table* t = static_cast<Table*>(handle);
  std::lock_guard<std::mutex> lock(t->mu);
  return static_cast<long>(t->dead[clamp_consumer(consumer)].size());
}

long kv_dead_count(void* handle) {
  return kv_dead_count_c(handle, 0);
}

// Export only the rows touched since the last clear — O(rows
// touched), never O(table).  Spill-tier dirty rows are read in place
// (no promotion).  With `clear`, exactly the EXPORTED keys leave the
// dirty set under the same lock hold, so a mutation racing the
// export stays dirty for the next delta instead of vanishing.
// Returns rows written (≤ max_n; loop when dirty_count > max_n).
long kv_export_dirty_c(void* handle, int64_t* keys_out,
                       float* values_out, uint64_t* freq_out,
                       long max_n, int clear, int consumer) {
  Table* t = static_cast<Table*>(handle);
  std::lock_guard<std::mutex> lock(t->mu);
  auto& dirty = t->dirty[clamp_consumer(consumer)];
  long n = 0;
  std::vector<int64_t> exported;
  exported.reserve(std::min<size_t>(dirty.size(),
                                    static_cast<size_t>(max_n)));
  for (int64_t key : dirty) {
    if (n >= max_n) break;
    uint64_t fq = 0;
    if (!t->read_row(key, values_out + n * t->dim, &fq)) {
      // unreadable (stranded on a dead spill tier): drop it from
      // the set when clearing — retrying forever republishes
      // nothing, and the row is gone from the exportable state
      exported.push_back(key);
      continue;
    }
    keys_out[n] = key;
    freq_out[n] = fq;
    exported.push_back(key);
    ++n;
  }
  if (clear) {
    for (int64_t key : exported) dirty.erase(key);
  }
  return n;
}

long kv_export_dirty(void* handle, int64_t* keys_out,
                     float* values_out, uint64_t* freq_out,
                     long max_n, int clear) {
  return kv_export_dirty_c(handle, keys_out, values_out, freq_out,
                           max_n, clear, 0);
}

// Deletion tombstones accumulated since the last clear (evictions a
// delta consumer must replay).
long kv_export_dead_c(void* handle, int64_t* keys_out, long max_n,
                      int clear, int consumer) {
  Table* t = static_cast<Table*>(handle);
  std::lock_guard<std::mutex> lock(t->mu);
  auto& dead = t->dead[clamp_consumer(consumer)];
  long n = 0;
  std::vector<int64_t> exported;
  for (int64_t key : dead) {
    if (n >= max_n) break;
    keys_out[n++] = key;
    exported.push_back(key);
  }
  if (clear) {
    for (int64_t key : exported) dead.erase(key);
  }
  return n;
}

long kv_export_dead(void* handle, int64_t* keys_out, long max_n,
                    int clear) {
  return kv_export_dead_c(handle, keys_out, max_n, clear, 0);
}

void kv_clear_dirty_c(void* handle, int consumer) {
  Table* t = static_cast<Table*>(handle);
  std::lock_guard<std::mutex> lock(t->mu);
  int c = clamp_consumer(consumer);
  t->dirty[c].clear();
  t->dead[c].clear();
}

void kv_clear_dirty(void* handle) { kv_clear_dirty_c(handle, 0); }

// Remove specific keys from either tier (delta-apply of eviction
// tombstones on a serving replica; O(1) amortized per key).  The
// deletions are themselves tracked as tombstones, so a table that
// both applies and re-exports deltas stays chainable.  Returns how
// many keys actually existed.
long kv_delete(void* handle, const int64_t* keys, long n) {
  Table* t = static_cast<Table*>(handle);
  std::lock_guard<std::mutex> lock(t->mu);
  long removed = 0;
  for (long i = 0; i < n; ++i) {
    if (t->erase_key(keys[i])) {
      t->mark_dead(keys[i]);
      ++removed;
    }
  }
  return removed;
}

// Gather rows for keys; missing keys are inserted (random or zero
// init) when insert_missing, else zero-filled in the output.
// Reference ops: KvVariableGatherOrInsert / GatherOrZeros.
void kv_gather(void* handle, const int64_t* keys, long n, float* out,
               int insert_missing, int random_init, int count_freq) {
  Table* t = static_cast<Table*>(handle);
  std::lock_guard<std::mutex> lock(t->mu);
  for (long i = 0; i < n; ++i) {
    int64_t row = t->find_or_promote(keys[i]);
    bool inserted = false;
    if (row < 0 && insert_missing) {
      row = t->insert(keys[i], nullptr, random_init != 0);
      inserted = true;
    }
    if (row < 0) {
      std::memset(out + i * t->dim, 0, sizeof(float) * t->dim);
    } else {
      if (count_freq) t->freq[row] += 1;
      // frequency is checkpoint state: a bumped counter makes the
      // row delta-visible just like a value change does
      if (inserted || count_freq) t->mark_dirty(keys[i]);
      std::memcpy(out + i * t->dim, t->row_ptr(row),
                  sizeof(float) * t->dim);
    }
  }
  t->maybe_spill_cold();
}

// Explicit insert/assign (reference: KvVariableInsert).
void kv_insert(void* handle, const int64_t* keys, const float* vals,
               long n) {
  Table* t = static_cast<Table*>(handle);
  std::lock_guard<std::mutex> lock(t->mu);
  for (long i = 0; i < n; ++i) {
    int64_t row = t->find_or_promote(keys[i]);
    if (row < 0) {
      t->insert(keys[i], vals + i * t->dim, false);
    } else {
      std::memcpy(t->row_ptr(row), vals + i * t->dim,
                  sizeof(float) * t->dim);
    }
    t->mark_dirty(keys[i]);
  }
  t->maybe_spill_cold();
}

// op: 0=add 1=sub 2=mul (reference: KvVariableScatterAdd/Sub/Mul).
void kv_scatter(void* handle, const int64_t* keys, const float* vals,
                long n, int op) {
  Table* t = static_cast<Table*>(handle);
  std::lock_guard<std::mutex> lock(t->mu);
  for (long i = 0; i < n; ++i) {
    int64_t row = t->find_or_promote(keys[i]);
    if (row < 0) row = t->insert(keys[i], nullptr, false);
    float* dst = t->row_ptr(row);
    const float* src = vals + i * t->dim;
    for (int d = 0; d < t->dim; ++d) {
      if (op == 0) dst[d] += src[d];
      else if (op == 1) dst[d] -= src[d];
      else dst[d] *= src[d];
    }
    t->mark_dirty(keys[i]);
  }
  t->maybe_spill_cold();
}

// Export all rows (checkpoint).  keys_out: [size], values_out:
// [size*dim], freq_out: [size].  Returns number exported.
long kv_export(void* handle, int64_t* keys_out, float* values_out,
               uint64_t* freq_out, long max_n) {
  Table* t = static_cast<Table*>(handle);
  std::lock_guard<std::mutex> lock(t->mu);
  long n = std::min<long>(max_n, static_cast<long>(t->row_keys.size()));
  for (long i = 0; i < n; ++i) {
    keys_out[i] = t->row_keys[i];
    freq_out[i] = t->freq[i];
  }
  std::memcpy(values_out, t->values.data(), sizeof(float) * n * t->dim);
  // a checkpoint must cover the FULL logical table: append the cold
  // tier's rows after the DRAM ones
  if (t->spill) {
    for (const auto& kv : t->spill->index) {
      if (n >= max_n) break;
      keys_out[n] = kv.first;
      if (t->spill_read(kv.second, values_out + n * t->dim,
                        freq_out + n)) {
        ++n;
      }
    }
  }
  return n;
}

// Frequency column only: eviction-threshold math on a big table must
// not force the caller to materialize the whole [n, dim] value matrix.
long kv_export_freq(void* handle, uint64_t* freq_out, long max_n) {
  Table* t = static_cast<Table*>(handle);
  std::lock_guard<std::mutex> lock(t->mu);
  long n = std::min<long>(max_n, static_cast<long>(t->freq.size()));
  for (long i = 0; i < n; ++i) freq_out[i] = t->freq[i];
  if (t->spill) {  // eviction math sees the cold tier's counts too
    for (const auto& kv : t->spill->index) {
      if (n >= max_n) break;
      if (t->spill_read(kv.second, nullptr, freq_out + n)) ++n;
    }
  }
  return n;
}

// ---------------------------------------------------------------------
// Cursor-based chunked export: O(window) value memory per call.
// ---------------------------------------------------------------------

// Snapshot the key column (both tiers) under the lock; the returned
// cursor iterates it in kv_export_chunk calls.  Valid across spill
// residence moves, promotions and slab compactions between chunks —
// membership is fixed at snapshot time, content is read live.  The
// caller MUST free it with kv_export_cursor_free.
void* kv_export_cursor_new(void* handle) {
  Table* t = static_cast<Table*>(handle);
  std::lock_guard<std::mutex> lock(t->mu);
  auto* c = new ExportCursor();
  c->keys.reserve(
      t->row_keys.size() + (t->spill ? t->spill->index.size() : 0));
  c->keys.insert(c->keys.end(), t->row_keys.begin(),
                 t->row_keys.end());
  if (t->spill) {
    for (const auto& kv : t->spill->index) c->keys.push_back(kv.first);
  }
  return c;
}

long kv_export_cursor_remaining(void* cursor) {
  auto* c = static_cast<ExportCursor*>(cursor);
  return static_cast<long>(c->keys.size() - c->pos);
}

void kv_export_cursor_free(void* cursor) {
  delete static_cast<ExportCursor*>(cursor);
}

// Export up to max_n rows at the cursor: DRAM rows memcpy'd, spilled
// rows read IN PLACE (no promotion, no residence churn).  Keys that
// vanished since the snapshot (evicted/deleted) are skipped inside
// the same lock hold, so a return of 0 means the cursor is
// exhausted, never "this window happened to be all tombstones".
long kv_export_chunk(void* handle, void* cursor, int64_t* keys_out,
                     float* values_out, uint64_t* freq_out,
                     long max_n) {
  Table* t = static_cast<Table*>(handle);
  auto* c = static_cast<ExportCursor*>(cursor);
  std::lock_guard<std::mutex> lock(t->mu);
  long n = 0;
  while (n < max_n && c->pos < c->keys.size()) {
    int64_t key = c->keys[c->pos++];
    uint64_t fq = 0;
    if (!t->read_row(key, values_out + n * t->dim, &fq)) continue;
    keys_out[n] = key;
    freq_out[n] = fq;
    ++n;
  }
  return n;
}

void kv_import(void* handle, const int64_t* keys, const float* vals,
               const uint64_t* freqs, long n) {
  Table* t = static_cast<Table*>(handle);
  std::lock_guard<std::mutex> lock(t->mu);
  for (long i = 0; i < n; ++i) {
    int64_t row = t->find_or_promote(keys[i]);
    if (row < 0) row = t->insert(keys[i], vals + i * t->dim, false);
    else std::memcpy(t->row_ptr(row), vals + i * t->dim,
                     sizeof(float) * t->dim);
    if (freqs) t->freq[row] = freqs[i];
    t->mark_dirty(keys[i]);
  }
  t->maybe_spill_cold();
}

void kv_frequency(void* handle, const int64_t* keys, long n,
                  uint64_t* out) {
  Table* t = static_cast<Table*>(handle);
  std::lock_guard<std::mutex> lock(t->mu);
  for (long i = 0; i < n; ++i) {
    int64_t row = t->find(keys[i]);
    if (row >= 0) {
      out[i] = t->freq[row];
    } else if (t->spill) {
      // read-only query: report the cold row's count WITHOUT
      // promoting it (a frequency probe must not churn the tiers)
      auto it = t->spill->index.find(keys[i]);
      uint64_t fq = 0;
      out[i] = (it != t->spill->index.end() &&
                t->spill_read(it->second, nullptr, &fq))
                   ? fq : 0;
    } else {
      out[i] = 0;
    }
  }
}

// Evict keys with frequency < min_freq (underflow policy; reference:
// kv_variable frequency/underflow handling).  Rebuilds the slab.
long kv_evict_below(void* handle, uint64_t min_freq) {
  Table* t = static_cast<Table*>(handle);
  std::lock_guard<std::mutex> lock(t->mu);
  long disk_evicted = 0;
  if (t->spill) {  // eviction (deletion) applies to the cold tier too
    for (auto it = t->spill->index.begin();
         it != t->spill->index.end();) {
      uint64_t fq = 0;
      if (t->spill_read(it->second, nullptr, &fq) && fq < min_freq) {
        t->spill->free_slots.push_back(it->second);
        t->mark_dead(it->first);
        it = t->spill->index.erase(it);
        ++disk_evicted;
      } else {
        ++it;
      }
    }
  }
  std::vector<int64_t> keep_keys;
  std::vector<float> keep_values;
  std::vector<uint64_t> keep_freq;
  long evicted = 0;
  for (size_t i = 0; i < t->row_keys.size(); ++i) {
    if (t->freq[i] >= min_freq) {
      keep_keys.push_back(t->row_keys[i]);
      keep_freq.push_back(t->freq[i]);
      size_t off = keep_values.size();
      keep_values.resize(off + t->dim);
      std::memcpy(keep_values.data() + off, t->row_ptr(i),
                  sizeof(float) * t->dim);
    } else {
      t->mark_dead(t->row_keys[i]);
      ++evicted;
    }
  }
  t->row_keys = std::move(keep_keys);
  t->values = std::move(keep_values);
  t->freq = std::move(keep_freq);
  t->used = t->row_keys.size();
  std::fill(t->keys.begin(), t->keys.end(), kEmptyKey);
  std::fill(t->rows.begin(), t->rows.end(), -1);
  for (size_t i = 0; i < t->row_keys.size(); ++i) {
    size_t slot = Table::hash_key(t->row_keys[i]) & t->mask();
    while (t->keys[slot] != kEmptyKey) slot = (slot + 1) & t->mask();
    t->keys[slot] = t->row_keys[i];
    t->rows[slot] = static_cast<int64_t>(i);
  }
  return evicted + disk_evicted;
}

// ---------------------------------------------------------------------
// Sparse group optimizers: state tables share key layout with the
// main table (reference: training_ops.cc + python training/
// {group_adam,adagrad,group_ftrl}.py — updates touch only the keys in
// this batch).
// ---------------------------------------------------------------------

// Group Adam step over the touched keys.
void kv_apply_group_adam(void* param_h, void* m_h, void* v_h,
                         const int64_t* keys, const float* grads, long n,
                         float lr, float beta1, float beta2, float eps,
                         float weight_decay, long step) {
  Table* p = static_cast<Table*>(param_h);
  Table* m = static_cast<Table*>(m_h);
  Table* v = static_cast<Table*>(v_h);
  std::lock_guard<std::mutex> lp(p->mu);
  std::lock_guard<std::mutex> lm(m->mu);
  std::lock_guard<std::mutex> lv(v->mu);
  const int dim = p->dim;
  const float bc1 = 1.0f - std::pow(beta1, static_cast<float>(step));
  const float bc2 = 1.0f - std::pow(beta2, static_cast<float>(step));
  for (long i = 0; i < n; ++i) {
    int64_t prow = p->find_or_promote(keys[i]);
    if (prow < 0) prow = p->insert(keys[i], nullptr, true);
    int64_t mrow = m->find_or_promote(keys[i]);
    if (mrow < 0) mrow = m->insert(keys[i], nullptr, false);
    int64_t vrow = v->find_or_promote(keys[i]);
    if (vrow < 0) vrow = v->insert(keys[i], nullptr, false);
    float* w = p->row_ptr(prow);
    float* mu = m->row_ptr(mrow);
    float* nu = v->row_ptr(vrow);
    const float* g = grads + i * dim;
    p->freq[prow] += 1;
    p->mark_dirty(keys[i]);
    m->mark_dirty(keys[i]);
    v->mark_dirty(keys[i]);
    for (int d = 0; d < dim; ++d) {
      float gd = g[d] + weight_decay * w[d];
      mu[d] = beta1 * mu[d] + (1.0f - beta1) * gd;
      nu[d] = beta2 * nu[d] + (1.0f - beta2) * gd * gd;
      float mhat = mu[d] / bc1;
      float vhat = nu[d] / bc2;
      w[d] -= lr * mhat / (std::sqrt(vhat) + eps);
    }
  }
  p->maybe_spill_cold();
  m->maybe_spill_cold();
  v->maybe_spill_cold();
}

// Group Adagrad step.
void kv_apply_group_adagrad(void* param_h, void* acc_h,
                            const int64_t* keys, const float* grads,
                            long n, float lr, float init_acc, float eps) {
  Table* p = static_cast<Table*>(param_h);
  Table* a = static_cast<Table*>(acc_h);
  std::lock_guard<std::mutex> lp(p->mu);
  std::lock_guard<std::mutex> la(a->mu);
  const int dim = p->dim;
  for (long i = 0; i < n; ++i) {
    int64_t prow = p->find_or_promote(keys[i]);
    if (prow < 0) prow = p->insert(keys[i], nullptr, true);
    int64_t arow = a->find_or_promote(keys[i]);
    if (arow < 0) {
      a->insert(keys[i], nullptr, false);
      arow = a->find(keys[i]);
      float* acc0 = a->row_ptr(arow);
      for (int d = 0; d < dim; ++d) acc0[d] = init_acc;
    }
    float* w = p->row_ptr(prow);
    float* acc = a->row_ptr(arow);
    const float* g = grads + i * dim;
    p->freq[prow] += 1;
    p->mark_dirty(keys[i]);
    a->mark_dirty(keys[i]);
    for (int d = 0; d < dim; ++d) {
      acc[d] += g[d] * g[d];
      w[d] -= lr * g[d] / (std::sqrt(acc[d]) + eps);
    }
  }
  p->maybe_spill_cold();
  a->maybe_spill_cold();
}

// Group FTRL step (reference: training/group_ftrl.py semantics).
void kv_apply_group_ftrl(void* param_h, void* z_h, void* n_h,
                         const int64_t* keys, const float* grads, long n,
                         float lr, float l1, float l2, float lr_power) {
  Table* p = static_cast<Table*>(param_h);
  Table* zt = static_cast<Table*>(z_h);
  Table* nt = static_cast<Table*>(n_h);
  std::lock_guard<std::mutex> lp(p->mu);
  std::lock_guard<std::mutex> lz(zt->mu);
  std::lock_guard<std::mutex> ln(nt->mu);
  const int dim = p->dim;
  for (long i = 0; i < n; ++i) {
    int64_t prow = p->find_or_promote(keys[i]);
    if (prow < 0) prow = p->insert(keys[i], nullptr, false);
    int64_t zrow = zt->find_or_promote(keys[i]);
    if (zrow < 0) zrow = zt->insert(keys[i], nullptr, false);
    int64_t nrow = nt->find_or_promote(keys[i]);
    if (nrow < 0) nrow = nt->insert(keys[i], nullptr, false);
    float* w = p->row_ptr(prow);
    float* z = zt->row_ptr(zrow);
    float* acc = nt->row_ptr(nrow);
    const float* g = grads + i * dim;
    p->freq[prow] += 1;
    p->mark_dirty(keys[i]);
    zt->mark_dirty(keys[i]);
    nt->mark_dirty(keys[i]);
    (void)lr_power;  // fixed -0.5 (sqrt) schedule, the common case
    for (int d = 0; d < dim; ++d) {
      float n_new = acc[d] + g[d] * g[d];
      float sigma = (std::sqrt(n_new) - std::sqrt(acc[d])) / lr;
      z[d] += g[d] - sigma * w[d];
      acc[d] = n_new;
      float zd = z[d];
      if (std::fabs(zd) <= l1) {
        w[d] = 0.0f;
      } else {
        float sign = zd > 0 ? 1.0f : -1.0f;
        w[d] = -(zd - sign * l1) / (l2 + std::sqrt(n_new) / lr);
      }
    }
  }
  p->maybe_spill_cold();
  zt->maybe_spill_cold();
  nt->maybe_spill_cold();
}

// Plain sparse SGD over the touched keys (reference: tfplus
// training/gradient_descent.py — the sparse path of
// GradientDescentOptimizer; no slot tables).
void kv_apply_sparse_sgd(void* param_h, const int64_t* keys,
                         const float* grads, long n, float lr) {
  Table* p = static_cast<Table*>(param_h);
  std::lock_guard<std::mutex> lp(p->mu);
  const int dim = p->dim;
  for (long i = 0; i < n; ++i) {
    int64_t prow = p->find_or_promote(keys[i]);
    if (prow < 0) prow = p->insert(keys[i], nullptr, true);
    float* w = p->row_ptr(prow);
    const float* g = grads + i * dim;
    p->freq[prow] += 1;
    p->mark_dirty(keys[i]);
    for (int d = 0; d < dim; ++d) w[d] -= lr * g[d];
  }
  p->maybe_spill_cold();
}

// Plain sparse Adam (reference: tfplus training/adam.py — standard
// Adam whose bias correction rides the learning rate:
// lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)), vs the group
// flavour above which corrects the moments per-dimension and adds
// decoupled weight decay.
void kv_apply_sparse_adam(void* param_h, void* m_h, void* v_h,
                          const int64_t* keys, const float* grads,
                          long n, float lr, float beta1, float beta2,
                          float eps, long step) {
  Table* p = static_cast<Table*>(param_h);
  Table* m = static_cast<Table*>(m_h);
  Table* v = static_cast<Table*>(v_h);
  std::lock_guard<std::mutex> lp(p->mu);
  std::lock_guard<std::mutex> lm(m->mu);
  std::lock_guard<std::mutex> lv(v->mu);
  const int dim = p->dim;
  const float t = static_cast<float>(step);
  const float lr_t = lr * std::sqrt(1.0f - std::pow(beta2, t)) /
                     (1.0f - std::pow(beta1, t));
  for (long i = 0; i < n; ++i) {
    int64_t prow = p->find_or_promote(keys[i]);
    if (prow < 0) prow = p->insert(keys[i], nullptr, true);
    int64_t mrow = m->find_or_promote(keys[i]);
    if (mrow < 0) mrow = m->insert(keys[i], nullptr, false);
    int64_t vrow = v->find_or_promote(keys[i]);
    if (vrow < 0) vrow = v->insert(keys[i], nullptr, false);
    float* w = p->row_ptr(prow);
    float* mu = m->row_ptr(mrow);
    float* nu = v->row_ptr(vrow);
    const float* g = grads + i * dim;
    p->freq[prow] += 1;
    p->mark_dirty(keys[i]);
    m->mark_dirty(keys[i]);
    v->mark_dirty(keys[i]);
    for (int d = 0; d < dim; ++d) {
      mu[d] = beta1 * mu[d] + (1.0f - beta1) * g[d];
      nu[d] = beta2 * nu[d] + (1.0f - beta2) * g[d] * g[d];
      w[d] -= lr_t * mu[d] / (std::sqrt(nu[d]) + eps);
    }
  }
  p->maybe_spill_cold();
  m->maybe_spill_cold();
  v->maybe_spill_cold();
}

// Rectified Adam (reference: tfplus training/rectified_adam.py /
// Liu et al. 2019): the adaptive term is used only once the variance
// estimate's rectification r_t is defined (rho_t > 4); earlier steps
// fall back to bias-corrected momentum SGD.  Warm-up without a
// schedule — exactly the cold-start regime a freshly inserted
// embedding row lives in.
void kv_apply_rectified_adam(void* param_h, void* m_h, void* v_h,
                             const int64_t* keys, const float* grads,
                             long n, float lr, float beta1, float beta2,
                             float eps, float weight_decay, long step) {
  Table* p = static_cast<Table*>(param_h);
  Table* m = static_cast<Table*>(m_h);
  Table* v = static_cast<Table*>(v_h);
  std::lock_guard<std::mutex> lp(p->mu);
  std::lock_guard<std::mutex> lm(m->mu);
  std::lock_guard<std::mutex> lv(v->mu);
  const int dim = p->dim;
  const float t = static_cast<float>(step);
  const float beta2_t = std::pow(beta2, t);
  const float bc1 = 1.0f - std::pow(beta1, t);
  const float bc2 = 1.0f - beta2_t;
  const float rho_inf = 2.0f / (1.0f - beta2) - 1.0f;
  const float rho_t = rho_inf - 2.0f * t * beta2_t / bc2;
  float r_t = 0.0f;
  const bool rectified = rho_t > 4.0f;
  if (rectified) {
    r_t = std::sqrt(((rho_t - 4.0f) * (rho_t - 2.0f) * rho_inf) /
                    ((rho_inf - 4.0f) * (rho_inf - 2.0f) * rho_t));
  }
  for (long i = 0; i < n; ++i) {
    int64_t prow = p->find_or_promote(keys[i]);
    if (prow < 0) prow = p->insert(keys[i], nullptr, true);
    int64_t mrow = m->find_or_promote(keys[i]);
    if (mrow < 0) mrow = m->insert(keys[i], nullptr, false);
    int64_t vrow = v->find_or_promote(keys[i]);
    if (vrow < 0) vrow = v->insert(keys[i], nullptr, false);
    float* w = p->row_ptr(prow);
    float* mu = m->row_ptr(mrow);
    float* nu = v->row_ptr(vrow);
    const float* g = grads + i * dim;
    p->freq[prow] += 1;
    p->mark_dirty(keys[i]);
    m->mark_dirty(keys[i]);
    v->mark_dirty(keys[i]);
    for (int d = 0; d < dim; ++d) {
      float gd = g[d] + weight_decay * w[d];
      mu[d] = beta1 * mu[d] + (1.0f - beta1) * gd;
      nu[d] = beta2 * nu[d] + (1.0f - beta2) * gd * gd;
      float mhat = mu[d] / bc1;
      if (rectified) {
        float vhat = std::sqrt(nu[d] / bc2);
        w[d] -= lr * r_t * mhat / (vhat + eps);
      } else {
        w[d] -= lr * mhat;
      }
    }
  }
  p->maybe_spill_cold();
  m->maybe_spill_cold();
  v->maybe_spill_cold();
}

}  // extern "C"
