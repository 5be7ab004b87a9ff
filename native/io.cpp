// Native data-plane helpers: vector-file IO + key bimap.
//
// The reference's ingestion data plane is native (ScyllaDB rust driver +
// scylla-cdc streaming rows into the index actor, reference:
// src/db_index.rs:297-375).  This build's equivalent host-side hot
// path — parsing on-disk vector datasets and maintaining the
// PrimaryKey⇄slot bimap (reference: src/index/usearch.rs:109-113) — is
// implemented here in C++ and exposed over a C ABI for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// fvecs / ivecs readers (the SIFT/GIST dataset wire format: each row is
// [int32 dim][dim * float32] — reference datasets in BASELINE.md).

// Returns rows read, fills dims.  data must hold max_rows*expect_dims floats.
long fvecs_read(const char* path, float* data, long max_rows, int* dims_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int dims = 0;
  long rows = 0;
  while (rows < max_rows) {
    int d;
    if (fread(&d, sizeof(int), 1, f) != 1) break;
    if (dims == 0) dims = d;
    if (d != dims) {
      fclose(f);
      return -2;  // ragged file
    }
    if (fread(data + rows * (long)dims, sizeof(float), d, f) != (size_t)d) break;
    ++rows;
  }
  *dims_out = dims;
  fclose(f);
  return rows;
}

long ivecs_read(const char* path, int* data, long max_rows, int* dims_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int dims = 0;
  long rows = 0;
  while (rows < max_rows) {
    int d;
    if (fread(&d, sizeof(int), 1, f) != 1) break;
    if (dims == 0) dims = d;
    if (d != dims) {
      fclose(f);
      return -2;
    }
    if (fread(data + rows * (long)dims, sizeof(int), d, f) != (size_t)d) break;
    ++rows;
  }
  *dims_out = dims;
  fclose(f);
  return rows;
}

// ---------------------------------------------------------------------------
// u64 key ⇄ slot bimap (the bimap role, usearch.rs:109-113): string keys
// are hashed host-side; the map stores 64-bit key hashes to int32 slots.

struct KeyMap64 {
  std::unordered_map<uint64_t, int32_t> by_key;
  std::unordered_map<int32_t, uint64_t> by_slot;
};

void* keymap_create() { return new KeyMap64(); }
void keymap_free(void* p) { delete (KeyMap64*)p; }

// binds key→slot; returns displaced old slot or -1
int32_t keymap_bind(void* p, uint64_t key, int32_t slot) {
  auto* m = (KeyMap64*)p;
  int32_t old = -1;
  auto it = m->by_key.find(key);
  if (it != m->by_key.end()) {
    old = it->second;
    m->by_slot.erase(old);
  }
  m->by_key[key] = slot;
  m->by_slot[slot] = key;
  return old;
}

// removes key; returns its slot or -1
int32_t keymap_unbind(void* p, uint64_t key) {
  auto* m = (KeyMap64*)p;
  auto it = m->by_key.find(key);
  if (it == m->by_key.end()) return -1;
  int32_t slot = it->second;
  m->by_key.erase(it);
  m->by_slot.erase(slot);
  return slot;
}

int32_t keymap_slot_of(void* p, uint64_t key) {
  auto* m = (KeyMap64*)p;
  auto it = m->by_key.find(key);
  return it == m->by_key.end() ? -1 : it->second;
}

// returns 1 if found (key written to *key_out), else 0
int keymap_key_of(void* p, int32_t slot, uint64_t* key_out) {
  auto* m = (KeyMap64*)p;
  auto it = m->by_slot.find(slot);
  if (it == m->by_slot.end()) return 0;
  *key_out = it->second;
  return 1;
}

long keymap_len(void* p) { return (long)((KeyMap64*)p)->by_key.size(); }

// batched bind for ingest hot path: binds n (key, slot) pairs, writes
// displaced old slots (-1 if none) to displaced[]
void keymap_bind_batch(void* p, const uint64_t* keys, const int32_t* slots,
                       int n, int32_t* displaced) {
  for (int i = 0; i < n; ++i) displaced[i] = keymap_bind(p, keys[i], slots[i]);
}

}  // extern "C"
