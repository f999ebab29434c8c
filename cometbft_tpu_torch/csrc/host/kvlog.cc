// Native append-log KV store — the C++ storage backend behind the
// KVStore seam (the role cometbft-db's LevelDB/RocksDB backends play for
// the reference engine, node/node.go:284; record format shared with the
// pure-Python FileDB in db/kv.py so files are interchangeable).
//
// The port's copy of cometbft_tpu/db/native/kvlog.cc, host code built by
// g++ (ops/_build.host_lib) into build/cometbft_tpu_torch/; files written
// by either package's FileDB or NativeDB open in the other.
//
// v1 record (written here): u8 op(0|1) | u32le klen | u32le vlen |
//   key | value — self-committing.
// v2 record (written by FileDB, docs/STORAGE.md): u8 op(2|3|4) |
//   u32le klen | u32le vlen | u32le crc | key | value, crc over the
//   v1-shaped header + key + value. Ops 2/3 buffer until a commit
//   marker (op 4, value = u32le record count) lands; an uncommitted,
//   torn, or CRC-bad tail truncates back to the last commit boundary,
//   mirroring FileDB's all-or-nothing batch replay. This backend keeps
//   WRITING v1 (each record its own commit point — FileDB replays the
//   mixed log fine) but must READ v2 so the two stay interchangeable.
// Open replays the log into an ordered in-memory index (std::map) and
// truncates a torn tail (crash mid-append). compact() rewrites live
// records through a temp file + atomic rename.
//
// C ABI for ctypes; all returned buffers are malloc'd and freed with
// nkv_free. Thread safety: a single mutex per handle (callers are the
// Python engine's storage paths, already coarse-grained).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint8_t REC_SET = 0;
constexpr uint8_t REC_DEL = 1;
constexpr uint8_t REC_SET2 = 2;
constexpr uint8_t REC_DEL2 = 3;
constexpr uint8_t REC_COMMIT = 4;

// zlib-compatible CRC-32 (polynomial 0xEDB88320), table built once —
// matches Python's zlib.crc32 so FileDB-written records verify here
const uint32_t* crc_table() {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  return table;
}

uint32_t crc32_update(uint32_t crc, const void* buf, size_t n) {
  const uint8_t* p = (const uint8_t*)buf;
  const uint32_t* t = crc_table();
  crc ^= 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) crc = t[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

struct Handle {
  std::map<std::string, std::string> index;
  std::string path;
  FILE* f = nullptr;
  bool fsync_each = false;
  std::mutex mu;
};

struct Iter {
  std::vector<std::pair<std::string, std::string>> snapshot;
  size_t pos = 0;
};

bool read_exact(FILE* f, void* buf, size_t n) {
  return fread(buf, 1, n, f) == n;
}

uint32_t rd32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

void wr32(uint8_t* p, uint32_t v) {
  p[0] = v & 0xff; p[1] = (v >> 8) & 0xff;
  p[2] = (v >> 16) & 0xff; p[3] = (v >> 24) & 0xff;
}

// replay; returns byte offset of the last COMMITTED byte (end of the
// last complete v1 record or v2 commit marker — buffered v2 records
// without their marker are a crashed batch, discarded wholesale)
long replay(Handle* h, FILE* f) {
  long good = 0, pos = 0;
  uint8_t hdr[13];
  std::string key, val;
  std::vector<std::pair<uint8_t, std::pair<std::string, std::string>>>
      pending;
  for (;;) {
    if (!read_exact(f, hdr, 1)) break;
    uint8_t op = hdr[0];
    if (op == REC_SET || op == REC_DEL) {
      if (!read_exact(f, hdr + 1, 8)) break;
      uint32_t klen = rd32(hdr + 1), vlen = rd32(hdr + 5);
      key.resize(klen);
      val.resize(vlen);
      if (klen && !read_exact(f, &key[0], klen)) break;
      if (vlen && !read_exact(f, &val[0], vlen)) break;
      if (!pending.empty()) break;  // v1 inside an open v2 batch: corrupt
      if (op == REC_SET) {
        h->index[key] = val;
      } else {
        h->index.erase(key);
      }
      pos += 9 + (long)klen + (long)vlen;
      good = pos;
    } else if (op == REC_SET2 || op == REC_DEL2 || op == REC_COMMIT) {
      if (!read_exact(f, hdr + 1, 12)) break;
      uint32_t klen = rd32(hdr + 1), vlen = rd32(hdr + 5);
      uint32_t crc = rd32(hdr + 9);
      key.resize(klen);
      val.resize(vlen);
      if (klen && !read_exact(f, &key[0], klen)) break;
      if (vlen && !read_exact(f, &val[0], vlen)) break;
      // crc covers the v1-shaped header (op|klen|vlen) + key + value
      uint32_t got = crc32_update(0, hdr, 1);
      got = crc32_update(got, hdr + 1, 8);
      got = crc32_update(got, key.data(), klen);
      got = crc32_update(got, val.data(), vlen);
      if (got != crc) break;
      pos += 13 + (long)klen + (long)vlen;
      if (op == REC_COMMIT) {
        if (klen != 0 || vlen != 4 ||
            rd32((const uint8_t*)val.data()) != pending.size())
          break;
        for (const auto& p : pending) {
          if (p.first == REC_SET2) {
            h->index[p.second.first] = p.second.second;
          } else {
            h->index.erase(p.second.first);
          }
        }
        pending.clear();
        good = pos;
      } else {
        pending.push_back({op, {key, val}});
      }
    } else {
      break;  // unknown op: corrupt tail
    }
  }
  return good;
}

int append(Handle* h, uint8_t op, const uint8_t* k, size_t klen,
           const uint8_t* v, size_t vlen) {
  if (h->f == nullptr) return -1;  // e.g. reopen failed after compact
  uint8_t hdr[9];
  hdr[0] = op;
  wr32(hdr + 1, (uint32_t)klen);
  wr32(hdr + 5, (uint32_t)vlen);
  if (fwrite(hdr, 1, 9, h->f) != 9) return -1;
  if (klen && fwrite(k, 1, klen, h->f) != klen) return -1;
  if (vlen && fwrite(v, 1, vlen, h->f) != vlen) return -1;
  if (fflush(h->f) != 0) return -1;
  if (h->fsync_each && fsync(fileno(h->f)) != 0) return -1;
  return 0;
}

}  // namespace

extern "C" {

void* nkv_open(const char* path, int fsync_each) {
  auto* h = new Handle();
  h->path = path;
  h->fsync_each = fsync_each != 0;
  // crash hygiene (parity with FileDB): a crash before compact()'s
  // rename leaves a stale temp beside the log — always stale state
  remove((h->path + ".compact").c_str());
  FILE* existing = fopen(path, "rb");
  if (existing != nullptr) {
    long good = replay(h, existing);
    fseek(existing, 0, SEEK_END);
    long size = ftell(existing);
    fclose(existing);
    if (good != size) {
      if (truncate(path, good) != 0) {
        delete h;
        return nullptr;
      }
    }
  }
  h->f = fopen(path, "ab");
  if (h->f == nullptr) {
    delete h;
    return nullptr;
  }
  return h;
}

void nkv_close(void* hp) {
  auto* h = static_cast<Handle*>(hp);
  if (h->f) fclose(h->f);
  delete h;
}

int nkv_set(void* hp, const uint8_t* k, size_t klen, const uint8_t* v,
            size_t vlen) {
  auto* h = static_cast<Handle*>(hp);
  std::lock_guard<std::mutex> lock(h->mu);
  if (append(h, REC_SET, k, klen, v, vlen) != 0) return -1;
  h->index[std::string((const char*)k, klen)] =
      std::string((const char*)v, vlen);
  return 0;
}

int nkv_del(void* hp, const uint8_t* k, size_t klen) {
  auto* h = static_cast<Handle*>(hp);
  std::lock_guard<std::mutex> lock(h->mu);
  if (append(h, REC_DEL, k, klen, nullptr, 0) != 0) return -1;
  h->index.erase(std::string((const char*)k, klen));
  return 0;
}

// returns value length, -1 if absent; *out is malloc'd (nkv_free)
int64_t nkv_get(void* hp, const uint8_t* k, size_t klen, uint8_t** out) {
  auto* h = static_cast<Handle*>(hp);
  std::lock_guard<std::mutex> lock(h->mu);
  auto it = h->index.find(std::string((const char*)k, klen));
  if (it == h->index.end()) return -1;
  *out = (uint8_t*)malloc(it->second.size() ? it->second.size() : 1);
  memcpy(*out, it->second.data(), it->second.size());
  return (int64_t)it->second.size();
}

void nkv_free(uint8_t* p) { free(p); }

int64_t nkv_size(void* hp) {
  auto* h = static_cast<Handle*>(hp);
  std::lock_guard<std::mutex> lock(h->mu);
  return (int64_t)h->index.size();
}

// ordered snapshot iterator over [start, end); empty end = unbounded
void* nkv_iter(void* hp, const uint8_t* start, size_t slen,
               const uint8_t* end, size_t elen) {
  auto* h = static_cast<Handle*>(hp);
  std::lock_guard<std::mutex> lock(h->mu);
  auto* it = new Iter();
  std::string s((const char*)start, slen);
  auto lo = h->index.lower_bound(s);
  if (elen == 0) {
    for (; lo != h->index.end(); ++lo) it->snapshot.push_back(*lo);
  } else {
    std::string e((const char*)end, elen);
    for (; lo != h->index.end() && lo->first < e; ++lo)
      it->snapshot.push_back(*lo);
  }
  return it;
}

int nkv_iter_next(void* ip, const uint8_t** k, size_t* klen,
                  const uint8_t** v, size_t* vlen) {
  auto* it = static_cast<Iter*>(ip);
  if (it->pos >= it->snapshot.size()) return 0;
  const auto& kv = it->snapshot[it->pos++];
  *k = (const uint8_t*)kv.first.data();
  *klen = kv.first.size();
  *v = (const uint8_t*)kv.second.data();
  *vlen = kv.second.size();
  return 1;
}

void nkv_iter_close(void* ip) { delete static_cast<Iter*>(ip); }

int nkv_compact(void* hp) {
  auto* h = static_cast<Handle*>(hp);
  std::lock_guard<std::mutex> lock(h->mu);
  std::string tmp = h->path + ".compact";
  FILE* out = fopen(tmp.c_str(), "wb");
  if (out == nullptr) return -1;
  uint8_t hdr[9];
  for (const auto& kv : h->index) {
    hdr[0] = REC_SET;
    wr32(hdr + 1, (uint32_t)kv.first.size());
    wr32(hdr + 5, (uint32_t)kv.second.size());
    if (fwrite(hdr, 1, 9, out) != 9 ||
        fwrite(kv.first.data(), 1, kv.first.size(), out) !=
            kv.first.size() ||
        fwrite(kv.second.data(), 1, kv.second.size(), out) !=
            kv.second.size()) {
      fclose(out);
      remove(tmp.c_str());
      return -1;
    }
  }
  if (fflush(out) != 0 || fsync(fileno(out)) != 0) {
    fclose(out);
    remove(tmp.c_str());
    return -1;
  }
  fclose(out);
  fclose(h->f);
  h->f = nullptr;
  int rc = rename(tmp.c_str(), h->path.c_str()) == 0 ? 0 : -1;
  // reopen the (renamed or original) log either way: the handle must
  // never be left with a dangling/closed FILE*, or later appends are UB
  h->f = fopen(h->path.c_str(), "ab");
  if (h->f == nullptr) return -1;
  return rc;
}

}  // extern "C"
