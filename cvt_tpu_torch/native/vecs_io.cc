// Native reader for cvt's id+feature record stream.
//
// Format (brute_force_search/src/brute_force.cpp:24-61):
//   [int32 n] then per record [int32 idlen][idlen bytes id]
//   [int32 d][d x float32]
//
// The variable-length records defeat numpy vectorization, so the Python
// fallback walks them one struct.unpack at a time; this reader does one
// buffered pass in C++ (two-phase: scan for sizes, then fill caller-
// allocated buffers). A copy of cvt_tpu/native/vecs_io.cc, exposed
// through ctypes (cvt_tpu_torch/io/vecs.py).
//
// Build: g++ -O3 -shared -fPIC, by cvt_tpu_torch/native/__init__.py into
// cvt_tpu_torch/_build/.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct Reader {
  FILE* f;
  explicit Reader(const char* path) : f(std::fopen(path, "rb")) {}
  ~Reader() {
    if (f) std::fclose(f);
  }
  bool read_i32(int32_t* out) { return std::fread(out, 4, 1, f) == 1; }
  bool skip(long n) { return std::fseek(f, n, SEEK_CUR) == 0; }
  bool read(void* dst, size_t n) { return std::fread(dst, 1, n, f) == n; }
};

}  // namespace

extern "C" {

// Phase 1: scan the stream; returns 0 on success, negative on error.
// Outputs: n records, feature dim d (-1 if inconsistent across records),
// total id bytes.
int64_t cvt_records_scan(const char* path, int64_t* n_out, int64_t* d_out,
                         int64_t* id_bytes_out) {
  Reader r(path);
  if (!r.f) return -1;
  int32_t n = 0;
  if (!r.read_i32(&n) || n < 0) return -2;
  int64_t d = -2;  // unset
  int64_t id_bytes = 0;
  for (int32_t i = 0; i < n; ++i) {
    int32_t idlen = 0, dim = 0;
    if (!r.read_i32(&idlen) || idlen < 0 || !r.skip(idlen)) return -3;
    if (!r.read_i32(&dim) || dim < 0) return -4;
    if (!r.skip(4L * dim)) return -5;
    id_bytes += idlen;
    if (d == -2)
      d = dim;
    else if (d != dim)
      d = -1;  // inconsistent
  }
  *n_out = n;
  *d_out = (d == -2 ? 0 : d);
  *id_bytes_out = id_bytes;
  return 0;
}

// Phase 2: fill caller buffers. feats: [n*d] f32; ids: concatenated raw
// id bytes; id_off: [n+1] offsets into ids (id_off[0] == 0). Buffers
// must be sized from cvt_records_scan. Returns 0 on success.
int64_t cvt_records_read(const char* path, int64_t n, int64_t d,
                         float* feats, char* ids, int64_t* id_off) {
  Reader r(path);
  if (!r.f) return -1;
  int32_t n_hdr = 0;
  if (!r.read_i32(&n_hdr) || n_hdr != n) return -2;
  int64_t off = 0;
  id_off[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t idlen = 0, dim = 0;
    if (!r.read_i32(&idlen) || idlen < 0) return -3;
    if (!r.read(ids + off, (size_t)idlen)) return -4;
    off += idlen;
    id_off[i + 1] = off;
    if (!r.read_i32(&dim) || dim != d) return -5;
    if (!r.read(feats + i * d, 4u * (size_t)dim)) return -6;
  }
  return 0;
}

// Streamed writer (mirror of the reference writer). ids/id_off as
// above; returns 0 on success.
int64_t cvt_records_write(const char* path, int64_t n, int64_t d,
                          const float* feats, const char* ids,
                          const int64_t* id_off) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  int32_t n32 = (int32_t)n;
  if (std::fwrite(&n32, 4, 1, f) != 1) goto fail;
  for (int64_t i = 0; i < n; ++i) {
    int32_t idlen = (int32_t)(id_off[i + 1] - id_off[i]);
    int32_t d32 = (int32_t)d;
    if (std::fwrite(&idlen, 4, 1, f) != 1) goto fail;
    if (idlen && std::fwrite(ids + id_off[i], 1, (size_t)idlen, f) !=
                     (size_t)idlen)
      goto fail;
    if (std::fwrite(&d32, 4, 1, f) != 1) goto fail;
    if (std::fwrite(feats + i * d, 4, (size_t)d, f) != (size_t)d) goto fail;
  }
  std::fclose(f);
  return 0;
fail:
  std::fclose(f);
  return -2;
}

}  // extern "C"
