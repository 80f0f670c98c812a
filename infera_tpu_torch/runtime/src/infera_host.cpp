// Native host data plane for infera_tpu_torch.
//
// The port's copy of infera_tpu's host library (infera_tpu/runtime/src/
// infera_host.cpp), the same C functions and ABI version. The upstream
// project implements its data plane natively (a Rust engine, engine.rs,
// and C++ DuckDB marshalling, infera_extension.cpp). This library provides
// the same host-side services through a narrow C ABI consumed via ctypes
// (infera_tpu_torch/runtime/native.py):
//
//   - blob validation + decode  (engine.rs:200-263 run_inference_blob_impl's
//     byte handling, vectorized)
//   - feature-matrix extraction: column-major typed columns -> row-major f32
//     with NULL detection (infera_extension.cpp:199-227 ExtractFeatures,
//     without per-cell boxed Values)
//   - splitmix64 hashing + radix partitioning for the distributed shuffle's
//     host ingest path
//   - an unquoted all-numeric CSV body parser for read_csv
//
// Device compute stays in the port's torch operations and CUDA kernels;
// this library only touches host memory.

#include <atomic>
#include <charconv>
#include <cstdlib>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// blob decode
// ---------------------------------------------------------------------------

// Returns 0 on success, -1 if len % 4 != 0. Decodes little-endian f32.
int infera_blob_decode_f32(const uint8_t* blob, int64_t len, float* out) {
  if (len % 4 != 0) return -1;
  std::memcpy(out, blob, static_cast<size_t>(len));
  return 0;
}

// Validate a batch of blobs: every length must be a multiple of 4 and an
// equal element count. Returns total float count or a negative error code.
// -1: size not multiple of 4 (first bad row in *bad_row)
int64_t infera_blob_batch_validate(const int64_t* lens, int64_t n_blobs,
                                   int64_t* bad_row) {
  int64_t total = 0;
  for (int64_t i = 0; i < n_blobs; ++i) {
    if (lens[i] % 4 != 0) {
      if (bad_row) *bad_row = i;
      return -1;
    }
    total += lens[i] / 4;
  }
  return total;
}

// ---------------------------------------------------------------------------
// feature extraction: typed columns -> row-major f32 matrix
// ---------------------------------------------------------------------------

// col_types: 0=f32, 1=f64, 2=i32, 3=i64, 4=u8(bool)
// cols: array of pointers to column data; validity: per-column pointer to
// uint8 masks (1=valid) or nullptr when all-valid.
// Returns 0 on success; 1-based (row*ncols+col+1) of first NULL when found.
int64_t infera_extract_features_f32(const void** cols, const int32_t* col_types,
                                    const uint8_t** validity, int64_t rows,
                                    int64_t ncols, float* out) {
  for (int64_t c = 0; c < ncols; ++c) {
    const uint8_t* v = validity[c];
    if (v != nullptr) {
      for (int64_t r = 0; r < rows; ++r) {
        if (!v[r]) return r * ncols + c + 1;
      }
    }
  }
  for (int64_t c = 0; c < ncols; ++c) {
    switch (col_types[c]) {
      case 0: {
        const float* src = static_cast<const float*>(cols[c]);
        for (int64_t r = 0; r < rows; ++r) out[r * ncols + c] = src[r];
        break;
      }
      case 1: {
        const double* src = static_cast<const double*>(cols[c]);
        for (int64_t r = 0; r < rows; ++r)
          out[r * ncols + c] = static_cast<float>(src[r]);
        break;
      }
      case 2: {
        const int32_t* src = static_cast<const int32_t*>(cols[c]);
        for (int64_t r = 0; r < rows; ++r)
          out[r * ncols + c] = static_cast<float>(src[r]);
        break;
      }
      case 3: {
        const int64_t* src = static_cast<const int64_t*>(cols[c]);
        for (int64_t r = 0; r < rows; ++r)
          out[r * ncols + c] = static_cast<float>(src[r]);
        break;
      }
      case 4: {
        const uint8_t* src = static_cast<const uint8_t*>(cols[c]);
        for (int64_t r = 0; r < rows; ++r)
          out[r * ncols + c] = src[r] ? 1.0f : 0.0f;
        break;
      }
      default:
        return -1;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// hashing (splitmix64 finalizer — must match infera_tpu/ops/hashing.py)
// ---------------------------------------------------------------------------

static inline uint64_t mix64(uint64_t x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return x;
}

void infera_hash64_i64(const int64_t* keys, int64_t n, uint64_t* out) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = mix64(static_cast<uint64_t>(keys[i]));
}

void infera_hash64_combine(const uint64_t* a, const uint64_t* b, int64_t n,
                           uint64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t acc = a[i];
    acc = mix64(acc ^ (b[i] + 0x9E3779B97F4A7C15ULL + (acc << 6) + (acc >> 2)));
    out[i] = acc;
  }
}

// ---------------------------------------------------------------------------
// radix partition: histogram + stable scatter of row indices by hash % parts
// ---------------------------------------------------------------------------

// out_counts: [parts]; out_indices: [n] row indices ordered by partition
// (stable within a partition). Multi-threaded histogram for large n.
void infera_radix_partition(const uint64_t* hashes, int64_t n, int32_t parts,
                            int64_t* out_counts, int64_t* out_indices) {
  std::vector<int64_t> counts(static_cast<size_t>(parts), 0);
  for (int64_t i = 0; i < n; ++i)
    counts[static_cast<size_t>(hashes[i] % static_cast<uint64_t>(parts))]++;
  std::vector<int64_t> offsets(static_cast<size_t>(parts), 0);
  int64_t acc = 0;
  for (int32_t p = 0; p < parts; ++p) {
    offsets[static_cast<size_t>(p)] = acc;
    out_counts[p] = counts[static_cast<size_t>(p)];
    acc += counts[static_cast<size_t>(p)];
  }
  for (int64_t i = 0; i < n; ++i) {
    size_t p = static_cast<size_t>(hashes[i] % static_cast<uint64_t>(parts));
    out_indices[offsets[p]++] = i;
  }
}

// ---------------------------------------------------------------------------
// CSV fast path: all-numeric body → column-major f64 + NULL mask
// ---------------------------------------------------------------------------

// Sequential parse of buf[lo, hi) starting at row index `row0`.
// Returns rows parsed, or -1 on any structural/numeric mismatch.
static int64_t csv_parse_range(const char* buf, int64_t lo, int64_t hi,
                               char delim, int64_t ncols, double* out,
                               uint8_t* nulls, uint8_t* local_flags,
                               int64_t n_rows_cap, int64_t row0) {
  int64_t row = row0;
  int64_t i = lo;
  while (i < hi) {
    if (row >= n_rows_cap) return -1;
    int64_t col = 0;
    while (true) {
      int64_t j = i;
      while (j < hi && buf[j] != delim && buf[j] != '\n' && buf[j] != '\r')
        ++j;
      if (col >= ncols) return -1;  // ragged (too many fields)
      int64_t flen = j - i;
      double v = 0.0;
      bool is_null = (flen == 0);
      if (!is_null) {
        if (buf[i] == '"') return -1;  // quoted → general reader
        const char* b = buf + i;
        const char* e2 = buf + j;
        while (b < e2 && *b == ' ') ++b;
        while (e2 > b && e2[-1] == ' ') --e2;
        if (b == e2) return -1;  // all-spaces field → general reader
        bool floaty = false;
        for (const char* k = b; k < e2; ++k) {
          char ch = *k;
          if (ch == '.' || ch == 'e' || ch == 'E' || ch == 'n' || ch == 'N' ||
              ch == 'i' || ch == 'I') {
            floaty = true;
            break;
          }
        }
        if (floaty) {
          auto res = std::from_chars(b, e2, v);
          if (res.ec != std::errc() || res.ptr != e2) return -1;
          local_flags[col] = 1;
        } else {
          // Integer-syntax field: parse exactly as int64 — a double parse
          // silently rounds |int| > 2^53 (BIGINT columns must be exact).
          // Values a double cannot represent exactly bail to the general
          // reader, as does int64 overflow.
          int64_t iv = 0;
          auto res = std::from_chars(b, e2, iv);
          if (res.ec != std::errc() || res.ptr != e2) return -1;
          const int64_t kExact = int64_t(1) << 53;
          if (iv > kExact || iv < -kExact) return -1;
          v = static_cast<double>(iv);
        }
      }
      out[col * n_rows_cap + row] = v;
      nulls[col * n_rows_cap + row] = is_null ? 0 : 1;
      ++col;
      i = j;
      if (i >= hi || buf[i] == '\n' || buf[i] == '\r') break;
      ++i;  // skip delimiter
    }
    if (col != ncols) return -1;  // ragged (too few fields)
    if (i < hi && buf[i] == '\r') ++i;
    if (i < hi && buf[i] == '\n') ++i;
    ++row;
  }
  return row - row0;
}

// Parses an unquoted CSV byte buffer (after the header) into column-major
// doubles, multi-threaded over newline-aligned chunks for large buffers.
// Empty fields become NULL (mask bit 0). Returns the number of data rows
// parsed, or -1 when the buffer needs the general (Python) reader: a quote
// character, a ragged row, or a non-numeric field.
// out: [ncols * n_rows_cap] column-major; nulls: same layout, 1 = valid.
// float_flags[c] is set to 1 when column c contained float syntax
// ('.', exponent, inf/nan) — callers type pure-integer columns as BIGINT,
// matching the Python reader's BIGINT → DOUBLE inference.
int64_t infera_csv_parse_numeric(const char* buf, int64_t len, char delim,
                                 int64_t ncols, double* out, uint8_t* nulls,
                                 uint8_t* float_flags, int64_t n_rows_cap) {
  const int64_t kParallelMin = 4 << 20;  // 4 MiB
  unsigned hw = std::thread::hardware_concurrency();
  int n_threads = (len >= kParallelMin && hw > 1)
                      ? static_cast<int>(hw > 16 ? 16 : hw)
                      : 1;
  if (n_threads == 1)
    return csv_parse_range(buf, 0, len, delim, ncols, out, nulls, float_flags,
                           n_rows_cap, 0);

  // newline-aligned chunk boundaries
  std::vector<int64_t> starts;
  starts.push_back(0);
  for (int t = 1; t < n_threads; ++t) {
    int64_t pos = len * t / n_threads;
    const void* nl = std::memchr(buf + pos, '\n', static_cast<size_t>(len - pos));
    if (nl == nullptr) break;
    int64_t s = static_cast<const char*>(nl) - buf + 1;
    if (s > starts.back() && s < len) starts.push_back(s);
  }
  int chunks = static_cast<int>(starts.size());
  // rows per chunk = newline count (+1 for a final line without newline)
  std::vector<int64_t> chunk_rows(static_cast<size_t>(chunks), 0);
  for (int c = 0; c < chunks; ++c) {
    int64_t lo = starts[static_cast<size_t>(c)];
    int64_t hi = (c + 1 < chunks) ? starts[static_cast<size_t>(c + 1)] : len;
    int64_t count = 0;
    const char* p = buf + lo;
    const char* pend = buf + hi;
    while (p < pend) {
      const void* nl = std::memchr(p, '\n', static_cast<size_t>(pend - p));
      if (nl == nullptr) {
        ++count;  // final line without trailing newline
        break;
      }
      ++count;
      p = static_cast<const char*>(nl) + 1;
    }
    chunk_rows[static_cast<size_t>(c)] = count;
  }
  std::vector<int64_t> row0(static_cast<size_t>(chunks), 0);
  int64_t total_cap = 0;
  for (int c = 0; c < chunks; ++c) {
    row0[static_cast<size_t>(c)] = total_cap;
    total_cap += chunk_rows[static_cast<size_t>(c)];
  }
  if (total_cap > n_rows_cap) return -1;

  std::vector<std::vector<uint8_t>> tl_flags(
      static_cast<size_t>(chunks),
      std::vector<uint8_t>(static_cast<size_t>(ncols), 0));
  std::vector<int64_t> results(static_cast<size_t>(chunks), -1);
  std::vector<std::thread> workers;
  for (int c = 0; c < chunks; ++c) {
    workers.emplace_back([&, c]() {
      int64_t lo = starts[static_cast<size_t>(c)];
      int64_t hi = (c + 1 < chunks) ? starts[static_cast<size_t>(c + 1)] : len;
      results[static_cast<size_t>(c)] = csv_parse_range(
          buf, lo, hi, delim, ncols, out, nulls,
          tl_flags[static_cast<size_t>(c)].data(), n_rows_cap,
          row0[static_cast<size_t>(c)]);
    });
  }
  for (auto& w : workers) w.join();
  int64_t total = 0;
  for (int c = 0; c < chunks; ++c) {
    int64_t r = results[static_cast<size_t>(c)];
    // every chunk must parse exactly its counted rows
    if (r < 0 || r != chunk_rows[static_cast<size_t>(c)]) return -1;
    total += r;
    for (int64_t j = 0; j < ncols; ++j)
      if (tl_flags[static_cast<size_t>(c)][static_cast<size_t>(j)])
        float_flags[j] = 1;
  }
  return total;
}

// ---------------------------------------------------------------------------
// version probe
// ---------------------------------------------------------------------------

int infera_host_abi_version() { return 2; }

}  // extern "C"
