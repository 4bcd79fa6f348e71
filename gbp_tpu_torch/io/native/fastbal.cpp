// Fast BAL-format parser: the port's own copy of gbp_tpu/io/native/fastbal.cpp.
// Python's float() loop takes seconds on Venice-scale BAL files (~10^6
// observations); this strtod sweep over an in-memory buffer parses at
// ~100 MB/s.  Exposed via ctypes (gbp_tpu_torch/io/_native.py); gzip
// decompression happens on the Python side so the C ABI stays a single
// contiguous buffer.
//
// Build: g++ -O2 -shared -fPIC fastbal.cpp -o fastbal.so
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <locale.h>

namespace {

struct Cursor {
  const char* p;
  const char* end;
};

// BAL files always use '.' decimals; strtod is LC_NUMERIC-dependent, so parse
// under a cached C locale (a comma-decimal host locale would otherwise stop
// every float at its '.' and garble the file).
locale_t c_locale() {
  static locale_t loc = newlocale(LC_NUMERIC_MASK, "C", (locale_t)0);
  return loc;
}

// strtod-based token scan; returns false at end of buffer.
bool next_double(Cursor& c, double* out) {
  while (c.p < c.end &&
         (*c.p == ' ' || *c.p == '\n' || *c.p == '\r' || *c.p == '\t'))
    ++c.p;
  if (c.p >= c.end) return false;
  char* endp = nullptr;
  locale_t loc = c_locale();
  *out = loc ? strtod_l(c.p, &endp, loc) : std::strtod(c.p, &endp);
  if (endp == c.p) return false;
  c.p = endp;
  return true;
}

bool next_long(Cursor& c, int64_t* out) {
  double d;
  if (!next_double(c, &d)) return false;
  *out = static_cast<int64_t>(d);
  return true;
}

}  // namespace

extern "C" {

// Reads the BAL header from `buf` -> (n_cams, n_points, n_obs).
// Returns 0 on success, nonzero on parse error.
int bal_header(const char* buf, int64_t len, int64_t* n_cams,
               int64_t* n_points, int64_t* n_obs) {
  Cursor c{buf, buf + len};
  if (!next_long(c, n_cams) || !next_long(c, n_points) || !next_long(c, n_obs))
    return 1;
  return 0;
}

// Parses the whole file. Caller allocates:
//   cam_ids [n_obs], point_ids [n_obs], obs [n_obs*2],
//   cam_params [n_cams*9], points [n_points*3].
// Returns 0 on success, 1 on truncated/garbled input, 2 if trailing tokens.
int bal_parse(const char* buf, int64_t len, int64_t* cam_ids,
              int64_t* point_ids, double* obs, double* cam_params,
              double* points) {
  Cursor c{buf, buf + len};
  int64_t n_cams, n_points, n_obs;
  if (!next_long(c, &n_cams) || !next_long(c, &n_points) ||
      !next_long(c, &n_obs))
    return 1;
  for (int64_t i = 0; i < n_obs; ++i) {
    if (!next_long(c, &cam_ids[i]) || !next_long(c, &point_ids[i]) ||
        !next_double(c, &obs[2 * i]) || !next_double(c, &obs[2 * i + 1]))
      return 1;
  }
  for (int64_t i = 0; i < n_cams * 9; ++i)
    if (!next_double(c, &cam_params[i])) return 1;
  for (int64_t i = 0; i < n_points * 3; ++i)
    if (!next_double(c, &points[i])) return 1;
  double extra;
  if (next_double(c, &extra)) return 2;
  return 0;
}

}  // extern "C"
