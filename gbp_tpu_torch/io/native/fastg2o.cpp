// Fast g2o-format parser for the pose-graph model: the port's own copy of
// gbp_tpu/io/native/fastg2o.cpp, loaded by gbp_tpu_torch/io/_native.py.  The
// Python line loop costs ~10 s on city-scale files (10^5 poses x per-line
// float() calls); this strtod sweep parses at ~100 MB/s and returns RAW
// rows — quaternion -> angle-axis conversion and information-frame
// conjugation happen vectorized on the Python side (io/g2o.py).
//
// Two-call protocol (like fastbal.cpp): g2o_count sizes the output arrays,
// g2o_parse fills caller-allocated buffers.  Unknown line tags are skipped.
//
// Build: g++ -O2 -shared -fPIC fastg2o.cpp -o fastg2o.so
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <locale.h>

namespace {

struct Cursor {
  const char* p;
  const char* end;
};

locale_t c_locale() {
  static locale_t loc = newlocale(LC_NUMERIC_MASK, "C", (locale_t)0);
  return loc;
}

void skip_ws(Cursor& c) {
  while (c.p < c.end && (*c.p == ' ' || *c.p == '\t' || *c.p == '\r')) ++c.p;
}

void skip_line(Cursor& c) {
  while (c.p < c.end && *c.p != '\n') ++c.p;
  if (c.p < c.end) ++c.p;
}

// Reads the first whitespace-delimited word of the current line into tag.
bool next_tag(Cursor& c, char* tag, int cap) {
  while (c.p < c.end && (*c.p == '\n' || *c.p == ' ' || *c.p == '\t' ||
                         *c.p == '\r'))
    ++c.p;
  if (c.p >= c.end) return false;
  int n = 0;
  while (c.p < c.end && *c.p != ' ' && *c.p != '\t' && *c.p != '\n' &&
         *c.p != '\r' && n < cap - 1)
    tag[n++] = *c.p++;
  tag[n] = 0;
  return true;
}

bool next_double(Cursor& c, double* out) {
  skip_ws(c);
  if (c.p >= c.end || *c.p == '\n') return false;
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

bool read_doubles(Cursor& c, double* out, int n) {
  for (int k = 0; k < n; ++k)
    if (!next_double(c, out + k)) return false;
  return true;
}

}  // namespace

extern "C" {

// counts[0..3] = n_vertex_se2, n_edge_se2, n_vertex_se3, n_edge_se3.
int g2o_count(const char* buf, int64_t len, int64_t* counts) {
  Cursor c{buf, buf + len};
  counts[0] = counts[1] = counts[2] = counts[3] = 0;
  char tag[32];
  while (next_tag(c, tag, sizeof(tag))) {
    if (!std::strcmp(tag, "VERTEX_SE2")) ++counts[0];
    else if (!std::strcmp(tag, "EDGE_SE2")) ++counts[1];
    else if (!std::strcmp(tag, "VERTEX_SE3:QUAT")) ++counts[2];
    else if (!std::strcmp(tag, "EDGE_SE3:QUAT")) ++counts[3];
    skip_line(c);
  }
  return 0;
}

// Fills caller-allocated buffers (sizes from g2o_count):
//   v2_id [n_v2], v2 [n_v2*3]            (x, y, theta)
//   e2_ij [n_e2*2], e2 [n_e2*9]          (dx, dy, dth, 6 upper-tri info)
//   v3_id [n_v3], v3 [n_v3*7]            (x, y, z, qx, qy, qz, qw)
//   e3_ij [n_e3*2], e3 [n_e3*28]         (t3, quat4, 21 upper-tri info)
// Returns 0 on success, 1 on a malformed known-tag line.
int g2o_parse(const char* buf, int64_t len,
              int64_t* v2_id, double* v2,
              int64_t* e2_ij, double* e2,
              int64_t* v3_id, double* v3,
              int64_t* e3_ij, double* e3) {
  Cursor c{buf, buf + len};
  char tag[32];
  int64_t iv2 = 0, ie2 = 0, iv3 = 0, ie3 = 0;
  while (next_tag(c, tag, sizeof(tag))) {
    if (!std::strcmp(tag, "VERTEX_SE2")) {
      if (!next_long(c, v2_id + iv2) || !read_doubles(c, v2 + iv2 * 3, 3))
        return 1;
      ++iv2;
    } else if (!std::strcmp(tag, "EDGE_SE2")) {
      if (!next_long(c, e2_ij + ie2 * 2) || !next_long(c, e2_ij + ie2 * 2 + 1)
          || !read_doubles(c, e2 + ie2 * 9, 9))
        return 1;
      ++ie2;
    } else if (!std::strcmp(tag, "VERTEX_SE3:QUAT")) {
      if (!next_long(c, v3_id + iv3) || !read_doubles(c, v3 + iv3 * 7, 7))
        return 1;
      ++iv3;
    } else if (!std::strcmp(tag, "EDGE_SE3:QUAT")) {
      if (!next_long(c, e3_ij + ie3 * 2) || !next_long(c, e3_ij + ie3 * 2 + 1)
          || !read_doubles(c, e3 + ie3 * 28, 28))
        return 1;
      ++ie3;
    }
    skip_line(c);
  }
  return 0;
}

}  // extern "C"
