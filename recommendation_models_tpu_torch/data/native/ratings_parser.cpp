// Fast ratings-file parser for the data plane (SURVEY.md N12, §7 hard part 6).
//
// The reference's data layer is scipy CSR built from Python parsing; at
// ML-25M/100M scale the text decode dominates ingest, so this framework
// carries a small native parser: a streaming chunked scan that extracts the
// first three numeric fields of each line (user, item, rating) regardless of
// delimiter ("\t", ",", "::"). Exposed over a C ABI for ctypes (no pybind11
// in this environment).
//
// Memory: the round-1 parser buffered the WHOLE file plus a growing vector
// plus a copy (~3x file size peak). This version reads fixed 4 MB chunks
// (carrying partial lines across chunk boundaries) and appends straight into
// one geometrically realloc-grown output buffer, so peak memory is the
// output itself (24 B/row) + one chunk, independent of file size.
//
// Build: lazy auto-build in native/__init__.py (g++ -O3 -march=native
// -shared) into build/native/ at the root of the checkout.

#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

inline bool is_num_start(char c) {
  return (c >= '0' && c <= '9') || c == '-' || c == '+' || c == '.';
}

// Inline decimal parser: MovieLens fields are small ints and half-star
// decimals, and glibc strtod (locale machinery, arbitrary precision) was
// the whole bottleneck — 63 MB/s end to end, SLOWER than np.loadtxt.
// Digits accumulate in uint64 (exact to 2^53 in the double result, far
// beyond any id/timestamp); anything exotic (exponents, >19 digits, hex)
// falls back to strtod for correctness.
constexpr double kNegPow10[] = {1.0, 1e-1, 1e-2, 1e-3, 1e-4, 1e-5, 1e-6,
                                1e-7, 1e-8, 1e-9, 1e-10, 1e-11, 1e-12};

inline bool fast_number(const char*& p, const char* end, double& val) {
  const char* start = p;
  bool neg = false;
  if (p < end && (*p == '+' || *p == '-')) {
    neg = (*p == '-');
    ++p;
  }
  unsigned long long ip = 0;
  int digs = 0;
  while (p < end && *p >= '0' && *p <= '9') {
    ip = ip * 10u + static_cast<unsigned>(*p - '0');
    ++p;
    ++digs;
  }
  double v = static_cast<double>(ip);
  int fdigs = 0;
  if (p < end && *p == '.') {
    ++p;
    unsigned long long fp = 0;
    while (p < end && *p >= '0' && *p <= '9') {
      if (fdigs < 12) {
        fp = fp * 10u + static_cast<unsigned>(*p - '0');
        ++fdigs;
      }
      ++p;
    }
    v += static_cast<double>(fp) * kNegPow10[fdigs];
  }
  if (digs + fdigs == 0 || digs > 19 ||
      (p < end && (*p == 'e' || *p == 'E'))) {
    char* next = nullptr;
    v = std::strtod(start, &next);   // window is '\0'/'\n'-terminated
    if (next == start) {
      p = start;
      return false;
    }
    p = next;
    val = v;
    return true;
  }
  val = neg ? -v : v;
  return true;
}

constexpr size_t kChunk = 4u << 20;  // 4 MB read blocks

struct Out {
  double* data = nullptr;
  size_t len = 0;  // doubles used
  size_t cap = 0;  // doubles allocated

  bool reserve3() {
    if (len + 3 <= cap) return true;
    size_t ncap = cap ? cap + cap / 2 : (1u << 18);
    if (ncap < len + 3) ncap = len + 3;
    double* nd = static_cast<double*>(
        std::realloc(data, ncap * sizeof(double)));
    if (!nd) return false;
    data = nd;
    cap = ncap;
    return true;
  }

  // Pre-size from the file size (MovieLens lines run ~20-30 B): one
  // allocation instead of a realloc-growth ladder whose final step
  // transiently holds ~2.5x the output. Underestimates just fall back to
  // growth; reserve3 stays the correctness path.
  void hint_rows(long file_bytes) {
    if (file_bytes <= 0 || cap) return;
    size_t rows = static_cast<size_t>(file_bytes) / 26 + 16;
    double* nd = static_cast<double*>(std::malloc(rows * 3 * sizeof(double)));
    if (nd) {
      data = nd;
      cap = rows * 3;
    }
  }
};

// Parse complete lines in [p, end); `end` points just past the final
// newline (or at a '\0'-terminated final partial line at EOF).
bool parse_window(const char* p, const char* end, Out& out) {
  while (p < end) {
    double fields[3];
    int nf = 0;
    while (p < end && *p != '\n') {
      if (nf < 3 && is_num_start(*p)) {
        if (fast_number(p, end, fields[nf])) {
          ++nf;
          if (nf == 3) {
            // done with this line's payload: jump to the newline
            const char* nl = static_cast<const char*>(
                std::memchr(p, '\n', static_cast<size_t>(end - p)));
            p = nl ? nl : end;
          }
          continue;
        }
      }
      ++p;
    }
    if (p < end) ++p;  // consume '\n'
    if (nf == 3) {
      if (!out.reserve3()) return false;
      out.data[out.len++] = fields[0];
      out.data[out.len++] = fields[1];
      out.data[out.len++] = fields[2];
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Parses `path`, writing an interleaved [user, item, rating] * n_rows buffer.
// Returns the number of rows parsed, or -1 on error. Caller must free *out
// with free_buffer(). Lines with fewer than 3 numeric fields are skipped.
long parse_ratings(const char* path, int skip_header, double** out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;

  size_t buf_cap = kChunk + 1;
  char* buf = static_cast<char*>(std::malloc(buf_cap));
  if (!buf) {
    std::fclose(f);
    return -1;
  }

  Out rows;
  if (std::fseek(f, 0, SEEK_END) == 0) {
    rows.hint_rows(std::ftell(f));
    std::fseek(f, 0, SEEK_SET);
  }
  size_t have = 0;  // carried partial-line bytes at the buffer head
  bool skipped = !skip_header;
  bool ok = true;

  for (;;) {
    size_t want = buf_cap - 1 - have;
    if (want == 0) {
      // one line longer than the buffer: grow it (pathological input)
      buf_cap *= 2;
      char* nb = static_cast<char*>(std::realloc(buf, buf_cap));
      if (!nb) {
        ok = false;
        break;
      }
      buf = nb;
      want = buf_cap - 1 - have;
    }
    size_t got = std::fread(buf + have, 1, want, f);
    size_t len = have + got;
    bool eof = got < want;
    buf[len] = '\0';

    if (!skipped) {
      // discard bytes up to and including the header's newline; a header
      // spanning chunks is discarded piecewise (no carry needed)
      char* nl = static_cast<char*>(std::memchr(buf, '\n', len));
      if (nl == nullptr) {
        have = 0;
        if (eof) break;
        continue;
      }
      size_t off = static_cast<size_t>(nl - buf) + 1;
      std::memmove(buf, buf + off, len - off);
      len -= off;
      buf[len] = '\0';
      skipped = true;
    }

    size_t proc = len;
    if (!eof) {
      // only complete lines; carry the trailing fragment to the next chunk
      while (proc > 0 && buf[proc - 1] != '\n') --proc;
      if (proc == 0) {  // no newline in the whole buffer: need a bigger one
        have = len;
        continue;
      }
    }
    // Complete lines end in '\n', so strtod never scans past the window;
    // the final partial line at EOF is handled below behind its own '\0'.
    if (!parse_window(buf, buf + proc, rows)) {
      ok = false;
      break;
    }
    have = len - proc;
    if (have) std::memmove(buf, buf + proc, have);
    if (eof) {
      if (have) {
        buf[have] = '\0';
        ok = parse_window(buf, buf + have, rows) && ok;
      }
      break;
    }
  }

  std::free(buf);
  std::fclose(f);
  if (!ok) {
    std::free(rows.data);
    return -1;
  }
  if (rows.data == nullptr) rows.data = static_cast<double*>(std::malloc(8));
  *out = rows.data;
  return static_cast<long>(rows.len / 3);
}

void free_buffer(double* p) { std::free(p); }

}  // extern "C"
