// Native CSV reader for heat_tpu.
//
// The reference framework reads CSV by splitting the file into per-rank byte
// ranges aligned to line breaks and parsing each range in Python
// (reference heat/core/io.py:713-925). This is the native equivalent of that
// data-loader: the byte-range decomposition is kept, but ranges are parsed by
// C++ worker threads (strtod hot loop, no per-line Python objects), feeding
// one contiguous output buffer that the caller hands to jax.device_put.
//
// Exposed C ABI (ctypes-bound in heat_tpu/_native/__init__.py):
//   csv_scan(path, sep, skip_lines, &rows, &cols)  -> 0 on success
//   csv_parse(path, sep, skip_lines, rows, cols, out, n_threads) -> rows done
//
// Build: g++ -O3 -std=c++17 -shared -fPIC csv_reader.cpp -o libheatcsv.so -lpthread

#include <charconv>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <string>
#include <thread>
#include <vector>

namespace {

// Read the whole file into memory. Returns false on IO failure.
bool slurp(const char* path, std::string& buf) {
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f) return false;
  std::streamsize size = f.tellg();
  if (size < 0) return false;
  f.seekg(0);
  buf.resize(static_cast<size_t>(size));
  return size == 0 || static_cast<bool>(f.read(&buf[0], size));
}

// Offset of the first byte after `skip_lines` newlines.
size_t skip_offset(const std::string& buf, long long skip_lines) {
  size_t pos = 0;
  for (long long i = 0; i < skip_lines && pos < buf.size(); ++i) {
    const char* nl = static_cast<const char*>(memchr(buf.data() + pos, '\n', buf.size() - pos));
    if (!nl) return buf.size();
    pos = static_cast<size_t>(nl - buf.data()) + 1;
  }
  return pos;
}

// A line is "data" if it contains any non-whitespace character.
inline bool is_data_line(const char* begin, const char* end) {
  for (const char* p = begin; p < end; ++p) {
    if (*p != ' ' && *p != '\t' && *p != '\r') return true;
  }
  return false;
}

// Count data lines in [begin, end); the final line may lack a newline.
long long count_lines(const char* begin, const char* end) {
  long long n = 0;
  const char* p = begin;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* line_end = nl ? nl : end;
    if (is_data_line(p, line_end)) ++n;
    p = nl ? nl + 1 : end;
  }
  return n;
}

// Parse data lines of [begin, end) into out[row0 * cols ...].
// Returns rows parsed, or -1 on malformed input (wrong column count).
long long parse_range(const char* begin, const char* end, char sep, long long cols,
                      double* out, long long row0) {
  long long row = row0;
  const char* p = begin;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* line_end = nl ? nl : end;
    if (is_data_line(p, line_end)) {
      double* dst = out + row * cols;
      const char* q = p;
      for (long long c = 0; c < cols; ++c) {
        while (q < line_end && *q != sep && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
        if (q < line_end && *q == '+') ++q;  // from_chars rejects leading '+'
        // from_chars: ~4x strtod, locale-free, and bounded by line_end so a
        // short row cannot silently consume the next line
        double val;
        std::from_chars_result res = std::from_chars(q, line_end, val);
        if (res.ec != std::errc()) return -1;
        dst[c] = val;
        q = res.ptr;
        // consume whitespace that is not itself the separator
        while (q < line_end && *q != sep && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
        if (c + 1 < cols) {
          if (q >= line_end || *q != sep) return -1;
          ++q;
        }
      }
      // a ragged row with MORE fields than the first data row must fail,
      // not silently truncate
      if (q < line_end && (*q == sep || is_data_line(q, line_end))) return -1;
      ++row;
    }
    p = nl ? nl + 1 : end;
  }
  return row - row0;
}

// Split [begin, end) into n newline-aligned chunks.
std::vector<const char*> chunk_bounds(const char* begin, const char* end, int n) {
  std::vector<const char*> bounds;
  bounds.push_back(begin);
  size_t total = static_cast<size_t>(end - begin);
  for (int i = 1; i < n; ++i) {
    const char* target = begin + total * i / n;
    if (target <= bounds.back()) target = bounds.back();
    const char* nl = static_cast<const char*>(
        memchr(target, '\n', static_cast<size_t>(end - target)));
    bounds.push_back(nl ? nl + 1 : end);
  }
  bounds.push_back(end);
  return bounds;
}

}  // namespace

extern "C" {

// Scan shape: rows = data lines after skip, cols from the first data line.
// Returns 0 on success, -1 on IO error, -2 on empty file.
int csv_scan(const char* path, char sep, long long skip_lines, long long* out_rows,
             long long* out_cols) {
  std::string buf;
  if (!slurp(path, buf)) return -1;
  size_t start = skip_offset(buf, skip_lines);
  const char* begin = buf.data() + start;
  const char* end = buf.data() + buf.size();
  *out_rows = count_lines(begin, end);
  if (*out_rows == 0) {
    *out_cols = 0;
    return -2;
  }
  // columns of the first data line: separators outside numbers + 1
  const char* p = begin;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* line_end = nl ? nl : end;
    if (is_data_line(p, line_end)) {
      long long cols = 1;
      for (const char* q = p; q < line_end; ++q) {
        if (*q == sep) ++cols;
      }
      *out_cols = cols;
      return 0;
    }
    p = nl ? nl + 1 : end;
  }
  return -2;
}

// Parse the file into out (rows*cols doubles, preallocated by the caller).
// Returns rows parsed, or negative on error (-1 IO, -3 malformed).
long long csv_parse(const char* path, char sep, long long skip_lines, long long rows,
                    long long cols, double* out, int n_threads) {
  std::string buf;
  if (!slurp(path, buf)) return -1;
  size_t start = skip_offset(buf, skip_lines);
  const char* begin = buf.data() + start;
  const char* end = buf.data() + buf.size();

  if (n_threads < 1) n_threads = 1;
  std::vector<const char*> bounds = chunk_bounds(begin, end, n_threads);

  // pass 1 (parallel): rows per chunk -> starting row of each chunk
  std::vector<long long> chunk_rows(static_cast<size_t>(n_threads), 0);
  {
    std::vector<std::thread> ts;
    for (int i = 0; i < n_threads; ++i) {
      ts.emplace_back([&, i] { chunk_rows[i] = count_lines(bounds[i], bounds[i + 1]); });
    }
    for (auto& t : ts) t.join();
  }
  std::vector<long long> row0(static_cast<size_t>(n_threads) + 1, 0);
  for (int i = 0; i < n_threads; ++i) row0[i + 1] = row0[i] + chunk_rows[i];
  if (row0[n_threads] != rows) return -3;

  // pass 2 (parallel): parse each chunk into its row range
  std::vector<long long> done(static_cast<size_t>(n_threads), 0);
  {
    std::vector<std::thread> ts;
    for (int i = 0; i < n_threads; ++i) {
      ts.emplace_back([&, i] {
        done[i] = parse_range(bounds[i], bounds[i + 1], sep, cols, out, row0[i]);
      });
    }
    for (auto& t : ts) t.join();
  }
  long long total = 0;
  for (int i = 0; i < n_threads; ++i) {
    if (done[i] < 0) return -3;
    total += done[i];
  }
  return total;
}

}  // extern "C"
