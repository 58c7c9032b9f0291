// Native CSV writer for heat_tpu.
//
// Counterpart of csv_reader.cpp: the reference serializes CSV rows in Python
// with a token-ring of rank-ordered writes (reference heat/core/io.py:926-1059).
// With a single controller the ordering problem disappears; what remains is
// the formatting hot loop, which this file runs in C++ worker threads — each
// thread formats a contiguous row range into its own buffer, then the buffers
// are written to the file in order.
//
// Exposed C ABI (ctypes-bound in heat_tpu/_native/__init__.py):
//   csv_write(path, data, rows, cols, sep, decimals, append, n_threads)
//     data:     row-major double buffer (rows x cols)
//     decimals: >= 0 -> fixed "%.<d>f"; < 0 -> shortest round-trip "%.17g"
//     append:   nonzero appends (header lines already written by the caller)
//     returns rows written, or -1 on I/O failure
//
// Build: g++ -O3 -std=c++17 -shared -fPIC csv_reader.cpp csv_writer.cpp \
//            -o libheatcsv.so -lpthread

#include <charconv>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

void format_rows(const double* data, long long row_begin, long long row_end,
                 long long cols, char sep, int decimals, std::string* out) {
  char num[64];
  out->reserve(static_cast<size_t>((row_end - row_begin) * cols * 12));
  for (long long r = row_begin; r < row_end; ++r) {
    const double* row = data + r * cols;
    for (long long c = 0; c < cols; ++c) {
      if (decimals >= 0) {
        size_t len = static_cast<size_t>(
            snprintf(num, sizeof(num), "%.*f", decimals, row[c]));
        if (len < sizeof(num)) {
          out->append(num, len);
        } else {
          // %.2f of 1e300 needs ~300 chars: reformat on the heap instead of
          // appending past the truncated stack buffer
          std::vector<char> wide(len + 1);
          snprintf(wide.data(), wide.size(), "%.*f", decimals, row[c]);
          out->append(wide.data(), len);
        }
      } else {
        // shortest round-trip representation — ~6x faster than %.17g and
        // produces the same value on re-parse
        auto res = std::to_chars(num, num + sizeof(num), row[c]);
        out->append(num, static_cast<size_t>(res.ptr - num));
      }
      out->push_back(c + 1 < cols ? sep : '\n');
    }
  }
}

}  // namespace

extern "C" long long csv_write(const char* path, const double* data,
                               long long rows, long long cols, char sep,
                               int decimals, int append, int n_threads) {
  if (rows < 0 || cols <= 0) return -1;
  if (n_threads < 1) n_threads = 1;
  long long max_threads = rows / 4096 + 1;  // don't spawn for tiny files
  if (n_threads > max_threads) n_threads = static_cast<int>(max_threads);

  std::vector<std::string> chunks(static_cast<size_t>(n_threads));
  std::vector<std::thread> workers;
  long long per = (rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    long long begin = static_cast<long long>(t) * per;
    long long end = begin + per < rows ? begin + per : rows;
    if (begin >= end) break;
    workers.emplace_back(format_rows, data, begin, end, cols, sep, decimals,
                         &chunks[static_cast<size_t>(t)]);
  }
  for (auto& w : workers) w.join();

  FILE* f = fopen(path, append ? "ab" : "wb");
  if (!f) return -1;
  for (const auto& chunk : chunks) {
    if (!chunk.empty() &&
        fwrite(chunk.data(), 1, chunk.size(), f) != chunk.size()) {
      fclose(f);
      return -1;
    }
  }
  if (fclose(f) != 0) return -1;
  return rows;
}
