// Native I/O runtime for rs_sfm_tpu: fast CSV matrix parsing and PLY export.
//
// The reference parses its H x W unprojection CSVs (hundreds of thousands of
// doubles per file) with std::getline + atof per cell
// (reference src/rsframe.cc:58-378) and writes PLY clouds with ofstream <<
// per vertex (src/camera.cc:423-491).  This library replaces both with
// buffered single-pass code exposed through a C ABI consumed via ctypes —
// the host-side native runtime of the framework (the device compute itself
// lives in XLA and native/sor_cuda.cu).
//
// Build: `make -C native` -> native/librs_io.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Parse a CSV of numbers. Returns 0 on success.
// On success *out_data (malloc'd, caller frees via rs_io_free), *out_rows,
// *out_cols are set. Rows are delimited by '\n'; empty trailing lines are
// ignored; ragged rows cause error code 3.
int rs_io_read_csv(const char* path, double** out_data, int64_t* out_rows,
                   int64_t* out_cols) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return 2; }
  long size = ftell(f);
  if (size < 0) { fclose(f); return 2; }
  rewind(f);
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  size_t got = fread(buf.data(), 1, static_cast<size_t>(size), f);
  fclose(f);
  buf[got] = '\0';

  std::vector<double> values;
  values.reserve(got / 4);
  int64_t rows = 0;
  int64_t cols = -1;
  int64_t cur_cols = 0;
  const char* p = buf.data();
  const char* end = buf.data() + got;
  bool row_has_data = false;
  while (p < end) {
    if (*p == '\n' || *p == '\r') {
      if (row_has_data) {
        ++rows;
        if (cols < 0) cols = cur_cols;
        else if (cols != cur_cols) return 3;
      }
      cur_cols = 0;
      row_has_data = false;
      ++p;
      continue;
    }
    if (*p == ',' || *p == ' ' || *p == '\t' || *p == ';') { ++p; continue; }
    char* next = nullptr;
    double v = strtod(p, &next);
    if (next == p) { ++p; continue; }  // skip unparseable garbage
    values.push_back(v);
    ++cur_cols;
    row_has_data = true;
    p = next;
  }
  if (row_has_data) {
    ++rows;
    if (cols < 0) cols = cur_cols;
    else if (cols != cur_cols) return 3;
  }
  if (rows == 0 || cols <= 0) return 4;
  double* data = static_cast<double*>(malloc(values.size() * sizeof(double)));
  if (!data) return 5;
  memcpy(data, values.data(), values.size() * sizeof(double));
  *out_data = data;
  *out_rows = rows;
  *out_cols = cols;
  return 0;
}

void rs_io_free(double* data) { free(data); }

// Write an ASCII PLY of n points (xyz float64) with uint8 RGB colors.
// Returns number of vertices written, or -1 on error.
int64_t rs_io_write_ply(const char* path, const double* xyz,
                        const uint8_t* rgb, int64_t n) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f,
          "ply\nformat ascii 1.0\nelement vertex %lld\n"
          "property float x\nproperty float y\nproperty float z\n"
          "property uchar red\nproperty uchar green\nproperty uchar blue\n"
          "end_header\n",
          static_cast<long long>(n));
  std::vector<char> out;
  out.reserve(static_cast<size_t>(n) * 48);
  char line[128];
  for (int64_t i = 0; i < n; ++i) {
    int len = snprintf(line, sizeof(line), "%.6f %.6f %.6f %u %u %u\n",
                       xyz[3 * i], xyz[3 * i + 1], xyz[3 * i + 2],
                       rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2]);
    out.insert(out.end(), line, line + len);
  }
  size_t written = fwrite(out.data(), 1, out.size(), f);
  fclose(f);
  return written == out.size() ? n : -1;
}

// Write a CSV matrix (float64, row-major). Returns 0 on success.
int rs_io_write_csv(const char* path, const double* data, int64_t rows,
                    int64_t cols) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  std::vector<char> out;
  out.reserve(static_cast<size_t>(rows) * cols * 14);
  char cell[64];
  for (int64_t r = 0; r < rows; ++r) {
    for (int64_t c = 0; c < cols; ++c) {
      int len = snprintf(cell, sizeof(cell), "%.10g%c", data[r * cols + c],
                         c + 1 == cols ? '\n' : ',');
      out.insert(out.end(), cell, cell + len);
    }
  }
  size_t written = fwrite(out.data(), 1, out.size(), f);
  fclose(f);
  return written == out.size() ? 0 : 2;
}

}  // extern "C"
