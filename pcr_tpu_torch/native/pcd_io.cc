// Native host-side data plane of pcr_tpu_torch: PCD v0.7 reader, threaded
// batch loader and voxel counter (a copy of pcr_tpu/native/pcd_io.cc with the
// same C ABI, so the port depends on no file of the JAX package).
//
// Parsing 901 binary scans and padding them into the fixed-shape dataset
// buckets is host work, done here in C++ with a thread pool so that scan
// loading overlaps across cores and never holds the card back.
//
// C ABI only (loaded via ctypes):
//   pcr_read_pcd        one file -> caller-provided padded buffers
//   pcr_read_pcd_batch  many files, std::thread pool, one contiguous buffer
//   pcr_count_voxels    occupied-voxel count of a point set
//
// Supported format subset (everything the reference datasets use, plus the
// common integer field types): FIELDS with x/y/z (+ optional packed-float
// rgb), TYPE F/I/U, SIZE 1/2/4/8, DATA ascii | binary.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <memory>
#include <vector>

namespace {

constexpr long kErrOpen = -1;
constexpr long kErrHeader = -2;
constexpr long kErrFields = -3;
constexpr long kErrTruncated = -4;
constexpr long kErrCapacity = -5;
constexpr long kErrMode = -6;

struct FieldSpec {
  std::string name;
  int size = 4;
  char type = 'F';
  int count = 1;
  long offset = 0;  // byte offset within a binary record
  int column = 0;   // first token index within an ascii row
};

struct Header {
  std::vector<FieldSpec> fields;
  long n_points = 0;
  long stride = 0;   // binary record size
  int n_columns = 0; // ascii tokens per row
  bool binary = false;
  long data_start = 0;  // byte offset of payload
};

// Parse the header of a PCD buffer. Returns 0 or a kErr* code.
long parse_header(const char* buf, long len, Header* h) {
  long pos = 0;
  std::vector<std::string> names, sizes, types, counts;
  while (pos < len) {
    long eol = pos;
    while (eol < len && buf[eol] != '\n') eol++;
    std::string line(buf + pos, eol - pos);
    pos = eol + 1;
    if (line.empty() || line[0] == '#') continue;
    // split on whitespace
    std::vector<std::string> tok;
    size_t i = 0;
    while (i < line.size()) {
      while (i < line.size() && std::isspace((unsigned char)line[i])) i++;
      size_t j = i;
      while (j < line.size() && !std::isspace((unsigned char)line[j])) j++;
      if (j > i) tok.emplace_back(line.substr(i, j - i));
      i = j;
    }
    if (tok.empty()) continue;
    std::string key = tok[0];
    for (auto& c : key) c = std::toupper((unsigned char)c);
    if (key == "FIELDS") names.assign(tok.begin() + 1, tok.end());
    else if (key == "SIZE") sizes.assign(tok.begin() + 1, tok.end());
    else if (key == "TYPE") types.assign(tok.begin() + 1, tok.end());
    else if (key == "COUNT") counts.assign(tok.begin() + 1, tok.end());
    else if (key == "POINTS" && tok.size() > 1) h->n_points = atol(tok[1].c_str());
    else if (key == "DATA") {
      if (tok.size() < 2) return kErrHeader;
      std::string mode = tok[1];
      for (auto& c : mode) c = std::tolower((unsigned char)c);
      if (mode == "binary") h->binary = true;
      else if (mode == "ascii") h->binary = false;
      else return kErrMode;
      h->data_start = pos;
      if (names.empty() || names.size() != sizes.size() ||
          names.size() != types.size())
        return kErrHeader;
      long off = 0;
      int col = 0;
      for (size_t k = 0; k < names.size(); k++) {
        FieldSpec f;
        f.name = names[k];
        for (auto& c : f.name) c = std::tolower((unsigned char)c);
        f.size = atoi(sizes[k].c_str());
        f.type = std::toupper((unsigned char)types[k][0]);
        f.count = k < counts.size() ? atoi(counts[k].c_str()) : 1;
        f.offset = off;
        f.column = col;
        off += (long)f.size * f.count;
        col += f.count;
        h->fields.push_back(f);
      }
      h->stride = off;
      h->n_columns = col;
      return 0;
    }
  }
  return kErrHeader;
}

float read_scalar(const char* p, char type, int size) {
  switch (type) {
    case 'F':
      if (size == 4) { float v; std::memcpy(&v, p, 4); return v; }
      if (size == 8) { double v; std::memcpy(&v, p, 8); return (float)v; }
      break;
    case 'I':
      if (size == 1) { int8_t v; std::memcpy(&v, p, 1); return (float)v; }
      if (size == 2) { int16_t v; std::memcpy(&v, p, 2); return (float)v; }
      if (size == 4) { int32_t v; std::memcpy(&v, p, 4); return (float)v; }
      break;
    case 'U':
      if (size == 1) { uint8_t v; std::memcpy(&v, p, 1); return (float)v; }
      if (size == 2) { uint16_t v; std::memcpy(&v, p, 2); return (float)v; }
      if (size == 4) { uint32_t v; std::memcpy(&v, p, 4); return (float)v; }
      break;
  }
  return 0.0f;
}

// Read one PCD file into padded buffers.  points: cap*3 floats, mask: cap
// bytes; colors: cap*3 floats or nullptr.  Returns point count or kErr*.
long read_one(const char* path, long cap, float pad_coord, float* points,
              unsigned char* mask, float* colors, unsigned char* has_colors) {
  FILE* fh = std::fopen(path, "rb");
  if (!fh) return kErrOpen;
  std::fseek(fh, 0, SEEK_END);
  long len = std::ftell(fh);
  std::fseek(fh, 0, SEEK_SET);
  std::unique_ptr<char[]> owned(new char[len]);  // no value-init memset
  char* data = owned.get();
  if ((long)std::fread(data, 1, len, fh) != len) {
    std::fclose(fh);
    return kErrTruncated;
  }
  std::fclose(fh);

  Header h;
  long rc = parse_header(data, len, &h);
  if (rc != 0) return rc;
  if (h.n_points > cap) return kErrCapacity;

  const FieldSpec *fx = nullptr, *fy = nullptr, *fz = nullptr, *frgb = nullptr;
  for (const auto& f : h.fields) {
    if (f.name == "x") fx = &f;
    else if (f.name == "y") fy = &f;
    else if (f.name == "z") fz = &f;
    else if (f.name == "rgb") frgb = &f;
  }
  if (!fx || !fy || !fz) return kErrFields;
  if (has_colors) *has_colors = (frgb && colors) ? 1 : 0;

  const long n = h.n_points;
  if (h.binary) {
    if (h.data_start + h.stride * n > len) return kErrTruncated;
    const char* base = data + h.data_start;
    const bool xyz_f4_contig =
        fx->type == 'F' && fx->size == 4 && fy->type == 'F' && fy->size == 4 &&
        fz->type == 'F' && fz->size == 4 && fy->offset == fx->offset + 4 &&
        fz->offset == fx->offset + 8;
    if (xyz_f4_contig && h.stride == 12 && fx->offset == 0) {
      std::memcpy(points, base, n * 12);  // pure-xyz file: one bulk copy
    } else if (xyz_f4_contig) {
      for (long i = 0; i < n; i++)
        std::memcpy(points + i * 3, base + i * h.stride + fx->offset, 12);
    } else {
      for (long i = 0; i < n; i++) {
        const char* rec = base + i * h.stride;
        points[i * 3 + 0] = read_scalar(rec + fx->offset, fx->type, fx->size);
        points[i * 3 + 1] = read_scalar(rec + fy->offset, fy->type, fy->size);
        points[i * 3 + 2] = read_scalar(rec + fz->offset, fz->type, fz->size);
      }
    }
    if (frgb && colors) {
      for (long i = 0; i < n; i++) {
        uint32_t packed;
        std::memcpy(&packed, base + i * h.stride + frgb->offset, 4);
        colors[i * 3 + 0] = (float)((packed >> 16) & 0xFF) / 255.0f;
        colors[i * 3 + 1] = (float)((packed >> 8) & 0xFF) / 255.0f;
        colors[i * 3 + 2] = (float)(packed & 0xFF) / 255.0f;
      }
    }
  } else {
    const char* p = data + h.data_start;
    const char* end = data + len;
    std::vector<float> row(h.n_columns);
    for (long i = 0; i < n; i++) {
      for (int c = 0; c < h.n_columns; c++) {
        char* next = nullptr;
        row[c] = std::strtof(p, &next);
        if (next == p) return kErrTruncated;
        p = next;
        if (p > end) return kErrTruncated;
      }
      points[i * 3 + 0] = row[fx->column];
      points[i * 3 + 1] = row[fy->column];
      points[i * 3 + 2] = row[fz->column];
      if (frgb && colors) {
        // ascii rgb is written as the packed float's decimal form
        float fv = row[frgb->column];
        uint32_t packed;
        std::memcpy(&packed, &fv, 4);
        colors[i * 3 + 0] = (float)((packed >> 16) & 0xFF) / 255.0f;
        colors[i * 3 + 1] = (float)((packed >> 8) & 0xFF) / 255.0f;
        colors[i * 3 + 2] = (float)(packed & 0xFF) / 255.0f;
      }
    }
  }

  for (long i = 0; i < n; i++) mask[i] = 1;
  for (long i = n; i < cap; i++) {
    mask[i] = 0;
    points[i * 3 + 0] = pad_coord;
    points[i * 3 + 1] = pad_coord;
    points[i * 3 + 2] = pad_coord;
  }
  if (colors)
    for (long i = n * 3; i < cap * 3; i++) colors[i] = 0.0f;
  return n;
}

}  // namespace

extern "C" {

long pcr_read_pcd(const char* path, long cap, float pad_coord, float* points,
                  unsigned char* mask, float* colors,
                  unsigned char* has_colors) {
  return read_one(path, cap, pad_coord, points, mask, colors, has_colors);
}

// Batched threaded load.  paths: n_files C strings; points: n_files*cap*3;
// mask: n_files*cap; colors: n_files*cap*3 (or nullptr); counts[i] gets the
// per-file point count or a negative error code.  Returns 0 if every file
// loaded, else the first error code.
long pcr_read_pcd_batch(const char* const* paths, long n_files, long cap,
                        float pad_coord, float* points, unsigned char* mask,
                        float* colors, unsigned char* has_colors, long* counts,
                        int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_files) n_threads = (int)n_files;
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; t++) {
    pool.emplace_back([=]() {
      for (long i = t; i < n_files; i += n_threads) {
        counts[i] = read_one(
            paths[i], cap, pad_coord, points + i * cap * 3, mask + i * cap,
            colors ? colors + i * cap * 3 : nullptr,
            has_colors ? has_colors + i : nullptr);
      }
    });
  }
  for (auto& th : pool) th.join();
  for (long i = 0; i < n_files; i++)
    if (counts[i] < 0) return counts[i];
  return 0;
}

// Fast host-side voxel-occupancy count (the hot loop of the static-shape
// planner, utils/cloud.py plan_scale_caps): floor((p - min)/v) cells, exact
// unique count via sort.  Returns the number of occupied voxels.
long pcr_count_voxels(const float* points, long n, float voxel) {
  if (n == 0) return 0;
  float mn[3] = {points[0], points[1], points[2]};
  for (long i = 1; i < n; i++)
    for (int d = 0; d < 3; d++)
      if (points[i * 3 + d] < mn[d]) mn[d] = points[i * 3 + d];
  std::vector<uint64_t> keys(n);
  for (long i = 0; i < n; i++) {
    uint64_t k = 0;
    for (int d = 0; d < 3; d++) {
      long c = (long)std::floor((points[i * 3 + d] - mn[d]) / voxel);
      k = (k << 21) | (uint64_t)(c & 0x1FFFFF);
    }
    keys[i] = k;
  }
  std::sort(keys.begin(), keys.end());
  long uniq = 1;
  for (long i = 1; i < n; i++)
    if (keys[i] != keys[i - 1]) uniq++;
  return uniq;
}

}  // extern "C"
