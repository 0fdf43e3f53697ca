// Native ORB vocabulary parsers (binary and text DBoW2 formats) and the
// binary writer.
//
// The port's own copy of orb_slam_2_ros_tpu/native/vocab_loader.cc. The
// reference's fast vocabulary load is a C++ binary reader
// (TemplatedVocabulary.h:1473-1546: header k, L, scoring, weighting as
// int32, then 45-byte packed records parent:int32, isLeaf:u8, desc:32xu8,
// weight:f64); the text format (loadFromTextFile) is one node per line.
// Bound with ctypes (native/__init__.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {
constexpr int kDescBytes = 32;
constexpr size_t kRecSize = 4 + 1 + kDescBytes + 8;   // packed, no padding
}  // namespace

extern "C" {

// Returns the node count parsed, or -1 on error. Arrays must hold at least
// max_nodes entries; k/L receive the tree branching and depth.
long parse_orbvoc_bin(const char* path, int* k, int* L,
                      int32_t* parents, uint8_t* is_leaf,
                      uint8_t* descs /* max_nodes*32 */, double* weights,
                      long max_nodes) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int32_t header[4];
  if (std::fread(header, sizeof(int32_t), 4, f) != 4) {
    std::fclose(f);
    return -1;
  }
  *k = header[0];
  *L = header[1];
  if (*k < 0 || *k > 20 || *L < 1 || *L > 10) {
    std::fclose(f);
    return -1;
  }
  // bulk read then unpack the packed 45-byte records
  std::fseek(f, 0, SEEK_END);
  long bytes = std::ftell(f) - 16;
  std::fseek(f, 16, SEEK_SET);
  long n = bytes / static_cast<long>(kRecSize);
  if (n > max_nodes) n = max_nodes;
  std::vector<uint8_t> buf(static_cast<size_t>(n) * kRecSize);
  size_t got = std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  n = static_cast<long>(got / kRecSize);
  const uint8_t* p = buf.data();
  for (long i = 0; i < n; ++i, p += kRecSize) {
    std::memcpy(&parents[i], p, 4);
    is_leaf[i] = p[4];
    std::memcpy(&descs[i * kDescBytes], p + 5, kDescBytes);
    std::memcpy(&weights[i], p + 5 + kDescBytes, 8);
  }
  return n;
}

// Text format (loadFromTextFile): first line "k L scoring weighting", then
// one node per line: "parent isLeaf b0 .. b31 weight".
long parse_orbvoc_txt(const char* path, int* k, int* L,
                      int32_t* parents, uint8_t* is_leaf,
                      uint8_t* descs, double* weights, long max_nodes) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  int scoring, weighting;
  if (std::fscanf(f, "%d %d %d %d", k, L, &scoring, &weighting) != 4) {
    std::fclose(f);
    return -1;
  }
  long n = 0;
  while (n < max_nodes) {
    int parent, leaf;
    if (std::fscanf(f, "%d %d", &parent, &leaf) != 2) break;
    parents[n] = parent;
    is_leaf[n] = static_cast<uint8_t>(leaf);
    bool ok = true;
    for (int b = 0; b < kDescBytes; ++b) {
      int v;
      if (std::fscanf(f, "%d", &v) != 1) { ok = false; break; }
      descs[n * kDescBytes + b] = static_cast<uint8_t>(v);
    }
    double w;
    if (!ok || std::fscanf(f, "%lf", &w) != 1) break;
    weights[n] = w;
    ++n;
  }
  std::fclose(f);
  return n;
}

// Binary writer (saveToBinFile layout) so a text vocabulary can be
// converted once and loaded fast afterwards (README.md:12 behavior).
long write_orbvoc_bin(const char* path, int k, int L,
                      const int32_t* parents, const uint8_t* is_leaf,
                      const uint8_t* descs, const double* weights, long n) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  int32_t header[4] = {k, L, 0, 0};
  std::fwrite(header, sizeof(int32_t), 4, f);
  std::vector<uint8_t> rec(kRecSize);
  for (long i = 0; i < n; ++i) {
    std::memcpy(rec.data(), &parents[i], 4);
    rec[4] = is_leaf[i];
    std::memcpy(rec.data() + 5, &descs[i * kDescBytes], kDescBytes);
    std::memcpy(rec.data() + 5 + kDescBytes, &weights[i], 8);
    std::fwrite(rec.data(), 1, kRecSize, f);
  }
  std::fclose(f);
  return n;
}

}  // extern "C"
