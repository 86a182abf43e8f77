// Native GIF-variant LZW encoder — C ABI, byte-identical output to the
// Python implementation in cosig_tpu_torch/utils/gif.py (itself a spec-level
// rebuild of the reference's hand-rolled encoder,
// Assets/Services/GifGenerator.cs:411-501): 9->12-bit growing codes,
// clear/end codes, 4096-entry cap, little-endian bit packing.
//
// The string table is a (prefix_code << 8 | byte) hash map instead of the
// reference's string-keyed dictionary — same code sequence, O(1) lookups.
//
// Build: cosig_tpu_torch/native/loader.py at first use.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t buffer = 0;
  int bits = 0;

  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}

  void write(int code, int size) {
    buffer |= (uint32_t)code << bits;
    bits += size;
    while (bits >= 8) {
      out.push_back((uint8_t)(buffer & 0xFF));
      buffer >>= 8;
      bits -= 8;
    }
  }

  void flush() {
    if (bits > 0) out.push_back((uint8_t)(buffer & 0xFF));
  }
};

}  // namespace

extern "C" {

// Compress `n` bytes of palette indices. Writes at most `cap` bytes into
// `out`; returns the compressed length, or -1 if `cap` is insufficient.
int cosig_lzw_compress(const uint8_t* data, int64_t n, int min_code_size,
                       uint8_t* out, int64_t cap) {
  const int clear_code = 1 << min_code_size;
  const int end_code = clear_code + 1;
  int next_code = end_code + 1;
  int code_size = min_code_size + 1;

  std::vector<uint8_t> buf;
  buf.reserve((size_t)(n ? n : 16));
  BitWriter w(buf);

  // Table keyed on (prefix_code << 8) | next_byte.
  std::unordered_map<uint32_t, int> table;
  table.reserve(4096 * 2);

  w.write(clear_code, code_size);
  if (n == 0) {
    w.write(end_code, code_size);
    w.flush();
  } else {
    int current = data[0];  // single bytes are their own codes
    for (int64_t i = 1; i < n; i++) {
      uint32_t key = ((uint32_t)current << 8) | data[i];
      auto it = table.find(key);
      if (it != table.end()) {
        current = it->second;
      } else {
        w.write(current, code_size);
        if (next_code < 4096) {
          table.emplace(key, next_code);
          if (next_code == (1 << code_size)) code_size++;
          next_code++;
        }
        current = data[i];
      }
    }
    w.write(current, code_size);
    w.write(end_code, code_size);
    w.flush();
  }

  if ((int64_t)buf.size() > cap) return -1;
  std::memcpy(out, buf.data(), buf.size());
  return (int)buf.size();
}

}  // extern "C"
