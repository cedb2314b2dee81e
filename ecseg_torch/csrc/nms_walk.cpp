// The greedy NMS walk of NuSeT's proposals on the host (ops/boxes.py
// greedy_walk; its Python twin greedy_walk_py): over candidates sorted by
// descending score, take the first live one, remove those its row of the
// packed suppression matrix marks, repeat, at most `max_output` times.
//
// `packed` holds n rows of `row_bytes` bytes, bit j of byte b of row i (bit
// order little, as np.packbits(..., bitorder="little")) set where candidate
// i suppresses candidate 8 b + j; `valid` (n bytes, 0 or 1) marks the
// candidates.  The walk keeps the removed set packed the same way and ORs a
// taken row into it a byte at a time.  Called through ctypes, which lets
// go of the Python interpreter's lock for the call.
//
// A plain C ABI for ctypes, built at first use by ecseg_torch/_build.py
// (host_library).

#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" {

// Writes the taken indices, in order, to `out` (room for max_output);
// returns how many.
int64_t nms_greedy_walk(const uint8_t* packed, const uint8_t* valid, int64_t n, int64_t row_bytes,
                        int64_t max_output, int64_t* out) {
  std::vector<uint8_t> removed(static_cast<size_t>(row_bytes), 0);
  for (int64_t i = 0; i < n; ++i)
    if (!valid[i]) removed[i >> 3] |= static_cast<uint8_t>(1u << (i & 7));
  int64_t k = 0;
  for (int64_t i = 0; i < n && k < max_output; ++i) {
    if (removed[i >> 3] >> (i & 7) & 1) continue;
    out[k++] = i;
    const uint8_t* row = packed + i * row_bytes;
    for (int64_t b = 0; b < row_bytes; ++b) removed[b] |= row[b];
  }
  return k;
}

}  // extern "C"
