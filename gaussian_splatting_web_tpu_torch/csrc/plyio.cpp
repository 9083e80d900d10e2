// Native PLY vertex unpacker: interleaved records -> SoA float32 arrays.
//
// The reference parses PLYs with a per-vertex, per-property scalar JS loop
// (reference: src/ply.ts:272-354) that takes "seconds to a couple of
// minutes" on large scenes (its loading popup text). This does the same
// decode as a single multithreaded pass: for each property, gather the
// strided column out of the record blob into a dense float32 array,
// converting uchar (scaled 1/255, ply.ts:122), int/short/double types as
// needed.
//
// Exposed as a plain C ABI for ctypes. Built at first use by the port's
// _native_build.py::load_host.
//
// uchar divides by 255 (x / 255.0f), as the NumPy path of io/ply.py does,
// so both paths give the same bits; x * (1.0f / 255.0f) differs from it by
// one ulp for 126 of the 256 values.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

enum PropType : int32_t {
  F32 = 0,
  F64 = 1,
  U8 = 2,
  I8 = 3,
  U16 = 4,
  I16 = 5,
  U32 = 6,
  I32 = 7,
};

template <typename T>
inline float load_as_float(const uint8_t* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return static_cast<float>(v);
}

inline float decode(const uint8_t* p, int32_t type) {
  switch (type) {
    case F32: return load_as_float<float>(p);
    case F64: return load_as_float<double>(p);
    case U8:  return load_as_float<uint8_t>(p) / 255.0f;
    case I8:  return load_as_float<int8_t>(p);
    case U16: return load_as_float<uint16_t>(p);
    case I16: return load_as_float<int16_t>(p);
    case U32: return load_as_float<uint32_t>(p);
    case I32: return load_as_float<int32_t>(p);
    default:  return 0.0f;
  }
}

}  // namespace

extern "C" {

// body:      n * stride bytes of little-endian records
// offsets:   per-property byte offset within a record
// types:     per-property PropType
// out:       nprops contiguous float32 columns, each of length n
//            (out[p * n + i] = property p of vertex i)
void ply_unpack(const uint8_t* body, int64_t n, int64_t stride,
                const int64_t* offsets, const int32_t* types, int32_t nprops,
                float* out, int32_t nthreads) {
  if (nthreads < 1) nthreads = 1;
  auto worker = [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      const uint8_t* rec = body + i * stride;
      for (int32_t p = 0; p < nprops; ++p) {
        out[static_cast<int64_t>(p) * n + i] = decode(rec + offsets[p], types[p]);
      }
    }
  };
  if (nthreads == 1 || n < 4096) {
    worker(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t block = (n + nthreads - 1) / nthreads;
  for (int32_t t = 0; t < nthreads; ++t) {
    int64_t b = t * block;
    int64_t e = b + block < n ? b + block : n;
    if (b >= e) break;
    threads.emplace_back(worker, b, e);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
