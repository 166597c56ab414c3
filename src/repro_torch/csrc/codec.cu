// K3 / K4: the uplink payload codec (absmax int8 / int4, uint32 words).
//
// Replaces: src/repro/kernels/compress.py::encode_pallas (body
// _encode_kernel) and compress.py::decode_pallas (body _decode_kernel),
// reached through compress.py::encode / decode from
// repro/offload/engine.py when a plan's compression_level is 1 or 2.
//
// Wire format, bit-exact with repro/kernels/ref.py::encode_codec_ref:
//   words  (rows, ceil(cols/128)*128 * bits/32) uint32, values packed
//          little-endian as two's-complement `bits`-bit integers
//   scales (rows, ceil(cols/128)) float32 = absmax * f32(1/qmax)
// Per (row, 128-feature group): non-finite inputs become 0; the scale is a
// MULTIPLY by the float32 reciprocal of qmax (not a divide); an all-zero
// group stores scale 0 and divides by 1; q = clamp(rint(z / safe), +-qmax)
// with an IEEE divide (this file must not be built with --use_fast_math)
// and rintf's round-half-to-even. A ragged last group is zero-filled.
//
// Bound on H100: bytes. Encode reads 4 B per feature and writes bits/8 B
// plus 4 B per 128 features; decode the reverse. The arithmetic is a
// handful of integer ops and one multiply per value. Decode moves 4 B of
// output per value against bits/8 B of input, so its speed is the speed of
// its stores: they have to reach the memory as whole 32-byte sectors.
//
// Design. Encode: one warp per (row, group), four consecutive values per
// lane; the absmax is a shuffle-max across the warp. int8: each lane's
// four values are one word. int4: a word holds eight values, so lanes 2j
// and 2j+1 OR their halves together with one shuffle and the even lane
// stores. Decode mirrors it: one warp per (row, group), each lane unpacking
// its four features (shift the field to the top, arithmetic shift back to
// sign-extend, then (float)q * scale) and writing them as one float4, so a
// warp store is 512 contiguous bytes. `bits` is a template parameter, so
// the unpack is straight-line code, and the row comes from blockIdx.y, so
// no thread divides. Only the `cols` live features are stored, so the
// output needs no slice; a row start that is not 16-byte aligned
// (cols % 4 != 0) takes a second instantiation with scalar stores.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxGridY = 65535;
constexpr unsigned kFull = 0xffffffffu;

__global__ void encode_kernel(const float* __restrict__ x, int rows, int cols, int groups,
                              int bits, uint32_t* __restrict__ words,
                              float* __restrict__ scales) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= static_cast<int64_t>(rows) * groups) return;  // whole warps leave together
  const int row = static_cast<int>(warp / groups);
  const int g = static_cast<int>(warp % groups);
  const float* xr = x + static_cast<int64_t>(row) * cols;
  const int c0 = g * kTile + lane * 4;

  float v[4];
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = c0 + k;
    float t = (c < cols) ? xr[c] : 0.f;
    t = isfinite(t) ? t : 0.f;
    v[k] = t;
    amax = fmaxf(amax, fabsf(t));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, off));
  }
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
  const float scale = amax * (1.0f / qmax);
  const float safe = scale > 0.f ? scale : 1.f;
  const uint32_t mask = (1u << bits) - 1u;
  // position of v[0] inside its word: int8 fills a word per lane, int4
  // puts the odd lane's four values in the high half
  const int pos0 = (bits == 8) ? 0 : 4 * (lane & 1);
  uint32_t packed = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float q = fminf(fmaxf(rintf(v[k] / safe), -qmax), qmax);
    packed |= (static_cast<uint32_t>(static_cast<int>(q)) & mask) << (bits * (pos0 + k));
  }
  const int64_t words_per_row = static_cast<int64_t>(groups) * kTile * bits / 32;
  uint32_t* wr = words + static_cast<int64_t>(row) * words_per_row;
  if (bits == 8) {
    wr[g * 32 + lane] = packed;
  } else {
    packed |= __shfl_xor_sync(kFull, packed, 1);  // bits is warp-uniform
    if ((lane & 1) == 0) wr[g * 16 + (lane >> 1)] = packed;
  }
  if (lane == 0) scales[static_cast<int64_t>(row) * groups + g] = scale;
}

// Lane l owns features 4l..4l+3 of group g. int8: it unpacks word l of the
// group. int4: lanes 2j and 2j+1 share word j (one 64-byte load for the
// warp) and take its low and high half. The scale is a broadcast load.
template <int kBits, bool kVec>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
decode_kernel(const uint32_t* __restrict__ words, const float* __restrict__ scales, int rows,
              int cols, int groups, float* __restrict__ out) {
  constexpr int kWordsPerGroup = kTile * kBits / 32;
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (g >= groups) return;  // whole warps leave together
  const int c0 = g * kTile + lane * 4;
  const int j = g * kWordsPerGroup + (kBits == 8 ? lane : lane >> 1);
  const int pos0 = (kBits == 8) ? 0 : 16 * (lane & 1);  // bit offset of feature c0
  const int64_t words_per_row = static_cast<int64_t>(groups) * kWordsPerGroup;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const uint32_t w = words[row * words_per_row + j];
    const float s = scales[static_cast<int64_t>(row) * groups + g];
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // lift the field to bit 31, then an arithmetic shift sign-extends it
      const int q = static_cast<int>(w << (32 - kBits - pos0 - kBits * k)) >> (32 - kBits);
      v[k] = __fmul_rn(static_cast<float>(q), s);  // one IEEE multiply, as the oracle
    }
    float* o = out + static_cast<int64_t>(row) * cols + c0;
    if (kVec) {
      if (c0 < cols) *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (c0 + k < cols) o[k] = v[k];
      }
    }
  }
}

template <int kBits>
void launch_decode(const uint32_t* words, const float* scales, int rows, int cols, int groups,
                   float* out, cudaStream_t stream) {
  const dim3 grid((groups + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY));
  const bool vec = cols % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    decode_kernel<kBits, true><<<grid, 32 * kWarpsPerBlock, 0, stream>>>(words, scales, rows,
                                                                          cols, groups, out);
  } else {
    decode_kernel<kBits, false><<<grid, 32 * kWarpsPerBlock, 0, stream>>>(words, scales, rows,
                                                                           cols, groups, out);
  }
}

}  // namespace

// x: (rows, cols) contiguous float32; bits: 8 or 4;
// words: (rows, ceil(cols/128)*128*bits/32) uint32; scales: (rows,
// ceil(cols/128)) float32. Returns cudaGetLastError().
extern "C" int repro_encode(const void* x, int rows, int cols, int bits, void* words,
                            void* scales, void* stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaSuccess);
  if (bits != 8 && bits != 4) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (cols + kTile - 1) / kTile;
  const int64_t warps = static_cast<int64_t>(rows) * groups;
  const dim3 grid(static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  encode_kernel<<<grid, 32 * kWarpsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), rows, cols, groups, bits, static_cast<uint32_t*>(words),
      static_cast<float*>(scales));
  return static_cast<int>(cudaGetLastError());
}

// words, scales: as written by repro_encode; out: (rows, cols) float32.
// Returns cudaGetLastError().
extern "C" int repro_decode(const void* words, const void* scales, int rows, int cols,
                            int bits, void* out, void* stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaSuccess);
  if (bits != 8 && bits != 4) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (cols + kTile - 1) / kTile;
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* sc = static_cast<const float*>(scales);
  auto* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 8) {
    launch_decode<8>(w, sc, rows, cols, groups, o, st);
  } else {
    launch_decode<4>(w, sc, rows, cols, groups, o, st);
  }
  return static_cast<int>(cudaGetLastError());
}
