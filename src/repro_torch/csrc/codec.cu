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
// with the IEEE quotient and rintf's round-half-to-even, bit for bit (see
// pack_codes; this file must not be built with --use_fast_math). A ragged
// last group is zero-filled.
//
// Bound on H100: bytes. Encode reads 4 B per feature and writes bits/8 B
// plus 4 B per 128 features; decode the reverse. The arithmetic is a
// handful of float and integer ops per value (the IEEE divide only near a
// rounding tie, see pack_codes). Decode moves 4 B of output per value against
// bits/8 B of input, so its speed is the speed of its stores: they have to
// reach the memory as whole 32-byte sectors.
//
// Design, encode. The layout and the grid come from the caller
// (kernels/compress.py::encode_layout), so the choice is tested on the CPU;
// every layout walks its work in a grid-stride loop, so any grid covers it.
// The pair index p = row*groups + g is also the scale's index and
// p*words_per_group the group's first word, so only a load needs the row,
// and not even it where cols % 128 == 0.
//  - wide (cols > 32, more than 32 768 pairs: (512, 16384), (4, 2097152)): a
//    (row, group) pair is a half-warp's. Lane l of the half holds values
//    8l..8l+7 of the group as two 16-byte loads, so the absmax is a 4-step
//    shuffle inside the half. At int4 those 8 codes are exactly word l of the
//    group (16 lanes store 64 contiguous bytes); at int8 they are words 2l
//    and 2l+1, one 8-byte store. A warp's step is two consecutive pairs, one
//    a half-warp. encode_layout gives every step a warp of its own (up to
//    65535 blocks of 128 threads, past which the warps loop): on the H100
//    that beat a grid of the card's resident warps walking several steps
//    each, with 32 or 64 B a lane in flight.
//  - quad (cols > 32, at most 32 768 pairs: one request's payload up to
//    granite's (4, 786432) and (252, 16384)): a warp per pair, lane l holding
//    values 4l..4l+3, one 16-byte load. Its chain of work a lane is half the
//    wide layout's, which is what a payload too small to fill the card waits
//    on; at int4 a lane stores its 4 codes as one 16-bit unit, so no lane
//    idles and none shuffles codes. It led the wide layout up to 16 384 pairs
//    and tied it at 24 576 and 32 256; wide led by 2-4% at 65 536.
//  - wide_scalar, quad_scalar: the same where a row start is not 16-byte
//    aligned (cols % 4 != 0, or a base pointer off 16 B): scalar loads.
//  - narrow (cols <= 32, one partial group a row: the (n, 10) logits): a row
//    is 8 lanes, a warp 4 rows. Lane j computes the codes of values 4j..4j+3
//    (the absmax a 3-step shuffle across the row's lanes), then stores the
//    row's 16-byte piece j of words, gathered by shuffles, zero padding
//    included, as one uint4: one launch and one pass for every row.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md, section 6), L2-cold:
// (512, 16384) int4 at 74-76% of its bound and int8 at 76-78%, granite's
// (4, 786432) at 57-61%, branch 2's 6.3 MB batches at 42-49%: each 1-12%
// slower than a strided copy that moves the same bytes in one launch, so
// what is left is the launch and the memory's ramp, not the kernel's work. One
// request's payload 1.34-1.55x the launch floor, the (n, 10) logits
// 1.40-2.34x.
//
// Design, decode: one warp per (row, group), each lane unpacking its four
// features (shift the field to the top, arithmetic shift back to
// sign-extend, then (float)q * scale) and writing them as one float4, so a
// warp store is 512 contiguous bytes. `bits` is a template parameter, so
// the unpack is straight-line code, and the row comes from blockIdx.y, so no
// thread divides. Only the `cols` live features are stored, so the output
// needs no slice; a row start that is not 16-byte aligned (cols % 4 != 0)
// takes a second instantiation with scalar stores.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxGridY = 65535;
constexpr unsigned kFull = 0xffffffffu;

// encode layouts, numbered as kernels/compress.py::ENCODE_LAYOUTS
constexpr int kWide = 0;
constexpr int kWideScalar = 1;
constexpr int kQuad = 2;
constexpr int kQuadScalar = 3;
constexpr int kNarrow = 4;
constexpr int kNarrowCols = 32;
constexpr int kMaxEncodeThreads = 256;
constexpr int kMaxEncodeBlocks = 65535;

// The kN values' codes, packed as the wire packs them (value k at bit
// kBits * k of the kN * kBits / 32 words), bit-exact with
// clamp(rintf(__fdiv_rn(v, safe)), +-qmax); safe is the group's scale, or 1.
//
// Fast path: t = v * r with r = 1/safe rounded, then rounded half-to-even to
// an integer by adding 1.5 * 2^23 (whose bit pattern then holds the integer).
// With safe normal, t is within 2^-23 * |v / safe| of the exact quotient (the
// reciprocal's rounding and the product's) and the IEEE quotient within
// 2^-24 * |v / safe|; |v / safe| <= 127.01, so t and the IEEE quotient lie
// within 2.3e-5 of each other and round to the same integer unless a
// half-integer lies between them. A lane any of whose
// values has t within 2^-14 of a half-integer, or whose safe is subnormal (r
// is then not within 2^-24 of 1/safe, or overflows), redoes all its values
// with the IEEE divide. Every intrinsic rounds once, so nothing is contracted
// into an FMA.
template <int kBits, int kN>
__device__ __forceinline__ void pack_codes(const float (&v)[kN], float safe,
                                           uint32_t (&w)[(kN * kBits + 31) / 32]) {
  constexpr float kQmax = static_cast<float>((1 << (kBits - 1)) - 1);
  constexpr float kMagic = 12582912.0f;            // 1.5 * 2^23
  constexpr float kNearTie = 0.5f - 1.0f / 16384;  // |t - rint(t)| from here on: near a tie
  constexpr uint32_t kMask = (1u << kBits) - 1u;
  constexpr int kPer = 32 / kBits;  // values a word
  const float r = __frcp_rn(safe);
  uint32_t code[kN];
  float off[kN];  // |t - rint(t)|
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    // t is clamped first: the bounds are integers, so rint(t) comes out clamped
    const float t = fminf(fmaxf(__fmul_rn(v[k], r), -kQmax), kQmax);
    const float m = __fadd_rn(t, kMagic);
    off[k] = fabsf(__fsub_rn(t, __fsub_rn(m, kMagic)));
    code[k] = __float_as_uint(m) & kMask;  // rint(t) mod 2^kBits: m's bits are 0x4B400000 + rint(t)
  }
#pragma unroll
  for (int s = 1; s < kN; s *= 2) {
#pragma unroll
    for (int k = 0; k + s < kN; k += 2 * s) off[k] = fmaxf(off[k], off[k + s]);
  }
  if (off[0] >= kNearTie || !(safe >= FLT_MIN)) {
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const float q = fminf(fmaxf(rintf(__fdiv_rn(v[k], safe)), -kQmax), kQmax);
      code[k] = static_cast<uint32_t>(static_cast<int>(q)) & kMask;
    }
  }
#pragma unroll
  for (int k = 0; k < kN; ++k) code[k] <<= kBits * (k % kPer);
#pragma unroll
  for (int s = 1; s < kPer; s *= 2) {
#pragma unroll
    for (int k = 0; k + s < kN; k += 2 * s) code[k] |= code[k + s];
  }
#pragma unroll
  for (int i = 0; i < (kN * kBits + 31) / 32; ++i) w[i] = code[i * kPer];
}

// The largest |v[k]|, after the non-finite values are zeroed in place.
template <int kN>
__device__ __forceinline__ float zero_nonfinite_absmax(float (&v)[kN]) {
  float a[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    v[k] = isfinite(v[k]) ? v[k] : 0.f;
    a[k] = fabsf(v[k]);
  }
#pragma unroll
  for (int s = 1; s < kN; s *= 2) {
#pragma unroll
    for (int k = 0; k + s < kN; k += 2 * s) a[k] = fmaxf(a[k], a[k + s]);
  }
  return a[0];
}

// The first value of pair p's group, and its live values from there on
// (at least 128 where cols % 128 == 0: then no thread divides).
__device__ __forceinline__ int64_t group_start(uint32_t p, int cols, int groups, int& live) {
  if (cols % kTile == 0) {
    live = kTile;
    return static_cast<int64_t>(p) * kTile;
  }
  const uint32_t row = p / static_cast<uint32_t>(groups);
  const int g0 = static_cast<int>(p - row * static_cast<uint32_t>(groups)) * kTile;
  live = cols - g0;
  return static_cast<int64_t>(row) * cols + g0;
}

// kN values from src, the first `left` of them live, zeros after: 16-byte
// loads where rows are 16-byte aligned (cols % 4 == 0, so a float4 is all
// live or all past the end), else a value at a time.
template <bool kVec, int kN>
__device__ __forceinline__ void load_values(const float* __restrict__ src, int left,
                                            float (&v)[kN]) {
#pragma unroll
  for (int k = 0; k < kN; ++k) v[k] = 0.f;
  if (kVec) {
#pragma unroll
    for (int i = 0; i < kN / 4; ++i) {
      if (4 * i < left) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(src) + i);
        v[4 * i] = a.x, v[4 * i + 1] = a.y, v[4 * i + 2] = a.z, v[4 * i + 3] = a.w;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      if (k < left) v[k] = __ldg(src + k);
    }
  }
}

// ------------------------------------------------------------- wide
// Lane l of a half-warp loads values 8l..8l+7 of pair p (zeros past the
// row's end or past the last pair).
template <bool kVec>
__device__ __forceinline__ void load_pair(const float* __restrict__ x, uint32_t p, uint32_t pairs,
                                          int cols, int groups, int l, float (&v)[8]) {
  int live = 0;
  const int64_t start = p < pairs ? group_start(p, cols, groups, live) : 0;
  load_values<kVec, 8>(x + start + 8 * l, live - 8 * l, v);
}

// Scale and codes of pair p from its 16 lanes' values; every lane of the
// warp calls it (the shuffles take the whole warp), lanes past the last
// pair store nothing.
template <int kBits>
__device__ __forceinline__ void encode_pair(float (&v)[8], uint32_t p, uint32_t pairs, int l,
                                            float inv_qmax, uint32_t* __restrict__ words,
                                            float* __restrict__ scales) {
  constexpr int kWordsPerGroup = kTile * kBits / 32;
  float amax = zero_nonfinite_absmax(v);
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {  // stays inside the half-warp
    amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, off));
  }
  const float scale = __fmul_rn(amax, inv_qmax);
  uint32_t w[8 * kBits / 32];
  pack_codes<kBits, 8>(v, scale > 0.f ? scale : 1.f, w);
  if (p >= pairs) return;
  uint32_t* dst = words + static_cast<int64_t>(p) * kWordsPerGroup;
  if constexpr (kBits == 8) {
    reinterpret_cast<uint2*>(dst)[l] = make_uint2(w[0], w[1]);
  } else {
    dst[l] = w[0];
  }
  if (l == 0) scales[p] = scale;
}

// Warp w encodes steps w, w + nwarps, ...; step s is pairs 2s and 2s + 1,
// one a half-warp.
template <int kBits, bool kVec>
__global__ void __launch_bounds__(kMaxEncodeThreads)
encode_wide(const float* __restrict__ x, int cols, int groups, uint32_t pairs,
            uint32_t* __restrict__ words, float* __restrict__ scales) {
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int l = lane & 15;
  const uint32_t nwarps = (gridDim.x * blockDim.x) >> 5;
  const uint32_t steps = (pairs + 1) / 2;
  const float inv_qmax = __fdiv_rn(1.f, static_cast<float>((1 << (kBits - 1)) - 1));
  // the loop bounds depend on the warp only, so whole warps run each step
  for (uint32_t s = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; s < steps; s += nwarps) {
    float v[8];
    load_pair<kVec>(x, 2 * s + half, pairs, cols, groups, l, v);
    encode_pair<kBits>(v, 2 * s + half, pairs, l, inv_qmax, words, scales);
  }
}

// ------------------------------------------------------------- quad
// A warp per pair, lane l holding values 4l..4l+3 (one 16-byte load, or
// four scalar ones): half the wide layout's chain of work a lane, for
// payloads too small to fill the card. At int8 the lane's codes are word
// l; at int4 they are the low (l even) or high (l odd) half of word l/2,
// stored as the 16-bit unit l of the group's words.
template <int kBits, bool kVec>
__global__ void __launch_bounds__(kMaxEncodeThreads)
encode_quad(const float* __restrict__ x, int cols, int groups, uint32_t pairs,
            uint32_t* __restrict__ words, float* __restrict__ scales) {
  constexpr int kWordsPerGroup = kTile * kBits / 32;
  const int l = threadIdx.x & 31;
  const uint32_t nwarps = (gridDim.x * blockDim.x) >> 5;
  const float inv_qmax = __fdiv_rn(1.f, static_cast<float>((1 << (kBits - 1)) - 1));
  // the loop bounds depend on the warp only, so whole warps run each pair
  for (uint32_t p = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; p < pairs; p += nwarps) {
    int live;
    const int64_t start = group_start(p, cols, groups, live);
    float v[4];
    load_values<kVec, 4>(x + start + 4 * l, live - 4 * l, v);
    float amax = zero_nonfinite_absmax(v);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, off));
    }
    const float scale = __fmul_rn(amax, inv_qmax);
    uint32_t w[1];
    pack_codes<kBits, 4>(v, scale > 0.f ? scale : 1.f, w);
    uint32_t* dst = words + static_cast<int64_t>(p) * kWordsPerGroup;
    if constexpr (kBits == 8) {
      dst[l] = w[0];
    } else {
      reinterpret_cast<uint16_t*>(dst)[l] = static_cast<uint16_t>(w[0]);
    }
    if (l == 0) scales[p] = scale;
  }
}

// ------------------------------------------------------------- narrow
// cols <= 32: one partial group a row, on 8 lanes. Lane j computes the
// codes of values 4j..4j+3: word j at int8, half of word j/2 at int4. The
// row's words are kWords / 4 pieces of 16 bytes; lane j stores piece j,
// words 4j..4j+3, gathered by shuffles (only the first 8 words can hold
// values), the zero padding included.
template <int kBits>
__global__ void __launch_bounds__(kMaxEncodeThreads)
encode_narrow(const float* __restrict__ x, uint32_t rows, int cols,
              uint32_t* __restrict__ words, float* __restrict__ scales) {
  constexpr int kLanes = 8;                   // lanes a row
  constexpr int kWords = kTile * kBits / 32;  // a row's words: 32 or 16
  constexpr int kStride = 32 / (4 * kBits);   // word i's codes start on lane kStride * i
  constexpr uint32_t kRowsPerWarp = 32 / kLanes;
  const int lane = threadIdx.x & 31;
  const int j = lane % kLanes;
  const int c0 = 4 * j;
  const float inv_qmax = __fdiv_rn(1.f, static_cast<float>((1 << (kBits - 1)) - 1));
  const uint32_t stride = ((gridDim.x * blockDim.x) >> 5) * kRowsPerWarp;
  for (uint32_t base = ((blockIdx.x * blockDim.x + threadIdx.x) >> 5) * kRowsPerWarp;
       base < rows; base += stride) {  // warp-uniform bounds
    const uint32_t row = base + lane / kLanes;
    const bool live = row < rows;
    const float* xr = x + static_cast<int64_t>(row) * cols + c0;
    float v[4];
    load_values<false, 4>(xr, live ? cols - c0 : 0, v);
    float amax = zero_nonfinite_absmax(v);
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, off));
    }
    const float scale = __fmul_rn(amax, inv_qmax);
    uint32_t w[1];
    pack_codes<kBits, 4>(v, scale > 0.f ? scale : 1.f, w);
    uint32_t word = w[0];  // complete on the lanes where a word starts
    if constexpr (kBits == 4) word |= __shfl_xor_sync(kFull, w[0], 1) << 16;
    uint32_t out[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int src = kStride * (4 * j + k);
      const uint32_t got = __shfl_sync(kFull, word, src % kLanes, kLanes);
      out[k] = src < kLanes ? got : 0u;
    }
    if (live && j < kWords / 4) {
      reinterpret_cast<uint4*>(words + static_cast<int64_t>(row) * kWords)[j] =
          make_uint4(out[0], out[1], out[2], out[3]);
    }
    if (live && j == 0) scales[row] = scale;
  }
}

template <int kBits>
void launch_encode(const float* x, int rows, int cols, int layout, int threads, int blocks,
                   uint32_t* words, float* scales, cudaStream_t stream) {
  const int groups = (cols + kTile - 1) / kTile;
  const uint32_t pairs = static_cast<uint32_t>(rows) * static_cast<uint32_t>(groups);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (layout == kNarrow) {
    encode_narrow<kBits><<<grid, threads, 0, stream>>>(x, static_cast<uint32_t>(rows), cols,
                                                       words, scales);
  } else if (layout == kWide) {
    encode_wide<kBits, true><<<grid, threads, 0, stream>>>(x, cols, groups, pairs, words, scales);
  } else if (layout == kWideScalar) {
    encode_wide<kBits, false><<<grid, threads, 0, stream>>>(x, cols, groups, pairs, words, scales);
  } else if (layout == kQuad) {
    encode_quad<kBits, true><<<grid, threads, 0, stream>>>(x, cols, groups, pairs, words, scales);
  } else {
    encode_quad<kBits, false><<<grid, threads, 0, stream>>>(x, cols, groups, pairs, words, scales);
  }
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
// words: (rows, ceil(cols/128)*128*bits/32) uint32, 16-byte aligned;
// scales: (rows, ceil(cols/128)) float32. layout: 0 wide, 1 wide_scalar,
// 2 quad, 3 quad_scalar, 4 narrow (cols <= 32); threads: a multiple of 32
// up to 256; blocks: 1..65535. Refuses (cudaErrorInvalidValue) a layout the
// data does not allow: wide and quad need cols % 4 == 0 and x 16-byte
// aligned. Returns cudaGetLastError().
extern "C" int repro_encode(const void* x, int rows, int cols, int bits, void* words,
                            void* scales, int layout, int threads, int blocks, void* stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaSuccess);
  const int64_t pairs = static_cast<int64_t>(rows) * ((cols + kTile - 1) / kTile);
  const bool vec = cols % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool ok = (bits == 8 || bits == 4) && pairs < (int64_t{1} << 31) &&
                  threads >= 32 && threads <= kMaxEncodeThreads && threads % 32 == 0 &&
                  blocks >= 1 && blocks <= kMaxEncodeBlocks &&
                  reinterpret_cast<uintptr_t>(words) % 16 == 0 &&
                  ((layout == kNarrow && cols <= kNarrowCols) ||
                   ((layout == kWide || layout == kQuad) && vec) || layout == kWideScalar ||
                   layout == kQuadScalar);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  auto* w = static_cast<uint32_t*>(words);
  auto* sc = static_cast<float*>(scales);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 8) {
    launch_encode<8>(xf, rows, cols, layout, threads, blocks, w, sc, st);
  } else {
    launch_encode<4>(xf, rows, cols, layout, threads, blocks, w, sc, st);
  }
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
