// K2: fused Temperature-Scaling statistics, one pass over (rows, vocab).
//
// Replaces: src/repro/kernels/calib_nll.py::calib_nll_kernel (Pallas TPU,
// body _kernel), reached through repro/kernels/ops.py::calib_stats and
// ops.py::fit_temperature_kernel.
//
// Computes per row, for u = z / T, m = max u and p = softmax(u):
//   e1 = E_p[z] = W1 / S,  e2 = E_p[z^2] = W2 / S,  z_y,
//   nll = log S + m - z_y / T
// with S = sum e^{u - m}, W1 = sum z e^{u - m}, W2 = sum z^2 e^{u - m} on
// the RAW logits z, read as float32 or natively as bfloat16. One Newton
// step of the temperature fit needs only the row means of these, which the
// wrapper takes in torch. T is read from device memory, so a Newton loop
// on the card never waits on the host.
//
// Bound on H100: bytes in float32, where each logit is read once (4 B) and
// costs about 9 instructions, a fraction of what the warp schedulers can
// dispatch at 3.35 TB/s (about 40 per logit at 1.98 GHz on 132 SMs). In
// bfloat16 (2 B a logit) that budget halves to about 20 and the
// instruction count per logit is what to watch, as it was for K1
// (exit_gate.cu). At the
// (2000,10) calibration shape the input is 80 KB and the launch is the
// cost.
//
// Design: K1's layouts, vector loads and merges (row_scan.cuh) with K2's
// carry (m, S, W1, W2):
//   vocab <= 32     a group of G lanes per row (G the next power of two),
//                   one element per lane: a shuffle max, one exponential,
//                   shuffle sums of S, W1 and W2, and one shuffle that
//                   brings z_y to the group's first lane. No carry chain.
//   33 ... 1024     one warp per row;
//   above           one 512-thread block per row, kUnroll 16-byte loads
//                   in flight per thread, a block merge in shared memory.
// No divide per element. For T > 0, x -> fl(x / T) is monotone, so
// max_j fl(z_j / T) = fl(max_j z_j / T): the carry keeps the raw maximum
// zm, each term is 2^((z - zm) c) with c = log2(e) / T formed once per
// thread (a subtract, a multiply and one ex2.approx), and m = zm / T is one
// IEEE divide per row at the end, so nll uses the plain version's m. The
// FMA form z c - zm c would save the subtract but leaves the max term at
// 2^(zm c - fl(zm c)), off 1 by up to 2^-25 |zm c|: 3e-5 on the nll of a
// row with zm / T = 1000, more than the 1e-6 tolerance of a row whose nll
// is near 0. (z - zm) c is exact at the max, and the error it leaves grows
// with z - zm, where the terms are small; so no Divider is needed. The
// rescale on a new maximum and the merges use the same form. T <= 0 (or
// NaN), which the fit never passes but the API allows, takes the IEEE `/`
// for u = z / T and the same exponent form over u, in a branch on the one
// T that all threads take alike.
// Per 16-byte vector a thread takes the vector's max first, so the carry
// rescales at most once per vector, then sums the vector's terms into
// partial sums of its own that join the carry once (3 adds per vector in
// the carry's chain, not 3 per element). z_y is read by the one thread
// that finishes the row (from the lane whose column is y in the lane-group
// layout), so it is the input value exactly; a label outside [0, vocab)
// gives 0.
#include "row_scan.cuh"

namespace {

using namespace rowscan;

constexpr float kLog2e = 1.44269504088896340736f;

// 2^x in one MUFU.EX2 (relative error about 2^-22; flushes results below
// 2^-126 to 0, terms that cannot move S >= 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct NllCarry {
  float m;   // running max of the key (z for T > 0, u = z / T otherwise)
  float s;   // sum 2^{(k - m) c}; 0 marks an empty carry
  float w1;  // sum z 2^{(k - m) c}
  float w2;  // sum z^2 2^{(k - m) c}

  static __device__ __forceinline__ NllCarry empty() { return NllCarry{-INFINITY, 0.f, 0.f, 0.f}; }
  __device__ __forceinline__ NllCarry shfl_xor(int off) const {
    return NllCarry{__shfl_xor_sync(kFull, m, off), __shfl_xor_sync(kFull, s, off),
                    __shfl_xor_sync(kFull, w1, off), __shfl_xor_sync(kFull, w2, off)};
  }
};

// kDivide = false (T > 0): key k = z, c = log2(e) / T;
// kDivide = true  (T <= 0 or NaN): key k = z / T (IEEE), c = log2(e).
// Either way 2^{(k - m) c} = e^{u - max u}.
template <bool kDivide>
struct NllFold {
  float t, c;
  NllCarry a;

  __device__ explicit NllFold(float temp)
      : t(temp), c(kDivide ? kLog2e : kLog2e / temp), a(NllCarry::empty()) {}
  __device__ __forceinline__ float key(float z) const { return kDivide ? z / t : z; }
  // m = max u of the plain version, from the max key
  __device__ __forceinline__ float max_u(float m) const { return kDivide ? m : m / t; }

  __device__ __forceinline__ void rescale(float m) {
    const float f = ex2((a.m - m) * c);  // 0 while the carry is empty
    a.s *= f;
    a.w1 *= f;
    a.w2 *= f;
    a.m = m;
  }
  __device__ __forceinline__ void scalar(float z, int) {
    const float k = key(z);
    if (k > a.m) rescale(k);
    const float e = ex2((k - a.m) * c);
    const float ze = z * e;
    a.s += e;
    a.w1 += ze;
    a.w2 = fmaf(ze, z, a.w2);
  }
  template <int kV>
  __device__ __forceinline__ void vector(float (&z)[kV], int) {
    float k[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) k[j] = key(z[j]);
    float vm = k[0];
#pragma unroll
    for (int j = 1; j < kV; ++j) vm = fmaxf(vm, k[j]);
    if (vm > a.m) rescale(vm);  // the max moves (rare after a thread's first vectors)
    float s = 0.f, w1 = 0.f, w2 = 0.f;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const float e = ex2((k[j] - a.m) * c);
      const float ze = z[j] * e;
      s += e;
      w1 += ze;
      w2 = fmaf(ze, z[j], w2);
    }
    a.s += s;
    a.w1 += w1;
    a.w2 += w2;
  }
  __device__ __forceinline__ NllCarry merge(const NllCarry& x, const NllCarry& y) const {
    if (y.s == 0.f) return x;
    if (x.s == 0.f) return y;
    const float m = fmaxf(x.m, y.m);
    const float fx = ex2((x.m - m) * c), fy = ex2((y.m - m) * c);
    return NllCarry{m, x.s * fx + y.s * fy, x.w1 * fx + y.w1 * fy, x.w2 * fx + y.w2 * fy};
  }
};

struct NllOut {
  float *e1, *e2, *zy, *nll;
};

template <bool kDivide>
__device__ __forceinline__ void finish(const NllFold<kDivide>& f, const NllCarry& a, float zy,
                                       int64_t row, const NllOut& out) {
  out.e1[row] = a.w1 / a.s;
  out.e2[row] = a.w2 / a.s;
  out.zy[row] = zy;
  out.nll[row] = logf(a.s) + f.max_u(a.m) - zy / f.t;
}

template <typename T>
__device__ __forceinline__ float label_logit(const T* __restrict__ zr, int y, int vocab) {
  return (y >= 0 && y < vocab) ? to_f32(zr[y]) : 0.f;
}

// vocab <= 32: 2^lg lanes per row, one element per lane (x; 0 on a dead
// lane), y the row's label
template <bool kDivide>
__device__ __forceinline__ void group_row(float x, bool live, int y, float t, int64_t row,
                                          bool first, int vocab, int lg, const NllOut& out) {
  const NllFold<kDivide> f(t);
  // every lane stays for the shuffles; dead lanes carry -inf and add 0
  const float k = live ? f.key(x) : -INFINITY;
  const float zy = __shfl_sync(kFull, x, y & ((1 << lg) - 1), 1 << lg);  // lane y's logit
  const float m = group_max(k, lg);
  const float e = live ? ex2((k - m) * f.c) : 0.f;
  const float ze = x * e;
  NllCarry a{m, e, ze, ze * x};
  group_rounds(lg, [&](int off) {
    a.s += __shfl_xor_sync(kFull, a.s, off);
    a.w1 += __shfl_xor_sync(kFull, a.w1, off);
    a.w2 += __shfl_xor_sync(kFull, a.w2, off);
  });
  if (first) finish(f, a, (y >= 0 && y < vocab) ? zy : 0.f, row, out);
}

// 33 <= vocab <= 1024: one warp per row
template <typename T, bool kDivide>
__device__ __forceinline__ void warp_row(const T* __restrict__ zr, float zy, float t, int vocab,
                                         int64_t row, const NllOut& out) {
  const int lane = threadIdx.x & 31;
  NllFold<kDivide> f(t);
  scan_row<T, 32>(zr, vocab, lane, f);
  const NllCarry a = warp_merge(f.a, f);
  if (lane == 0) finish(f, a, zy, row, out);
}

// vocab > 1024: one block per row
template <typename T, bool kDivide>
__device__ __forceinline__ void block_row(const T* __restrict__ zr, float zy, float t, int vocab,
                                          int64_t row, const NllOut& out) {
  NllFold<kDivide> f(t);
  scan_row<T, kRowThreads>(zr, vocab, threadIdx.x, f);
  NllCarry a = f.a;
  if (block_merge<kRowThreads>(a, f)) finish(f, a, zy, row, out);
}

// Each kernel loads its label logit and T first, then takes one branch on
// T for all its threads.
template <typename T>
__global__ void __launch_bounds__(kBlock)
nll_group_kernel(const T* __restrict__ z, const int* __restrict__ labels,
                 const float* __restrict__ temp, int rows, int vocab, int lg, NllOut out) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const int64_t row = tid >> lg;
  const int col = static_cast<int>(tid & ((1 << lg) - 1));
  const bool live = row < rows && col < vocab;
  // the logit, the label and T are all loaded before anything waits on one
  const float x = live ? to_f32(z[row * vocab + col]) : 0.f;
  const int y = row < rows ? labels[row] : 0;
  const float t = *temp;
  const bool first = col == 0 && row < rows;
  if (t > 0.f) {
    group_row<false>(x, live, y, t, row, first, vocab, lg, out);
  } else {
    group_row<true>(x, live, y, t, row, first, vocab, lg, out);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
nll_warp_kernel(const T* __restrict__ z, const int* __restrict__ labels,
                const float* __restrict__ temp, int rows, int vocab, NllOut out) {
  const int row = blockIdx.x * (kBlock / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const T* zr = z + static_cast<int64_t>(row) * vocab;
  const float zy = (threadIdx.x & 31) == 0 ? label_logit(zr, labels[row], vocab) : 0.f;
  const float t = *temp;
  if (t > 0.f) {
    warp_row<T, false>(zr, zy, t, vocab, row, out);
  } else {
    warp_row<T, true>(zr, zy, t, vocab, row, out);
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
nll_block_kernel(const T* __restrict__ z, const int* __restrict__ labels,
                 const float* __restrict__ temp, int vocab, NllOut out) {
  const int row = blockIdx.x;
  const T* zr = z + static_cast<int64_t>(row) * vocab;
  const float zy = threadIdx.x == 0 ? label_logit(zr, labels[row], vocab) : 0.f;
  const float t = *temp;
  if (t > 0.f) {
    block_row<T, false>(zr, zy, t, vocab, row, out);
  } else {
    block_row<T, true>(zr, zy, t, vocab, row, out);
  }
}

template <typename T>
void launch_nll(const T* z, const int* labels, const float* temp, int rows, int vocab,
                const NllOut& out, cudaStream_t s) {
  if (vocab <= kSmallVocab) {
    const int lg = group_lg(vocab);
    nll_group_kernel<T><<<group_grid(rows, lg), kBlock, 0, s>>>(z, labels, temp, rows, vocab,
                                                                lg, out);
  } else if (vocab <= kWarpVocab) {
    nll_warp_kernel<T><<<warp_grid(rows), kBlock, 0, s>>>(z, labels, temp, rows, vocab, out);
  } else {
    nll_block_kernel<T><<<rows, kRowThreads, 0, s>>>(z, labels, temp, vocab, out);
  }
}

}  // namespace

// z: (rows, vocab) contiguous float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1);
// labels: (rows,) int32; temp: one float32 on the device; e1, e2, zy, nll:
// (rows,) float32. Returns cudaGetLastError().
extern "C" int repro_calib_nll(const void* z, int is_bf16, const void* labels, const void* temp,
                               int rows, int vocab, void* e1, void* e2, void* zy, void* nll,
                               void* stream) {
  if (rows <= 0 || vocab <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const NllOut out{static_cast<float*>(e1), static_cast<float*>(e2), static_cast<float*>(zy),
                   static_cast<float*>(nll)};
  const auto* y = static_cast<const int*>(labels);
  const auto* t = static_cast<const float*>(temp);
  if (is_bf16) {
    launch_nll(static_cast<const __nv_bfloat16*>(z), y, t, rows, vocab, out, s);
  } else {
    launch_nll(static_cast<const float*>(z), y, t, rows, vocab, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}
