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
// the RAW logits z. One Newton step of the temperature fit needs only the
// row means of these, which the wrapper takes in torch.
//
// Bound on H100: bytes. Each logit is read once (4 B) for ~12 flops and
// one expf, so the roofline is rows * vocab * 4 B over the memory rate;
// the (rows,) outputs and labels are noise beside it.
//
// Design: the skeleton of K1 (exit_gate.cu): one warp per row, each lane
// striding over the vocab with an online carry (m, S, W1, W2) in
// registers, then an xor-shuffle merge. z_y is picked where col == label
// and summed across lanes (exactly one lane holds it). The ragged edge is
// masked by the loop bound instead of padding, so z^2 can never meet a
// -1e30 pad value. T is read from device memory so that a Newton loop on
// the card never waits on the host.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

struct NllCarry {
  float m;   // running max of u = z / T
  float s;   // sum e^{u - m}; 0 marks an empty carry
  float w1;  // sum z e^{u - m}
  float w2;  // sum z^2 e^{u - m}
  float zy;  // label logit (0 on lanes that never saw the label column)
};

__device__ __forceinline__ void push(NllCarry& c, float z, float u) {
  if (u > c.m) {
    const float a = expf(c.m - u);  // 0 on a lane's first element
    c.s = a * c.s + 1.f;
    c.w1 = a * c.w1 + z;
    c.w2 = a * c.w2 + z * z;
    c.m = u;
  } else {
    const float b = expf(u - c.m);
    c.s += b;
    c.w1 += z * b;
    c.w2 += z * z * b;
  }
}

__device__ __forceinline__ NllCarry merge(const NllCarry& a, const NllCarry& b) {
  NllCarry r;
  if (b.s == 0.f) {
    r = a;
  } else if (a.s == 0.f) {
    r = b;
  } else {
    r.m = fmaxf(a.m, b.m);
    const float ea = expf(a.m - r.m), eb = expf(b.m - r.m);
    r.s = a.s * ea + b.s * eb;
    r.w1 = a.w1 * ea + b.w1 * eb;
    r.w2 = a.w2 * ea + b.w2 * eb;
  }
  r.zy = a.zy + b.zy;
  return r;
}

__global__ void calib_nll_kernel(const float* __restrict__ z, const int* __restrict__ labels,
                                 const float* __restrict__ temp, int rows, int vocab,
                                 float* __restrict__ e1, float* __restrict__ e2,
                                 float* __restrict__ zy, float* __restrict__ nll) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const float t = *temp;
  const int y = labels[row];
  const float* zr = z + static_cast<int64_t>(row) * vocab;

  NllCarry c{-INFINITY, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int col = lane; col < vocab; col += 32) {
    const float v = zr[col];
    c.zy = (col == y) ? v : c.zy;
    push(c, v, v / t);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    NllCarry o;
    o.m = __shfl_xor_sync(kFull, c.m, off);
    o.s = __shfl_xor_sync(kFull, c.s, off);
    o.w1 = __shfl_xor_sync(kFull, c.w1, off);
    o.w2 = __shfl_xor_sync(kFull, c.w2, off);
    o.zy = __shfl_xor_sync(kFull, c.zy, off);
    c = merge(c, o);
  }
  if (lane == 0) {
    e1[row] = c.w1 / c.s;
    e2[row] = c.w2 / c.s;
    zy[row] = c.zy;
    nll[row] = logf(c.s) + c.m - c.zy / t;
  }
}

}  // namespace

// z: (rows, vocab) contiguous float32; labels: (rows,) int32; temp: one
// float32 on the device; e1, e2, zy, nll: (rows,) float32.
// Returns cudaGetLastError().
extern "C" int repro_calib_nll(const void* z, const void* labels, const void* temp, int rows,
                               int vocab, void* e1, void* e2, void* zy, void* nll,
                               void* stream) {
  if (rows <= 0 || vocab <= 0) return static_cast<int>(cudaSuccess);
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  calib_nll_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const int*>(labels),
      static_cast<const float*>(temp), rows, vocab, static_cast<float*>(e1),
      static_cast<float*>(e2), static_cast<float*>(zy), static_cast<float*>(nll));
  return static_cast<int>(cudaGetLastError());
}
