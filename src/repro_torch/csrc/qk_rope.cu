// K5: qk-norm and RoPE of q and k in one pass, as the attention layers of
// Qwen3 (and, without the norm, of every model with RoPE) apply them at
// inference.
//
// Replaces: no Pallas kernel. The reference leaves qk-norm and RoPE to XLA
// (src/repro/models/layers.py::rms_norm_headwise, rope_freqs, apply_rope,
// called from repro/models/attention.py::_project_qkv). The port's plain
// chain of the same functions (src/repro_torch/models/layers.py) is 44
// launches an attention layer on bf16 q and k, one of them a host-to-device
// copy of theta that made the host wait for the card in every layer; K5 is
// one launch, with no copy and no tables.
//
// Per token t, head h and element i < hd of q (b, s, qh, hd) and of k
// (b, s, kvh, hd), the plain chain's operations in its order, each rounded
// where it rounds:
//   qk-norm (when scales are given):
//     xf = float(x);  ms = mean(xf^2);  r = rsqrtf(ms + eps)
//     y = (xf * r) * scale[i], rounded to x's dtype and back
//   RoPE at p = float(positions[b, s]), for i < hd/2:
//     inv = 1 / powf(theta, 2i * (1/hd));  a = p * inv;  c = cosf(a), s = sinf(a)
//     out[i]        = y[i] c - y[i + hd/2] s
//     out[i + hd/2] = y[i + hd/2] c + y[i] s
//   rounded to x's dtype.
// Every product and sum is a separately rounded __fmul_rn / __fadd_rn /
// __fsub_rn, so nvcc contracts nothing into an FMA that the chain does not
// have; cosf, sinf, powf and rsqrtf are the library's (no fast math). The
// sum of squares is a lane's elements, then an xor butterfly: at hd = 128
// that is torch.mean's own order on the card (below); at another head_dim
// the order differs, which moves ms by an ulp at times and an output by
// about an ulp of its dtype.
//
// Bound on H100: bytes. Each element of q and k is read once and written
// once (4 B in bf16, 8 B in float32) for about 15 float operations; the
// angles are hd/2 powf, cosf and sinf a token, shared by all its heads. At
// Qwen3-8B's 32 + 8 heads of 128 and 4096 tokens that is 84 MB, 25 us at
// 3.35 TB/s. Written plainly (a warp a head, a lane 4 consecutive elements,
// the sum a five-step butterfly and each RoPE partner a shuffle 16 lanes
// away) it took 58 us there: 9 shuffles a lane a head, 55 registers and 3
// blocks an SM, and the loads waited for the angles' barrier. So:
//   - a half-warp takes a head: lane l of the half holds elements
//     lV .. lV+V-1 and their partners hd/2 + lV .. (V = hd/32, two 8-byte
//     vectors at hd = 128 in bf16), so RoPE needs no shuffle and the sum of
//     squares four (xor 8, 4, 2, 1). Adding the lane's two partial sums
//     first keeps the plain version's order at hd = 128 (the element
//     pairs of torch's reduction), so its results are bit for bit the
//     chain's at the benchmark's shapes;
//   - a warp's first head pair is loaded before the block computes the
//     angles and the scales go to shared memory, so the loads are in flight
//     across the barrier;
//   - a block has at most kMaxWarps warps (more head pairs loop, the loop
//     split evenly) and three of them fit an SM (__launch_bounds__ caps
//     the registers at 42).
// That gave 38-39 us (64-65% of the bound) at the edge's 4096 tokens and 20
// us (62%) at the cloud's 2048 on an H100 80GB HBM3 at 700 W; the plain
// chain takes 776 us there.
//
// Design: one block a token. Its first hd/2 threads compute the token's
// angles into shared memory; after one barrier each lane keeps the cos and
// sin of its own element indices in registers for every head it takes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 16;  // warps a block; more head pairs loop
constexpr int kMinBlocks = 3;  // blocks an SM holds at once

struct Args {
  const void* q;
  const void* k;
  void* q_out;
  void* k_out;
  const float* q_scale;  // null: RoPE only
  const float* k_scale;
  const void* pos;
  int pos_is_64;
  int pos_stride_b;
  int pos_stride_s;
  int s;
  int qh;
  int kvh;
  float theta;
  float eps;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V consecutive elements, loaded and stored as one vector
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks) qk_rope_kernel(const Args a) {
  constexpr int kHalf = 16 * V;  // hd / 2
  constexpr int kHd = 32 * V;
  constexpr float kInvHd = 1.f / kHd;  // exact: hd is a power of two
  __shared__ float cos_s[kHalf], sin_s[kHalf];
  __shared__ float scale_s[2 * kHd];  // q's, then k's
  const int64_t token = blockIdx.x;
  const int lane = threadIdx.x & 31, l = lane & 15, half = lane >> 4;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int nh = a.qh + a.kvh, pairs = (nh + 1) >> 1;
  // this lane's first element in head 0 of the token, in q and in k
  const T* q = static_cast<const T*>(a.q) + token * a.qh * kHd + l * V;
  const T* k = static_cast<const T*>(a.k) + token * a.kvh * kHd + l * V;
  T* q_out = static_cast<T*>(a.q_out) + token * a.qh * kHd + l * V;
  T* k_out = static_cast<T*>(a.k_out) + token * a.kvh * kHd + l * V;

  // the warp's first head pair, in flight across the barrier
  Pack<T, V> lo, hi;
  if (warp < pairs && 2 * warp + half < nh) {
    const int h = 2 * warp + half;
    const T* src = h < a.qh ? q + h * kHd : k + (h - a.qh) * kHd;
    lo = load<T, V>(src);
    hi = load<T, V>(src + kHalf);
  }
  for (int i = threadIdx.x; i < kHalf; i += blockDim.x) {
    const int64_t bi = token / a.s, si = token - bi * a.s;
    const int64_t at = bi * a.pos_stride_b + si * a.pos_stride_s;
    const float p = a.pos_is_64
                        ? static_cast<float>(static_cast<const long long*>(a.pos)[at])
                        : static_cast<float>(static_cast<const int*>(a.pos)[at]);
    const float e = __fmul_rn(static_cast<float>(2 * i), kInvHd);
    const float inv = __fdiv_rn(1.f, powf(a.theta, e));
    const float ang = __fmul_rn(p, inv);
    cos_s[i] = cosf(ang);
    sin_s[i] = sinf(ang);
  }
  const bool norm = a.q_scale != nullptr;
  if (norm) {
    for (int i = threadIdx.x; i < 2 * kHd; i += blockDim.x) {
      scale_s[i] = i < kHd ? a.q_scale[i] : a.k_scale[i - kHd];
    }
  }
  __syncthreads();
  float c[V], sn[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    c[j] = cos_s[l * V + j];
    sn[j] = sin_s[l * V + j];
  }

  for (int pair = warp; pair < pairs; pair += warps) {
    const int h = 2 * pair + half;
    const bool live = h < nh;  // a last, odd head leaves the upper half idle
    const bool isq = h < a.qh;
    if (pair != warp && live) {
      const T* src = isq ? q + h * kHd : k + (h - a.qh) * kHd;
      lo = load<T, V>(src);
      hi = load<T, V>(src + kHalf);
    }
    float x0[V], x1[V];  // elements lV + j and hd/2 + lV + j
#pragma unroll
    for (int j = 0; j < V; ++j) {
      x0[j] = live ? to_f32(lo.v[j]) : 0.f;
      x1[j] = live ? to_f32(hi.v[j]) : 0.f;
    }
    if (norm) {  // every lane of the warp takes part in the shuffles
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s0 = __fadd_rn(s0, __fmul_rn(x0[j], x0[j]));
        s1 = __fadd_rn(s1, __fmul_rn(x1[j], x1[j]));
      }
      float ss = __fadd_rn(s0, s1);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        ss = __fadd_rn(ss, __shfl_xor_sync(kFull, ss, off));
      }
      const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, kInvHd), a.eps));
      const float* sc = scale_s + (isq ? 0 : kHd) + l * V;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        x0[j] = to_f32(from_f32<T>(__fmul_rn(__fmul_rn(x0[j], r), sc[j])));
        x1[j] = to_f32(from_f32<T>(__fmul_rn(__fmul_rn(x1[j], r), sc[kHalf + j])));
      }
    }
    if (live) {
      Pack<T, V> o0, o1;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        o0.v[j] = from_f32<T>(__fsub_rn(__fmul_rn(x0[j], c[j]), __fmul_rn(x1[j], sn[j])));
        o1.v[j] = from_f32<T>(__fadd_rn(__fmul_rn(x1[j], c[j]), __fmul_rn(x0[j], sn[j])));
      }
      T* dst = isq ? q_out + h * kHd : k_out + (h - a.qh) * kHd;
      *reinterpret_cast<Pack<T, V>*>(dst) = o0;
      *reinterpret_cast<Pack<T, V>*>(dst + kHalf) = o1;
    }
  }
}

template <typename T>
cudaError_t launch(const Args& a, int tokens, int hd, cudaStream_t stream) {
  // as few warps as take every head pair in the fewest rounds
  const int pairs = (a.qh + a.kvh + 1) / 2;
  const int rounds = (pairs + kMaxWarps - 1) / kMaxWarps;
  const dim3 grid(tokens), block(32 * ((pairs + rounds - 1) / rounds));
  switch (hd) {
    case 32: qk_rope_kernel<T, 1><<<grid, block, 0, stream>>>(a); break;
    case 64: qk_rope_kernel<T, 2><<<grid, block, 0, stream>>>(a); break;
    case 128: qk_rope_kernel<T, 4><<<grid, block, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

// q (b, s, qh, hd), k (b, s, kvh, hd): contiguous, float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1), each aligned to its hd/32 elements; q_out, k_out
// the same shapes and dtype. q_scale, k_scale: (hd,) float32, both null for
// RoPE alone. positions: int32 (pos_is_64 = 0) or int64, element (bi, si) at
// bi * pos_stride_b + si * pos_stride_s. hd is 32, 64 or 128. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a head_dim it does not take.
extern "C" int repro_qk_norm_rope(const void* q, const void* k, void* q_out, void* k_out,
                                  const void* q_scale, const void* k_scale,
                                  const void* positions, int pos_is_64, int pos_stride_b,
                                  int pos_stride_s, int b, int s, int qh, int kvh, int hd,
                                  int is_bf16, float theta, float eps, void* stream) {
  if (b <= 0 || s <= 0 || qh + kvh <= 0) return static_cast<int>(cudaSuccess);
  const Args a{q, k, q_out, k_out, static_cast<const float*>(q_scale),
               static_cast<const float*>(k_scale), positions, pos_is_64, pos_stride_b,
               pos_stride_s, s, qh, kvh, theta, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch<__nv_bfloat16>(a, b * s, hd, st)
                                  : launch<float>(a, b * s, hd, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
