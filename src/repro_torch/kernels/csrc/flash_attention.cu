// Causal / sliding-window online-softmax attention with GQA for Hopper
// (sm_90a).
//
//   flash_attention  replaces repro/kernels/flash_attention.py::_fa_kernel
//                    (wrapper flash_attention, pallas_call at :85)
//
// q (BH, Sq, D), k and v (BKV, Skv, D), float32 or bfloat16, D in
// {16, 32, 64, 128}; row bh attends KV row bh / (BH / BKV). One CTA of 256
// threads per (bh, block of 64 query rows): the TPU grid's sequential kv axis
// is a loop inside the CTA, over 64-key tiles of K and V staged in shared
// memory as float32. Thread (r, c) (r = tid / 16, c = tid % 16) holds the
// query rows 4r .. 4r + 3 and the running (m, l, acc) of those rows for the
// output columns c + 16 j, in registers; a row's 16 threads sit in one warp,
// so the row max and sum are warp shuffles and the probabilities P pass
// through shared memory with a __syncwarp only. Shared rows are padded to an
// odd stride, so the products read without bank conflicts.
//
// Arithmetic as the TPU kernel's: bf16 operands upcast to float32, scores
// (q . k) * scale with scale = 1/sqrt(D) after the product, masked scores
// -1e30, m_new = max(m, rowmax), p = exp(s - m_new), corr = exp(m - m_new),
// l = l * corr + sum(p), acc = acc * corr + p v, out = acc / max(l, 1e-30),
// with fused multiply-adds in float32 (FFMA) in place of the MXU.
//
// Blocks outside the causal band or the window are skipped: such a block
// before a row's first valid key only adds terms that corr = exp(-1e30 - m)
// = 0 wipes when the first valid key arrives, and one after it adds p = 0
// with corr = 1, so skipping gives what visiting gives. Any length: keys at
// or beyond Skv score -inf (p = 0 exactly, whatever the running max), query
// rows beyond Sq are computed and not stored. Causal calls need Sq == Skv,
// so every query row has a valid key (itself).
//
// What bounds it on this card: at hymba-1.5b's prefill (q and out
// (B * 25, 2048, 64), k and v (B * 5, 2048, 64), bf16, window 1024) a call
// at B = 4 moves 63 MB (0.019 ms at 3.35 TB/s) and needs 4 * 64 flops for
// each of the 1,573,376 (query, valid key) pairs of a head: 40 GFLOP, 0.041
// ms at the 989 TFLOP/s of the bf16 tensor cores, so operations bound it.
// This kernel does them in float32 FFMA from shared memory, outside the
// tensor cores, so it runs far from that bound; wgmma tiles, TMA loads and a
// pipelined K/V ring are the later work that closes the gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;
constexpr int LDP = BK + 1;     // row stride of the P tile
constexpr float NEG_INF = -1e30f;
constexpr int MAX_SMEM = 232448;   // one block's shared memory on H100

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + 1) + (size_t)BQ * LDP);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int group, int Sq,
          int Skv, int n_qb, int causal, int window, float scale) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;            // BQ x LD
  float* ks = qs + BQ * LD;    // BK x LD
  float* vs = ks + BK * LD;    // BK x LD
  float* ps = vs + BK * LD;    // BQ x LDP

  const int bh = blockIdx.x / n_qb;
  const int q0 = (blockIdx.x % n_qb) * BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 4, c = tid & 15;
  const T* qg = q + (size_t)bh * Sq * D;
  const T* kg = k + (size_t)(bh / group) * Skv * D;
  const T* vg = v + (size_t)(bh / group) * Skv * D;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int row = idx / D, col = idx % D;
    qs[row * LD + col] =
        q0 + row < Sq ? to_f(qg[(size_t)(q0 + row) * D + col]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  // the keys any row of this block may attend: [k_lo, k_hi)
  int k_lo = 0, k_hi = Skv;
  if (causal) {
    k_hi = min(Skv, min(q0 + BQ, Sq));
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }
  const int t_end = (k_hi + BK - 1) / BK;

  for (int t = k_lo / BK; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // the previous tile's K, V and P are used up
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int row = idx / D, col = idx % D;
      const bool in = k0 + row < Skv;
      const size_t off = (size_t)(k0 + row) * D + col;
      ks[row * LD + col] = in ? to_f(kg[off]) : 0.f;
      vs[row * LD + col] = in ? to_f(vg[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * r + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(c + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * r + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + c + 16 * j;
        float x = s[i][j] * scale;
        if (kpos >= Skv)
          x = -INFINITY;
        else if (causal &&
                 (kpos > qpos || (window > 0 && kpos <= qpos - window)))
          x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(4 * r + i) * LDP + c + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= corr;
    }
    __syncwarp();   // a row's P is written and read by its own 16 lanes

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * r + i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = vs[kk * LD + c + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* og = out + (size_t)bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + 4 * r + i;
    if (qr >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j)
      og[(size_t)qr * D + c + 16 * j] = from_f<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int BKV, int Sq, int Skv, int causal, int window,
           cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = smem_bytes(D);
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        fa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int n_qb = (Sq + BQ - 1) / BQ;
  // rounded once from double, as the TPU wrapper's 1.0 / math.sqrt(d)
  const float scale = (float)(1.0 / sqrt((double)D));
  fa_kernel<T, D><<<(unsigned)BH * n_qb, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), BH / BKV, Sq, Skv, n_qb,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, int BH,
               int BKV, int Sq, int Skv, int D, int causal, int window,
               cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, BH, BKV, Sq, Skv, causal, window, s);
    case 32: return launch<T, 32>(q, k, v, out, BH, BKV, Sq, Skv, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, out, BH, BKV, Sq, Skv, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, out, BH, BKV, Sq, Skv, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. Returns a cudaError_t (0 on success).
int launch_flash_attention(const void* q, const void* k, const void* v,
                           void* out, int BH, int BKV, int Sq, int Skv, int D,
                           int causal, int window, int dtype, void* stream) {
  if (BH < 1 || BKV < 1 || BH % BKV || Sq < 1 || Skv < 1 || window < 0 ||
      (causal && Sq != Skv) || smem_bytes(D) > (size_t)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  if ((long long)BH * ((Sq + BQ - 1) / BQ) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, out, BH, BKV, Sq, Skv, D, causal,
                             window, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, BH, BKV, Sq, Skv, D,
                                     causal, window, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
