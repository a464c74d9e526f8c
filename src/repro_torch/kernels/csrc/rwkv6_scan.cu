// Chunked gated linear attention for Hopper (sm_90a), both modes of one
// kernel template.
//
//   gla_scan mode "k"  replaces repro/kernels/rwkv6_scan.py::_gla_kernel_k
//                      (RWKV6 time mix: decay on K, bonus u on the diagonal)
//   gla_scan mode "v"  replaces repro/kernels/rwkv6_scan.py::_gla_kernel_v
//                      (Mamba2-style SSD: decay on V, inclusive diagonal),
//                      reached through repro/kernels/ssm_scan.py::ssd_pallas
//   (wrapper gla_pallas, pallas_call at rwkv6_scan.py:129)
//
// q, k (BH, S, dk) and v (BH, S, dv) in float32 or bfloat16; the decays w
// (BH, S, dk) in mode k, (BH, S, dv) in mode v, and u (BH, dk), in float32.
// Out (BH, S, dv) in q's type, the final state (BH, dk, dv) in float32; the
// state starts at zero. One CTA of 256 threads per bh: the TPU grid's
// sequential chunk axis is a loop inside the CTA, and the (dk, dv) float32
// state stays in shared memory across chunks (16 KB at 64 x 64). Per chunk
// of C rows, staged in shared memory as float32 with odd row strides (no
// bank conflicts in the products):
//
//   1. the cumulative decays of each column (one thread per column, in
//      order): qs = exp(cumsum(log w)); mode k: r_t = q * (qs / w),
//      k_t = k / qs; mode v: v_t = v / qs;
//   2. A (C x C): mode k r_t k_t^T below the diagonal and sum(q * u * k) on
//      it; mode v q k^T on and below it;
//   3. out = r_t S + A v (mode k), qs * (q S + A v_t) (mode v);
//   4. S = S * qs[-1] + (k_t * qs[-1])^T v (mode k),
//      S = qs[-1] * (S + k^T v_t) (mode v).
//
// That is the TPU kernel's math, bf16 operands upcast to float32, with
// float32 FFMA in place of the MXU's products. Its numerics are kept, not
// fixed: k / qs divides by a product of up to C decays, which underflows to
// 0 in float32 for decays near the model's floor exp(-8), and then the
// result is inf or NaN, as in the reference.
//
// What bounds it on this card: at rwkv6-7b's prefill (B * 64 heads, S 2048,
// dk = dv = 64, C = 64) a call at B = 4 moves 406 MB (0.12 ms at 3.35 TB/s)
// and needs 12.9 GFLOP of float32 products (0.19 ms at 67 TFLOP/s outside
// the tensor cores), so operations bound it; at hymba-1.5b's SSD (B * 25
// heads, dk 16, dv 64) the bytes do (118 MB, 0.035 ms, against 1.9 GFLOP).
// The design keeps the state and every intermediate on chip, so each input
// byte is read once and each output byte written once; its products run on
// CUDA cores from shared memory, and B * heads CTAs (100 for hymba at B = 4)
// underfill the 132 SMs. Tensor-core tiles and a split of the chunk's
// intra-chunk products over several CTAs are the later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
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

size_t smem_floats(int dk, int dv, int C, bool mode_k) {
  const size_t dw = mode_k ? dk : dv;
  return (size_t)C * (2 * (dk + 1) + (dv + 1) + (dw + 1) + (C + 1)) +
         (size_t)dk * dv + dw + C;
}

template <typename T, bool MODE_K>
__global__ void __launch_bounds__(THREADS)
gla_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, T* __restrict__ out,
           float* __restrict__ state_out, int S, int dk, int dv, int C) {
  const int dw = MODE_K ? dk : dv;
  const int ldk = dk + 1, ldv = dv + 1, ldw = dw + 1, ldc = C + 1;
  extern __shared__ float sm[];
  float* qs = sm;                  // C x ldk: q, then r_t in mode k
  float* ks = qs + C * ldk;        // C x ldk: k, then k_t in mode k
  float* vs = ks + C * ldk;        // C x ldv: v, then v_t in mode v
  float* ws = vs + C * ldv;        // C x ldw: w, then its cumulative product
  float* as = ws + C * ldw;        // C x ldc: the intra-chunk matrix A
  float* st = as + C * ldc;        // dk x dv: the state
  float* qc = st + dk * dv;        // dw: the chunk's total decay qs[-1]
  float* dg = qc + dw;             // C: the bonus diagonal (mode k)

  const int bh = blockIdx.x, tid = threadIdx.x;
  q += (size_t)bh * S * dk;
  k += (size_t)bh * S * dk;
  v += (size_t)bh * S * dv;
  w += (size_t)bh * S * dw;
  out += (size_t)bh * S * dv;
  const float* ub = u ? u + (size_t)bh * dk : nullptr;

  for (int idx = tid; idx < dk * dv; idx += THREADS) st[idx] = 0.f;

  for (int c0 = 0; c0 < S; c0 += C) {
    __syncthreads();   // the previous chunk's tiles and state are used up
    for (int idx = tid; idx < C * dk; idx += THREADS) {
      const int i = idx / dk, d = idx % dk;
      qs[i * ldk + d] = to_f(q[(size_t)c0 * dk + idx]);
      ks[i * ldk + d] = to_f(k[(size_t)c0 * dk + idx]);
    }
    for (int idx = tid; idx < C * dv; idx += THREADS)
      vs[(idx / dv) * ldv + idx % dv] = to_f(v[(size_t)c0 * dv + idx]);
    for (int idx = tid; idx < C * dw; idx += THREADS)
      ws[(idx / dw) * ldw + idx % dw] = w[(size_t)c0 * dw + idx];
    __syncthreads();

    if (MODE_K) {
      for (int i = tid; i < C; i += THREADS) {
        float x = 0.f;
        if (ub)
          for (int d = 0; d < dk; ++d)
            x += qs[i * ldk + d] * ub[d] * ks[i * ldk + d];
        dg[i] = x;
      }
      __syncthreads();   // the diagonal reads q and k before step 1
    }

    // 1. cumulative decays, one thread per column, rows in order
    for (int col = tid; col < dw; col += THREADS) {
      float lsum = 0.f, qsv = 1.f;
      for (int i = 0; i < C; ++i) {
        const float wv = ws[i * ldw + col];
        lsum += logf(wv);
        qsv = expf(lsum);
        if (MODE_K) {
          qs[i * ldk + col] *= qsv / wv;
          ks[i * ldk + col] /= qsv;
        } else {
          vs[i * ldv + col] /= qsv;
        }
        ws[i * ldw + col] = qsv;
      }
      qc[col] = qsv;
    }
    __syncthreads();

    // 2. the intra-chunk matrix
    for (int idx = tid; idx < C * C; idx += THREADS) {
      const int i = idx / C, j = idx % C;
      float x = 0.f;
      if (MODE_K ? j < i : j <= i)
        for (int d = 0; d < dk; ++d)
          x = fmaf(qs[i * ldk + d], ks[j * ldk + d], x);
      if (MODE_K && j == i) x = dg[i];
      as[i * ldc + j] = x;
    }
    __syncthreads();

    // 3. the chunk's output
    for (int idx = tid; idx < C * dv; idx += THREADS) {
      const int i = idx / dv, b = idx % dv;
      float x = 0.f, y = 0.f;
      for (int d = 0; d < dk; ++d) x = fmaf(qs[i * ldk + d], st[d * dv + b], x);
      for (int j = 0; j <= i; ++j) y = fmaf(as[i * ldc + j], vs[j * ldv + b], y);
      const float o = MODE_K ? x + y : ws[i * ldw + b] * (x + y);
      out[(size_t)(c0 + i) * dv + b] = from_f<T>(o);
    }
    __syncthreads();   // step 3 reads the state that step 4 writes

    // 4. the state carried to the next chunk
    for (int idx = tid; idx < dk * dv; idx += THREADS) {
      const int a = idx / dv, b = idx % dv;
      float x = 0.f;
      if (MODE_K) {
        const float qa = qc[a];
        for (int j = 0; j < C; ++j)
          x = fmaf(ks[j * ldk + a] * qa, vs[j * ldv + b], x);
        st[idx] = st[idx] * qa + x;
      } else {
        for (int j = 0; j < C; ++j) x = fmaf(ks[j * ldk + a], vs[j * ldv + b], x);
        st[idx] = qc[b] * (st[idx] + x);
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < dk * dv; idx += THREADS)
    state_out[(size_t)bh * dk * dv + idx] = st[idx];
}

template <typename T, bool MODE_K>
int launch(const void* q, const void* k, const void* v, const void* w,
           const void* u, void* out, void* state, int BH, int S, int dk,
           int dv, int C, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        gla_kernel<T, MODE_K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const size_t smem = sizeof(float) * smem_floats(dk, dv, C, MODE_K);
  gla_kernel<T, MODE_K><<<BH, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<T*>(out),
      static_cast<float*>(state), S, dk, dv, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

long long gla_smem_bytes(int dk, int dv, int chunk, int mode_k) {
  return (long long)(sizeof(float) * smem_floats(dk, dv, chunk, mode_k != 0));
}

int gla_max_smem() { return MAX_SMEM; }

// mode_k: 1 RWKV6 (u may be null: no bonus), 0 SSD (u ignored); dtype of
// q, k, v and out: 0 float32, 1 bfloat16. Returns a cudaError_t.
int launch_gla_scan(const void* q, const void* k, const void* v,
                    const void* w, const void* u, void* out, void* state,
                    int BH, int S, int dk, int dv, int chunk, int mode_k,
                    int dtype, void* stream) {
  if (BH < 1 || S < 1 || dk < 1 || dv < 1 || chunk < 1 || S % chunk ||
      gla_smem_bytes(dk, dv, chunk, mode_k) > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return mode_k ? launch<float, true>(q, k, v, w, u, out, state, BH, S, dk,
                                        dv, chunk, s)
                  : launch<float, false>(q, k, v, w, nullptr, out, state, BH,
                                         S, dk, dv, chunk, s);
  if (dtype == 1)
    return mode_k ? launch<__nv_bfloat16, true>(q, k, v, w, u, out, state, BH,
                                                S, dk, dv, chunk, s)
                  : launch<__nv_bfloat16, false>(q, k, v, w, nullptr, out,
                                                 state, BH, S, dk, dv, chunk,
                                                 s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
