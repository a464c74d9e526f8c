// Chunked gated linear attention for Hopper (sm_90a): an FFMA kernel
// template for both modes in float32 and a tensor-core kernel for each mode
// in bfloat16.
//
//   gla_scan mode "k"  replaces repro/kernels/rwkv6_scan.py::_gla_kernel_k
//                      (RWKV6 time mix: decay on K, bonus u on the diagonal):
//                      rwkv6_tc_kernel for bfloat16 q, k, v (the serve
//                      path), gla_kernel<true> for float32
//   gla_scan mode "v"  replaces repro/kernels/rwkv6_scan.py::_gla_kernel_v
//                      (Mamba2-style SSD: decay on V, inclusive diagonal),
//                      reached through repro/kernels/ssm_scan.py::ssd_pallas:
//                      ssd_tc_kernel for bfloat16 (hymba's serve path),
//                      gla_kernel<false> for float32
//   (wrapper gla_pallas, pallas_call at rwkv6_scan.py:129)
//
// q, k (BH, S, dk) and v (BH, S, dv) in float32 or bfloat16; the decays w
// (BH, S, dk) in mode k, (BH, S, dv) in mode v, and u (BH, dk), in float32.
// Out (BH, S, dv) in q's type, the final state (BH, dk, dv) in float32; the
// state starts at zero. Per chunk of C rows (the TPU grid's sequential
// chunk axis is a loop inside each CTA):
//
//   1. the cumulative decays of each column: qs = exp(cumsum(log w));
//      mode k: r_t = q * (qs / w), k_t = k / qs; mode v: v_t = v / qs;
//   2. A (C x C): mode k r_t k_t^T below the diagonal and sum(q * u * k) on
//      it; mode v q k^T on and below it;
//   3. out = r_t S + A v (mode k), qs * (q S + A v_t) (mode v);
//   4. S = S * qs[-1] + (k_t * qs[-1])^T v (mode k),
//      S = qs[-1] * (S + k^T v_t) (mode v).
//
// Both kernels keep the reference's numerics, not fixed: k / qs divides by
// a product of up to C decays, which underflows to 0 in float32 for decays
// near the model's floor exp(-8), and then the result is inf or NaN, as in
// the reference.
//
// What bounds them on this card. rwkv6-7b's prefill (B * 64 heads, S 2048,
// dk = dv = 64, C = 64) moves 406.8 MB a call at B = 4 (0.121 ms at 3.35
// TB/s) and needs 17.2 GFLOP of products with the state update split in
// two (0.035 ms at TF32's 495 TFLOP/s), so bytes bound rwkv6_tc_kernel;
// hymba-1.5b's SSD (B * 25 heads, dk 16, dv 64) is bound by its bytes too:
// 118 MB a call at B = 4 (0.035 ms); its 1.9 GFLOP of products take 0.004
// ms at TF32.
//
// rwkv6_tc_kernel (one CTA of 8 warps per bh; chunk, dk and dv padded to
// one 64-wide tile, so each may be any multiple of 8 up to 64):
//   - the products run on the tensor cores, mma.sync m16n8k8 in TF32 with
//     float32 sums: A = r_t k_t^T, r_t S and A v with operands rounded to
//     nearest (cvt.rna), and the state update with x = k_t * qs[-1] split
//     into hi = tf32(x) and lo = tf32(x - hi), two products against v (a
//     bf16 v is exact in TF32), so the carried state keeps float32
//     accuracy (one TF32 rounding there fails the state tolerance);
//   - warp w owns rows 16 (w & 3) of the chunk and of the state and
//     columns 32 (w >> 2): the state lives in its mma accumulators across
//     the chunks, and A in the accumulators of the warp that uses it, read
//     as the A operand of A v with the k index permuted (k-index t is
//     column 2t, t + 4 is 2t + 1; v's rows are read to match), so A never
//     goes through shared memory; the two warps of a row block both compute
//     its A (the cheapest product, a triangle);
//   - a chunk runs A with r_t S, then A v and the output's store, then the
//     state update, so A's and the output's accumulators are dead while the
//     state's are updated: 128 registers a thread and no spill;
//   - the cumulative decay: log w once per element, each of 256 threads
//     sums 16 rows of one column, and the four segments' totals combine
//     through shared memory (a warp holds 32 columns of one segment, so
//     every load is conflict-free), in place of one thread walking 64 rows;
//   - the next chunk's q, k, v and w land in a staging buffer by cp.async
//     (16 B a thread) while the current chunk computes from its converted
//     tiles (r_t and k_t in float32, v in bf16, the state in TF32), so the
//     staging buffer and the converted tiles form a two-stage ring;
//   - row strides of 68 and 72 words make every fragment load
//     conflict-free; 105,216 B of shared memory and __launch_bounds__(256,
//     2) keep two CTAs on an SM, so the 256 bh of B = 4 run in one wave on
//     132 SMs.
//
// ssd_tc_kernel (mode v; one CTA of 4 warps per bh and slice of 16 columns
// of v, the slices of a bh neighbours in blockIdx; dk a multiple of 8 up to
// 64, dv a multiple of 8, the chunk padded to 64 rows). One CTA per bh
// gave hymba's 100 bh one CTA on each of 100 of the 132 SMs, each walking
// 32 chunks in a serial chain. Mode v decays the columns of v, so column j
// of the output and of the state depends only on column j of v, w and S
// and on the shared q k^T: the slices need no pass across CTAs, and at B
// = 4 the 400 CTAs run in one wave at four a SM.
//   - each CTA recomputes B = q k^T for its chunk (the cheapest product at
//     dk 16); q and k are read from L2 by the bh's other slices;
//   - the products run on the tensor cores, mma.sync m16n8k8 in TF32 with
//     float32 sums, as in rwkv6_tc_kernel: B (q and k are bf16, exact in
//     TF32), q S, B v_t with B's accumulators as its A operand under the
//     permuted k index, and the state update k^T v_t with v_t split into hi
//     + lo (one TF32 rounding there fails the state tolerance; the output
//     stays well inside its own with one);
//   - warp w owns rows 16 w of the chunk and carries the state those rows
//     contribute, S_w = qs[-1] * (S_w + k_w^T v_t), in its accumulators; the
//     state is the sum of the four, formed once a chunk in shared memory
//     for q S; B v_t sums its even and odd k-steps in two accumulator sets,
//     which halves the triangle's longest dependent chain;
//   - the cumulative decay: log w once per element, each thread sums 8
//     rows of one column, and the eight segments' totals combine through
//     shared memory;
//   - the next chunk's q, k and slices of v and w land by cp.async (16 B a
//     thread, offsets computed once) in the other of two staging buffers
//     while the current chunk computes from its own;
//   - staged rows of q and k padded by 16 B and row strides of 20 and 24
//     words make the fragment loads conflict-free; 42,560 B of shared
//     memory at dk 16 and no spill keep four CTAs on an SM.
//
// gla_kernel (float32): 256 threads per bh, the chunk's tiles staged in
// shared memory as float32 with odd row strides, the (dk, dv) state in
// shared memory; the products run as float32 FFMA from shared memory, and
// the cumulative decays one thread per column.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SMEM = 232448;   // one block's shared memory on H100

size_t smem_floats(int dk, int dv, int C, bool mode_k) {
  const size_t dw = mode_k ? dk : dv;
  return (size_t)C * (2 * (dk + 1) + (dv + 1) + (dw + 1) + (C + 1)) +
         (size_t)dk * dv + dw + C;
}

template <bool MODE_K>
__global__ void __launch_bounds__(THREADS)
gla_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ out,
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
      qs[i * ldk + d] = q[(size_t)c0 * dk + idx];
      ks[i * ldk + d] = k[(size_t)c0 * dk + idx];
    }
    for (int idx = tid; idx < C * dv; idx += THREADS)
      vs[(idx / dv) * ldv + idx % dv] = v[(size_t)c0 * dv + idx];
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
      out[(size_t)(c0 + i) * dv + b] = o;
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

// ------------------------------------------------------ rwkv6_tc_kernel
namespace tc {

constexpr int T = 64;          // chunk rows, dk and dv, padded to one tile
constexpr int THREADS = 256;   // 8 warps
constexpr int LDF = 68;        // words a row of r_t and k_t
constexpr int LDS = 72;        // words a row of the state
constexpr int LDV = 72;        // bf16 a row of v

// shared memory, in bytes: the staging buffer (the next chunk as it lies in
// device memory), then the converted tiles and the small tables
constexpr int ST_Q = 0;
constexpr int ST_K = ST_Q + T * T * 2;
constexpr int ST_V = ST_K + T * T * 2;
constexpr int ST_W = ST_V + T * T * 2;
constexpr int RT_OFF = ST_W + T * T * 4;       // r_t, TF32 bits
constexpr int KT_OFF = RT_OFF + T * LDF * 4;   // k_t, float32
constexpr int V_OFF = KT_OFF + T * LDF * 4;    // v, bf16
constexpr int S_OFF = V_OFF + T * LDV * 2;     // the state, TF32 bits
constexpr int TOT_OFF = S_OFF + T * LDS * 4;   // 4 segment sums of log w
constexpr int LAST_OFF = TOT_OFF + 4 * T * 4;  // qs[-1] of each column
constexpr int DG_OFF = LAST_OFF + T * 4;       // the bonus diagonal, 2 halves
constexpr int SMEM = DG_OFF + 2 * T * 4;       // 105,216

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += a b: a 16 x 8 (row), b 8 x 8 (col), TF32 operands, float32 sums
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 x) {
  return (uint32_t)__bfloat16_as_ushort(x) << 16;   // exact in TF32
}

// One step of a butterfly that sums 16 rows over a warp's 32 lanes while
// halving the rows each lane keeps: lanes with bit 2N set keep rows N..2N-1.
template <int N>
__device__ __forceinline__ void fold_rows(float (&x)[16], int lane) {
  const bool up = lane & (2 * N);
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const float send = up ? x[r] : x[r + N];
    const float keep = up ? x[r + N] : x[r];
    x[r] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * N);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
rwkv6_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ u,
                __nv_bfloat16* __restrict__ out,
                float* __restrict__ state_out, int S, int dk, int dv,
                int C) {
  extern __shared__ __align__(16) unsigned char sm[];
  const __nv_bfloat16* qst = reinterpret_cast<const __nv_bfloat16*>(sm + ST_Q);
  const __nv_bfloat16* kst = reinterpret_cast<const __nv_bfloat16*>(sm + ST_K);
  const __nv_bfloat16* vst = reinterpret_cast<const __nv_bfloat16*>(sm + ST_V);
  const float* wst = reinterpret_cast<const float*>(sm + ST_W);
  float* rt = reinterpret_cast<float*>(sm + RT_OFF);
  float* kt = reinterpret_cast<float*>(sm + KT_OFF);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(sm + V_OFF);
  float* ss = reinterpret_cast<float*>(sm + S_OFF);
  float* tot = reinterpret_cast<float*>(sm + TOT_OFF);
  float* last = reinterpret_cast<float*>(sm + LAST_OFF);
  float* dgp = reinterpret_cast<float*>(sm + DG_OFF);

  const int bh = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // products: fragment coordinates, the warp's row block (rows of the chunk
  // and of the state) and column half (columns of out and of the state)
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp & 3, r0 = 16 * mt, c0w = 32 * (warp >> 2);
  // conversion: column cd, rows 16 sg .. 16 sg + 15 (a segment is 2 warps)
  const int cd = tid & 63, sg = tid >> 6;
  const float ud = (u != nullptr && cd < dk) ? u[(size_t)bh * dk + cd] : 0.f;

  q += (size_t)bh * S * dk;
  k += (size_t)bh * S * dk;
  v += (size_t)bh * S * dv;
  w += (size_t)bh * S * dk;
  out += (size_t)bh * S * dv;

  // the C rows of q, k, v and w from row c into the staging buffer
  auto stage = [&](int c) {
    const char* src[4] = {reinterpret_cast<const char*>(q + (size_t)c * dk),
                          reinterpret_cast<const char*>(k + (size_t)c * dk),
                          reinterpret_cast<const char*>(v + (size_t)c * dv),
                          reinterpret_cast<const char*>(w + (size_t)c * dk)};
    const int bytes[4] = {C * dk * 2, C * dk * 2, C * dv * 2, C * dk * 4};
    const int dst[4] = {ST_Q, ST_K, ST_V, ST_W};
#pragma unroll
    for (int p = 0; p < 4; ++p)
      for (int o = tid * 16; o < bytes[p]; o += THREADS * 16)
        cp16(sm + dst[p] + o, src[p] + o);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  // the state: rows r0 + g (+8), columns c0w + 8n + 2t (+1)
  float sacc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;

  stage(0);
  for (int c0 = 0; c0 < S; c0 += C) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();   // the chunk is staged; the last one's products done

    // the state entering the chunk, as the B operand of r_t S
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = c0w + 8 * n + 2 * t;
      *reinterpret_cast<float2*>(&ss[(r0 + g) * LDS + col]) =
          make_float2(__uint_as_float(tf32(sacc[n][0])),
                      __uint_as_float(tf32(sacc[n][1])));
      *reinterpret_cast<float2*>(&ss[(r0 + g + 8) * LDS + col]) =
          make_float2(__uint_as_float(tf32(sacc[n][2])),
                      __uint_as_float(tf32(sacc[n][3])));
    }

    // 1. log w once an element; each thread sums its 16 rows
    float lw[16], part = 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int i = 16 * sg + r;
      lw[r] = (i < C && cd < dk) ? logf(wst[i * dk + cd]) : 0.f;
      part += lw[r];
    }
    tot[sg * T + cd] = part;
    __syncthreads();

    // the segments before this one, then the rows in order: qs, r_t, k_t,
    // v and the bonus products; padded rows and columns give zeros (qs 1)
    float cum = 0.f;
    for (int s2 = 0; s2 < sg; ++s2) cum += tot[s2 * T + cd];
    float dg[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int i = 16 * sg + r;
      cum += lw[r];
      const float qs = expf(cum);
      float rv = 0.f, kv = 0.f, p = 0.f;
      if (i < C && cd < dk) {
        const float qv = __bfloat162float(qst[i * dk + cd]);
        const float kx = __bfloat162float(kst[i * dk + cd]);
        rv = qv * (qs / wst[i * dk + cd]);
        kv = kx / qs;
        p = qv * ud * kx;
      }
      if (i == C - 1) last[cd] = qs;
      rt[i * LDF + cd] = __uint_as_float(tf32(rv));
      kt[i * LDF + cd] = kv;
      vs[i * LDV + cd] = (i < C && cd < dv) ? vst[i * dv + cd]
                                            : __float2bfloat16_rn(0.f);
      dg[r] = p;
    }
    // the bonus diagonal: row sums over the warp's 32 columns, then the two
    // halves of dk added where it is read
    fold_rows<8>(dg, lane);
    fold_rows<4>(dg, lane);
    fold_rows<2>(dg, lane);
    fold_rows<1>(dg, lane);
    dg[0] += __shfl_xor_sync(0xffffffffu, dg[0], 1);
    if ((lane & 1) == 0) dgp[(warp & 1) * T + 16 * sg + (lane >> 1)] = dg[0];
    __syncthreads();   // the tiles are converted; the staging buffer is free

    if (c0 + C < S) stage(c0 + C);

    // 2.-3. A = r_t k_t^T (the triangle this row block needs) and r_t S
    float acc[8][4], oacc[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const int kc = 8 * ks + t;
      const uint32_t a0 = __float_as_uint(rt[(r0 + g) * LDF + kc]);
      const uint32_t a1 = __float_as_uint(rt[(r0 + g + 8) * LDF + kc]);
      const uint32_t a2 = __float_as_uint(rt[(r0 + g) * LDF + kc + 4]);
      const uint32_t a3 = __float_as_uint(rt[(r0 + g + 8) * LDF + kc + 4]);
#pragma unroll
      for (int n = 0; n < 8; ++n)
        if (n <= 2 * mt + 1)
          mma(acc[n], a0, a1, a2, a3, tf32(kt[(8 * n + g) * LDF + kc]),
              tf32(kt[(8 * n + g) * LDF + kc + 4]));
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = c0w + 8 * n + g;
        mma(oacc[n], a0, a1, a2, a3, __float_as_uint(ss[kc * LDS + col]),
            __float_as_uint(ss[(kc + 4) * LDS + col]));
      }
    }
    // A below the diagonal as computed, the bonus on it, zeros above
    const float dga = dgp[r0 + g] + dgp[T + r0 + g];
    const float dgb = dgp[r0 + g + 8] + dgp[T + r0 + g + 8];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = r0 + g + (e >> 1) * 8, j = 8 * n + 2 * t + (e & 1);
        acc[n][e] = j < i ? acc[n][e] : j == i ? (e >> 1 ? dgb : dga) : 0.f;
      }

    // 3. out += A v, then the chunk's output rows, rounded to bf16 (to
    // nearest). k index t is row j0 = 8 ks + 2t, t + 4 is j0 + 1: A's
    // accumulators are then its A operand as they stand.
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      if (ks <= 2 * mt + 1) {
        const int j0 = 8 * ks + 2 * t;
        const uint32_t a0 = tf32(acc[ks][0]), a1 = tf32(acc[ks][2]);
        const uint32_t a2 = tf32(acc[ks][1]), a3 = tf32(acc[ks][3]);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int col = c0w + 8 * n + g;
          mma(oacc[n], a0, a1, a2, a3, bf16_bits(vs[j0 * LDV + col]),
              bf16_bits(vs[(j0 + 1) * LDV + col]));
        }
      }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = c0w + 8 * n + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = r0 + g + 8 * h;
        if (i < C && col < dv)
          *reinterpret_cast<__nv_bfloat162*>(
              &out[(size_t)(c0 + i) * dv + col]) =
              __floats2bfloat162_rn(oacc[n][2 * h], oacc[n][2 * h + 1]);
      }
    }

    // 4. S = S * qs[-1] + (hi + lo)^T v, x = k_t * qs[-1] split into hi +
    // lo, with the same permuted k index (x^T reads k_t conflict-free)
    const float la = last[r0 + g], lb = last[r0 + g + 8];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      sacc[n][0] *= la;
      sacc[n][1] *= la;
      sacc[n][2] *= lb;
      sacc[n][3] *= lb;
    }
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const int j0 = 8 * ks + 2 * t;
      const float x[4] = {kt[j0 * LDF + r0 + g] * la,
                          kt[j0 * LDF + r0 + g + 8] * lb,
                          kt[(j0 + 1) * LDF + r0 + g] * la,
                          kt[(j0 + 1) * LDF + r0 + g + 8] * lb};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = tf32(x[e]);
        lo[e] = tf32(x[e] - __uint_as_float(hi[e]));
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = c0w + 8 * n + g;
        const uint32_t b0 = bf16_bits(vs[j0 * LDV + col]);
        const uint32_t b1 = bf16_bits(vs[(j0 + 1) * LDV + col]);
        mma(sacc[n], lo[0], lo[1], lo[2], lo[3], b0, b1);
        mma(sacc[n], hi[0], hi[1], hi[2], hi[3], b0, b1);
      }
    }
  }

  state_out += (size_t)bh * dk * dv;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int col = c0w + 8 * n + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = r0 + g + 8 * h;
      if (d < dk && col < dv)
        *reinterpret_cast<float2*>(&state_out[(size_t)d * dv + col]) =
            make_float2(sacc[n][2 * h], sacc[n][2 * h + 1]);
    }
  }
}

// What the kernel takes: dk and dv multiples of 8 up to T, a chunk up to
// T, and q, k, v and w 16-byte aligned (cp.async copies 16 B a thread).
bool takes(const void* q, const void* k, const void* v, const void* w,
           int dk, int dv, int C) {
  const void* ptrs[4] = {q, k, v, w};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return dk % 8 == 0 && dv % 8 == 0 && dk <= T && dv <= T && C <= T;
}

// The shared-memory limit and carveout, once per process.
cudaError_t configure() {
  static bool done = false;
  if (!done) {
    cudaError_t e = cudaFuncSetAttribute(
        rwkv6_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(rwkv6_tc_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    done = true;
  }
  return cudaSuccess;
}

int launch(const void* q, const void* k, const void* v, const void* w,
           const void* u, void* out, void* state, int BH, int S, int dk,
           int dv, int C, cudaStream_t stream) {
  if (!takes(q, k, v, w, dk, dv, C)) return (int)cudaErrorInvalidValue;
  const cudaError_t e = configure();
  if (e != cudaSuccess) return (int)e;
  rwkv6_tc_kernel<<<BH, THREADS, SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(state), S, dk, dv, C);
  return (int)cudaGetLastError();
}

}  // namespace tc

// -------------------------------------------------------- ssd_tc_kernel
namespace ssd {

using tc::bf16_bits;
using tc::cp16;
using tc::mma;
using tc::tf32;

constexpr int T = 64;           // chunk rows, padded to one tile
constexpr int NS = 16;          // the columns of v (and of w, out and the
                                // state) a CTA owns: one slice
constexpr int NB = NS / 8;      // the slice's 8-column mma blocks
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;   // warp w: rows 16 w of the chunk
constexpr int SEG = T * NS / THREADS; // rows of one column a thread scans: 8
constexpr int NSEG = T / SEG;
constexpr int LDVT = 20;        // words a row of v_t
constexpr int LDQS = 24;        // words a row of qs and of a state partial
constexpr int MAX_DK = 64;

// Shared memory, in bytes, for dk: two stages of the chunk as it lies in
// device memory (q and k rows padded by 16 B, the slice of v and of w),
// then v_t and qs in float32, the warps' state partials (the first also
// holds their sum in TF32), the segments' sums of log w and qs[-1].
struct Layout {
  int ldq, st_k, st_v, st_w, stage, vt, qs, sp, tot, last, total;
};

__host__ __device__ inline Layout layout(int dk) {
  Layout y;
  y.ldq = 2 * dk + 16;
  y.st_k = T * y.ldq;
  y.st_v = 2 * T * y.ldq;
  y.st_w = y.st_v + T * NS * 2;
  y.stage = y.st_w + T * NS * 4;
  y.vt = 2 * y.stage;
  y.qs = y.vt + T * LDVT * 4;
  y.sp = y.qs + T * LDQS * 4;
  y.tot = y.sp + WARPS * ((dk + 15) / 16 * 16) * LDQS * 4;
  y.last = y.tot + NSEG * NS * 4;
  y.total = y.last + NS * 4;
  return y;
}

// A warp's partial state (rows 16 mb + g (+8), columns 8 nb + 2t (+1) of
// its accumulators) into p, row stride LDQS.
template <int MB>
__device__ __forceinline__ void store_partial(float* p,
                                              const float (&sacc)[MB][NB][4],
                                              int g, int t) {
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int d = 16 * mb + g, col = 8 * nb + 2 * t;
      *reinterpret_cast<float2*>(&p[d * LDQS + col]) =
          make_float2(sacc[mb][nb][0], sacc[mb][nb][1]);
      *reinterpret_cast<float2*>(&p[(d + 8) * LDQS + col]) =
          make_float2(sacc[mb][nb][2], sacc[mb][nb][3]);
    }
}

// MB: the state's 16-row blocks, dk padded to 16 MB
template <int MB>
__global__ void __launch_bounds__(THREADS, MB <= 2 ? 4 : 2)
ssd_tc_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const float* __restrict__ w, __nv_bfloat16* __restrict__ out,
              float* __restrict__ state_out, int S, int dk, int dv, int C) {
  extern __shared__ __align__(16) unsigned char sm[];
  const Layout y = layout(dk);
  float* vt = reinterpret_cast<float*>(sm + y.vt);
  float* qsm = reinterpret_cast<float*>(sm + y.qs);
  float* sp = reinterpret_cast<float*>(sm + y.sp);
  float* tot = reinterpret_cast<float*>(sm + y.tot);
  float* last = reinterpret_cast<float*>(sm + y.last);

  // the slices of one bh are neighbours in blockIdx, so they read its q
  // and k from L2
  const int n_sl = (dv + NS - 1) / NS;
  const int bh = blockIdx.x / n_sl, j0 = (blockIdx.x - bh * n_sl) * NS;
  const int ns = min(NS, dv - j0);     // 16, or 8 in a last slice
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // products: fragment coordinates and the warp's row block
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp;
  // decay: column cd of the slice, rows SEG sg .. SEG sg + SEG - 1
  const int cd = tid & (NS - 1), sg = tid / NS;
  const int ldqe = y.ldq / 2;          // bf16 a staged row of q and k
  const int dkp = 16 * MB;             // state rows, padded to 16
  const int sps = dkp * LDQS;          // words a warp's state partial

  q += (size_t)bh * S * dk;
  k += (size_t)bh * S * dk;
  v += (size_t)bh * S * dv + j0;
  w += (size_t)bh * S * dv + j0;
  out += (size_t)bh * S * dv + j0;

  // both stages zeroed once: the rows past C, the columns past dk and ns,
  // and the rows' padding are never copied, so they stay zero
  for (int o = tid * 16; o < 2 * y.stage; o += THREADS * 16)
    *reinterpret_cast<uint4*>(sm + o) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // the C rows of q, k and of the slice of v and w from row c into stage
  // b, 16 B a thread: the pieces' offsets (source in elements from row c,
  // destination in bytes; -1 past the chunk) are the same every chunk
  constexpr int QK_PIECES = T * MAX_DK / 8 / THREADS;   // q's and k's: 4
  constexpr int W_PIECES = T * NS / 4 / THREADS;        // w's; v's: half
  int q_src[QK_PIECES], q_dst[QK_PIECES], v_src = -1, v_dst = 0;
  int w_src[W_PIECES], w_dst[W_PIECES];
#pragma unroll
  for (int r = 0; r < QK_PIECES; ++r) {
    const int p = tid + r * THREADS, i = p / (dk / 8), o = p % (dk / 8);
    q_src[r] = p < C * (dk / 8) ? i * dk + o * 8 : -1;
    q_dst[r] = i * y.ldq + o * 16;
  }
  if (tid < C * (ns / 8)) {
    const int i = tid / (ns / 8), o = tid % (ns / 8);
    v_src = i * dv + o * 8;
    v_dst = y.st_v + i * NS * 2 + o * 16;
  }
#pragma unroll
  for (int r = 0; r < W_PIECES; ++r) {
    const int p = tid + r * THREADS, i = p / (ns / 4), o = p % (ns / 4);
    w_src[r] = p < C * (ns / 4) ? i * dv + o * 4 : -1;
    w_dst[r] = y.st_w + i * NS * 4 + o * 16;
  }
  auto stage = [&](int c, int b) {
    unsigned char* base = sm + b * y.stage;
#pragma unroll
    for (int r = 0; r < QK_PIECES; ++r)
      if (q_src[r] >= 0) {
        cp16(base + q_dst[r], q + (size_t)c * dk + q_src[r]);
        cp16(base + y.st_k + q_dst[r], k + (size_t)c * dk + q_src[r]);
      }
    if (v_src >= 0) cp16(base + v_dst, v + (size_t)c * dv + v_src);
#pragma unroll
    for (int r = 0; r < W_PIECES; ++r)
      if (w_src[r] >= 0)
        cp16(base + w_dst[r], w + (size_t)c * dv + w_src[r]);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  // the warp's partial state: rows 16 mb + g (+8), columns 8 nb + 2t (+1);
  // the state is the sum of the four partials
  float sacc[MB][NB][4];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[mb][nb][e] = 0.f;

  stage(0, 0);
  int b = 0;
  for (int c0 = 0; c0 < S; c0 += C, b ^= 1) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();   // the chunk is staged; the last one's products done
    if (c0 + C < S) stage(c0 + C, b ^ 1);
    const unsigned char* base = sm + b * y.stage;
    const __nv_bfloat16* qst = reinterpret_cast<const __nv_bfloat16*>(base);
    const __nv_bfloat16* kst =
        reinterpret_cast<const __nv_bfloat16*>(base + y.st_k);
    const __nv_bfloat16* vst =
        reinterpret_cast<const __nv_bfloat16*>(base + y.st_v);
    const float* wst = reinterpret_cast<const float*>(base + y.st_w);

    store_partial<MB>(sp + warp * sps, sacc, g, t);

    // 1. log w once an element; each thread sums its SEG rows
    float lw[SEG], part = 0.f;
#pragma unroll
    for (int r = 0; r < SEG; ++r) {
      const int i = SEG * sg + r;
      lw[r] = (i < C && cd < ns) ? logf(wst[i * NS + cd]) : 0.f;
      part += lw[r];
    }
    tot[sg * NS + cd] = part;
    __syncthreads();   // the segments' sums and the partials are written

    // the segments before this one, then the rows in order: qs and v_t
    // (zeros in padded rows and columns)
    float cum = 0.f;
    for (int s2 = 0; s2 < sg; ++s2) cum += tot[s2 * NS + cd];
#pragma unroll
    for (int r = 0; r < SEG; ++r) {
      const int i = SEG * sg + r;
      cum += lw[r];
      const float e = expf(cum);
      const bool in = i < C && cd < ns;
      qsm[i * LDQS + cd] = e;
      vt[i * LDVT + cd] = in ? __bfloat162float(vst[i * NS + cd]) / e : 0.f;
      if (i == C - 1) last[cd] = e;
    }
    // the state entering the chunk, the partials' sum in TF32 (the B
    // operand of q S), in place of the first partial
    for (int x = tid; x < dkp * NS; x += THREADS) {
      const int o = (x / NS) * LDQS + x % NS;
      const float s = sp[o] + sp[sps + o] + sp[2 * sps + o] + sp[3 * sps + o];
      sp[o] = __uint_as_float(tf32(s));
    }
    __syncthreads();

    // 2.-3. B = q k^T (the triangle this row block needs, diagonal
    // included) and q S; q and k are bf16, exact in TF32
    // out in two accumulator sets, even and odd k-steps of B v_t (q S in
    // the even set), so the longest dependent chain is half as long
    float acc[8][4], oacc[2][NB][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[h][nb][e] = 0.f;
    for (int ks = 0; ks < dk / 8; ++ks) {
      const int kc = 8 * ks + t;
      const uint32_t a0 = bf16_bits(qst[(r0 + g) * ldqe + kc]);
      const uint32_t a1 = bf16_bits(qst[(r0 + g + 8) * ldqe + kc]);
      const uint32_t a2 = bf16_bits(qst[(r0 + g) * ldqe + kc + 4]);
      const uint32_t a3 = bf16_bits(qst[(r0 + g + 8) * ldqe + kc + 4]);
#pragma unroll
      for (int n = 0; n < 8; ++n)
        if (n <= 2 * warp + 1)
          mma(acc[n], a0, a1, a2, a3, bf16_bits(kst[(8 * n + g) * ldqe + kc]),
              bf16_bits(kst[(8 * n + g) * ldqe + kc + 4]));
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int col = 8 * nb + g;
        mma(oacc[0][nb], a0, a1, a2, a3, __float_as_uint(sp[kc * LDQS + col]),
            __float_as_uint(sp[(kc + 4) * LDQS + col]));
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = r0 + g + (e >> 1) * 8, j = 8 * n + 2 * t + (e & 1);
        acc[n][e] = j <= i ? acc[n][e] : 0.f;
      }

    // 3. out += B v_t, then out = qs * out, rounded to bf16 (to nearest).
    // k index t is row j0 = 8 ks + 2t, t + 4 is j0 + 1: B's accumulators
    // are then its A operand as they stand.
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      if (ks <= 2 * warp + 1) {
        const int jr = 8 * ks + 2 * t;
        const uint32_t a0 = tf32(acc[ks][0]), a1 = tf32(acc[ks][2]);
        const uint32_t a2 = tf32(acc[ks][1]), a3 = tf32(acc[ks][3]);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const int col = 8 * nb + g;
          mma(oacc[ks & 1][nb], a0, a1, a2, a3, tf32(vt[jr * LDVT + col]),
              tf32(vt[(jr + 1) * LDVT + col]));
        }
      }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int col = 8 * nb + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[0][nb][e] += oacc[1][nb][e];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = r0 + g + 8 * h;
        if (i < C && col < ns) {
          const float2 e = *reinterpret_cast<const float2*>(
              &qsm[i * LDQS + col]);
          *reinterpret_cast<__nv_bfloat162*>(
              &out[(size_t)(c0 + i) * dv + col]) =
              __floats2bfloat162_rn(e.x * oacc[0][nb][2 * h],
                                    e.y * oacc[0][nb][2 * h + 1]);
        }
      }
    }

    // 4. the partial state: S_w = qs[-1] * (S_w + k_w^T v_t) over the
    // warp's 16 rows, v_t split into hi = tf32(v_t) and lo = tf32(v_t -
    // hi), with the same permuted k index
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      const int jr = r0 + 8 * kh + 2 * t;
      uint32_t hi[NB][2], lo[NB][2];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float x = vt[(jr + h) * LDVT + 8 * nb + g];
          hi[nb][h] = tf32(x);
          lo[nb][h] = tf32(x - __uint_as_float(hi[nb][h]));
        }
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        const int d = 16 * mb + g;
        const uint32_t a0 = bf16_bits(kst[jr * ldqe + d]);
        const uint32_t a1 = bf16_bits(kst[jr * ldqe + d + 8]);
        const uint32_t a2 = bf16_bits(kst[(jr + 1) * ldqe + d]);
        const uint32_t a3 = bf16_bits(kst[(jr + 1) * ldqe + d + 8]);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          mma(sacc[mb][nb], a0, a1, a2, a3, lo[nb][0], lo[nb][1]);
          mma(sacc[mb][nb], a0, a1, a2, a3, hi[nb][0], hi[nb][1]);
        }
      }
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const float la = last[8 * nb + 2 * t], lb = last[8 * nb + 2 * t + 1];
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        sacc[mb][nb][0] *= la;
        sacc[mb][nb][1] *= lb;
        sacc[mb][nb][2] *= la;
        sacc[mb][nb][3] *= lb;
      }
    }
  }

  // the final state: the four partials summed, in float32
  __syncthreads();
  store_partial<MB>(sp + warp * sps, sacc, g, t);
  __syncthreads();
  state_out += (size_t)bh * dk * dv + j0;
  for (int x = tid; x < dk * ns; x += THREADS) {
    const int d = x / ns, col = x - d * ns, o = d * LDQS + col;
    state_out[(size_t)d * dv + col] =
        sp[o] + sp[sps + o] + sp[2 * sps + o] + sp[3 * sps + o];
  }
}

// What the kernel takes: dk a multiple of 8 up to MAX_DK, dv a multiple of
// 8, a chunk up to T, and q, k, v and w 16-byte aligned (cp.async copies
// 16 B a thread).
bool takes(const void* q, const void* k, const void* v, const void* w,
           int dk, int dv, int C) {
  const void* ptrs[4] = {q, k, v, w};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return dk % 8 == 0 && dv % 8 == 0 && dk <= MAX_DK && C <= T;
}

using Kernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                        const __nv_bfloat16*, const float*, __nv_bfloat16*,
                        float*, int, int, int, int);

// The instantiation for dk (dk <= MAX_DK), with its shared-memory limit
// and carveout set once per process; null if they cannot be set.
Kernel kernel_for(int dk) {
  static const Kernel kernels[MAX_DK / 16] = {
      ssd_tc_kernel<1>, ssd_tc_kernel<2>, ssd_tc_kernel<3>, ssd_tc_kernel<4>};
  static bool done[MAX_DK / 16] = {};
  const int m = (dk + 15) / 16 - 1;
  if (!done[m]) {
    if (cudaFuncSetAttribute(kernels[m],
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             layout(16 * (m + 1)).total) != cudaSuccess ||
        cudaFuncSetAttribute(kernels[m],
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared) !=
            cudaSuccess)
      return nullptr;
    done[m] = true;
  }
  return kernels[m];
}

int launch(const void* q, const void* k, const void* v, const void* w,
           void* out, void* state, int BH, int S, int dk, int dv, int C,
           cudaStream_t stream) {
  if (!takes(q, k, v, w, dk, dv, C)) return (int)cudaErrorInvalidValue;
  const Kernel kern = kernel_for(dk);
  if (kern == nullptr) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  const long long n_cta = (long long)BH * ((dv + NS - 1) / NS);
  if (n_cta > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)n_cta, THREADS, layout(dk).total, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(w),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(state), S, dk,
      dv, C);
  return (int)cudaGetLastError();
}

}  // namespace ssd

template <bool MODE_K>
int launch(const void* q, const void* k, const void* v, const void* w,
           const void* u, void* out, void* state, int BH, int S, int dk,
           int dv, int C, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        gla_kernel<MODE_K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const size_t smem = sizeof(float) * smem_floats(dk, dv, C, MODE_K);
  gla_kernel<MODE_K><<<BH, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(out),
      static_cast<float*>(state), S, dk, dv, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// gla_kernel's shared memory (bytes), and one block's limit.
long long gla_smem_bytes(int dk, int dv, int chunk, int mode_k) {
  return (long long)(sizeof(float) * smem_floats(dk, dv, chunk, mode_k != 0));
}

int gla_max_smem() { return MAX_SMEM; }

// rwkv6_tc_kernel's shared memory (bytes) and its resident CTAs per SM.
int gla_tc_smem_bytes() { return tc::SMEM; }

int gla_tc_blocks_per_sm() {
  int n = 0;
  if (tc::configure() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, tc::rwkv6_tc_kernel, tc::THREADS, tc::SMEM) != cudaSuccess)
    return -1;
  return n;
}

// ssd_tc_kernel's shared memory (bytes) and its resident CTAs per SM at dk.
int gla_ssd_smem_bytes(int dk) { return ssd::layout(dk).total; }

int gla_ssd_blocks_per_sm(int dk) {
  int n = 0;
  const ssd::Kernel kern =
      dk >= 1 && dk <= ssd::MAX_DK ? ssd::kernel_for(dk) : nullptr;
  if (kern == nullptr ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kern, ssd::THREADS, ssd::layout(dk).total) != cudaSuccess)
    return -1;
  return n;
}

// mode_k: 1 RWKV6 (u may be null: no bonus), 0 SSD (u ignored); dtype of
// q, k, v and out: 0 float32, 1 bfloat16. float32 runs gla_kernel (its
// shared memory at most gla_max_smem()); bfloat16 runs rwkv6_tc_kernel in
// mode k (dk, dv multiples of 8 up to 64), ssd_tc_kernel in mode v (dk a
// multiple of 8 up to 64, dv a multiple of 8), both with a chunk up to 64
// and q, k, v and w 16-byte aligned. Returns a cudaError_t.
int launch_gla_scan(const void* q, const void* k, const void* v,
                    const void* w, const void* u, void* out, void* state,
                    int BH, int S, int dk, int dv, int chunk, int mode_k,
                    int dtype, void* stream) {
  if (BH < 1 || S < 1 || dk < 1 || dv < 1 || chunk < 1 || S % chunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (gla_smem_bytes(dk, dv, chunk, mode_k) > MAX_SMEM)
      return (int)cudaErrorInvalidValue;
    return mode_k ? launch<true>(q, k, v, w, u, out, state, BH, S, dk, dv,
                                 chunk, s)
                  : launch<false>(q, k, v, w, nullptr, out, state, BH, S, dk,
                                  dv, chunk, s);
  }
  if (dtype == 1)
    return mode_k ? tc::launch(q, k, v, w, u, out, state, BH, S, dk, dv,
                               chunk, s)
                  : ssd::launch(q, k, v, w, out, state, BH, S, dk, dv, chunk,
                                s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
