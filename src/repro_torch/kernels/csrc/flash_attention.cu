// Causal / sliding-window online-softmax attention with GQA for Hopper
// (sm_90a).
//
//   flash_attention  replaces repro/kernels/flash_attention.py::_fa_kernel
//                    (wrapper flash_attention :70, pallas_call :85)
//
// q (BH, Sq, D), k and v (BKV, Skv, D), float32 or bfloat16, D in
// {16, 32, 64, 128}; row bh attends KV row bh / (BH / BKV). Arithmetic as the
// TPU kernel's: scores (q . k) * scale with scale = 1/sqrt(D) after the
// product, masked scores -1e30, m_new = max(m, rowmax), p = exp(s - m_new),
// corr = exp(m - m_new), l = l * corr + sum(p), acc = acc * corr + p v,
// out = acc / max(l, 1e-30). Keys at or beyond Skv score -inf (p = 0 exactly,
// whatever the running max), so any length works; query rows beyond Sq are
// computed and not stored. The causal mask has no offset, as the
// reference's: query row q attends keys 0 .. min(q, Skv - 1), and with a
// window only those after q - window, so Sq and Skv may differ. A row
// q >= Skv + window - 1 then has no key in its band: every score is -1e30,
// and the reference's softmax makes it the mean of all Skv values. A block
// (or warpgroup) holding such a row visits every key, where p = exp(-1e30 -
// (-1e30)) = 1 gives that mean, and its other rows lose the extra tiles to
// corr = 0 (see below).
//
// Two kernels, picked by dtype in launch_flash_attention (0 -> FFMA, 1 ->
// wgmma). This is an explicit dispatch, not a fallback: neither kernel gives
// way to the other or to the plain version, and a launch the picked kernel
// cannot take returns an error, on which the wrapper raises.
//
// bfloat16: fa_wgmma_kernel, on the tensor cores. One CTA per (bh, 128 query
// rows) of two consumer warpgroups (64 query rows each, wgmma's M) and one
// producer warp; two CTAs share an SM below D = 128. The producer loads the
// CTA's Q once, then streams K and V tiles of 64 keys into a ring of three
// stages with TMA (cp.async.bulk.tensor from tensor maps made per call by
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so the
// library needs no -lcuda); each stage has a full barrier (TMA bytes) and an
// empty one (all 256 consumer threads arrive). The maps are 3-D (D, S,
// heads), so a tile's rows past the end of its head are zero-filled and then
// score -inf. Each box is one swizzle span wide: 128-byte rows and the
// 128-byte swizzle for D >= 64 (D = 128 is two boxes side by side), 64 and
// 32 bytes for D = 32 and 16; the wgmma descriptors name the same swizzle.
// A consumer warpgroup computes S = Q K^T as wgmma m64n64k16 with both
// operands in shared memory (K-major) into float32 registers, masks only the
// tiles that cross the diagonal, the window's edge or Skv, takes the row max
// and sum across the four lanes that share a row (the accumulator holds rows
// 16 warp + lane/4 and +8, columns 8 j + 2 (lane % 4) + {0, 1}), rescales its
// O accumulator (64 x D float32, in registers), rounds P to bf16 in the
// registers that already have wgmma's A-fragment layout, and issues O += P V
// with P as the register A operand and V as an MN-major (transposed)
// shared-memory B operand. Exponentials are exp2 in log2(e)-scaled units;
// on a tile that masks nothing the scale folds into the exponent's FFMA.
// Rounding P to bf16 before the PV product is the one change from the TPU
// kernel's arithmetic, which keeps P in float32.
//
// float32: fa_ffma_kernel. Tensor cores take float32 only as TF32 (about
// three decimal digits), which cannot meet the float32 tolerance of 2e-6, so
// float32 stays in FFMA: one CTA of 256 threads per (bh, 64 query rows),
// 64-key tiles of K and V staged in shared memory, thread (r, c) (r = tid /
// 16, c = tid % 16) holding query rows 4r .. 4r + 3 and their (m, l, acc)
// for the output columns c + 16 j in registers, the row max and sum by warp
// shuffles, P through shared memory under a __syncwarp. Shared rows are
// padded to an odd stride, so the products read without bank conflicts.
//
// Both skip key tiles outside the causal band or the window: such a tile
// before a row's first valid key only adds terms that corr = exp(-1e30 - m)
// = 0 wipes when the first valid key arrives, and one after it adds p = 0
// with corr = 1, so skipping gives what visiting gives (at S 2048, window
// 1024 it halves the work). The wgmma kernel also skips, per warpgroup, the
// tiles none of its 64 rows attends, and launches the query blocks with the
// most tiles first.
//
// What bounds it on this card: at hymba-1.5b's prefill (q and out
// (B * 25, 2048, 64), k and v (B * 5, 2048, 64), bf16, window 1024) a call
// at B = 4 moves 63 MB (0.019 ms at 3.35 TB/s) and needs 4 * 64 flops for
// each of the 1,573,376 (query, valid key) pairs of a head: 40 GFLOP, 0.041
// ms at the 989 TFLOP/s of the bf16 tensor cores, so operations bound it.
// The wgmma kernel's pace is set by the softmax between its two products
// (exponentials, row reductions and the rescale on the CUDA cores), which a
// warpgroup runs while its tensor-core work waits: hiding it behind the next
// tile's Q K^T within a warpgroup is the later work (PERF.md, ROADMAP.md).

#include <cuda.h>   // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

// The keys [*lo, *hi) that query rows q_lo .. q_end - 1 (q_end <= Sq) may
// attend: a causal row q keys 0 .. q, with a window those after q - window,
// all below Skv; every key when a row has none in its band (its scores are
// all -1e30, and the softmax spreads over every key, as the reference's).
__device__ __forceinline__ void band(int causal, int window, int q_lo,
                                     int q_end, int Skv, int* lo, int* hi) {
  *lo = 0;
  *hi = Skv;
  if (!causal || (window > 0 && q_end - 1 >= Skv + window - 1)) return;
  *hi = min(Skv, q_end);
  if (window > 0) *lo = max(0, q_lo - window + 1);
}
constexpr int MAX_SMEM = 232448;   // one block's shared memory on H100

// ------------------------------------------------------------ float32 FFMA
namespace ffma {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;
constexpr int LDP = BK + 1;     // row stride of the P tile

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + 1) + (size_t)BQ * LDP);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
fa_ffma_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ out,
               int group, int Sq, int Skv, int n_qb, int causal, int window,
               float scale) {
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
  const float* qg = q + (size_t)bh * Sq * D;
  const float* kg = k + (size_t)(bh / group) * Skv * D;
  const float* vg = v + (size_t)(bh / group) * Skv * D;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int row = idx / D, col = idx % D;
    qs[row * LD + col] = q0 + row < Sq ? qg[(size_t)(q0 + row) * D + col] : 0.f;
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
  int k_lo, k_hi;
  band(causal, window, q0, min(q0 + BQ, Sq), Skv, &k_lo, &k_hi);
  const int t_end = (k_hi + BK - 1) / BK;

  for (int t = k_lo / BK; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // the previous tile's K, V and P are used up
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int row = idx / D, col = idx % D;
      const bool in = k0 + row < Skv;
      const size_t off = (size_t)(k0 + row) * D + col;
      ks[row * LD + col] = in ? kg[off] : 0.f;
      vs[row * LD + col] = in ? vg[off] : 0.f;
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

  float* og = out + (size_t)bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + 4 * r + i;
    if (qr >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j)
      og[(size_t)qr * D + c + 16 * j] = acc[i][j] / denom;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int BKV, int Sq, int Skv, int causal, int window,
           cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = smem_bytes(D);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        fa_ffma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int n_qb = (Sq + BQ - 1) / BQ;
  if ((long long)BH * n_qb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // rounded once from double, as the TPU wrapper's 1.0 / math.sqrt(d)
  const float scale = (float)(1.0 / sqrt((double)D));
  fa_ffma_kernel<D><<<(unsigned)BH * n_qb, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), BH / BKV, Sq,
      Skv, n_qb, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace ffma

// ------------------------------------------------- bfloat16 wgmma + TMA ring
namespace tc {

constexpr int BQ = 128;                  // query rows per CTA
constexpr int STAGES = 3;                // K/V tiles in flight
constexpr int CONSUMERS = 256;           // two warpgroups of 64 query rows
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int BK = 64;   // keys per tile: one m64n64 wgmma wide
  // CTAs per SM: two below D = 128 (96 registers a thread), where the
  // warpgroups of one CTA alone leave the softmax short of warps to hide
  // its latency; one at D = 128 (the 64 x 128 accumulator)
  static constexpr int MIN_BLOCKS = D == 128 ? 1 : 2;
  static constexpr int COLS = D < 64 ? D : 64;     // columns of one TMA box
  static constexpr int ROWB = 2 * COLS;            // its row: the swizzle span
  static constexpr int BOXES = D / COLS;           // boxes side by side
  static constexpr int KPB = ROWB / 32;            // k16 steps in one box
  // wgmma descriptor swizzle mode: 1 = 128 B, 2 = 64 B, 3 = 32 B
  static constexpr uint64_t SWIZZLE = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  static constexpr int Q_BYTES = 64 * D * 2;       // one warpgroup's Q
  static constexpr int KV_BYTES = BK * D * 2;      // one K or V tile
  static constexpr int BAR_OFF = 2 * Q_BYTES + STAGES * 2 * KV_BYTES;
  // + q_full, full[STAGES], empty[STAGES]; + slack to align the base to 1024
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait for the phase of parity ``parity`` to complete. A wait that outlasts
// any run by far traps, so a fault in the ring ends the launch with an
// error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 28)) __trap();
  }
}

// TMA: one box of a 3-D tensor map into shared memory, completing on ``bar``
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode. The stride offset is 8 rows of one
// box (the next group of 8 rows, K-major or MN-major alike).
template <int D>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  using T = Tile<D>;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((8 * T::ROWB) >> 4) << 32) | (T::SWIZZLE << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accesses of wgmma's registers across it
template <int N>
__device__ __forceinline__ void reg_fence(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define F8(d, i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64 float32) (+)= A (64 x 16, shared, K-major) B^T (64 x 16,
// shared, K-major); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N float32) += A (64 x 16 bf16, registers) B (16 x N, shared,
// MN-major: the V tile's rows as stored)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "
        "1, 1;\n}\n"
        : F8(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : F8(d, 0), F8(d, 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    static_assert(N == 64, "wgmma_rs: N is 16, 32 or 64");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

#undef F8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int D>
__global__ void __launch_bounds__(THREADS, Tile<D>::MIN_BLOCKS)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ out, int BH, int group, int Sq,
                int Skv, int n_qb, int causal, int window, float scale_log2) {
  using T = Tile<D>;
  constexpr int BK = T::BK;
  static_assert(BK == 64, "a K tile's boxes sit as Q's, one wgmma wide");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                    // Q of warpgroup w at w Q_BYTES
  const uint32_t kv_s = base + 2 * T::Q_BYTES;  // stage s: K, then V
  const uint32_t q_full = base + T::BAR_OFF;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * STAGES;

  const int bh = blockIdx.x % BH;
  const int q0 = (n_qb - 1 - (int)blockIdx.x / BH) * BQ;   // most tiles first
  // the keys any row of this block may attend: [k_lo, k_hi)
  int k_lo, k_hi;
  band(causal, window, q0, min(q0 + BQ, Sq), Skv, &k_lo, &k_hi);
  const int t0 = k_lo / BK;
  const int n_tiles = (k_hi + BK - 1) / BK - t0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == CONSUMERS / 32) {
    // ---- producer: Q once, then the K/V ring
    if (lane != 0) return;
    const int live = Sq - q0 > 64 ? 2 : 1;   // warpgroups with a query row
    mbar_expect_tx(q_full, live * T::Q_BYTES);
    for (int w = 0; w < live; ++w)
      for (int b = 0; b < T::BOXES; ++b)
        tma_load(q_s + w * T::Q_BYTES + b * 64 * T::ROWB, &tm_q,
                 b * T::COLS, q0 + 64 * w, bh, q_full);
    const int kvh = bh / group;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const uint32_t full = full0 + 8 * s;
      mbar_wait(empty0 + 8 * s, ((i / STAGES) & 1) ^ 1);
      mbar_expect_tx(full, 2 * T::KV_BYTES);
      const uint32_t ks = kv_s + 2 * s * T::KV_BYTES;
      const int k0 = (t0 + i) * BK;
      for (int b = 0; b < T::BOXES; ++b) {
        tma_load(ks + b * BK * T::ROWB, &tm_k, b * T::COLS, k0, kvh, full);
        tma_load(ks + T::KV_BYTES + b * BK * T::ROWB, &tm_v, b * T::COLS,
                 k0, kvh, full);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows q0w .. q0w + 63
  const int wg = warp / 4;
  const int q0w = q0 + 64 * wg;
  const int ra = q0w + 16 * (warp % 4) + lane / 4, rb = ra + 8;
  const uint32_t qw = q_s + wg * T::Q_BYTES;
  const bool live = q0w < Sq;
  // the keys any row of this warpgroup may attend: [lo, hi)
  int lo, hi;
  band(causal, window, q0w, min(q0w + 64, Sq), Skv, &lo, &hi);

  float o[D / 2], sc[BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  float ma = NEG_INF, mb = NEG_INF, la = 0.f, lb = 0.f;
  if (live) mbar_wait(q_full, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int k0 = (t0 + i) * BK;
    mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
    if (live && k0 < hi && k0 + BK > lo) {
      const uint32_t ks = kv_s + 2 * s * T::KV_BYTES;
      const uint32_t vs = ks + T::KV_BYTES;

      // S = Q K^T: D / 16 k-steps, each a wgmma over the tile's 64 keys
      wg_fence();
      reg_fence<BK / 2>(sc);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / T::KPB) * 64 * T::ROWB   // the box
                             + (kk % T::KPB) * 32;          // its row part
        wgmma_ss_n64(sc, desc<D>(qw + off, 16), desc<D>(ks + off, 16),
                     kk > 0);
      }
      wg_commit();
      wg_wait0();
      reg_fence<BK / 2>(sc);

      // The online softmax on the rows ra and rb, in log2 units. A tile
      // that masks no (row, key) of this warpgroup keeps its raw scores:
      // the row max commutes with the positive scale, which then folds into
      // the exponent's FFMA. A tile that crosses the diagonal, the window's
      // edge or Skv is scaled and masked first, behind a branch of its own.
      const bool inside =
          k0 + BK <= Skv &&
          (!causal || (k0 + BK - 1 <= q0w &&
                       (window == 0 || k0 > q0w + 63 - window)));
      float mxa = -INFINITY, mxb = -INFINITY;
      if (inside) {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          if ((j / 2) % 2)
            mxb = fmaxf(mxb, sc[j]);
          else
            mxa = fmaxf(mxa, sc[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          const int kp = k0 + 8 * (j / 4) + 2 * (lane % 4) + (j % 2);
          const int qp = (j / 2) % 2 ? rb : ra;
          float x = sc[j] * scale_log2;
          if (kp >= Skv)
            x = -INFINITY;
          else if (causal && (kp > qp || (window > 0 && kp <= qp - window)))
            x = NEG_INF;
          sc[j] = x;
          if ((j / 2) % 2)
            mxb = fmaxf(mxb, x);
          else
            mxa = fmaxf(mxa, x);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, off));
        mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, off));
      }
      const float mul = inside ? scale_log2 : 1.f;   // what sc still needs
      const float mna = fmaxf(ma, mxa * mul), mnb = fmaxf(mb, mxb * mul);
      const float ca = ex2(ma - mna), cb = ex2(mb - mnb);
      ma = mna;
      mb = mnb;
      float suma = 0.f, sumb = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        if ((j / 2) % 2) {
          sc[j] = ex2(fmaf(sc[j], mul, -mnb));
          sumb += sc[j];
        } else {
          sc[j] = ex2(fmaf(sc[j], mul, -mna));
          suma += sc[j];
        }
      }
      la = la * ca + suma;   // this lane's share; the 4 lanes sum at the end
      lb = lb * cb + sumb;
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] *= (j / 2) % 2 ? cb : ca;

      // P in bf16: the accumulator's layout is wgmma's A-fragment layout,
      // keys 16 kk .. 16 kk + 15 in sc[8 kk .. 8 kk + 7]
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      // O += P V: BK / 16 k-steps, one wgmma per box of D
      wg_fence();
      reg_fence<D / 2>(o);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int b = 0; b < T::BOXES; ++b)
          wgmma_rs<T::COLS>(o + b * (T::COLS / 2), pa[kk],
                            desc<D>(vs + b * BK * T::ROWB +
                                        kk * 16 * T::ROWB,
                                    BK * T::ROWB));
      wg_commit();
      wg_wait0();
      reg_fence<D / 2>(o);
    }
    mbar_arrive(empty0 + 8 * s);
  }

  // out = acc / max(l, 1e-30) in bf16; rows at or beyond Sq not stored
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    la += __shfl_xor_sync(0xffffffffu, la, off);
    lb += __shfl_xor_sync(0xffffffffu, lb, off);
  }
  const float da = fmaxf(la, 1e-30f), db = fmaxf(lb, 1e-30f);
  __nv_bfloat16* og = out + (size_t)bh * Sq * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    if (ra < Sq)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)ra * D + c) =
          __floats2bfloat162_rn(o[4 * j] / da, o[4 * j + 1] / da);
    if (rb < Sq)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)rb * D + c) =
          __floats2bfloat162_rn(o[4 * j + 2] / db, o[4 * j + 3] / db);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (libcuda is
// loaded by it, not linked)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (heads, S, D) bf16 as a 3-D tensor map with boxes of rows x one swizzle
// span; elements outside the tensor read as zero
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int heads, int S, int rows) {
  using T = Tile<D>;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)T::COLS, (cuuint32_t)rows, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      T::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : T::ROWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int BKV, int Sq, int Skv, int causal, int window,
           cudaStream_t stream) {
  using T = Tile<D>;
  static_assert(T::SMEM <= MAX_SMEM, "fa_wgmma_kernel: shared memory");
  static bool configured = false;
  // TMA takes 16-byte aligned tensors
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorMisalignedAddress;
  const int n_qb = (Sq + BQ - 1) / BQ;
  if ((long long)BH * n_qb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        fa_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  CUtensorMap tq, tk, tv;
  if (!make_map<D>(&tq, q, BH, Sq, 64) || !make_map<D>(&tk, k, BKV, Skv, T::BK) ||
      !make_map<D>(&tv, v, BKV, Skv, T::BK))
    return (int)cudaErrorInvalidValue;
  // rounded once from double, as the TPU wrapper's 1.0 / math.sqrt(d)
  const float scale = (float)(1.0 / sqrt((double)D));
  fa_wgmma_kernel<D><<<(unsigned)BH * n_qb, THREADS, T::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), BH, BH / BKV, Sq, Skv,
      n_qb, causal, window, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int BH,
             int BKV, int Sq, int Skv, int causal, int window, int dtype,
             cudaStream_t s) {
  if (dtype == 0)
    return ffma::launch<D>(q, k, v, out, BH, BKV, Sq, Skv, causal, window, s);
  if (dtype == 1)
    return tc::launch<D>(q, k, v, out, BH, BKV, Sq, Skv, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32 (the FFMA kernel), 1 bfloat16 (the wgmma kernel).
// Returns a cudaError_t (0 on success).
int launch_flash_attention(const void* q, const void* k, const void* v,
                           void* out, int BH, int BKV, int Sq, int Skv, int D,
                           int causal, int window, int dtype, void* stream) {
  if (BH < 1 || BKV < 1 || BH % BKV || Sq < 1 || Skv < 1 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<16>(q, k, v, out, BH, BKV, Sq, Skv, causal, window, dtype, s);
    case 32: return launch_d<32>(q, k, v, out, BH, BKV, Sq, Skv, causal, window, dtype, s);
    case 64: return launch_d<64>(q, k, v, out, BH, BKV, Sq, Skv, causal, window, dtype, s);
    case 128: return launch_d<128>(q, k, v, out, BH, BKV, Sq, Skv, causal, window, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
