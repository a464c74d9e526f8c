// Max-min fair bandwidth sharing (progressive filling) for Hopper (sm_90a).
//
//   maxmin_rates  replaces repro/kernels/bandwidth_share.py::_waterfill_kernel
//                 (wrapper maxmin_rates_pallas)
//
// Two kernels, picked by (F, L) alone:
//   - maxmin_warp_kernel for F <= 32 and L <= 32 (tiered_grid's (32, 4)):
//     one warp per lane, 8 lanes a CTA, no block barrier;
//   - maxmin_kernel for the rest (the one-lane tabled orders, F >= 44, and
//     the 64-pod workload's (128, 64)): one CTA per lane.
// Each lane b holds F flows over L links, (F, L) 0/1 incidence, (L,)
// capacities and (F,) active flags, and gets (F,) fair rates. The L rounds
// of progressive filling run inside the kernel: per link the count of
// unfrozen flows and the sum of frozen rates, the min over links (the
// level), then per flow the freeze. A round that freezes nothing leaves the
// state as it was, so every later round would too: the loop stops there,
// which gives the same bits as running all L rounds.
//
// maxmin_warp_kernel: thread x of a warp is flow x and link x. The lane's
// incidence is read once, coalesced, into the warp's slice of shared
// memory; thread x keeps column x (link x's flows) in registers, the bits
// of its nonzero entries, and the bits of row x (flow x's links, by 32
// ballots). A round is then: the unfrozen flows' bits by one ballot, each
// link's count a __popc of them and its column's bits (exact: the
// incidence is 0/1); the frozen rates staged in the warp's slice of shared
// memory, and thread l's serial sum over them; the fair share; the level a
// butterfly min read from thread 0 (as maxmin_kernel's block min, so even
// a +0/-0 tie gives the same bits); the bottleneck links' bits by a
// ballot, each flow's freeze an AND with its row's bits; __any_sync ends
// the loop. Only __syncwarp orders the shared memory.
//
// maxmin_kernel: the lane's incidence in shared memory (row stride L or
// L + 1, odd, so the per-flow pass over links is free of bank conflicts);
// per link the count and the sum (one thread per link), a block min for
// the level, then per flow the freeze (one thread per flow).
//
// What bounds them on this card: a call moves 4 * (F * L + L + F) + F
// bytes per lane and does about 4 * F * L float operations per round
// (0.000421 ms of bytes at 2048 lanes of (32, 4)), so at the main path's
// shapes (F <= 128, L <= 64) they are bound by latency: the launch, the
// rounds' dependent chain (each link's serial sum over flows) and, in
// maxmin_kernel, the barriers of each round.
//
// Bits: the result equals the plain version (kernels/ref.py::maxmin_rates)
// bit for bit. The per-link sum of frozen rates runs in the plain version's
// order, which the host passes (kernels/ref.py::FlowOrder): eight lane
// accumulators over a head of V flows in a given block order, added by
// halves, then the other flows in 1, 2, 4 or 8 interleaved sums, then the
// last T flows one at a time (V = 0: left to right). For F <= 32 the order
// is always left to right (ref.flow_order: the tabled orders start at 44
// flows), and the warp kernel takes no other. Every add, multiply and
// divide is an IEEE round-to-nearest intrinsic, so nothing is contracted
// into a fused multiply-add; the constants are float literals, so no
// comparison is promoted to double. The unfrozen counts are sums of 0/1
// values, exact in any order. The min propagates NaN as torch.amin does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float EPS = 1e-6f;
constexpr float BIG = 3.0e38f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ORDER_BLOCKS = 32;   // a byte per block index, 4 u64 words
// one block's shared memory on H100 less maxmin_kernel's static s_min
constexpr int MAX_SMEM = 232448 - WARPS * (int)sizeof(float);
constexpr int WARP_MAX = 32;           // flows and links the warp kernel takes
constexpr int WARP_LANES = 8;          // lanes (warps) a CTA of the warp kernel

__host__ __device__ int row_stride(int L) { return L | 1; }

__host__ __device__ size_t smem_bytes(int F, int L) {
  // inc (F * ld), rate * frozen, rate (F each), fair, bw (L each) as float;
  // active, frozen (F each) as bytes
  return sizeof(float) * ((size_t)F * row_stride(L) + 2 * (size_t)F +
                          2 * (size_t)L) + 2 * (size_t)F;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// The head's block order: block index k in byte k % 8 of word k / 8.
struct BlockOrder {
  unsigned long long w[MAX_ORDER_BLOCKS / 8];
  __device__ __forceinline__ int at(int k) const {
    return (int)((w[k >> 3] >> (8 * (k & 7))) & 255ull);
  }
};

__device__ __forceinline__ float term(const float* inc, int ld,
                                      const float* rf, int f, int l) {
  return __fmul_rn(inc[f * ld + l], rf[f]);
}

// The sum over flows of inc[f][l] * rf[f] in the plain version's order
// (kernels/ref.py::FlowOrder): eight lane accumulators over the first V
// flows, each lane's blocks in `chains` runs summed in turn, the lanes added
// by halves; then the flows V .. F - T - 1 in W interleaved sums (lane 0
// starting from the head's total), added by halves; then the last T flows
// one at a time. V = 0: left to right.
__device__ float frozen_sum(const float* inc, int ld, const float* rf, int F,
                            int l, int V, const BlockOrder& order,
                            int chains, int W, int T) {
  if (V == 0) {
    float acc = term(inc, ld, rf, 0, l);
    for (int f = 1; f < F; ++f) acc = __fadd_rn(acc, term(inc, ld, rf, f, l));
    return acc;
  }
  const int run = V / 8 / chains;
  float lane[8];
  for (int c = 0; c < chains; ++c) {
    float part[8];
    const int b0 = order.at(c * run);
#pragma unroll
    for (int j = 0; j < 8; ++j) part[j] = term(inc, ld, rf, 8 * b0 + j, l);
    for (int k = c * run + 1; k < (c + 1) * run; ++k) {
      const int bk = order.at(k);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        part[j] = __fadd_rn(part[j], term(inc, ld, rf, 8 * bk + j, l));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      lane[j] = c == 0 ? part[j] : __fadd_rn(lane[j], part[j]);
  }
  for (int h = 4; h >= 1; h >>= 1)
    for (int j = 0; j < h; ++j) lane[j] = __fadd_rn(lane[j], lane[j + h]);
  // the tail: lane[0] holds the head's total
  const int E = F - T;
  for (int k = 1; k < W; ++k) lane[k] = term(inc, ld, rf, V + k, l);
  if (V < E) lane[0] = __fadd_rn(lane[0], term(inc, ld, rf, V, l));
  for (int f = V + W; f < E; ++f) {
    const int k = (f - V) % W;
    lane[k] = __fadd_rn(lane[k], term(inc, ld, rf, f, l));
  }
  for (int h = W / 2; h >= 1; h >>= 1)
    for (int j = 0; j < h; ++j) lane[j] = __fadd_rn(lane[j], lane[j + h]);
  for (int f = E; f < F; ++f)
    lane[0] = __fadd_rn(lane[0], term(inc, ld, rf, f, l));
  return lane[0];
}

__global__ void __launch_bounds__(THREADS)
maxmin_kernel(const float* __restrict__ inc, const float* __restrict__ bw,
              const uint8_t* __restrict__ active, float* __restrict__ out,
              int F, int L, int V, BlockOrder order, int chains,
              int W, int T) {
  extern __shared__ float smem[];
  const int ld = row_stride(L);
  float* s_inc = smem;
  float* s_rf = s_inc + (size_t)F * ld;
  float* s_rate = s_rf + F;
  float* s_fair = s_rate + F;
  float* s_bw = s_fair + L;
  uint8_t* s_act = reinterpret_cast<uint8_t*>(s_bw + L);
  uint8_t* s_frz = s_act + F;
  __shared__ float s_min[WARPS];

  const size_t b = blockIdx.x;
  const float* g_inc = inc + b * F * L;
  const uint8_t* g_act = active + b * F;
  for (int f = threadIdx.x; f < F; f += THREADS) {
    const bool a = g_act[f] != 0;
    s_act[f] = a;
    s_frz[f] = !a;
    s_rate[f] = 0.f;
    s_rf[f] = 0.f;
  }
  for (int l = threadIdx.x; l < L; l += THREADS) s_bw[l] = bw[b * L + l];
  for (int i = threadIdx.x; i < F * L; i += THREADS) {
    const int f = i / L;
    const int l = i - f * L;
    s_inc[f * ld + l] = __fmul_rn(g_inc[i], g_act[f] ? 1.f : 0.f);
  }
  __syncthreads();

  for (int round = 0; round < L; ++round) {
    // per link: unfrozen flows, frozen rates, fair share
    float my_min = INFINITY;
    for (int l = threadIdx.x; l < L; l += THREADS) {
      float n_unf = 0.f;
      for (int f = 0; f < F; ++f) {
        const float unf = (s_act[f] && !s_frz[f]) ? 1.f : 0.f;
        n_unf = __fadd_rn(n_unf, __fmul_rn(s_inc[f * ld + l], unf));
      }
      const float used =
          frozen_sum(s_inc, ld, s_rf, F, l, V, order, chains, W, T);
      float resid = __fsub_rn(s_bw[l], used);
      resid = resid < 0.f ? 0.f : resid;
      float fair = n_unf > 0.f
          ? __fdiv_rn(resid, n_unf < 1.f ? 1.f : n_unf) : BIG;
      if (s_bw[l] <= 0.f && n_unf > 0.f) fair = 0.f;
      s_fair[l] = fair;
      my_min = min_nan(my_min, fair);
    }
    // block min: the level
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      my_min = min_nan(my_min, __shfl_xor_sync(0xffffffffu, my_min, off));
    if ((threadIdx.x & 31) == 0) s_min[threadIdx.x >> 5] = my_min;
    __syncthreads();
    float level = s_min[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) level = min_nan(level, s_min[w]);
    const float thresh = __fadd_rn(level, EPS);

    // per flow: freeze the unfrozen flows that cross a bottleneck link
    int froze = 0;
    for (int f = threadIdx.x; f < F; f += THREADS) {
      if (s_act[f] && !s_frz[f]) {
        bool hit = false;
        for (int l = 0; l < L && !hit; ++l)
          hit = s_inc[f * ld + l] > 0.f && s_fair[l] <= thresh;
        if (hit) {
          s_rate[f] = level;
          s_frz[f] = 1;
          froze = 1;
        }
      }
      s_rf[f] = __fmul_rn(s_rate[f], s_frz[f] ? 1.f : 0.f);
    }
    if (!__syncthreads_or(froze)) break;
  }

  float* g_out = out + b * F;
  for (int f = threadIdx.x; f < F; f += THREADS)
    g_out[f] = s_act[f] ? s_rate[f] : 0.f;
}

__global__ void __launch_bounds__(32 * WARP_LANES)
maxmin_warp_kernel(const float* __restrict__ inc, const float* __restrict__ bw,
                   const uint8_t* __restrict__ active,
                   float* __restrict__ out, int B, int F, int L) {
  __shared__ float s_inc[WARP_LANES][WARP_MAX * WARP_MAX];
  __shared__ float s_rf[WARP_LANES][32];
  const unsigned FULL = 0xffffffffu;
  const int wl = threadIdx.x >> 5, x = threadIdx.x & 31;
  const size_t b = (size_t)blockIdx.x * WARP_LANES + wl;
  if (b >= (size_t)B) return;   // a whole warp: no barrier below
  float* my_inc = s_inc[wl];
  float* my_rf = s_rf[wl];

  const float* g_inc = inc + b * F * L;
  for (int i = x; i < F * L; i += 32) my_inc[i] = g_inc[i];
  const bool act = x < F && active[b * F + x] != 0;
  const unsigned act_bits = __ballot_sync(FULL, act);
  const float bwl = x < L ? bw[b * L + x] : 0.f;
  __syncwarp();

  // link x: its column of the incidence (times the active flags) and the
  // bits of its nonzero entries; flow x: the bits of its row
  float col[WARP_MAX];
  unsigned colbits = 0u;
#pragma unroll
  for (int f = 0; f < WARP_MAX; ++f) {
    col[f] = (f < F && x < L)
        ? __fmul_rn(my_inc[f * L + x], (act_bits >> f) & 1u ? 1.f : 0.f)
        : 0.f;
    colbits |= (col[f] > 0.f ? 1u : 0u) << f;
  }
  unsigned rowbits = 0u;
#pragma unroll
  for (int f = 0; f < WARP_MAX; ++f) {
    const unsigned r = __ballot_sync(FULL, (colbits >> f) & 1u);
    if (x == f) rowbits = r;
  }

  float rate = 0.f;
  bool frozen = !act;
  for (int round = 0; round < L; ++round) {
    const bool unf = act && !frozen;
    const unsigned unf_bits = __ballot_sync(FULL, unf);
    my_rf[x] = __fmul_rn(rate, frozen ? 1.f : 0.f);
    __syncwarp();
    // per link: unfrozen flows, frozen rates left to right, fair share
    float fair = INFINITY;
    if (x < L) {
      const float n_unf = (float)__popc(unf_bits & colbits);
      float used = __fmul_rn(col[0], my_rf[0]);
#pragma unroll
      for (int f = 1; f < WARP_MAX; ++f)
        if (f < F) used = __fadd_rn(used, __fmul_rn(col[f], my_rf[f]));
      float resid = __fsub_rn(bwl, used);
      resid = resid < 0.f ? 0.f : resid;
      fair = n_unf > 0.f ? __fdiv_rn(resid, n_unf < 1.f ? 1.f : n_unf) : BIG;
      if (bwl <= 0.f && n_unf > 0.f) fair = 0.f;
    }
    __syncwarp();   // the frozen rates are read before the next round's
    // the level: thread 0's butterfly min, as maxmin_kernel's
    float level = fair;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      level = min_nan(level, __shfl_xor_sync(FULL, level, off));
    level = __shfl_sync(FULL, level, 0);
    const float thresh = __fadd_rn(level, EPS);
    // per flow: freeze the unfrozen flows that cross a bottleneck link
    const unsigned bottleneck = __ballot_sync(FULL, x < L && fair <= thresh);
    const bool newly = unf && (rowbits & bottleneck) != 0u;
    if (newly) {
      rate = level;
      frozen = true;
    }
    if (!__any_sync(FULL, newly)) break;
  }
  if (x < F) out[b * F + x] = act ? rate : 0.f;
}

bool takes_warp(int F, int L) { return F <= WARP_MAX && L <= WARP_MAX; }

}  // namespace

extern "C" {

// Shared memory one lane of (F, L) takes; the wrapper refuses shapes above
// maxmin_max_smem().
long long maxmin_smem_bytes(int n_flows, int n_links) {
  return (long long)smem_bytes(n_flows, n_links);
}

int maxmin_max_smem() { return MAX_SMEM; }

int maxmin_max_order_blocks() { return MAX_ORDER_BLOCKS; }

// 1 if (F, L) runs maxmin_warp_kernel (which sums left to right only),
// 0 if maxmin_kernel.
int maxmin_takes_warp(int n_flows, int n_links) {
  return takes_warp(n_flows, n_links) ? 1 : 0;
}

// maxmin_warp_kernel's resident CTAs per SM.
int maxmin_warp_blocks_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, maxmin_warp_kernel, 32 * WARP_LANES, 0) != cudaSuccess)
    return -1;
  return n;
}

// inc (B, F, L) f32, bw (B, L) f32, active (B, F) bool (one byte) -> out
// (B, F) f32. (n_head, order0..3, chains, tail_lanes, trailing): the
// flow-sum order of kernels/ref.py::FlowOrder, n_head a multiple of 8 up to
// 8 * MAX_ORDER_BLOCKS (0: left to right), byte k % 8 of order<k / 8> the
// block summed k-th. F <= 32 and L <= 32 run maxmin_warp_kernel and take
// left to right only; the rest run maxmin_kernel.
int launch_maxmin_rates(const float* inc, const float* bw,
                        const uint8_t* active, float* out, int n_lanes,
                        int n_flows, int n_links, int n_head,
                        unsigned long long order0, unsigned long long order1,
                        unsigned long long order2, unsigned long long order3,
                        int chains, int tail_lanes, int trailing,
                        void* stream) {
  const BlockOrder order{{order0, order1, order2, order3}};
  const size_t smem = smem_bytes(n_flows, n_links);
  const int tail = n_flows - n_head - trailing;
  if (n_lanes < 1 || n_flows < 1 || n_links < 1 || smem > MAX_SMEM ||
      n_head < 0 || n_head % 8 != 0 || tail < 0 ||
      n_head / 8 > MAX_ORDER_BLOCKS || chains < 1 ||
      (n_head > 0 && (n_head / 8) % chains != 0) ||
      (tail_lanes != 1 && tail_lanes != 2 && tail_lanes != 4 &&
       tail_lanes != 8) ||
      (tail_lanes > 1 &&
       (tail < tail_lanes || tail % tail_lanes != 0 || n_head == 0)) ||
      (n_head == 0 && (chains != 1 || trailing != 0)) || trailing < 0)
    return (int)cudaErrorInvalidValue;
  if (takes_warp(n_flows, n_links)) {
    if (n_head != 0) return (int)cudaErrorInvalidValue;
    const int n_cta = (n_lanes + WARP_LANES - 1) / WARP_LANES;
    maxmin_warp_kernel<<<n_cta, 32 * WARP_LANES, 0, (cudaStream_t)stream>>>(
        inc, bw, active, out, n_lanes, n_flows, n_links);
    return (int)cudaGetLastError();
  }
  // dynamic shared memory past 48 KB needs the kernel's attribute raised
  // (to what this launch needs: with the static s_min, no more than a
  // block holds)
  static size_t configured = 48 * 1024;
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        maxmin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  maxmin_kernel<<<n_lanes, THREADS, smem, (cudaStream_t)stream>>>(
      inc, bw, active, out, n_flows, n_links, n_head, order, chains,
      tail_lanes, trailing);
  return (int)cudaGetLastError();
}

}  // extern "C"
