// Window front-end kernels of the conservative-window DES engine, for Hopper
// (sm_90a). Six integer kernels, one CTA per agent over (A, n) rows:
//
//   select_events  replaces repro/kernels/event_select.py::_sort_kernel
//                  (wrappers _run_sort / select_events / sort_events)
//   group_by_kind  replaces repro/kernels/event_select.py::_group_kernel
//   trace_rank     replaces repro/kernels/event_select.py::_trace_rank_kernel
//   route_rank     replaces repro/kernels/event_select.py::_route_rank_kernel
//   ring_slots     replaces repro/kernels/event_select.py::_ring_slots_kernel
//   fused_select   replaces repro/kernels/event_select.py::_fused_select_kernel
//
// What bounds them on this card: none moves more than a few hundred KB or
// does more than a few million integer operations per call, so each call is
// bound by latency (one launch, one CTA's chain of __syncthreads) rather than
// by HBM bytes or issue rate. The design keeps every intermediate in shared
// memory or registers, reads each input once and writes each output once,
// and replaces the TPU kernels' vector-unit workarounds (reshape-and-swap
// exchanges, chunked one-hot compares and gathers, the O(n^2) predecessor
// count) with warp ballots and matches, popc, block-wide scans and direct
// gathers.
// select_events and fused_select, which need only the first m of each
// agent's order, select them by one code (radix_select): a radix pass per
// key byte, then a sort of only the candidates (at most the power of two
// >= 2m) instead of the whole pool; sort_events and a large m keep the full
// bitonic sort (sort_slots). fused_select finds its conflicts by sorting
// the window's conflict keys with the same networks, not by a pairwise scan.
//
// Every entry point is a plain C function that launches on the given stream
// and returns cudaGetLastError(), so a refused launch is reported to the
// caller. No float arithmetic happens here: float payload words move as
// 32-bit integers, so every bit pattern (NaNs included) survives. Integer
// arithmetic that the reference does in int32 wraps here as it does there
// (computed in uint32), and its modulo is a floor modulo, as jnp's.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MAX_WARPS = 32;   // 1024 threads
constexpr int MAX_KEYS = 64;    // fused group: n_kinds + 1 <= 33; route: A + 1
constexpr int32_t I32_MAX = 0x7fffffff;
constexpr int32_t I32_MIN = -I32_MAX - 1;
constexpr int MAX_SORT_SLOTS = 16384;   // 12 B a slot in one block

__device__ __forceinline__ bool lex_less(int32_t t1, int32_t s1, int32_t i1,
                                         int32_t t2, int32_t s2, int32_t i2) {
  return (t1 < t2) || (t1 == t2 && (s1 < s2 || (s1 == s2 && i1 < i2)));
}

// ---------------------------------------------------------------- select
// Bitonic network over n (a power of two) (t, s, ix) triples in shared
// memory, ascending by lex_less; every thread calls it, and it ends after a
// barrier (none when n == 1). With distinct ix the order is total.
__device__ void bitonic_smem(int32_t* t, int32_t* s, int32_t* ix, int n) {
  const int half = n >> 1;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j >= 1; j >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int lo = (p / j) * 2 * j + (p % j);
        const int hi = lo + j;
        const bool ascend = (lo & k) == 0;
        const bool hi_first = lex_less(t[hi], s[hi], ix[hi], t[lo], s[lo], ix[lo]);
        if (hi_first == ascend) {
          int32_t x;
          x = t[lo]; t[lo] = t[hi]; t[hi] = x;
          x = s[lo]; s[lo] = s[hi]; s[hi] = x;
          x = ix[lo]; ix[lo] = ix[hi]; ix[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

// Bitonic sort of (time_key, seq, index) in dynamic shared memory (12 B per
// slot, padded to the next power of two with (I32_MAX, I32_MAX, i >= cap)).
// Indices are distinct, so the order is total and equals the stable
// (time, seq) lexsort with ties broken by slot index. On return (after a
// barrier) ix[0..n_pad) holds the sorted slot indices.
__device__ void sort_slots(const int32_t* __restrict__ time_key,
                           const int32_t* __restrict__ seq, int cap,
                           int n_pad, int32_t* t, int32_t* s, int32_t* ix) {
  for (int i = threadIdx.x; i < n_pad; i += blockDim.x) {
    if (i < cap) {
      t[i] = time_key[i];
      s[i] = seq[i];
    } else {
      t[i] = I32_MAX;
      s[i] = I32_MAX;
    }
    ix[i] = i;
  }
  __syncthreads();
  bitonic_smem(t, s, ix, n_pad);
}

// sort_events (and select_events with 2m > min(n_pad, RADIX_CAND)): the
// whole bitonic sort, the first m indices written out.
__global__ void sort_events_kernel(const int32_t* __restrict__ time_key,
                                   const int32_t* __restrict__ seq,
                                   int32_t* __restrict__ out, int cap,
                                   int n_pad, int m) {
  extern __shared__ int32_t smem[];
  int32_t* ix = smem + 2 * n_pad;
  const int a = blockIdx.x;
  sort_slots(time_key + (size_t)a * cap, seq + (size_t)a * cap, cap, n_pad,
             smem, smem + n_pad, ix);
  out += (size_t)a * m;
  for (int i = threadIdx.x; i < m; i += blockDim.x) out[i] = ix[i];
}

// The radix selection of the first m slots (2m <= min(n_pad, RADIX_CAND)),
// shared by select_events and fused_select: one CTA of RADIX_THREADS per
// agent, thread t holding slots t * IPT .. t * IPT + IPT - 1 (slot order is
// thread order, then item order).
//   1. key = (time_key ^ 2^31) << 32 | (seq ^ 2^31): unsigned order is the
//      signed (time, seq) order (seq wraps negative in the reference).
//   2. Most significant byte first, over the keys that still match the
//      prefix: a shared histogram of the next byte (lanes of one bin added
//      by __match_any_sync, one atomic each), one warp's scan finds the bin
//      of the k-th key; `below` counts the keys under the prefix, `eq` those
//      in it. Stop once below + eq <= bound (the least power of two >= 2m)
//      or after the last byte (the boundary key itself).
//   3. Compact the candidates by one block scan of (below, equal) counts in
//      slot order: every key under the prefix, then the keys in it: all of
//      them when they fit the bound, else (last byte, so all equal to the
//      boundary key) the first k in slot order, which is what breaks ties by
//      slot index.
//   4. Bitonic sort of the candidates (key, slot), one a thread, exchanges
//      of distance < 32 by warp shuffles and the others through shared
//      memory; thread t then holds the t-th slot of the order.
constexpr int RADIX_THREADS = 1024;
constexpr int RADIX_CAND = 1024;   // candidates, one a thread
constexpr uint64_t KEY_MAX = ~0ull;

struct RadixState {
  uint64_t prefix;
  int shift, k, below, eq;
};

struct RadixSmem {
  int hist[256];
  int warp_tot[MAX_WARPS];
  RadixState st;
  uint64_t sk[2][RADIX_CAND];
  int32_t si[2][RADIX_CAND];
};

// the least power of two >= 2m: the candidates the selection may keep
int radix_bound(int m) {
  int bound = 1;
  while (bound < 2 * m) bound <<= 1;
  return bound;
}

__device__ __forceinline__ uint64_t order_key(int32_t t, int32_t s) {
  return ((uint64_t)((uint32_t)t ^ 0x80000000u) << 32) |
         (uint64_t)((uint32_t)s ^ 0x80000000u);
}

// key >> shift, for shift in [0, 64]
__device__ __forceinline__ uint64_t key_top(uint64_t key, int shift) {
  return shift >= 64 ? 0ull : key >> shift;
}

// Block-wide exclusive scan of v (thread order); every thread calls it.
__device__ int block_excl_scan(int v, int* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    int t = lane < n_warps ? warp_tot[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, t, off);
      if (lane >= off) t += y;
    }
    if (lane < n_warps) warp_tot[lane] = t;
  }
  __syncthreads();
  return incl - v + (warp > 0 ? warp_tot[warp - 1] : 0);
}

// One-a-thread bitonic network over the (key, index) pairs of the block's
// first n threads (n a power of two <= RADIX_CAND), ascending by (key,
// index): exchanges of distance < 32 by warp shuffles, the others through
// sk and si. Every thread of the block calls it.
__device__ void bitonic_regs(uint64_t& kv, int32_t& iv, int n,
                             uint64_t (*sk)[RADIX_CAND],
                             int32_t (*si)[RADIX_CAND]) {
  const int tid = threadIdx.x;
  int buf = 1;
  for (int size = 2; size <= n; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      uint64_t pk;
      int32_t pi;
      if (j >= 32) {
        sk[buf][tid] = kv;
        si[buf][tid] = iv;
        __syncthreads();
        pk = sk[buf][tid ^ j];
        pi = si[buf][tid ^ j];
        buf ^= 1;
      } else {
        pk = __shfl_xor_sync(FULL_MASK, kv, j);
        pi = __shfl_xor_sync(FULL_MASK, iv, j);
      }
      const bool p_less = pk < kv || (pk == kv && pi < iv);
      const bool keep_min = ((tid & j) == 0) == ((tid & size) == 0);
      if (p_less == keep_min) {
        kv = pk;
        iv = pi;
      }
    }
  }
}

// Steps 1-4 over one agent's cap slots; returns the slot of order position
// threadIdx.x (meaningful for threadIdx.x < m). Every thread calls it.
template <int IPT>
__device__ int32_t radix_select(const int32_t* __restrict__ time_key,
                                const int32_t* __restrict__ seq, int cap,
                                int m, int bound, RadixSmem& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = tid * IPT;

  // 1. keys
  uint64_t key[IPT];
#pragma unroll
  for (int i = 0; i < IPT; ++i)
    key[i] = base + i < cap ? order_key(time_key[base + i], seq[base + i])
                            : KEY_MAX;

  // 2. digit passes; the state is block-uniform (read after a barrier)
  uint64_t prefix = 0;
  int shift = 64, k = m, below = 0, eq = cap;
  while (shift > 0 && below + eq > bound) {
    for (int b = tid; b < 256; b += blockDim.x) sm.hist[b] = 0;
    __syncthreads();
    const int next = shift - 8;
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      const bool in = base + i < cap && key_top(key[i], shift) == prefix;
      const unsigned act = __ballot_sync(FULL_MASK, in);
      if (in) {
        const unsigned d = (unsigned)(key[i] >> next) & 255u;
        const unsigned peers = __match_any_sync(act, d);
        if (lane == __ffs(peers) - 1) atomicAdd(&sm.hist[d], __popc(peers));
      }
    }
    __syncthreads();
    if (warp == 0) {
      int c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = sm.hist[8 * lane + j];
        sum += c[j];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FULL_MASK, incl, off);
        if (lane >= off) incl += y;
      }
      int excl = incl - sum;
      if (excl < k && k <= incl) {   // one lane: its bins hold the k-th key
        int j = 0;
        while (excl + c[j] < k) excl += c[j++];
        sm.st = RadixState{(prefix << 8) | (uint64_t)(8 * lane + j), next,
                           k - excl, below + excl, c[j]};
      }
    }
    __syncthreads();
    prefix = sm.st.prefix;
    shift = sm.st.shift;
    k = sm.st.k;
    below = sm.st.below;
    eq = sm.st.eq;
  }

  // 3. stable compaction: under the prefix to [0, below), in it after
  const int n_eq = below + eq <= bound ? eq : k;
  const int n_cand = below + n_eq;
  int lt_n = 0, eq_n = 0;
#pragma unroll
  for (int i = 0; i < IPT; ++i) {
    if (base + i < cap) {
      const uint64_t t = key_top(key[i], shift);
      lt_n += t < prefix;
      eq_n += t == prefix;
    }
  }
  const int pos = block_excl_scan(lt_n | (eq_n << 16), sm.warp_tot);
  int lt_pos = pos & 0xffff, eq_pos = pos >> 16;
#pragma unroll
  for (int i = 0; i < IPT; ++i) {
    if (base + i < cap) {
      const uint64_t t = key_top(key[i], shift);
      int p = -1;
      if (t < prefix)
        p = lt_pos++;
      else if (t == prefix && eq_pos++ < n_eq)
        p = below + eq_pos - 1;
      if (p >= 0) {
        sm.sk[0][p] = key[i];
        sm.si[0][p] = base + i;
      }
    }
  }
  __syncthreads();

  // 4. bitonic sort of the n_cand candidates, padded to a power of two
  uint64_t kv = tid < n_cand ? sm.sk[0][tid] : KEY_MAX;
  int32_t iv = tid < n_cand ? sm.si[0][tid] : I32_MAX;
  int n = 1;
  while (n < n_cand) n <<= 1;
  bitonic_regs(kv, iv, n, sm.sk, sm.si);
  return iv;
}

// select_events with 2m <= min(n_pad, RADIX_CAND): the radix selection,
// the first m slots written out.
template <int IPT>
__global__ void __launch_bounds__(RADIX_THREADS)
select_events_kernel(const int32_t* __restrict__ time_key,
                     const int32_t* __restrict__ seq,
                     int32_t* __restrict__ out, int cap, int m, int bound) {
  __shared__ RadixSmem sm;
  const int a = blockIdx.x;
  const int32_t slot = radix_select<IPT>(time_key + (size_t)a * cap,
                                         seq + (size_t)a * cap, cap, m, bound,
                                         sm);
  if (threadIdx.x < m) out[(size_t)a * m + threadIdx.x] = slot;
}

// The radix kernels' template argument: slots a thread, the least of 1, 2,
// 4, 8, 16 that covers cap with RADIX_THREADS threads. f(IPT) launches.
template <typename F>
int radix_dispatch(int cap, F&& f) {
  const int ipt = (cap + RADIX_THREADS - 1) / RADIX_THREADS;
  if (ipt <= 1)
    f(std::integral_constant<int, 1>());
  else if (ipt <= 2)
    f(std::integral_constant<int, 2>());
  else if (ipt <= 4)
    f(std::integral_constant<int, 4>());
  else if (ipt <= 8)
    f(std::integral_constant<int, 8>());
  else if (ipt <= 16)
    f(std::integral_constant<int, 16>());
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// ------------------------------------------------- stable per-key ranks
// For one chunk of blockDim rows (one row per thread, key < 0 for rows past
// the end), each row's stable rank among rows of the same key, counting the
// rows of earlier chunks through carry[key]. One ballot per key per warp,
// then a sum of the earlier warps' totals. blockDim is a multiple of 32, so
// every warp is full for __ballot_sync.
__device__ int chunk_rank(int key, int n_keys, int* warp_tot, int* carry) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  int mine = 0;
  for (int g = 0; g < n_keys; ++g) {
    const unsigned b = __ballot_sync(FULL_MASK, key == g);
    if (key == g) mine = __popc(b & lt);
    if (lane == 0) warp_tot[warp * MAX_KEYS + g] = __popc(b);
  }
  __syncthreads();
  int rank = -1;
  if (key >= 0) {
    rank = carry[key] + mine;
    for (int w = 0; w < warp; ++w) rank += warp_tot[w * MAX_KEYS + key];
  }
  __syncthreads();
  for (int g = threadIdx.x; g < n_keys; g += blockDim.x) {
    int sum = 0;
    for (int w = 0; w < n_warps; ++w) sum += warp_tot[w * MAX_KEYS + g];
    carry[g] += sum;
  }
  __syncthreads();
  return rank;
}

// ------------------------------------------------------------- group
// key = clip(kind, 0, n_kinds-1) if active else n_kinds (at most 33 keys).
// Warp w owns the contiguous segment of `steps` 32-row steps from row
// 32 * steps * w, so segments are in position order; steps is 1 up to m =
// blockDim (the main path, m = 256: every key read once, kept in a
// register). One __syncthreads in all:
//   1. each warp counts its segment's rows of each key: __match_any_sync on
//      the key gives a row's peers (rank = peers below its lane), and each
//      group's lowest lane adds the group's size to the warp's row of cnt
//      (a warp-private row: no atomics);
//   2. after the barrier, lane g of every warp reads column g of cnt: the
//      key's rows in earlier warps and in all, a shuffle scan over the keys
//      gives the key starts, and the warp writes its row of positions
//      (start + rows in earlier warps); warp 0 writes the counts;
//   3. each row goes to its key's next position in its warp, plus its rank
//      among its peers: order[p] = i, rank[p] = p - start[key].
// The active mask is read as it comes: int32 or one byte a row.
constexpr int GROUP_KEYS = 33;   // n_kinds <= 32

template <typename M>
__device__ __forceinline__ int group_key(const int32_t* kind, const M* active,
                                         int i, int m, int n_kinds) {
  if (i >= m) return -1;
  return active[i] != 0 ? min(max(kind[i], 0), n_kinds - 1) : n_kinds;
}

template <typename M>
__global__ void group_by_kind_kernel(const int32_t* __restrict__ kind,
                                     const M* __restrict__ active,
                                     int32_t* __restrict__ order,
                                     int32_t* __restrict__ rank_out,
                                     int32_t* __restrict__ counts,
                                     int m, int n_kinds) {
  __shared__ int cnt[MAX_WARPS][GROUP_KEYS];   // a warp's rows of each key
  __shared__ int pos[MAX_WARPS][GROUP_KEYS];   // its next position of each
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5, n_keys = n_kinds + 1;
  const size_t a = blockIdx.x;
  kind += a * m;
  active += a * m;
  order += a * m;
  rank_out += a * m;
  counts += a * n_kinds;
  const unsigned lt = (1u << lane) - 1u;
  const int steps = (m + blockDim.x - 1) / blockDim.x;
  const int lo = warp * steps * 32 + lane;

  // 1. counts per warp
  for (int g = lane; g < n_keys; g += 32) cnt[warp][g] = 0;
  __syncwarp();
  int key = -1;
  unsigned peers = 0;
  for (int s = 0; s < steps; ++s) {
    key = group_key(kind, active, lo + 32 * s, m, n_kinds);
    peers = __match_any_sync(FULL_MASK, key);
    if (key >= 0 && lane == __ffs(peers) - 1) cnt[warp][key] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // 2. lane g: key g (and lane 0 also key 32)
  int before0 = 0, tot0 = 0, before1 = 0;
  for (int w = 0; w < n_warps; ++w) {
    const int c0 = lane < n_keys ? cnt[w][lane] : 0;
    if (w < warp) {
      before0 += c0;
      if (lane + 32 < n_keys) before1 += cnt[w][lane + 32];
    }
    tot0 += c0;
  }
  int incl = tot0;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, incl, off);
    if (lane >= off) incl += y;
  }
  const int start0 = incl - tot0;                         // key lane
  const int start1 = __shfl_sync(FULL_MASK, incl, 31);   // key 32
  if (lane < n_keys) pos[warp][lane] = start0 + before0;
  if (lane + 32 < n_keys) pos[warp][lane + 32] = start1 + before1;
  if (warp == 0 && lane < n_kinds) counts[lane] = tot0;
  __syncwarp();

  // 3. placement (steps == 1 keeps the key and peers of step 1)
  for (int s = 0; s < steps; ++s) {
    const int i = lo + 32 * s;
    if (steps > 1) {
      key = group_key(kind, active, i, m, n_kinds);
      peers = __match_any_sync(FULL_MASK, key);
    }
    const int st_lo = __shfl_sync(FULL_MASK, start0, key & 31);
    const int start = key < 32 ? st_lo : start1;
    const int p = key >= 0 ? pos[warp][key] + __popc(peers & lt) : 0;
    if (s + 1 < steps) {
      __syncwarp();
      if (key >= 0 && lane == __ffs(peers) - 1)
        pos[warp][key] += __popc(peers);
      __syncwarp();
    }
    if (key >= 0) {
      order[p] = i;
      rank_out[p] = p - start;
    }
  }
}

// ------------------------------------------------------------- route
// rank[i] counts the earlier rows of row i's bucket (keys in [0, n_buckets),
// n_buckets <= MAX_KEYS; the engine passes agent ids with A the sentinel of
// rows that are not valid), where the TPU kernel counts predecessors
// pairwise, O(n^2). This is group_by_kind's rank written at the row: warp
// w owns the contiguous segment of `steps` 32-row steps from row 32 * steps
// * w (steps = 4 at n = 4096 on 1024 threads, the engine's emit_cap), so
// segments follow row order, and there is one __syncthreads in all:
//   1. per step, walk_step on the warp's own row of cnt: a row's rank among
//      its bucket's rows in the warp (the group's lowest lane hands the
//      running count it read to its peers by a shuffle; a __syncwarp a
//      step). The engine's rows are mostly the sentinel, so most steps are
//      one group;
//   2. after the barrier, lane g sums column g (and g + 32) of the earlier
//      warps' counts, and each row adds its key's sum, taken from lane
//      key & 31 by a shuffle.
// Up to ROUTE_KEPT steps (n <= 4096) keep each step's key and rank in
// registers (template S); more steps (S = 0) re-read the keys and walk the
// segment again from the earlier warps' counts, in a second table (later
// warps still read the first). A key outside [0, n_buckets) breaks the
// contract: it is counted nowhere and reads no table entry, so its rank is
// unspecified and the rows that keep the contract keep their ranks.
// Built with -DROUTE_KEPT=0, every launch walks twice (chip_smoke.py times
// that build against this one).
#ifndef ROUTE_KEPT
#define ROUTE_KEPT 4
#endif

// A warp's step over one row a lane: the row's rank among the rows of its
// key that the warp has walked (run[key] before the step plus its peers
// below its lane); the group's lowest lane moves run[key] on by the
// group's size. A key outside [0, n_keys) reads and moves nothing.
__device__ __forceinline__ int walk_step(int key, int n_keys, int* run) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(FULL_MASK, key);
  const int leader = __ffs(peers) - 1;
  int seen = 0;
  if (lane == leader && (unsigned)key < (unsigned)n_keys) {
    seen = run[key];
    run[key] = seen + __popc(peers);
  }
  seen = __shfl_sync(FULL_MASK, seen, leader);
  __syncwarp();
  return seen + __popc(peers & ((1u << lane) - 1u));
}

template <int S>   // steps kept in registers, or 0: walk the segment twice
__global__ void route_rank_kernel(const int32_t* __restrict__ dst,
                                  int32_t* __restrict__ rank_out, int n,
                                  int n_buckets) {
  __shared__ int cnt[MAX_WARPS][MAX_KEYS];   // a warp's rows of each key
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t a = blockIdx.x;
  dst += a * n;
  rank_out += a * n;
  const int steps = S > 0 ? S : (n + blockDim.x - 1) / blockDim.x;
  const int lo = warp * steps * 32 + lane;
  cnt[warp][lane] = 0;
  cnt[warp][lane + 32] = 0;
  __syncwarp();

  // 1. each warp's counts (S > 0: and each row's rank in the warp)
  int key[S > 0 ? S : 1], rank[S > 0 ? S : 1];
  if constexpr (S > 0) {
#pragma unroll
    for (int s = 0; s < S; ++s)
      key[s] = lo + 32 * s < n ? dst[lo + 32 * s] : -1;
#pragma unroll
    for (int s = 0; s < S; ++s)
      rank[s] = walk_step(key[s], n_buckets, cnt[warp]);
  } else {
    for (int s = 0; s < steps; ++s) {
      const int i = lo + 32 * s;
      walk_step(i < n ? dst[i] : -1, n_buckets, cnt[warp]);
    }
  }
  __syncthreads();

  // 2. lane g: the rows of key g (and of key g + 32) in earlier warps
  const bool wide = n_buckets > 32;
  int before0 = 0, before1 = 0;
  for (int w = 0; w < warp; ++w) {
    before0 += cnt[w][lane];
    if (wide) before1 += cnt[w][lane + 32];
  }
  if constexpr (S > 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = key[s];
      int before = __shfl_sync(FULL_MASK, before0, k & 31);
      if (wide) {
        const int b1 = __shfl_sync(FULL_MASK, before1, k & 31);
        if (k >= 32) before = b1;
      }
      if (lo + 32 * s < n) rank_out[lo + 32 * s] = rank[s] + before;
    }
  } else {
    __shared__ int pos[MAX_WARPS][MAX_KEYS];   // the second walk's counts
    pos[warp][lane] = before0;
    pos[warp][lane + 32] = before1;
    __syncwarp();
    for (int s = 0; s < steps; ++s) {
      const int i = lo + 32 * s;
      const int r = walk_step(i < n ? dst[i] : -1, n_buckets, pos[warp]);
      if (i < n) rank_out[i] = r;
    }
  }
}

// ------------------------------------------------------------- scans
// For one chunk of blockDim rows (one per thread; w false past the end), the
// count of w rows before this one, plus *carry, the count of earlier chunks;
// then *carry grows by the chunk's count. A ballot + popc per warp and a sum
// of the earlier warps' totals. Every thread of the block calls it.
__device__ int chunk_excl_count(bool w, int* warp_tot, int* carry) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned b = __ballot_sync(FULL_MASK, w);
  if (lane == 0) warp_tot[warp] = __popc(b);
  __syncthreads();
  int r = *carry + __popc(b & ((1u << lane) - 1u));
  for (int q = 0; q < warp; ++q) r += warp_tot[q];
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int q = 0; q < n_warps; ++q) sum += warp_tot[q];
    *carry += sum;
  }
  __syncthreads();
  return r;
}

// The floor modulo of x by cap > 0.
__device__ __forceinline__ int floor_mod(int32_t x, int cap) {
  const int r = x % cap;
  return r < 0 ? r + cap : r;
}

// int32 a + b with two's-complement wrap, then the floor modulo by cap > 0.
__device__ __forceinline__ int ring_pos(int32_t a, int32_t b, int cap) {
  return floor_mod((int32_t)((uint32_t)a + (uint32_t)b), cap);
}

// Exclusive prefix count of the mask (int32, or one byte a row: the
// engine's bool mask as it comes, with no int32 copy).
template <typename M>
__global__ void trace_rank_kernel(const M* __restrict__ mask,
                                  int32_t* __restrict__ out, int n) {
  __shared__ int warp_tot[MAX_WARPS];
  __shared__ int carry;
  const int a = blockIdx.x;
  mask += (size_t)a * n;
  out += (size_t)a * n;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int r = chunk_excl_count(i < n && mask[i] != 0, warp_tot, &carry);
    if (i < n) out[i] = r;
  }
}

// ------------------------------------------------------------- ring slots
// Free-ring insert slots: out[i] = ring[(head + rank_i) % cap], rank_i the
// exclusive count of wanted rows before row i (int32 wrap, floor modulo). A
// direct gather replaces the TPU kernel's chunked one-hot selection. Rows
// that are not wanted get the same formula; the engine drops them.
//
// Each thread owns a group of RING_ROWS = 4 consecutive rows whose mask
// bytes share one aligned 32-bit word (group k: rows 4k - lead .. 4k - lead
// + 3, lead the row's byte offset in its word), so a thread reads one word
// (byte loads only in the first and last group of a row that is not
// aligned) and counts it by popc. A tile is blockDim groups (4,096 rows at
// 1,024 threads, the main path): a warp shuffle scan of the counts, one
// warp's scan of the 32 warp totals in shared memory, one barrier pair; a
// larger n loops over tiles with a carry (the totals double-buffered, so
// one pair a tile suffices). The ring position is a floor modulo once a
// thread, then advances by one a wanted row with a compare for the wrap at
// cap; where head + rank steps from 2^31 - 1 to -2^31 (int32 overflow) it
// is worked out again, as the reference computes it. The slots go out as
// one 16-byte store a thread where aligned.
constexpr int RING_ROWS = 4;

// Bit 7 of each byte of x that is nonzero (no carry crosses a byte).
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
}

__global__ void ring_slots_kernel(const int32_t* __restrict__ ring,
                                  const int32_t* __restrict__ head,
                                  const uint8_t* __restrict__ want,
                                  int32_t* __restrict__ out, int cap, int n) {
  __shared__ int warp_tot[2][MAX_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const size_t a = blockIdx.x;
  ring += a * cap;
  want += a * n;
  out += a * n;
  const int32_t h = head[a];
  const int lead = (int)((uintptr_t)want & 3);
  const int n_groups = (n + lead + RING_ROWS - 1) / RING_ROWS;
  int carry = 0;
  for (int base = 0, tile = 0; base < n_groups; base += blockDim.x, ++tile) {
    const int k = base + threadIdx.x;
    const int r0 = RING_ROWS * k - lead;
    const bool whole = r0 >= 0 && r0 + RING_ROWS <= n;
    uint32_t bits = 0;   // bit 7 of byte j: row r0 + j is wanted
    if (whole) {
      bits = nonzero_bytes(*reinterpret_cast<const uint32_t*>(want + r0));
    } else if (k < n_groups) {
#pragma unroll
      for (int j = 0; j < RING_ROWS; ++j)
        if (r0 + j >= 0 && r0 + j < n && want[r0 + j] != 0)
          bits |= 0x80u << (8 * j);
    }
    const int c = __popc(bits);
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, incl, off);
      if (lane >= off) incl += y;
    }
    int* tot = warp_tot[tile & 1];
    if (lane == 31) tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int t = lane < n_warps ? tot[lane] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FULL_MASK, t, off);
        if (lane >= off) t += y;
      }
      if (lane < n_warps) tot[lane] = t;
    }
    __syncthreads();
    const int32_t rank = carry + incl - c + (warp > 0 ? tot[warp - 1] : 0);
    carry += tot[n_warps - 1];
    if (k >= n_groups) continue;

    int32_t x = (int32_t)((uint32_t)h + (uint32_t)rank);
    int p = floor_mod(x, cap);
    int slot[RING_ROWS];
#pragma unroll
    for (int j = 0; j < RING_ROWS; ++j) {
      slot[j] = p;
      if ((bits >> (8 * j + 7)) & 1u) {
        x = (int32_t)((uint32_t)x + 1u);
        p = x == I32_MIN ? floor_mod(x, cap) : (p + 1 == cap ? 0 : p + 1);
      }
    }
    int32_t v[RING_ROWS];
#pragma unroll
    for (int j = 0; j < RING_ROWS; ++j)
      v[j] = r0 + j >= 0 && r0 + j < n ? ring[slot[j]] : 0;
    if (whole && ((uintptr_t)(out + r0) & 15) == 0) {
      *reinterpret_cast<int4*>(out + r0) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < RING_ROWS; ++j)
        if (r0 + j >= 0 && r0 + j < n) out[r0 + j] = v[j];
    }
  }
}

// ------------------------------------------------------------ fused select
// The window front end in one CTA per agent:
//   1. select the first m slots of the (time_key, seq, slot) order, as
//      select_events does: the radix selection (radix_select, one CTA of
//      RADIX_THREADS, thread i holding lane i's slot) when 2m <=
//      min(n_pad, RADIX_CAND), the main path (m = 256 of 4096), else the
//      bitonic sort of 12 B per slot (sort_slots, up to pool_cap 16384).
//      The TPU kernel carries every field (76 B per slot) through its
//      network, which at pool_cap 4096 would need 311,296 B of the 232,448
//      B a block has; here only the keys are ordered, and the m window
//      lanes' fields are gathered from device memory afterwards;
//   2. gather the window lanes by slot (payload words as raw bits) with
//      each lane's rkey = table_id * n_res + res and flags (safe, conflict
//      candidate: safe and table_id > 0, clipped kind << 8);
//   3. conflict: a candidate lane is dirty if another candidate lane has
//      its rkey (the reference's pairwise count >= 2). The lanes are sorted
//      by (rkey, not a candidate, lane) with the same bitonic network as
//      step 1 (one a thread on the radix path, in shared memory on the
//      other), and a candidate is dirty when a sorted neighbour has its
//      rkey and is a candidate: O(m log^2 m) compares, not the m^2 of a
//      pairwise scan;
//   4. group the clean lanes by kind, stable in window position, with the
//      ballot ranks of group_by_kind, and write the per-kind counts;
//   5. release positions (free_tail + exclusive count of safe) % cap, with
//      free_tail read from device memory (no host sync).
struct FusedIn {
  const int32_t *time_key, *seq;
  const uint8_t* safe;
  const int32_t *time, *kind, *src, *dst, *ctx;
  const uint8_t* valid;
  const int32_t *table_id, *res, *payload, *free_tail;
};

struct FusedOut {
  int32_t* exec_idx;
  uint8_t* exec_safe;
  int32_t *time, *seq, *kind, *src, *dst, *ctx;
  uint8_t* valid;
  int32_t* payload;
  uint8_t* clean;
  int32_t *order, *rel_pos, *counts;
};

struct GroupSmem {
  int warp_tot[MAX_WARPS * MAX_KEYS];
  int cnt[MAX_KEYS], start[MAX_KEYS], carry[MAX_KEYS];
  int scan_carry;
};

// The per-key counts and carries start at 0 (read after a later barrier).
__device__ void group_init(GroupSmem& gs, int n_keys) {
  for (int g = threadIdx.x; g < n_keys; g += blockDim.x) {
    gs.cnt[g] = 0;
    gs.carry[g] = 0;
  }
  if (threadIdx.x == 0) gs.scan_carry = 0;
}

// Lane o's fields from pool slot `slot` (base: the agent's first slot);
// returns the lane's rkey and sets its flags: bit 0 safe, bit 1 conflict
// candidate, bits 8-12 the clipped kind.
__device__ int32_t gather_lane(const FusedIn& in, const FusedOut& out,
                               size_t base, size_t o, int slot, int n_pay,
                               int n_kinds, int n_res, int32_t& flags) {
  const size_t g = base + slot;
  const bool es = in.safe[g] != 0;
  const int32_t tb = in.table_id[g];
  const int32_t kd = in.kind[g];
  out.exec_idx[o] = slot;
  out.exec_safe[o] = es;
  out.time[o] = in.time[g];
  out.seq[o] = in.seq[g];
  out.kind[o] = kd;
  out.src[o] = in.src[g];
  out.dst[o] = in.dst[g];
  out.ctx[o] = in.ctx[g];
  out.valid[o] = in.valid[g] != 0;
  for (int p = 0; p < n_pay; ++p)
    out.payload[o * n_pay + p] = in.payload[g * n_pay + p];
  flags = (es ? 1 : 0) | ((es && tb > 0) ? 2 : 0) |
          (min(max(kd, 0), n_kinds - 1) << 8);
  return (int32_t)((uint32_t)tb * (uint32_t)n_res + (uint32_t)in.res[g]);
}

// A sorted conflict entry: v = lane | flags << 16. Writes the lane's clean
// flag, its grouping key (clipped kind if clean, else n_kinds) to gk and
// its safe flag to es, both in lane order.
__device__ __forceinline__ void lane_result(const FusedOut& out,
                                            size_t obase, int32_t v,
                                            bool dirty, int n_kinds,
                                            int32_t* gk, int32_t* es) {
  const int lane = v & 0xffff, fl = (v >> 16) & 0x1fff;
  const bool clean = (fl & 1) && !dirty;
  out.clean[obase + lane] = clean;
  gk[lane] = clean ? fl >> 8 : n_kinds;
  es[lane] = fl & 1;
}

// Steps 4-5 from the lane-order arrays gk and es (after a barrier).
__device__ void group_release(const int32_t* gk, const int32_t* es,
                              const FusedOut& out, int a, int m, int n_kinds,
                              int cap, int32_t tail, GroupSmem& gs) {
  const int n_keys = n_kinds + 1;
  const size_t obase = (size_t)a * m;
  for (int i = threadIdx.x; i < m; i += blockDim.x)
    atomicAdd(&gs.cnt[gk[i]], 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int g = 0; g < n_keys; ++g) {
      gs.start[g] = acc;
      acc += gs.cnt[g];
    }
  }
  for (int g = threadIdx.x; g < n_kinds; g += blockDim.x)
    out.counts[(size_t)a * n_kinds + g] = gs.cnt[g];
  __syncthreads();
  for (int b = 0; b < m; b += blockDim.x) {
    const int i = b + threadIdx.x;
    const int k = i < m ? gk[i] : -1;
    const int r = chunk_rank(k, n_keys, gs.warp_tot, gs.carry);
    if (i < m) out.order[obase + gs.start[k] + r] = i;
    const int e = chunk_excl_count(i < m && es[i], gs.warp_tot,
                                   &gs.scan_carry);
    if (i < m) out.rel_pos[obase + i] = ring_pos(tail, e, cap);
  }
}

// The main path: the radix selection, then the conflict sort one a thread.
template <int IPT>
__global__ void __launch_bounds__(RADIX_THREADS)
fused_select_radix_kernel(FusedIn in, FusedOut out, int cap, int m,
                          int n_pay, int n_kinds, int n_res, int bound) {
  __shared__ RadixSmem sm;
  __shared__ GroupSmem gs;
  const int a = blockIdx.x, tid = threadIdx.x;
  const size_t base = (size_t)a * cap, obase = (size_t)a * m;
  group_init(gs, n_kinds + 1);
  const int32_t slot = radix_select<IPT>(in.time_key + base, in.seq + base,
                                         cap, m, bound, sm);
  // 2. gather; the conflict key: rkey, then 0 for a candidate
  uint64_t kv = KEY_MAX;
  int32_t iv = I32_MAX;
  if (tid < m) {
    int32_t fl;
    const int32_t rk = gather_lane(in, out, base, obase + tid, slot, n_pay,
                                   n_kinds, n_res, fl);
    kv = ((uint64_t)(uint32_t)rk << 1) | (uint64_t)((fl & 2) == 0);
    iv = tid | (fl << 16);
  }
  // 3. conflicts
  int n = 1;
  while (n < m) n <<= 1;
  __syncthreads();   // the selection's exchange buffers are read
  bitonic_regs(kv, iv, n, sm.sk, sm.si);
  __syncthreads();
  sm.sk[0][tid] = kv;
  __syncthreads();
  int32_t* gk = sm.si[0];
  int32_t* es = sm.si[1];
  if (tid < m) {
    const bool same = (tid > 0 && sm.sk[0][tid - 1] == kv) ||
                      (tid + 1 < n && sm.sk[0][tid + 1] == kv);
    lane_result(out, obase, iv, (kv & 1) == 0 && same, n_kinds, gk, es);
  }
  __syncthreads();
  group_release(gk, es, out, a, m, n_kinds, cap, in.free_tail[a], gs);
}

// A larger m: the bitonic sort of the pool, then the conflict sort in the
// same shared memory (t, s, ix: 12 * n_pad B).
__global__ void fused_select_sort_kernel(FusedIn in, FusedOut out, int cap,
                                         int n_pad, int m, int n_pay,
                                         int n_kinds, int n_res) {
  extern __shared__ int32_t smem[];
  int32_t* t = smem;            // time keys, then rkeys, then gk
  int32_t* s = smem + n_pad;    // seqs, then "not a candidate", then es
  int32_t* ix = smem + 2 * n_pad;   // slots, then lane | flags << 16
  __shared__ GroupSmem gs;
  const int a = blockIdx.x;
  const size_t base = (size_t)a * cap, obase = (size_t)a * m;
  group_init(gs, n_kinds + 1);
  sort_slots(in.time_key + base, in.seq + base, cap, n_pad, t, s, ix);

  // 2. gather lane i into entry i; pads up to n, the power of two >= m
  int n = 1;
  while (n < m) n <<= 1;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (i < m) {
      int32_t fl;
      t[i] = gather_lane(in, out, base, obase + i, ix[i], n_pay, n_kinds,
                         n_res, fl);
      s[i] = (fl & 2) == 0;
      ix[i] = i | (fl << 16);
    } else {
      t[i] = s[i] = ix[i] = I32_MAX;
    }
  }
  __syncthreads();
  // 3. conflicts: a dirty entry is marked in bit 30 of its ix
  bitonic_smem(t, s, ix, n);
  for (int p = threadIdx.x; p < m; p += blockDim.x) {
    const bool same = (p > 0 && t[p - 1] == t[p] && s[p - 1] == s[p]) ||
                      (p + 1 < n && t[p + 1] == t[p] && s[p + 1] == s[p]);
    if (s[p] == 0 && same) ix[p] |= 1 << 30;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < m; p += blockDim.x)
    lane_result(out, obase, ix[p], (ix[p] >> 30) & 1, n_kinds, t, s);
  __syncthreads();
  group_release(t, s, out, a, m, n_kinds, cap, in.free_tail[a], gs);
}

int threads_for(int n) {
  int t = 32;
  while (t < n && t < 1024) t <<= 1;
  return t;
}

}  // namespace

extern "C" {

// out: (A, m) the first m indices of each agent's (time, seq) sort over its
// cap slots; n_pad is the power of two >= cap. 2m <= min(n_pad, RADIX_CAND)
// (cap <= 16 RADIX_THREADS) runs the radix selection (static shared memory),
// a larger m the bitonic sort (12 * n_pad B of dynamic shared memory, its
// limit raised once per process).
int launch_select_events(const int32_t* time_key, const int32_t* seq,
                         int32_t* out, int n_agents, int cap, int n_pad,
                         int m, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_agents < 1 || cap < 1 || n_pad < cap || m < 1 || m > cap)
    return (int)cudaErrorInvalidValue;
  if (2 * m <= n_pad && 2 * m <= RADIX_CAND) {
    const int bound = radix_bound(m);
    return radix_dispatch(cap, [&](auto ipt) {
      select_events_kernel<decltype(ipt)::value>
          <<<n_agents, RADIX_THREADS, 0, s>>>(time_key, seq, out, cap, m,
                                               bound);
    });
  }
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        sort_events_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        3 * MAX_SORT_SLOTS * (int)sizeof(int32_t));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const size_t smem = (size_t)3 * n_pad * sizeof(int32_t);
  sort_events_kernel<<<n_agents, threads_for(n_pad / 2), smem, s>>>(
      time_key, seq, out, cap, n_pad, m);
  return (int)cudaGetLastError();
}

// active: mask_bytes 4 an int32 mask, 1 a bool or uint8 one. n_kinds in
// [1, 32].
int launch_group_by_kind(const int32_t* kind, const void* active,
                         int mask_bytes, int32_t* order, int32_t* rank,
                         int32_t* counts, int n_agents, int m, int n_kinds,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_agents < 1 || m < 1 || n_kinds < 1 || n_kinds > GROUP_KEYS - 1)
    return (int)cudaErrorInvalidValue;
  if (mask_bytes == 1)
    group_by_kind_kernel<uint8_t><<<n_agents, threads_for(m), 0, s>>>(
        kind, static_cast<const uint8_t*>(active), order, rank, counts, m,
        n_kinds);
  else if (mask_bytes == 4)
    group_by_kind_kernel<int32_t><<<n_agents, threads_for(m), 0, s>>>(
        kind, static_cast<const int32_t*>(active), order, rank, counts, m,
        n_kinds);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// mask_bytes: 4 an int32 mask, 1 a bool or uint8 one.
int launch_trace_rank(const void* mask, int mask_bytes, int32_t* out,
                      int n_agents, int n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mask_bytes == 1)
    trace_rank_kernel<uint8_t><<<n_agents, threads_for(n), 0, s>>>(
        static_cast<const uint8_t*>(mask), out, n);
  else if (mask_bytes == 4)
    trace_rank_kernel<int32_t><<<n_agents, threads_for(n), 0, s>>>(
        static_cast<const int32_t*>(mask), out, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dst and rank (A, n); keys in [0, n_buckets), n_buckets in [1, MAX_KEYS].
// Up to ROUTE_KEPT 32-row steps a warp (n <= 4096) keep their keys in
// registers; more walk each warp's segment twice.
int launch_route_rank(const int32_t* dst, int32_t* rank, int n_agents, int n,
                      int n_buckets, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_agents < 1 || n < 1 || n_buckets < 1 || n_buckets > MAX_KEYS)
    return (int)cudaErrorInvalidValue;
  const int threads = threads_for(n);
  const int steps = (n + threads - 1) / threads;
  const int kept = steps <= ROUTE_KEPT ? steps : 0;
  static_assert(ROUTE_KEPT >= 0 && ROUTE_KEPT <= 4,
                "one instance a kept step count");
  if (kept == 1)
    route_rank_kernel<1><<<n_agents, threads, 0, s>>>(dst, rank, n, n_buckets);
  else if (kept == 2)
    route_rank_kernel<2><<<n_agents, threads, 0, s>>>(dst, rank, n, n_buckets);
  else if (kept == 3)
    route_rank_kernel<3><<<n_agents, threads, 0, s>>>(dst, rank, n, n_buckets);
  else if (kept == 4)
    route_rank_kernel<4><<<n_agents, threads, 0, s>>>(dst, rank, n, n_buckets);
  else
    route_rank_kernel<0><<<n_agents, threads, 0, s>>>(dst, rank, n, n_buckets);
  return (int)cudaGetLastError();
}

int launch_ring_slots(const int32_t* ring, const int32_t* head,
                      const uint8_t* want, int32_t* out, int n_agents, int cap,
                      int n, void* stream) {
  if (n_agents < 1 || cap < 1 || n < 1) return (int)cudaErrorInvalidValue;
  ring_slots_kernel<<<n_agents, threads_for(n / RING_ROWS + 1), 0,
                      (cudaStream_t)stream>>>(ring, head, want, out, cap, n);
  return (int)cudaGetLastError();
}

// Inputs, then outputs in the order of the FusedSelect fields, then the
// per-kind counts (A, n_kinds); outputs are (A, m) (payload (A, m, n_pay));
// bool tensors are one byte. 2m <= min(n_pad, RADIX_CAND) runs the radix
// selection (static shared memory), a larger m the bitonic sort (12 * n_pad
// B of dynamic shared memory, its limit raised once per process).
int launch_fused_select(
    const int32_t* time_key, const int32_t* seq, const uint8_t* safe,
    const int32_t* time, const int32_t* kind, const int32_t* src,
    const int32_t* dst, const int32_t* ctx, const uint8_t* valid,
    const int32_t* table_id, const int32_t* res, const int32_t* payload,
    const int32_t* free_tail, int32_t* exec_idx, uint8_t* exec_safe,
    int32_t* o_time, int32_t* o_seq, int32_t* o_kind, int32_t* o_src,
    int32_t* o_dst, int32_t* o_ctx, int32_t* o_payload, uint8_t* o_valid,
    uint8_t* clean, int32_t* order, int32_t* rel_pos, int32_t* counts,
    int n_agents, int cap, int n_pad, int m, int n_pay, int n_kinds,
    int n_res, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_agents < 1 || cap < 1 || n_pad < cap || m < 1 || m > cap ||
      n_kinds < 1 || n_kinds > MAX_KEYS - 1)
    return (int)cudaErrorInvalidValue;
  const FusedIn in{time_key, seq, safe, time, kind, src, dst, ctx, valid,
                   table_id, res, payload, free_tail};
  const FusedOut out{exec_idx, exec_safe, o_time, o_seq, o_kind, o_src,
                     o_dst, o_ctx, o_valid, o_payload, clean, order,
                     rel_pos, counts};
  if (2 * m <= n_pad && 2 * m <= RADIX_CAND) {
    const int bound = radix_bound(m);
    return radix_dispatch(cap, [&](auto ipt) {
      fused_select_radix_kernel<decltype(ipt)::value>
          <<<n_agents, RADIX_THREADS, 0, s>>>(in, out, cap, m, n_pay,
                                               n_kinds, n_res, bound);
    });
  }
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_select_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        3 * MAX_SORT_SLOTS * (int)sizeof(int32_t));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const size_t smem = (size_t)3 * n_pad * sizeof(int32_t);
  fused_select_sort_kernel<<<n_agents, threads_for(n_pad / 2), smem, s>>>(
      in, out, cap, n_pad, m, n_pay, n_kinds, n_res);
  return (int)cudaGetLastError();
}

int max_keys() { return MAX_KEYS; }

}  // extern "C"
