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
// count) with warp ballots, popc, block-wide scans and direct gathers.
//
// Every entry point is a plain C function that launches on the given stream
// and returns cudaGetLastError(), so a refused launch is reported to the
// caller. No float arithmetic happens here: float payload words move as
// 32-bit integers, so every bit pattern (NaNs included) survives. Integer
// arithmetic that the reference does in int32 wraps here as it does there
// (computed in uint32), and its modulo is a floor modulo, as jnp's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MAX_WARPS = 32;   // 1024 threads
constexpr int MAX_KEYS = 64;    // group: n_kinds + 1 <= 33; route: A + 1
constexpr int32_t I32_MAX = 0x7fffffff;

__device__ __forceinline__ bool lex_less(int32_t t1, int32_t s1, int32_t i1,
                                         int32_t t2, int32_t s2, int32_t i2) {
  return (t1 < t2) || (t1 == t2 && (s1 < s2 || (s1 == s2 && i1 < i2)));
}

// ---------------------------------------------------------------- select
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

  const int half = n_pad >> 1;
  for (int k = 2; k <= n_pad; k <<= 1) {
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

// The first m indices of the sort are written out.
__global__ void select_events_kernel(const int32_t* __restrict__ time_key,
                                     const int32_t* __restrict__ seq,
                                     int32_t* __restrict__ out,
                                     int cap, int n_pad, int m) {
  extern __shared__ int32_t smem[];
  int32_t* ix = smem + 2 * n_pad;
  const int a = blockIdx.x;
  sort_slots(time_key + (size_t)a * cap, seq + (size_t)a * cap, cap, n_pad,
             smem, smem + n_pad, ix);
  out += (size_t)a * m;
  for (int i = threadIdx.x; i < m; i += blockDim.x) out[i] = ix[i];
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
// key = clip(kind, 0, n_kinds-1) if active else n_kinds. Pass 1 counts the
// keys (shared atomics) and scans them into segment starts; pass 2 ranks each
// row within its key, stable in position, and writes
// order[start[key] + rank] = i with rank aligned to order.
__global__ void group_by_kind_kernel(const int32_t* __restrict__ kind,
                                     const int32_t* __restrict__ active,
                                     int32_t* __restrict__ order,
                                     int32_t* __restrict__ rank_out,
                                     int32_t* __restrict__ counts,
                                     int m, int n_kinds) {
  __shared__ int warp_tot[MAX_WARPS * MAX_KEYS];
  __shared__ int cnt[MAX_KEYS];
  __shared__ int start[MAX_KEYS];
  __shared__ int carry[MAX_KEYS];
  const int a = blockIdx.x;
  const int n_keys = n_kinds + 1;
  kind += (size_t)a * m;
  active += (size_t)a * m;
  order += (size_t)a * m;
  rank_out += (size_t)a * m;
  counts += (size_t)a * n_kinds;

  for (int g = threadIdx.x; g < n_keys; g += blockDim.x) {
    cnt[g] = 0;
    carry[g] = 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int k = active[i] ? min(max(kind[i], 0), n_kinds - 1) : n_kinds;
    atomicAdd(&cnt[k], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int g = 0; g < n_keys; ++g) {
      start[g] = acc;
      acc += cnt[g];
    }
  }
  for (int g = threadIdx.x; g < n_kinds; g += blockDim.x) counts[g] = cnt[g];
  __syncthreads();

  for (int base = 0; base < m; base += blockDim.x) {
    const int i = base + threadIdx.x;
    int k = -1;
    if (i < m) k = active[i] ? min(max(kind[i], 0), n_kinds - 1) : n_kinds;
    const int r = chunk_rank(k, n_keys, warp_tot, carry);
    if (i < m) {
      const int p = start[k] + r;
      order[p] = i;
      rank_out[p] = r;
    }
  }
}

// ------------------------------------------------------------- route
// Key-range contract: every dst is in [0, n_buckets). rank[i] counts the
// earlier rows of the same bucket: O(n * n_buckets / 32) ballots instead of
// the TPU kernel's O(n^2) predecessor count.
__global__ void route_rank_kernel(const int32_t* __restrict__ dst,
                                  int32_t* __restrict__ rank_out,
                                  int n, int n_buckets) {
  __shared__ int warp_tot[MAX_WARPS * MAX_KEYS];
  __shared__ int carry[MAX_KEYS];
  const int a = blockIdx.x;
  dst += (size_t)a * n;
  rank_out += (size_t)a * n;
  for (int g = threadIdx.x; g < n_buckets; g += blockDim.x) carry[g] = 0;
  __syncthreads();
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int k = i < n ? dst[i] : -1;
    const int r = chunk_rank(k, n_buckets, warp_tot, carry);
    if (i < n) rank_out[i] = r;
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

// int32 a + b with two's-complement wrap, then the floor modulo by cap > 0.
__device__ __forceinline__ int ring_pos(int32_t a, int32_t b, int cap) {
  const int32_t x = (int32_t)((uint32_t)a + (uint32_t)b);
  const int r = x % cap;
  return r < 0 ? r + cap : r;
}

// Exclusive prefix count of the 0/1 mask.
__global__ void trace_rank_kernel(const int32_t* __restrict__ mask,
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
// exclusive count of wanted rows before row i. A direct gather replaces the
// TPU kernel's chunked one-hot selection. Rows that are not wanted get the
// same formula; the engine drops them.
__global__ void ring_slots_kernel(const int32_t* __restrict__ ring,
                                  const int32_t* __restrict__ head,
                                  const uint8_t* __restrict__ want,
                                  int32_t* __restrict__ out, int cap, int n) {
  __shared__ int warp_tot[MAX_WARPS];
  __shared__ int carry;
  const int a = blockIdx.x;
  ring += (size_t)a * cap;
  want += (size_t)a * n;
  out += (size_t)a * n;
  const int32_t h = head[a];
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int r = chunk_excl_count(i < n && want[i] != 0, warp_tot, &carry);
    if (i < n) out[i] = ring[ring_pos(h, r, cap)];
  }
}

// ------------------------------------------------------------ fused select
// The window front end in one CTA per agent:
//   1. sort (time_key, seq, slot) in shared memory, as select_events: the
//      TPU kernel carries every field (76 B per slot) through its network,
//      which at pool_cap 4096 would need 311,296 B of the 232,448 B a block
//      has; sorting 12 B per slot and gathering the m window lanes' fields
//      from device memory afterwards fits up to pool_cap 16384;
//   2. gather the window lanes by slot (payload words as raw bits) and
//      reuse the sort buffers: t[i] = rkey = table_id * n_res + res,
//      s[i] = flags (safe, conflict candidate, clipped kind << 8);
//   3. conflict: a candidate lane (safe, table_id > 0) is dirty if another
//      candidate lane has its rkey (the reference's pairwise count >= 2);
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

__global__ void fused_select_kernel(FusedIn in, FusedOut out, int cap,
                                    int n_pad, int m, int n_pay, int n_kinds,
                                    int n_res) {
  extern __shared__ int32_t smem[];
  int32_t* rkey = smem;            // the sort's time keys, then rkey
  int32_t* flags = smem + n_pad;   // the sort's seqs, then lane flags
  int32_t* ix = smem + 2 * n_pad;  // the sort's slots, then clean flags
  __shared__ int warp_tot[MAX_WARPS * MAX_KEYS];
  __shared__ int cnt[MAX_KEYS];
  __shared__ int start[MAX_KEYS];
  __shared__ int carry[MAX_KEYS];
  __shared__ int scan_carry;
  const int a = blockIdx.x;
  const int n_keys = n_kinds + 1;
  const size_t base = (size_t)a * cap;
  const size_t obase = (size_t)a * m;
  for (int g = threadIdx.x; g < n_keys; g += blockDim.x) {
    cnt[g] = 0;
    carry[g] = 0;
  }
  if (threadIdx.x == 0) scan_carry = 0;
  sort_slots(in.time_key + base, in.seq + base, cap, n_pad, rkey, flags, ix);

  // 2. gather the window
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int slot = ix[i];
    const size_t g = base + slot;
    const size_t o = obase + i;
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
    rkey[i] = (int32_t)((uint32_t)tb * (uint32_t)n_res + (uint32_t)in.res[g]);
    flags[i] = (es ? 1 : 0) | ((es && tb > 0) ? 2 : 0) |
               (min(max(kd, 0), n_kinds - 1) << 8);
  }
  __syncthreads();

  // 3. conflicts
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const int fj = flags[j];
    bool dirty = false;
    if (fj & 2) {
      const int32_t rk = rkey[j];
      for (int i = 0; i < m; ++i) {
        if (i != j && (flags[i] & 2) && rkey[i] == rk) {
          dirty = true;
          break;
        }
      }
    }
    const bool clean = (fj & 1) && !dirty;
    out.clean[obase + j] = clean;
    ix[j] = clean;
  }
  __syncthreads();

  // 4. group the clean lanes by kind: key counts, segment starts, ranks
  for (int i = threadIdx.x; i < m; i += blockDim.x)
    atomicAdd(&cnt[ix[i] ? (flags[i] >> 8) : n_kinds], 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int g = 0; g < n_keys; ++g) {
      start[g] = acc;
      acc += cnt[g];
    }
  }
  for (int g = threadIdx.x; g < n_kinds; g += blockDim.x)
    out.counts[(size_t)a * n_kinds + g] = cnt[g];
  __syncthreads();
  const int32_t tail = in.free_tail[a];
  for (int b = 0; b < m; b += blockDim.x) {
    const int i = b + threadIdx.x;
    const int k = i < m ? (ix[i] ? (flags[i] >> 8) : n_kinds) : -1;
    const int r = chunk_rank(k, n_keys, warp_tot, carry);
    if (i < m) out.order[obase + start[k] + r] = i;
    // 5. release positions
    const int e = chunk_excl_count(i < m && (flags[i] & 1), warp_tot,
                                   &scan_carry);
    if (i < m) out.rel_pos[obase + i] = ring_pos(tail, e, cap);
  }
}

int threads_for(int n) {
  int t = 32;
  while (t < n && t < 1024) t <<= 1;
  return t;
}

}  // namespace

extern "C" {

// out: (A, m) the first m indices of each agent's (time, seq) sort over its
// cap slots. n_pad is the power of two >= cap; shared memory is 12 * n_pad B.
int launch_select_events(const int32_t* time_key, const int32_t* seq,
                         int32_t* out, int n_agents, int cap, int n_pad,
                         int m, void* stream) {
  const size_t smem = (size_t)3 * n_pad * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      select_events_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  select_events_kernel<<<n_agents, threads_for(n_pad / 2), smem,
                         (cudaStream_t)stream>>>(time_key, seq, out, cap,
                                                 n_pad, m);
  return (int)cudaGetLastError();
}

int launch_group_by_kind(const int32_t* kind, const int32_t* active,
                         int32_t* order, int32_t* rank, int32_t* counts,
                         int n_agents, int m, int n_kinds, void* stream) {
  group_by_kind_kernel<<<n_agents, threads_for(m), 0, (cudaStream_t)stream>>>(
      kind, active, order, rank, counts, m, n_kinds);
  return (int)cudaGetLastError();
}

int launch_trace_rank(const int32_t* mask, int32_t* out, int n_agents, int n,
                      void* stream) {
  trace_rank_kernel<<<n_agents, threads_for(n), 0, (cudaStream_t)stream>>>(
      mask, out, n);
  return (int)cudaGetLastError();
}

int launch_route_rank(const int32_t* dst, int32_t* rank, int n_agents, int n,
                      int n_buckets, void* stream) {
  route_rank_kernel<<<n_agents, threads_for(n), 0, (cudaStream_t)stream>>>(
      dst, rank, n, n_buckets);
  return (int)cudaGetLastError();
}

int launch_ring_slots(const int32_t* ring, const int32_t* head,
                      const uint8_t* want, int32_t* out, int n_agents, int cap,
                      int n, void* stream) {
  ring_slots_kernel<<<n_agents, threads_for(n), 0, (cudaStream_t)stream>>>(
      ring, head, want, out, cap, n);
  return (int)cudaGetLastError();
}

// Inputs, then outputs in the order of the FusedSelect fields, then the
// per-kind counts (A, n_kinds); outputs are (A, m) (payload (A, m, n_pay));
// bool tensors are one byte.
// Shared memory is 12 * n_pad B dynamic plus the static rank tables.
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
  const size_t smem = (size_t)3 * n_pad * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      fused_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const FusedIn in{time_key, seq, safe, time, kind, src, dst, ctx, valid,
                   table_id, res, payload, free_tail};
  const FusedOut out{exec_idx, exec_safe, o_time, o_seq, o_kind, o_src,
                     o_dst, o_ctx, o_valid, o_payload, clean, order,
                     rel_pos, counts};
  fused_select_kernel<<<n_agents, threads_for(n_pad / 2), smem,
                        (cudaStream_t)stream>>>(in, out, cap, n_pad, m,
                                                n_pay, n_kinds, n_res);
  return (int)cudaGetLastError();
}

int max_keys() { return MAX_KEYS; }

}  // extern "C"
