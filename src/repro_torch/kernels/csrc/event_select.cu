// Window front-end kernels of the conservative-window DES engine, for Hopper
// (sm_90a). Four integer kernels, one CTA per agent over (A, n) int32 rows:
//
//   select_events  replaces repro/kernels/event_select.py::_sort_kernel
//                  (wrappers _run_sort / select_events / sort_events)
//   group_by_kind  replaces repro/kernels/event_select.py::_group_kernel
//   trace_rank     replaces repro/kernels/event_select.py::_trace_rank_kernel
//   route_rank     replaces repro/kernels/event_select.py::_route_rank_kernel
//
// What bounds them on this card: none moves more than a few hundred KB or
// does more than a few million integer operations per call, so each call is
// bound by latency (one launch, one CTA's chain of __syncthreads) rather than
// by HBM bytes or issue rate. The design keeps every intermediate in shared
// memory or registers, reads each input once and writes each output once,
// and replaces the TPU kernels' vector-unit workarounds (reshape-and-swap
// exchanges, chunked one-hot compares, the O(n^2) predecessor count) with
// warp ballots, popc and block-wide scans.
//
// Every entry point is a plain C function that launches on the given stream
// and returns cudaGetLastError(), so a refused launch is reported to the
// caller. No float arithmetic happens here.

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
// (time, seq) lexsort with ties broken by slot index. The first m indices
// are written out.
__global__ void select_events_kernel(const int32_t* __restrict__ time_key,
                                     const int32_t* __restrict__ seq,
                                     int32_t* __restrict__ out,
                                     int cap, int n_pad, int m) {
  extern __shared__ int32_t smem[];
  int32_t* t = smem;
  int32_t* s = smem + n_pad;
  int32_t* ix = smem + 2 * n_pad;
  const int a = blockIdx.x;
  time_key += (size_t)a * cap;
  seq += (size_t)a * cap;
  out += (size_t)a * m;

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

// ------------------------------------------------------------- trace
// Exclusive prefix count of the 0/1 mask: a ballot + popc per warp, a scan
// of the warp totals, and a carry across chunks.
__global__ void trace_rank_kernel(const int32_t* __restrict__ mask,
                                  int32_t* __restrict__ out, int n) {
  __shared__ int warp_tot[MAX_WARPS];
  __shared__ int carry;
  const int a = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  mask += (size_t)a * n;
  out += (size_t)a * n;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const bool w = i < n && mask[i] != 0;
    const unsigned b = __ballot_sync(FULL_MASK, w);
    if (lane == 0) warp_tot[warp] = __popc(b);
    __syncthreads();
    int r = carry + __popc(b & lt);
    for (int q = 0; q < warp; ++q) r += warp_tot[q];
    if (i < n) out[i] = r;
    __syncthreads();
    if (threadIdx.x == 0) {
      int sum = 0;
      for (int q = 0; q < n_warps; ++q) sum += warp_tot[q];
      carry += sum;
    }
    __syncthreads();
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

int max_keys() { return MAX_KEYS; }

}  // extern "C"
