// Probe kernels for the join kernel's memory behaviour (sm_90a).  Built and
// timed by sview_fmindex_tpu_torch/bench/join_probe.py; nothing on a query
// path calls them.
//
// 1. probe_stream: the streaming floor.  Reads key and payload, writes one
//    int64, touches no row; with or without the streaming hints.
// 2. probe_fetch: a bare row fetch.  Loads VECS 16-byte vectors of the row
//    at (key >> 7) * stride and xors them into one word, with one thread per
//    row or with L lanes sharing the rows of their L keys (each load
//    instruction then touches 32 / L rows instead of 32), so sector cost,
//    64-byte straddling and lines per instruction each show as a time.
// 3. probe_base: the thread-per-key join kernel as it stood before the
//    warp-cooperative fetch, on its own row layout (planes at sigma rounded
//    up to 4 words, no further padding), the baseline every redesign is
//    timed against; at sigma 4 and 16 also with 2 and 4 keys per thread.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 4;
constexpr int kMaxSigma = 63;
constexpr int kThreads = 256;
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

__host__ __device__ constexpr int planes_for(int sigma) {
  int p = 0;
  for (int v = sigma - 1; v > 0; v >>= 1) ++p;
  return p < 1 ? 1 : p;
}

__host__ __device__ constexpr int plane_offset(int sigma) { return (sigma + 3) & ~3; }

// ---------------------------------------------------------------- 1. floor

template <bool HINTS>
__global__ void __launch_bounds__(kThreads) stream_kernel(const int64_t* key,
                                                          const int64_t* payload, int64_t* out,
                                                          int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= n) return;
  if (HINTS) {
    __stcs(out + i, __ldcs(key + i) ^ __ldcs(payload + i));
  } else {
    out[i] = key[i] ^ payload[i];
  }
}

// ------------------------------------------------------------ 2. row fetch

__device__ __forceinline__ uint32_t fold(const uint4 x) { return x.x ^ x.y ^ x.z ^ x.w; }

template <int VECS, int L>
__global__ void __launch_bounds__(kThreads) fetch_kernel(const uint4* tbl, int64_t stride_vecs,
                                                         const int64_t* key, int64_t* out,
                                                         int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  const int64_t blk = i < n ? key[i] >> 7 : 0;
  uint32_t acc = 0;
  if (L == 1) {
    const uint4* row = tbl + blk * stride_vecs;
#pragma unroll
    for (int v = 0; v < VECS; ++v) acc ^= fold(__ldg(row + v));
  } else {
    const int lane = threadIdx.x & 31;
    const int sub = lane & (L - 1);
    const int base = lane & ~(L - 1);
#pragma unroll
    for (int r = 0; r < L; ++r) {
      const uint4* row = tbl + __shfl_sync(kFullWarp, blk, base + r) * stride_vecs;
      uint32_t part = 0;
#pragma unroll
      for (int v = sub; v < VECS; v += L) part ^= fold(__ldg(row + v));
#pragma unroll
      for (int m = L / 2; m > 0; m >>= 1) part ^= __shfl_xor_sync(kFullWarp, part, m);
      acc = (r == sub) ? part : acc;
    }
  }
  if (i < n) out[i] = acc;
}

template <int VECS, int L>
cudaError_t launch_fetch(const void* tbl, int64_t stride_vecs, const void* key, void* out,
                         int64_t n, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  fetch_kernel<VECS, L><<<blocks, kThreads, 0, s>>>(
      static_cast<const uint4*>(tbl), stride_vecs, static_cast<const int64_t*>(key),
      static_cast<int64_t*>(out), n);
  return cudaGetLastError();
}

// ----------------------------------------- 3. the thread-per-key join kernel

struct JoinArgs {
  const int32_t* tbl;
  int64_t n_rows;
  const int64_t* key;
  const int64_t* payload;
  const int64_t* seg_base;
  int seg_shift;
  int sigma;
  int64_t* rank_out;
  int64_t* sym_out;
  int64_t n;
};

template <int P>
__device__ __forceinline__ int decode_sym(const uint32_t* planes, int rem) {
  const int lane = rem >> 5;
  const int bit = 31 - (rem & 31);
  int sym = 0;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    uint32_t lv = 0;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) lv = (l == lane) ? planes[q * kLanes + l] : lv;
    sym |= static_cast<int>((lv >> bit) & 1u) << q;
  }
  return sym;
}

template <int P>
__device__ __forceinline__ uint32_t count_before(const uint32_t* planes, int sym, int rem) {
  uint32_t cnt = 0;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    uint32_t comb = 0xFFFFFFFFu;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const uint32_t wq = planes[q * kLanes + l];
      comb &= ((sym >> q) & 1) ? wq : ~wq;
    }
    const int take = min(max(rem - 32 * l, 0), 32);
    const uint32_t mask = take == 0 ? 0u : 0xFFFFFFFFu << (32 - take);
    cnt += __popc(comb & mask);
  }
  return cnt;
}

template <bool DECODE, bool SEGMENTED>
__device__ __forceinline__ void store(const JoinArgs& a, int64_t i, int64_t blk, int sigma,
                                      int sym, uint32_t ckpt, uint32_t cnt) {
  int64_t rank = static_cast<int64_t>(ckpt + cnt);
  if (SEGMENTED && sym < sigma) rank += a.seg_base[(blk >> a.seg_shift) * sigma + sym];
  a.rank_out[i] = rank;
  if (DECODE) a.sym_out[i] = sym;
}

// Thread t of block b takes keys (b * KPT + k) * 256 + t, k < KPT: every
// key load stays coalesced, and all KPT rows are asked before the first is
// used.  KPT = 1 is the kernel as it stood.
template <int SIGMA, bool DECODE, bool SEGMENTED, int KPT>
__global__ void __launch_bounds__(kThreads) base_kernel(const JoinArgs a) {
  constexpr int P = planes_for(SIGMA);
  constexpr int RW = SIGMA + P * kLanes;
  static_assert(SIGMA % 4 == 0 && RW % 4 == 0, "rows are read as 16-byte vectors");

  int64_t i[KPT], p[KPT], blk[KPT];
  uint32_t w[KPT][RW];
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    i[k] = (blockIdx.x * static_cast<int64_t>(KPT) + k) * kThreads + threadIdx.x;
    p[k] = i[k] < a.n ? a.key[i[k]] : -1;
    blk[k] = (p[k] >= 0 && (p[k] >> 7) < a.n_rows) ? (p[k] >> 7) : -1;
  }
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    if (blk[k] < 0) continue;
    const uint4* row = reinterpret_cast<const uint4*>(a.tbl + blk[k] * RW);
#pragma unroll
    for (int v = 0; v < RW / 4; ++v) {
      const uint4 x = __ldg(row + v);
      w[k][4 * v] = x.x;
      w[k][4 * v + 1] = x.y;
      w[k][4 * v + 2] = x.z;
      w[k][4 * v + 3] = x.w;
    }
  }
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    if (i[k] >= a.n) continue;
    if (blk[k] < 0) {
      a.rank_out[i[k]] = 0;
      if (DECODE) a.sym_out[i[k]] = 0;
      continue;
    }
    const int rem = static_cast<int>(p[k] & 127);
    const int sym = DECODE ? decode_sym<P>(w[k] + SIGMA, rem)
                           : static_cast<int>(a.payload[i[k]] & 63);
    uint32_t ckpt = 0;
#pragma unroll
    for (int s = 0; s < SIGMA; ++s) ckpt = (s == sym) ? w[k][s] : ckpt;
    store<DECODE, SEGMENTED>(a, i[k], blk[k], SIGMA, sym, ckpt,
                             count_before<P>(w[k] + SIGMA, sym, rem));
  }
}

template <int P, bool DECODE, bool SEGMENTED>
__global__ void __launch_bounds__(kThreads) base_kernel_any(const JoinArgs a) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= a.n) return;
  const int64_t p = a.key[i];
  const int64_t blk = p >> 7;
  if (p < 0 || blk >= a.n_rows) {
    a.rank_out[i] = 0;
    if (DECODE) a.sym_out[i] = 0;
    return;
  }
  const int sigma = a.sigma;
  const int off = plane_offset(sigma);
  const int32_t* row = a.tbl + blk * (off + P * kLanes);
  uint32_t w[P * kLanes];
  const uint4* planes = reinterpret_cast<const uint4*>(row + off);
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const uint4 x = __ldg(planes + q);
    w[4 * q] = x.x;
    w[4 * q + 1] = x.y;
    w[4 * q + 2] = x.z;
    w[4 * q + 3] = x.w;
  }
  const int rem = static_cast<int>(p & 127);
  const int sym = DECODE ? decode_sym<P>(w, rem) : static_cast<int>(a.payload[i] & 63);
  const uint32_t ckpt = sym < sigma ? static_cast<uint32_t>(__ldg(row + sym)) : 0u;
  store<DECODE, SEGMENTED>(a, i, blk, sigma, sym, ckpt, count_before<P>(w, sym, rem));
}

template <int SIGMA, bool DECODE, bool SEGMENTED>
cudaError_t launch_base_kpt(const JoinArgs& a, int kpt, cudaStream_t s) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * kpt;
  const unsigned blocks = static_cast<unsigned>((a.n + per_block - 1) / per_block);
  switch (kpt) {
    case 1: base_kernel<SIGMA, DECODE, SEGMENTED, 1><<<blocks, kThreads, 0, s>>>(a); break;
    case 2: base_kernel<SIGMA, DECODE, SEGMENTED, 2><<<blocks, kThreads, 0, s>>>(a); break;
    case 4: base_kernel<SIGMA, DECODE, SEGMENTED, 4><<<blocks, kThreads, 0, s>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <bool DECODE, bool SEGMENTED>
cudaError_t launch_base(const JoinArgs& a, int kpt, cudaStream_t s) {
  if (a.sigma == 4) return launch_base_kpt<4, DECODE, SEGMENTED>(a, kpt, s);
  if (a.sigma == 16) return launch_base_kpt<16, DECODE, SEGMENTED>(a, kpt, s);
  if (kpt != 1) return cudaErrorInvalidValue;
  void (*kernel)(JoinArgs);
  switch (planes_for(a.sigma)) {
    case 1: kernel = base_kernel_any<1, DECODE, SEGMENTED>; break;
    case 2: kernel = base_kernel_any<2, DECODE, SEGMENTED>; break;
    case 3: kernel = base_kernel_any<3, DECODE, SEGMENTED>; break;
    case 4: kernel = base_kernel_any<4, DECODE, SEGMENTED>; break;
    case 5: kernel = base_kernel_any<5, DECODE, SEGMENTED>; break;
    default: kernel = base_kernel_any<6, DECODE, SEGMENTED>; break;
  }
  const unsigned blocks = static_cast<unsigned>((a.n + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int probe_stream(const void* key, const void* payload, void* out, int64_t n, int hints,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const int64_t* k = static_cast<const int64_t*>(key);
  const int64_t* p = static_cast<const int64_t*>(payload);
  int64_t* o = static_cast<int64_t*>(out);
  if (hints) {
    stream_kernel<true><<<blocks, kThreads, 0, s>>>(k, p, o, n);
  } else {
    stream_kernel<false><<<blocks, kThreads, 0, s>>>(k, p, o, n);
  }
  return cudaGetLastError();
}

// vecs 16-byte vectors of each key's row, rows stride_vecs vectors apart,
// `lanes` lanes per row: (vecs, lanes) in {2,3,4,7,8} x {1,4,8}.
int probe_fetch(const void* tbl, int64_t stride_vecs, int vecs, int lanes, const void* key,
                void* out, int64_t n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVIEW_FETCH_CASE(V, L) \
  if (vecs == V && lanes == L) return launch_fetch<V, L>(tbl, stride_vecs, key, out, n, s);
  SVIEW_FETCH_CASE(2, 1) SVIEW_FETCH_CASE(2, 4) SVIEW_FETCH_CASE(2, 8)
  SVIEW_FETCH_CASE(3, 1) SVIEW_FETCH_CASE(3, 4) SVIEW_FETCH_CASE(3, 8)
  SVIEW_FETCH_CASE(4, 1) SVIEW_FETCH_CASE(4, 4) SVIEW_FETCH_CASE(4, 8)
  SVIEW_FETCH_CASE(7, 1) SVIEW_FETCH_CASE(7, 4) SVIEW_FETCH_CASE(7, 8)
  SVIEW_FETCH_CASE(8, 1) SVIEW_FETCH_CASE(8, 4) SVIEW_FETCH_CASE(8, 8)
#undef SVIEW_FETCH_CASE
  return cudaErrorInvalidValue;
}

// The thread-per-key join kernel, kpt keys per thread (2 and 4 only at
// sigma 4 and 16); arguments as sview_join's.
int probe_base(int sigma, int decode, const void* tbl, int64_t n_rows, const void* key,
               const void* payload, const void* seg_base, int seg_shift, void* rank, void* sym,
               int64_t n, int kpt, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (sigma < 1 || sigma > kMaxSigma) return cudaErrorInvalidValue;
  const JoinArgs a{static_cast<const int32_t*>(tbl), n_rows,
                   static_cast<const int64_t*>(key), static_cast<const int64_t*>(payload),
                   static_cast<const int64_t*>(seg_base), seg_shift, sigma,
                   static_cast<int64_t*>(rank), static_cast<int64_t*>(sym), n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool segmented = seg_base != nullptr;
  if (decode) {
    return segmented ? launch_base<true, true>(a, kpt, s) : launch_base<true, false>(a, kpt, s);
  }
  return segmented ? launch_base<false, true>(a, kpt, s) : launch_base<false, false>(a, kpt, s);
}

}  // extern "C"
