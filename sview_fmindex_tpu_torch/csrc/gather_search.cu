// The gather engine's whole backward search in one kernel, for Hopper
// (sm_90a): seed every pattern's range, then take its LF steps, each end of
// each range in registers from the first symbol to the last.
//
// Replaces no TPU kernel.  The JAX package writes this engine in jnp
// (sview_fmindex_tpu/ops/search.py::pos_ranges, the single-symbol loop over
// fused-row gathers) and XLA fuses it under one jit.  The port runs eagerly:
// its plain version (ops/search.gather_ranges) issues about 72 PyTorch
// operations per LF step and 30 more for the seed, so at a batch of a few
// thousand patterns the host's launches, not the card, set the pace.  This
// kernel is that whole function in one launch.
//
// What it computes, per pattern i of length n = lens[i] over symbols
// sym[i, 0..L) (ops/search.initial_range, then ops/search.lf_step):
//   seed  n >= dense_k > 0:  [lo, hi) = dense_lo/hi[last dense_k symbols,
//                            base sigma], rem = n - dense_k, seed = dense_k
//         else:              the blob k-mer table over the last min(n, k)
//                            symbols, digits + 1 in base sigma + 1, hi past
//                            the unsearched low digits (gap = base^(k-m) - 1),
//                            rem = max(n - k, 0), seed = k
//   step  t < min(rem, steps) while lo < hi, with the symbol c at
//         clamp(n - seed - 1 - t, 0, L - 1):
//         end <- count_arr[c] + rank(end, c),
//         rank(p, c) over the fused row of the sentinel-shifted position
//         p' = p + (p < sentinel): ckpt[c] + popc of the positions before
//         p' % BL in the block that hold c (the planes AND/NOT-combined by
//         the bits of c), BL = 32 * LANES.
// Index -1 of the k-mer table (a pattern of length 0) is its last entry, as
// a PyTorch index is.  Every value is an int64 or a u32 word widened to
// one, so positions and checkpoints past 2^31 read as they do in the plain
// version, and the outputs equal it bit for bit.
//
// Fused row layout (int32 words, one row per block of BL positions):
//   words [0, sigma)                checkpoint: count of each symbol before
//                                   the block
//   words [W - P*LANES, W)          P bit planes x LANES MSB-first u32 lanes
// (W = sigma + P*LANES on a narrow index: 8 words, 32 B, at dna20's sigma 4,
// P 2, LANES 2.)
//
// What bounds it on this card: the latency of a chain of dependent reads.
// Each end takes its steps one after the other, and each step reads one row
// whose address is the previous step's result: a 20-bp read against a
// dense_k 14 seed is one dense-table read and six row reads in a row.  The
// bytes are few (B x (pattern + 2 x 6 rows x 32 B + 16 B out), 1.7 MB at
// B=4096), so at the batches that reach this engine (below the stream
// engine's crossover, DeviceFmIndex.STREAM_MIN_BATCH) the bound is a few
// device-memory round trips, not the rate.
//
// What the design does about it: one thread per range end, the two ends of
// a pattern in neighbouring lanes of one warp, so each end's chain of reads
// is its own and twice as many chains are in flight as patterns.  The two
// exchange their ends by one shuffle per step to stop together once the
// range is empty (the plain loop's active mask).  A step's symbol and its
// count_arr word do not depend on the range, so only the row read is on the
// chain; a row's words sit in one or two 32-byte sectors and are read as
// words, since a row of sigma + P*LANES words is not 16-byte aligned at
// most sigma.  Launched on the caller's stream, no synchronisation, outputs
// allocated by the caller.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

struct SearchArgs {
  const uint32_t* fused;
  int64_t row_words;
  const int64_t* kmer_tbl;
  int64_t n_kmer;
  const uint32_t* dense_lo;  // dense_k > 0 only
  const uint32_t* dense_hi;
  int dense_k;
  int kmer_size;
  int sigma;
  const int64_t* count_arr;
  int64_t sentinel;
  const int64_t* sym;  // [B, L]
  const int64_t* lens;
  int64_t B;
  int64_t L;
  int64_t steps;
  int64_t* lo_out;
  int64_t* hi_out;
};

__device__ __forceinline__ int64_t min64(int64_t x, int64_t y) { return x < y ? x : y; }
__device__ __forceinline__ int64_t max64(int64_t x, int64_t y) { return x > y ? x : y; }

// The symbol at column j of the pattern, j clamped into [0, L - 1].
__device__ __forceinline__ int64_t sym_at(const int64_t* row, int64_t L, int64_t j) {
  return row[min64(max64(j, 0), L - 1)];
}

// Occurrences of c before position p (get_next_rank: the sentinel shift,
// the block's checkpoint, the popcount of the masked lanes).
template <int P, int LANES>
__device__ __forceinline__ int64_t rank_next(const SearchArgs& a, int64_t pos, int c) {
  constexpr int kShift = LANES == 1 ? 5 : LANES == 2 ? 6 : 7;
  const int64_t p = pos + (pos < a.sentinel ? 1 : 0);
  const uint32_t* row = a.fused + (p >> kShift) * a.row_words;
  const uint32_t* planes = row + (a.row_words - P * LANES);
  const int rem = static_cast<int>(p & ((1 << kShift) - 1));
  uint32_t w[P * LANES];
#pragma unroll
  for (int k = 0; k < P * LANES; ++k) w[k] = __ldg(planes + k);
  const uint32_t ckpt = __ldg(row + c);
  int cnt = 0;
#pragma unroll
  for (int l = 0; l < LANES; ++l) {
    uint32_t comb = 0xFFFFFFFFu;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const uint32_t wq = w[q * LANES + l];
      comb &= ((c >> q) & 1) ? wq : ~wq;
    }
    const int take = min(max(rem - 32 * l, 0), 32);
    const uint32_t mask = take == 0 ? 0u : 0xFFFFFFFFu << (32 - take);
    cnt += __popc(comb & mask);
  }
  return static_cast<int64_t>(ckpt) + cnt;
}

// Thread 2i + e holds end e (0: lo, 1: hi) of pattern i.  Both threads of a
// pattern take the same number of steps and leave the loop together, so
// every shuffle finds its partner.
template <int P, int LANES>
__global__ void __launch_bounds__(kThreads) gather_search_kernel(const SearchArgs a) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  const int64_t i = t >> 1;
  if (i >= a.B) return;  // 2B threads in pairs: a pair leaves whole
  const bool is_hi = t & 1;
  const unsigned pair = 3u << (threadIdx.x & 30);
  const int64_t n = a.lens[i];
  const int64_t* row = a.sym + i * a.L;
  const int64_t L = a.L;

  int64_t end, rem_steps, seed_len;
  if (a.dense_k > 0 && n >= a.dense_k) {
    int64_t idx = 0;
    for (int d = 0; d < a.dense_k; ++d) idx = idx * a.sigma + sym_at(row, L, n - a.dense_k + d);
    end = __ldg((is_hi ? a.dense_hi : a.dense_lo) + idx);
    rem_steps = n - a.dense_k;
    seed_len = a.dense_k;
  } else {
    const int k = a.kmer_size;
    const int64_t base = a.sigma + 1;
    const int64_t m = min64(n, k);
    int64_t start = 0;
    for (int d = 0; d < k; ++d) start = start * base + (d < m ? sym_at(row, L, n - m + d) + 1 : 0);
    int64_t gap = 1;
    for (int64_t d = m; d < k; ++d) gap *= base;
    int64_t at = is_hi ? start + gap - 1 : start - 1;
    if (at < 0) at += a.n_kmer;
    end = a.kmer_tbl[at];
    rem_steps = max64(n - k, 0);
    seed_len = k;
  }

  const int64_t todo = min64(rem_steps, a.steps);
  for (int64_t s = 0; s < todo; ++s) {
    const int c = static_cast<int>(sym_at(row, L, n - seed_len - 1 - s));
    const int64_t pre = a.count_arr[c];
    const long long other = __shfl_xor_sync(pair, static_cast<long long>(end), 1);
    if (!(is_hi ? other < end : end < other)) break;
    end = pre + rank_next<P, LANES>(a, end, c);
  }
  (is_hi ? a.hi_out : a.lo_out)[i] = end;
}

template <int P>
cudaError_t launch_planes(int lanes, const SearchArgs& a, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((2 * a.B + kThreads - 1) / kThreads);
  switch (lanes) {
    case 1: gather_search_kernel<P, 1><<<blocks, kThreads, 0, stream>>>(a); break;
    case 2: gather_search_kernel<P, 2><<<blocks, kThreads, 0, stream>>>(a); break;
    default: gather_search_kernel<P, 4><<<blocks, kThreads, 0, stream>>>(a); break;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the search on `stream`; returns the launch's cudaError_t (0 when
// it was accepted).  planes 1-6, lanes 1, 2 or 4 (blocks of 32, 64 or 128
// positions); fused holds rows of row_words words whose last planes * lanes
// are the planes; dense_lo / dense_hi may be NULL when dense_k is 0.
int sview_gather_search(int planes, int lanes, int sigma, const void* fused, int64_t row_words,
                        const void* kmer_tbl, int64_t n_kmer, const void* dense_lo,
                        const void* dense_hi, int dense_k, int kmer_size, const void* count_arr,
                        int64_t sentinel, const void* sym, const void* lens, int64_t B, int64_t L,
                        int64_t steps, void* lo, void* hi, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (B > static_cast<int64_t>(0x7FFFFFFF) * (kThreads / 2)) return cudaErrorInvalidValue;
  if (planes < 1 || planes > 6 || (lanes != 1 && lanes != 2 && lanes != 4) || L < 1 ||
      row_words < planes * lanes || sigma < 1 || (dense_k > 0 && (!dense_lo || !dense_hi)))
    return cudaErrorInvalidValue;
  const SearchArgs a{static_cast<const uint32_t*>(fused), row_words,
                     static_cast<const int64_t*>(kmer_tbl), n_kmer,
                     static_cast<const uint32_t*>(dense_lo), static_cast<const uint32_t*>(dense_hi),
                     dense_k, kmer_size, sigma, static_cast<const int64_t*>(count_arr), sentinel,
                     static_cast<const int64_t*>(sym), static_cast<const int64_t*>(lens), B, L,
                     steps, static_cast<int64_t*>(lo), static_cast<int64_t*>(hi)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (planes) {
    case 1: return launch_planes<1>(lanes, a, s);
    case 2: return launch_planes<2>(lanes, a, s);
    case 3: return launch_planes<3>(lanes, a, s);
    case 4: return launch_planes<4>(lanes, a, s);
    case 5: return launch_planes<5>(lanes, a, s);
    default: return launch_planes<6>(lanes, a, s);
  }
}

}  // extern "C"
