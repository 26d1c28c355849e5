// The LF walk of a narrow index in one kernel, for Hopper (sm_90a): every
// located BWT row walked back to a row the sampled suffix array holds, in
// registers from its first step to its answer.
//
// Replaces no TPU kernel.  The JAX package writes the walk in jnp
// (sview_fmindex_tpu/ops/locate.py::lf_walk, a loop whose every step decodes
// the whole row buffer through the Pallas join kernel's decode mode,
// sview_fmindex_tpu/ops/stream_join.py), and XLA runs the loop on the device.
// The port runs eagerly: its plain version (ops/locate.lf_walk) sorts the row
// buffer, launches the join's decode and ~25 elementwise ops, and reads the
// count of live rows on the host, every step, about 445 steps for a buffer of
// 1M rows at r = 32.  This kernel is that whole loop in one launch.
//
// What it computes, per row i of the buffer (ops/locate.lf_walk with the
// narrow decode ops/rank.pre_rank_and_symidx; one answer per row, equal to it
// bit for bit):
//   pos = rows[i], offset = 0; a row that is not valid never steps.
//   while pos % r != 0:
//     one decode; if pos == sentinel - 1: the answer is offset, stop;
//     pos <- count_arr[c] + rank, offset += 1, where c and rank come from the
//     fused row of the sentinel-shifted p = pos + (pos < sentinel): c is the
//     symbol at p % BL (bit 31 - p % 32 of lane p % BL / 32 in each of the P
//     planes, plane q giving bit q of c), rank = ckpt[c] + popc of the
//     positions before p % BL in the block that hold c, BL = 32 * LANES.
//   the answer is u32(sa[pos / r]) + offset.
// Positions and checkpoints are int64, or u32 words widened to int64, so a
// narrow index up to 2^32 - 1 bp reads as the plain version reads it.
//
// Fused row layout (int32 words, one row per block of BL positions):
//   words [0, sigma)                checkpoint: count of each symbol before
//                                   the block
//   words [W - P*LANES, W)          P bit planes x LANES MSB-first u32 lanes
// (W = sigma + P*LANES: 8 words, 32 B, at dna20's sigma 4, P 2, LANES 2.)
//
// What bounds it on this card: the latency of each row's chain of dependent
// reads.  A step reads one 32-B row whose address is the previous step's
// result, and a row takes r - 1 steps at most, about r on average (the
// walk's length is close to geometric): 32.5M row steps for a 1M-row call at
// r = 32, about 1 GB of row reads.  dna20's fused table is 1.5625M rows x 32
// B = 50 MB, so much of it sits in the 50 MB L2; the rest is one random
// 32-B sector of device memory a step.
//
// What the design does about it: one thread walks one row, so each row's
// chain is its own and as many chains are in flight as the card holds
// threads (256-thread blocks at 32 registers: 2048 a SM, the whole card's
// 270K at dna20's layout).  count_arr sits in shared memory; the row and the
// sampled SA are read through the read-only path; the row's plane words are
// read first and its checkpoint word, in the same sector at sigma 4, once the
// symbol is known.  Walks differ in length (close to geometric: mean ~31, the
// longest of 1M ~420 at r = 32), so a warp runs as long as its longest lane,
// about 4x its mean, with the rest of its lanes done.  A persistent grid in
// which a lane that ends takes the next row from a queue (one atomic per warp
// and chunk of 32 rows, the idle lanes filled by ballot) keeps every lane
// busy, and was measured against this design on an H100 (700 W) at sa32's
// 1M rows: 0.850-0.857 ms against 0.759-0.763 ms for one thread a row, in
// turns in one call.  The queue's grid holds 75% of the threads (40
// registers), and its ballots cost each step more than the idle lanes do:
// what bounds the walk is the reads in flight, and the block scheduler refills
// an SM as soon as a block ends.  Launched on the caller's stream, no
// synchronisation; the output and the optional count buffer are allocated by
// the caller.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCount = 64;  // count_arr words staged: 2^P symbols at most
constexpr unsigned kFull = 0xFFFFFFFFu;

struct WalkArgs {
  const uint32_t* fused;
  int64_t row_words;
  const int64_t* count_arr;
  int n_count;  // count_arr words staged in shared memory
  const uint32_t* sa;  // the sampled SA, u32 words
  int64_t sentinel;
  int64_t r;
  int r_shift;  // log2(r) where r is a power of two, else -1
  const int64_t* rows;
  const uint8_t* valid;
  int64_t n;
  int64_t* out;
  unsigned long long* stats;  // NULL, or [decodes of all rows, of the longest]
};

__device__ __forceinline__ bool is_sampled(const WalkArgs& a, int64_t pos) {
  return a.r_shift >= 0 ? (pos & (a.r - 1)) == 0 : pos % a.r == 0;
}

__device__ __forceinline__ int64_t sa_at(const WalkArgs& a, int64_t pos) {
  const int64_t k = a.r_shift >= 0 ? pos >> a.r_shift : pos / a.r;
  return static_cast<int64_t>(__ldg(a.sa + k));
}

// LF(pos) = count_arr[c] + rank of c before pos, c the symbol at pos
// (get_pre_rank_and_symidx); pos is not the sentinel's row.
template <int P, int LANES>
__device__ __forceinline__ int64_t lf_step(const WalkArgs& a, const int64_t* cnt, int64_t pos) {
  constexpr int kShift = LANES == 1 ? 5 : LANES == 2 ? 6 : 7;
  const int64_t p = pos + (pos < a.sentinel ? 1 : 0);
  const uint32_t* row = a.fused + (p >> kShift) * a.row_words;
  const uint32_t* planes = row + (a.row_words - P * LANES);
  const int rem = static_cast<int>(p & ((1 << kShift) - 1));
  uint32_t w[P * LANES];
#pragma unroll
  for (int k = 0; k < P * LANES; ++k) w[k] = __ldg(planes + k);
  const int lane = rem >> 5;
  const int bit = 31 - (rem & 31);
  int c = 0;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    uint32_t lw = w[q * LANES];
#pragma unroll
    for (int l = 1; l < LANES; ++l) lw = l == lane ? w[q * LANES + l] : lw;
    c |= static_cast<int>((lw >> bit) & 1u) << q;
  }
  const uint32_t ckpt = __ldg(row + c);
  int before = 0;
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
    before += __popc(comb & mask);
  }
  return cnt[c] + static_cast<int64_t>(ckpt) + before;
}

// Thread i walks row i.  Every thread of the grid reaches the warp's
// reduction of the counts at the end, those past n with none.
template <int P, int LANES>
__global__ void __launch_bounds__(kThreads) lf_walk_kernel(const WalkArgs a) {
  __shared__ int64_t cnt[kMaxCount];
  for (int s = threadIdx.x; s < a.n_count; s += kThreads) cnt[s] = a.count_arr[s];
  __syncthreads();
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  unsigned long long steps = 0;
  if (i < a.n) {
    int64_t pos = a.rows[i], offset = 0;
    bool sentinel = false;
    if (a.valid[i]) {  // a row that is not valid never steps
      while (!is_sampled(a, pos)) {
        ++steps;
        if (pos == a.sentinel - 1) {
          sentinel = true;
          break;
        }
        pos = lf_step<P, LANES>(a, cnt, pos);
        ++offset;
      }
    }
    a.out[i] = sentinel ? offset : sa_at(a, pos) + offset;
  }
  if (a.stats != nullptr) {
    unsigned long long longest = steps;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      steps += __shfl_xor_sync(kFull, steps, o);
      const unsigned long long m = __shfl_xor_sync(kFull, longest, o);
      longest = longest > m ? longest : m;
    }
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(a.stats, steps);
      atomicMax(a.stats + 1, longest);
    }
  }
}

template <int P>
cudaError_t launch_planes(int lanes, const WalkArgs& a, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((a.n + kThreads - 1) / kThreads);
  switch (lanes) {
    case 1: lf_walk_kernel<P, 1><<<blocks, kThreads, 0, stream>>>(a); break;
    case 2: lf_walk_kernel<P, 2><<<blocks, kThreads, 0, stream>>>(a); break;
    default: lf_walk_kernel<P, 4><<<blocks, kThreads, 0, stream>>>(a); break;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the walk of n rows on `stream`; returns the launch's cudaError_t
// (0 when it was accepted).  planes 1-6, lanes 1, 2 or 4 (blocks of 32, 64 or
// 128 positions); fused holds rows of row_words words whose first sigma are
// the checkpoints and last planes * lanes the planes; sa the sampled SA
// (every r-th row), u32 words; rows int64, valid one byte a row, out int64;
// stats NULL or two zeroed u64, which gather the decodes of all rows and
// those of the row that took the most.
int sview_lf_walk(int planes, int lanes, int sigma, const void* fused, int64_t row_words,
                  const void* count_arr, int64_t n_count, const void* sa, int64_t sentinel,
                  int64_t r, const void* rows, const void* valid, int64_t n, void* out,
                  void* stats, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (n > static_cast<int64_t>(0x7FFFFFFF) * kThreads) return cudaErrorInvalidValue;
  if (planes < 1 || planes > 6 || (lanes != 1 && lanes != 2 && lanes != 4) || sigma < 1 ||
      row_words < sigma + planes * lanes || n_count < 1 || r < 1)
    return cudaErrorInvalidValue;
  int r_shift = -1;
  if ((r & (r - 1)) == 0)
    for (r_shift = 0; (int64_t{1} << r_shift) < r; ++r_shift) {
    }
  const WalkArgs a{static_cast<const uint32_t*>(fused), row_words,
                   static_cast<const int64_t*>(count_arr),
                   static_cast<int>(n_count < kMaxCount ? n_count : kMaxCount),
                   static_cast<const uint32_t*>(sa), sentinel, r, r_shift,
                   static_cast<const int64_t*>(rows), static_cast<const uint8_t*>(valid), n,
                   static_cast<int64_t*>(out), static_cast<unsigned long long*>(stats)};
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
