// Sort-join rank kernel for Hopper (sm_90a): rank and decode modes, each
// plain or segmented, for every alphabet of 1 to 63 symbols.
//
// Replaces: sview_fmindex_tpu/ops/stream_join.py::_make_kernel (the Pallas
// kernel that _join_fn hands to pl.pallas_call) in all four of its modes:
// decode=False and decode=True, without blkkey (plain here) and with blkkey
// (segmented here), at every sigma the JAX package sends through it
// (sigma <= 63: the payload's 6-bit symbol).
//
// Row layout (int32 words, one row per 128 positions of the table):
//   words [0, SIGMA)        checkpoint: count of each symbol before the block
//   words [SIGMA, OFF)      zero padding
//   words [OFF, OFF + 4P)   P bit planes x 4 MSB-first uint32 lanes,
//                           P = ceil(log2 SIGMA) (1 at SIGMA <= 2)
// OFF is SIGMA rounded up to 4 words, so every row and its planes are
// 16-byte aligned; where that leaves a row of 48 bytes modulo 64, OFF grows
// by 4 more words (plane_offset below, the one place that decides it).
// Device memory is fetched in aligned 64-byte pieces: a row of 64k + 48 bytes
// would lie in k + 2 pieces at two of every four positions, a row of
// 64(k + 1) bytes lies in k + 1 wherever it starts (the other row sizes,
// 16 or 32 bytes modulo 64, never touch more pieces than they must).  The
// sigma 3-4 table grows by a third for it, the others by 5-14%.  Bytes per row:
//   SIGMA 1-2: 32   3-4: 64   5-8: 80   9-12: 128   13-16: 128
//   17-20: 160   21-24: 192   25-28: 192   29-32: 208   33-36: 256
//   37-40: 256   ...   61-63: 352
// (the main path's sigma=4 stream and sigma^2=16 pair rows: 64 B and
// 128 B; protein sigma=20: 160 B; wildcard DNA sigma=5: 80 B and its pair
// table's sigma^2=25: 192 B).
//
// What it computes, per query i with key p (a sentinel-shifted position):
//   row  = tbl[p >> 7]
//   sym  = payload[i] & 63             (rank mode)
//        | bit (31 - rem%32) of lane rem/32 of each plane   (decode mode)
//   rank = ckpt[sym] + sum_l popc(AND_planes(bit_q(sym) ? w : ~w) & mask_l),
//          rem = p & 127, mask_l = the first clamp(rem - 32l, 0, 32) bits,
//          ckpt[sym] = 0 for sym >= SIGMA.
// Segmented modes (u64-position texts): the table's checkpoints count from
// the first block of their segment of 2^seg_shift blocks, and the kernel
// adds the segment's global count, rank += seg_base[((p >> 7) >> seg_shift)
// * SIGMA + sym], with sym the decoded symbol in decode mode.  The TPU kernel
// keys on the u32 block id with rem in the payload and leaves the base add
// to its caller; here the key is the int64 position and the add is fused.
// Keys outside the table give rank 0 and sym 0.
//
// What bounds it on this card: the rate at which device memory hands out
// 64-byte pieces at data-dependent addresses.  Each query needs one row plus
// 24 B of keys and results; the arithmetic is a few dozen integer ops.  A real
// index misses the 50 MB L2 (the pair table is ~1 GB at 1 Gbp), and there
// almost every sorted key has a row of its own.  Measured with a standalone
// row-fetch probe on an H100 80GB HBM3 at 700 W, 2M sorted keys over 34.6M
// rows: a bare fetch of 32 B or of 64 B of a 64-byte-aligned row takes the
// same 0.075 ms (the piece is 64 B, about 2.1 TB/s of them against 2.7 TB/s
// for the same bytes streamed), rows 48 B apart take 0.088-0.090 ms, and it
// does not matter how many lanes share a row.  At 128-byte rows it does: one
// thread per row makes every load instruction of its warp touch 32 lines,
// once per 16 bytes of row (0.135 ms), 8 lanes per row touch 4 (0.109 ms).
//
// What the design does about it: rows never straddle a 64-byte piece they
// need not (the layout above), and a warp takes 32 consecutive sorted keys
// and fetches their rows together.
// - The rows asked by the 32 keys are found once: callers sort the keys, so
//   equal rows are neighbours, and a lane whose row differs from the lane
//   below heads a new one (shuffle, ballot); each distinct row is fetched
//   once, whatever the number of keys in it.
// - The lanes copy consecutive 16-byte pieces of consecutive rows into the
//   warp's slice of shared memory with cp.async.cg (no L1 allocation, no
//   register held while in flight): a 128-byte row is one line request from
//   8 lanes, not 8 requests from one.  Rows lie in shared memory at an odd
//   pitch of 16-byte vectors, so that the 8 threads of a 128-bit shared
//   load's phase hit 8 different bank groups.
// - Rows of at most 128 bytes (sigma <= 16) are staged whole in both modes:
//   checkpoints and planes are one or two neighbouring pieces, and asking
//   for them in one go is faster than planes here and a checkpoint word
//   there (on 2^23 rows at sigma 16 the split fetch lost to one thread per
//   key, the whole-row fetch beats it by 7%), and decode mode finds the word
//   of the symbol it decodes already there.  Of wider rows
//   only the P plane vectors are staged, since most of the checkpoint group
//   is not needed; the one checkpoint word is each thread's own load, in rank
//   mode sent after the copies and before the wait, in decode mode after
//   the symbol is known.
// - Keys, payloads and results go by once: they are read and written with
//   the streaming hints (ld.global.cs / st.global.cs), so rows keep the L2
//   where the table fits it.
// A block's shared memory is at most 18 KB (4 warps x 32 rows x 144 B), so
// enough warps are resident that one batch per warp keeps far more bytes in
// flight than latency times bandwidth needs: there is no multi-stage pipeline
// inside a warp, and more keys per thread bought nothing on the old kernel.
// With this the kernel runs within 10% of the bare fetch of its rows; what
// is left to its bound is the card's, which counts 36 B of a 64-byte piece
// and the streamed rate.
// The TPU kernel's chunk cursor, SMEM state, group-select gathers and DMA
// semaphores exist for a sequential grid and have no counterpart here.
//
// Address math is int64 throughout: keys reach 2^32 and beyond, and a
// 4.5 Gbp table has 35M rows.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 4;  // uint32 lanes per plane per 128-position block
constexpr int kMaxSigma = 63;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

__host__ __device__ constexpr int planes_for(int sigma) {
  int p = 0;
  for (int v = sigma - 1; v > 0; v >>= 1) ++p;
  return p < 1 ? 1 : p;
}

// Word offset of a row's planes: the layout's padding rule.
__host__ __device__ constexpr int plane_offset(int sigma) {
  int off = (sigma + 3) & ~3;
  if (((off + planes_for(sigma) * kLanes) & 15) == 12) off += 4;
  return off;
}

struct JoinArgs {
  const uint4* tbl;
  int64_t n_rows;
  int row_vecs;    // 16-byte vectors per row
  int plane_vec;   // the vector of a row where its planes start
  const int64_t* key;
  const int64_t* payload;   // rank mode only
  const int64_t* seg_base;  // segmented modes only: [n_segs, sigma]
  int seg_shift;
  int sigma;
  int64_t* rank_out;
  int64_t* sym_out;         // decode mode only
  int64_t n;
};

// Rows of at most 128 bytes (sigma <= 16, that is P <= 4) are staged whole;
// of wider rows only the P plane vectors.
template <int P>
__host__ __device__ constexpr bool staged_whole() { return P <= 4; }

// Vectors of a row that a warp stages, and the pitch they lie at in shared
// memory: odd, so 8 consecutive rows start in 8 different 16-byte bank groups.
template <int P>
__host__ __device__ __forceinline__ int staged_vecs(int row_vecs) {
  return staged_whole<P>() ? row_vecs : P;
}
__host__ __device__ __forceinline__ int pitch_of(int vecs) { return vecs | 1; }

__device__ __forceinline__ void copy16_async(uint4* dst_shared, const uint4* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(dst_shared));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void wait_async_copies() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The symbol at position rem of the block: one bit of lane rem/32 per plane.
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

// Occurrences of sym among the block's first rem positions.
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

// One thread per key, one warp per 32 consecutive keys.  No lane leaves
// before the warp's last shuffle, copy and barrier: a lane past n, or with a
// key outside the table, asks for no row and takes part all the same.
template <int P, bool DECODE, bool SEGMENTED>
__global__ void __launch_bounds__(kThreads) join_kernel(const JoinArgs a) {
  extern __shared__ uint4 staged[];            // [kWarps][32 rows][pitch]
  __shared__ int64_t row_of[kWarps][32];       // the distinct rows a warp asks
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  const bool live = i < a.n;
  const int64_t p = live ? __ldcs(a.key + i) : -1;
  int64_t sym_word = 0;
  if (!DECODE && live) sym_word = __ldcs(a.payload + i);
  const int64_t blk = p >> 7;
  const bool ok = p >= 0 && blk < a.n_rows;

  // the distinct rows among the warp's keys, in key order
  const int64_t mine = ok ? blk : -1;
  const int64_t below = __shfl_up_sync(kFullWarp, mine, 1);
  const bool head = ok && (lane == 0 || mine != below);
  const unsigned heads = __ballot_sync(kFullWarp, head);
  const int slot = __popc(heads & (kFullWarp >> (31 - lane))) - 1;  // of this lane's row
  if (head) row_of[warp][slot] = blk;
  __syncwarp();

  // lanes copy consecutive 16-byte pieces of consecutive rows
  constexpr bool kWhole = staged_whole<P>();
  const int vecs = staged_vecs<P>(a.row_vecs);
  const int first = kWhole ? 0 : a.plane_vec;
  const int pitch = pitch_of(vecs);
  uint4* rows = staged + warp * 32 * pitch;
  const int n_heads = __popc(heads);
  const int step_r = 32 / vecs;
  const int step_v = 32 - step_r * vecs;
  int r = lane / vecs;
  int v = lane - r * vecs;
  while (r < n_heads) {
    copy16_async(rows + r * pitch + v, a.tbl + row_of[warp][r] * a.row_vecs + first + v);
    r += step_r;
    v += step_v;
    if (v >= vecs) {
      v -= vecs;
      ++r;
    }
  }

  // rank mode on a wide row: the one checkpoint word, asked while the copies fly
  int sym = static_cast<int>(sym_word & 63);
  uint32_t ckpt = 0;
  const uint32_t* ckpt_words = reinterpret_cast<const uint32_t*>(a.tbl + blk * a.row_vecs);
  if (!kWhole && !DECODE && ok && sym < a.sigma) ckpt = __ldg(ckpt_words + sym);
  wait_async_copies();
  __syncwarp();
  if (!live) return;
  if (!ok) {
    __stcs(a.rank_out + i, static_cast<int64_t>(0));
    if (DECODE) __stcs(a.sym_out + i, static_cast<int64_t>(0));
    return;
  }

  const uint4* row = rows + slot * pitch;
  const uint4* planes = row + (kWhole ? a.plane_vec : 0);
  uint32_t w[P * kLanes];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const uint4 x = planes[q];
    w[4 * q] = x.x;
    w[4 * q + 1] = x.y;
    w[4 * q + 2] = x.z;
    w[4 * q + 3] = x.w;
  }
  const int rem = static_cast<int>(p & 127);
  if (DECODE) sym = decode_sym<P>(w, rem);
  if (kWhole) {
    ckpt = sym < a.sigma ? reinterpret_cast<const uint32_t*>(row)[sym] : 0u;
  } else if (DECODE) {
    ckpt = sym < a.sigma ? __ldg(ckpt_words + sym) : 0u;
  }
  // the u32 sum ckpt + cnt is exact: on a narrow table the checkpoint may
  // reach 2^32 - 1, but the sum is a rank, at most n < 2^32; a segmented
  // table's checkpoint is local, below 2^31, plus at most 128
  int64_t rank = static_cast<int64_t>(ckpt + count_before<P>(w, sym, rem));
  if (SEGMENTED && sym < a.sigma) rank += a.seg_base[(blk >> a.seg_shift) * a.sigma + sym];
  __stcs(a.rank_out + i, rank);
  if (DECODE) __stcs(a.sym_out + i, static_cast<int64_t>(sym));
}

template <int P, bool DECODE, bool SEGMENTED>
cudaError_t launch_planes(const JoinArgs& a, cudaStream_t stream) {
  const size_t shared = static_cast<size_t>(kWarps) * 32 *
                        pitch_of(staged_vecs<P>(a.row_vecs)) * sizeof(uint4);
  const unsigned blocks = static_cast<unsigned>((a.n + kThreads - 1) / kThreads);
  join_kernel<P, DECODE, SEGMENTED><<<blocks, kThreads, shared, stream>>>(a);
  return cudaGetLastError();
}

template <bool DECODE, bool SEGMENTED>
cudaError_t launch(const JoinArgs& a, cudaStream_t stream) {
  switch (planes_for(a.sigma)) {
    case 1: return launch_planes<1, DECODE, SEGMENTED>(a, stream);
    case 2: return launch_planes<2, DECODE, SEGMENTED>(a, stream);
    case 3: return launch_planes<3, DECODE, SEGMENTED>(a, stream);
    case 4: return launch_planes<4, DECODE, SEGMENTED>(a, stream);
    case 5: return launch_planes<5, DECODE, SEGMENTED>(a, stream);
    default: return launch_planes<6, DECODE, SEGMENTED>(a, stream);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the launch's cudaError_t (0 when
// it was accepted).  1 <= sigma <= 63; tbl holds rows of the layout above,
// 16-byte aligned.  A non-NULL seg_base selects the segmented mode; every
// row's segment (row >> seg_shift) must have a base.
int sview_join(int sigma, int decode, const void* tbl, int64_t n_rows, const void* key,
               const void* payload, const void* seg_base, int seg_shift, void* rank,
               void* sym, int64_t n, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (n > static_cast<int64_t>(0x7FFFFFFF) * kThreads) return cudaErrorInvalidValue;  // grid.x
  if (sigma < 1 || sigma > kMaxSigma) return cudaErrorInvalidValue;
  if (seg_base != nullptr && (seg_shift < 0 || seg_shift > 56)) return cudaErrorInvalidValue;
  const int off = plane_offset(sigma);
  const JoinArgs a{static_cast<const uint4*>(tbl), n_rows,
                   (off + planes_for(sigma) * kLanes) / 4, off / 4,
                   static_cast<const int64_t*>(key), static_cast<const int64_t*>(payload),
                   static_cast<const int64_t*>(seg_base), seg_shift, sigma,
                   static_cast<int64_t*>(rank), static_cast<int64_t*>(sym), n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool segmented = seg_base != nullptr;
  if (decode) return segmented ? launch<true, true>(a, s) : launch<true, false>(a, s);
  return segmented ? launch<false, true>(a, s) : launch<false, false>(a, s);
}

const char* sview_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
