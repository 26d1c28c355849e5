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
//   words [SIGMA, OFF)      zero padding, OFF = SIGMA rounded up to 4
//   words [OFF, OFF + 4P)   P bit planes x 4 MSB-first uint32 lanes,
//                           P = ceil(log2 SIGMA) (1 at SIGMA <= 2)
// RW = OFF + 4P words is a multiple of 4, so every row and its planes are
// 16-byte aligned.  Bytes per row, 16 * (ceil(SIGMA/4) + P):
//   SIGMA 1-2: 32   3-4: 48   5-8: 80   9-12: 112   13-16: 128
//   17-20: 160   21-24: 176   25-28: 192   29-32: 208
//   33-36: 240   37-40: 256   ...  +16 per 4 symbols ...   61-63: 352
// (the main path's sigma=4 stream and sigma^2=16 pair rows: 48 B and
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
// What bounds it on this card: device-memory traffic.  Each query reads one
// row at a data-dependent address plus 24-32 B of keys and outputs; the
// arithmetic is a few dozen integer ops.  A B=1M search pass ranks 2M keys
// against a pair table that is ~1 GB at 1 Gbp, far beyond the 50 MB L2, so
// rows come from HBM.  A segmented query adds one 8-byte seg_base read; the
// base table is n_segs * SIGMA * 8 bytes (96 B at 4.5 Gbp), so it stays in
// L1/L2.
//
// What the design does about it: one thread per query, no shared state.
// Callers sort the keys, so neighbouring threads read the same or
// neighbouring rows: warps coalesce, repeated rows hit L2, and each row is
// read as 16-byte vector loads.  Two instantiations per mode:
// - join_kernel<SIGMA>, for the main path's sigma 4 and 16: the whole row in
//   registers, the checkpoint picked from them with compile-time indices;
// - join_kernel_any<P>, for every other sigma: sigma is a run-time value,
//   so only the P plane vectors are loaded into registers (their offset is
//   a multiple of 4 words), and the one checkpoint word the query needs is
//   read from the row, whose line the vector loads brought into L1.  P
//   ranges over 1..6, so 24 kernels serve the 61 other alphabets.
// The TPU kernel's chunk cursor, SMEM state, group-select gathers and DMA
// semaphores exist for a sequential grid and have no counterpart here.
// Staging the sorted key range's rows in shared memory, or fewer bytes per
// row, is later work.
//
// Address math is int64 throughout: keys reach 2^32 and beyond, and a
// 4.5 Gbp table has 35M rows.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 4;  // uint32 lanes per plane per 128-position block
constexpr int kMaxSigma = 63;

__host__ __device__ constexpr int planes_for(int sigma) {
  int p = 0;
  for (int v = sigma - 1; v > 0; v >>= 1) ++p;
  return p < 1 ? 1 : p;
}

__host__ __device__ constexpr int plane_offset(int sigma) { return (sigma + 3) & ~3; }

struct JoinArgs {
  const int32_t* tbl;
  int64_t n_rows;
  const int64_t* key;
  const int64_t* payload;   // rank mode only
  const int64_t* seg_base;  // segmented modes only: [n_segs, sigma]
  int seg_shift;
  int sigma;
  int64_t* rank_out;
  int64_t* sym_out;         // decode mode only
  int64_t n;
};

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

// Writes query i's outputs; ckpt + cnt is a local checkpoint (below 2^31)
// plus at most 128, so the u32 sum is exact.
template <bool DECODE, bool SEGMENTED>
__device__ __forceinline__ void store(const JoinArgs& a, int64_t i, int64_t blk, int sigma,
                                      int sym, uint32_t ckpt, uint32_t cnt) {
  int64_t rank = static_cast<int64_t>(ckpt + cnt);
  if (SEGMENTED && sym < sigma) rank += a.seg_base[(blk >> a.seg_shift) * sigma + sym];
  a.rank_out[i] = rank;
  if (DECODE) a.sym_out[i] = sym;
}

// Query i's block, or -1 (outputs written) for a key outside the table.
template <bool DECODE>
__device__ __forceinline__ int64_t block_of(const JoinArgs& a, int64_t i, int64_t p) {
  const int64_t blk = p >> 7;
  if (p < 0 || blk >= a.n_rows) {
    a.rank_out[i] = 0;
    if (DECODE) a.sym_out[i] = 0;
    return -1;
  }
  return blk;
}

template <int SIGMA, bool DECODE, bool SEGMENTED>
__global__ void __launch_bounds__(256) join_kernel(const JoinArgs a) {
  constexpr int P = planes_for(SIGMA);
  constexpr int RW = SIGMA + P * kLanes;
  static_assert(SIGMA % 4 == 0 && RW % 4 == 0, "rows are read as 16-byte vectors");

  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= a.n) return;
  const int64_t p = a.key[i];
  const int64_t blk = block_of<DECODE>(a, i, p);
  if (blk < 0) return;

  uint32_t w[RW];
  const uint4* row = reinterpret_cast<const uint4*>(a.tbl + blk * RW);
#pragma unroll
  for (int v = 0; v < RW / 4; ++v) {
    const uint4 x = __ldg(row + v);
    w[4 * v] = x.x;
    w[4 * v + 1] = x.y;
    w[4 * v + 2] = x.z;
    w[4 * v + 3] = x.w;
  }

  const int rem = static_cast<int>(p & 127);
  const int sym = DECODE ? decode_sym<P>(w + SIGMA, rem) : static_cast<int>(a.payload[i] & 63);
  uint32_t ckpt = 0;
#pragma unroll
  for (int s = 0; s < SIGMA; ++s) ckpt = (s == sym) ? w[s] : ckpt;
  store<DECODE, SEGMENTED>(a, i, blk, SIGMA, sym, ckpt, count_before<P>(w + SIGMA, sym, rem));
}

template <int P, bool DECODE, bool SEGMENTED>
__global__ void __launch_bounds__(256) join_kernel_any(const JoinArgs a) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= a.n) return;
  const int64_t p = a.key[i];
  const int64_t blk = block_of<DECODE>(a, i, p);
  if (blk < 0) return;

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

template <bool DECODE, bool SEGMENTED>
cudaError_t launch(const JoinArgs& a, bool any, cudaStream_t stream) {
  void (*kernel)(JoinArgs);
  if (!any && a.sigma == 4) {
    kernel = join_kernel<4, DECODE, SEGMENTED>;
  } else if (!any && a.sigma == 16) {
    kernel = join_kernel<16, DECODE, SEGMENTED>;
  } else {
    switch (planes_for(a.sigma)) {
      case 1: kernel = join_kernel_any<1, DECODE, SEGMENTED>; break;
      case 2: kernel = join_kernel_any<2, DECODE, SEGMENTED>; break;
      case 3: kernel = join_kernel_any<3, DECODE, SEGMENTED>; break;
      case 4: kernel = join_kernel_any<4, DECODE, SEGMENTED>; break;
      case 5: kernel = join_kernel_any<5, DECODE, SEGMENTED>; break;
      default: kernel = join_kernel_any<6, DECODE, SEGMENTED>; break;
    }
  }
  constexpr int kThreads = 256;
  const unsigned blocks = static_cast<unsigned>((a.n + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

int join(bool any, int sigma, int decode, const void* tbl, int64_t n_rows, const void* key,
         const void* payload, const void* seg_base, int seg_shift, void* rank, void* sym,
         int64_t n, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (n > static_cast<int64_t>(0x7FFFFFFF) * 256) return cudaErrorInvalidValue;  // grid.x limit
  if (sigma < 1 || sigma > kMaxSigma) return cudaErrorInvalidValue;
  if (seg_base != nullptr && (seg_shift < 0 || seg_shift > 56)) return cudaErrorInvalidValue;
  const JoinArgs a{static_cast<const int32_t*>(tbl), n_rows,
                   static_cast<const int64_t*>(key), static_cast<const int64_t*>(payload),
                   static_cast<const int64_t*>(seg_base), seg_shift, sigma,
                   static_cast<int64_t*>(rank), static_cast<int64_t*>(sym), n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool segmented = seg_base != nullptr;
  if (decode) {
    return segmented ? launch<true, true>(a, any, s) : launch<true, false>(a, any, s);
  }
  return segmented ? launch<false, true>(a, any, s) : launch<false, false>(a, any, s);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the launch's cudaError_t (0 when
// it was accepted).  1 <= sigma <= 63; tbl holds rows of the layout above.
// A non-NULL seg_base selects the segmented mode; every row's segment
// (row >> seg_shift) must have a base.
int sview_join(int sigma, int decode, const void* tbl, int64_t n_rows, const void* key,
               const void* payload, const void* seg_base, int seg_shift, void* rank,
               void* sym, int64_t n, void* stream) {
  return join(false, sigma, decode, tbl, n_rows, key, payload, seg_base, seg_shift, rank, sym,
              n, stream);
}

// sview_join through the run-time-sigma kernel at every sigma, 4 and 16
// included: for timing it against their own instantiations.
int sview_join_any(int sigma, int decode, const void* tbl, int64_t n_rows, const void* key,
                   const void* payload, const void* seg_base, int seg_shift, void* rank,
                   void* sym, int64_t n, void* stream) {
  return join(true, sigma, decode, tbl, n_rows, key, payload, seg_base, seg_shift, rank, sym,
              n, stream);
}

const char* sview_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
