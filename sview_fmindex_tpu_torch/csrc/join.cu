// Sort-join rank kernel for Hopper (sm_90a): rank and decode modes, each
// plain or segmented.
//
// Replaces: sview_fmindex_tpu/ops/stream_join.py::_make_kernel (the Pallas
// kernel that _join_fn hands to pl.pallas_call) in all four of its modes:
// decode=False and decode=True, without blkkey (plain here) and with blkkey
// (segmented here).
//
// What it computes, per query i with key p (a sentinel-shifted position):
//   row  = tbl[p >> 7]   (one stream-table row: SIGMA checkpoint words, then
//                         P bit planes x 4 MSB-first uint32 lanes)
//   sym  = payload[i] & 63             (rank mode)
//        | bit (31 - rem%32) of lane rem/32 of each plane   (decode mode)
//   rank = ckpt[sym] + sum_l popc(AND_planes(bit_q(sym) ? w : ~w) & mask_l),
//          rem = p & 127, mask_l = the first clamp(rem - 32l, 0, 32) bits.
// Segmented modes (u64-position texts): the table's checkpoints count from
// the first block of their segment of 2^seg_shift blocks, and the kernel
// adds the segment's global count, rank += seg_base[((p >> 7) >> seg_shift)
// * SIGMA + sym], with sym the decoded symbol in decode mode.  The TPU kernel
// keys on the u32 block id with rem in the payload and leaves the base add
// to its caller; here the key is the int64 position and the add is fused.
// Keys outside the table give rank 0 and sym 0.
//
// What bounds it on this card: device-memory traffic.  Each query reads one
// 48 B (SIGMA=4) or 128 B (SIGMA=16) row at a data-dependent address plus
// 24-32 B of keys and outputs; the arithmetic is a few dozen integer ops.  A
// B=1M search pass ranks 2M keys against a pair table that is ~1 GB at
// 1 Gbp, far beyond the 50 MB L2, so rows come from HBM.  A segmented query
// adds one 8-byte seg_base read; the base table is n_segs * SIGMA * 8 bytes
// (96 B at 4.5 Gbp), so it stays in L1/L2.
//
// What the design does about it: one thread per query, no shared state.
// Callers sort the keys, so neighbouring threads read the same or
// neighbouring rows: warps coalesce, repeated rows hit L2, and each row is
// read as 16-byte vector loads.  The TPU kernel's chunk cursor, SMEM state,
// group-select gathers and DMA semaphores exist for a sequential grid and
// have no counterpart here.  Staging the sorted key range's rows in shared
// memory, or fewer bytes per row, is later work.
//
// Address math is int64 throughout: keys reach 2^32 and beyond, and a
// 4.5 Gbp table has 35M rows.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 4;  // uint32 lanes per plane per 128-position block

__host__ __device__ constexpr int planes_for(int sigma) {
  int p = 0;
  for (int v = sigma - 1; v > 0; v >>= 1) ++p;
  return p < 1 ? 1 : p;
}

struct JoinArgs {
  const int32_t* tbl;
  int64_t n_rows;
  const int64_t* key;
  const int64_t* payload;   // rank mode only
  const int64_t* seg_base;  // segmented modes only: [n_segs, SIGMA]
  int seg_shift;
  int64_t* rank_out;
  int64_t* sym_out;         // decode mode only
  int64_t n;
};

template <int SIGMA, bool DECODE, bool SEGMENTED>
__global__ void __launch_bounds__(256) join_kernel(const JoinArgs a) {
  constexpr int P = planes_for(SIGMA);
  constexpr int RW = SIGMA + P * kLanes;
  static_assert(RW % 4 == 0, "rows are read as 16-byte vectors");

  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= a.n) return;
  const int64_t p = a.key[i];
  const int64_t blk = p >> 7;
  if (p < 0 || blk >= a.n_rows) {
    a.rank_out[i] = 0;
    if (DECODE) a.sym_out[i] = 0;
    return;
  }

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
  int sym;
  if (DECODE) {
    const int lane = rem >> 5;
    const int bit = 31 - (rem & 31);
    sym = 0;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      uint32_t lv = 0;
#pragma unroll
      for (int l = 0; l < kLanes; ++l) lv = (l == lane) ? w[SIGMA + q * kLanes + l] : lv;
      sym |= static_cast<int>((lv >> bit) & 1u) << q;
    }
  } else {
    sym = static_cast<int>(a.payload[i] & 63);
  }

  uint32_t ckpt = 0;
#pragma unroll
  for (int s = 0; s < SIGMA; ++s) ckpt = (s == sym) ? w[s] : ckpt;

  uint32_t cnt = 0;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    uint32_t comb = 0xFFFFFFFFu;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const uint32_t wq = w[SIGMA + q * kLanes + l];
      comb &= ((sym >> q) & 1) ? wq : ~wq;
    }
    const int take = min(max(rem - 32 * l, 0), 32);
    const uint32_t mask = take == 0 ? 0u : 0xFFFFFFFFu << (32 - take);
    cnt += __popc(comb & mask);
  }

  // a local checkpoint is below 2^31 and cnt <= 128, so the u32 sum is exact
  int64_t rank = static_cast<int64_t>(ckpt + cnt);
  if (SEGMENTED && sym < SIGMA) rank += a.seg_base[(blk >> a.seg_shift) * SIGMA + sym];
  a.rank_out[i] = rank;
  if (DECODE) a.sym_out[i] = sym;
}

template <int SIGMA, bool DECODE, bool SEGMENTED>
cudaError_t launch(const JoinArgs& a, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t blocks = (a.n + kThreads - 1) / kThreads;
  join_kernel<SIGMA, DECODE, SEGMENTED>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int SIGMA>
cudaError_t launch_mode(bool decode, const JoinArgs& a, cudaStream_t stream) {
  const bool segmented = a.seg_base != nullptr;
  if (decode) {
    return segmented ? launch<SIGMA, true, true>(a, stream)
                     : launch<SIGMA, true, false>(a, stream);
  }
  return segmented ? launch<SIGMA, false, true>(a, stream)
                   : launch<SIGMA, false, false>(a, stream);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the launch's cudaError_t (0 when
// it was accepted).  sigma must be 4 or 16.  A non-NULL seg_base selects the
// segmented mode; every row's segment (row >> seg_shift) must have a base.
int sview_join(int sigma, int decode, const void* tbl, int64_t n_rows,
               const void* key, const void* payload, const void* seg_base,
               int seg_shift, void* rank, void* sym, int64_t n, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (n > static_cast<int64_t>(0x7FFFFFFF) * 256) return cudaErrorInvalidValue;  // grid.x limit
  if (seg_base != nullptr && (seg_shift < 0 || seg_shift > 56)) return cudaErrorInvalidValue;
  const JoinArgs a{static_cast<const int32_t*>(tbl), n_rows,
                   static_cast<const int64_t*>(key), static_cast<const int64_t*>(payload),
                   static_cast<const int64_t*>(seg_base), seg_shift,
                   static_cast<int64_t*>(rank), static_cast<int64_t*>(sym), n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sigma) {
    case 4:
      return launch_mode<4>(decode != 0, a, s);
    case 16:
      return launch_mode<16>(decode != 0, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* sview_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
