// Fused gate run: one read+write pass of the planar (2, 2^n) state that
// applies an ordered list of gate ops to every tile of it.
//
// Replaces the TPU kernel quest_tpu/ops/pallas_gates.py::_fused_local_run
// (the manual-DMA chunk loop _make_dma_kernel and the BlockSpec grid kernel
// _make_kernel, both running the op body _ops_body), on one device and per
// shard of a sharded state. It computes what
// _ops_body computes, op kind for op kind:
//   matrix  2x2 on an in-tile target (or a diagonal 2x2 on any qubit), any
//           controls with any control states
//   parity  exp(-i theta/2 Z..Z) on any qubits, all-1 controls
//   swap    SWAP of two in-tile qubits, any controls and states
//   diagw   a <= 256-entry diagonal table over any targets, all-1 controls
//   lane_u  a dense 128x128 complex unitary on qubits [0, 7)
//   window  a dense 2^span x 2^span complex unitary (span <= 5) on the
//           in-tile qubits [lo, lo + span)
//   kraus1, kraus2, krausn
//           a whole decoherence channel on a density state,
//           rho' = sum_k s_k K_k rho K_k^dagger with K_k on t = 1, 2 or 3
//           in-tile row qubits and conj(K_k) on t in-tile column qubits
// and folds a frame swap (the bit blocks [T-k, T) and [hi, hi+k) of the
// flat index exchanged) into the loads and/or the stores, and a second,
// 1-bit exchange (an in-tile bit with one above the tile) into both.
//
// Design. One thread block owns one tile of 2^T amplitudes (T = tile_bits)
// and keeps both planes of it in shared memory for the whole op list.
// Bits >= T of an amplitude's index come from blockIdx; a partner
// exchange amp[i ^ 2^q] is a shared-memory access, with __syncthreads()
// between ops.
//
// Per shard (the BlockSpec grid kernel _make_kernel with local_n and its
// SMEM shard index hi_ref, pallas_gates.py:725-767, and the per-shard f64
// runs of _make_dma_kernel, :818-824 and :887-888). A state sharded over
// D = 2^d devices is D blocks (2, 2^local_n) of the flat index, shard r
// holding [r 2^local_n, (r+1) 2^local_n). One launch runs on one shard: the
// grid covers its 2^(local_n - T) tiles and addresses stay local, while an
// op's roles read the GLOBAL index, (shard_index << local_n) | local index.
// So controls, diagonal targets, diagw members and parity members on the
// sharded qubits (q >= local_n) resolve inside the kernel, per block, with
// no communication. Dense targets stay below the tile and folded swaps
// inside the shard (hi + k <= local_n): the caller checks both. A
// single-device call passes local_n = n and shard_index = 0.
//
// The ops arrive as a table (8 int64 per op: kind, qubits,
// control mask and values, parity mask, offset of the op's coefficients)
// plus a coefficient buffer, so one build serves every plan. A pass with
// a folded swap reads tiles that other blocks write: the caller runs it
// out of place (dst != src); a pass without one runs in place.
//
// What bounds it on an H100. A pass moves 2 x state bytes (each amplitude
// read once and written once): at 26 qubits in f32, 1 GiB, 0.32 ms at
// 3.35 TB/s. Elementwise and 2x2 ops cost a few flops per amplitude, so a
// pass of them is bound by bytes, and the design keeps the whole op list
// between one load and one store of each tile.
//   Diagonal ops (the diagonal arm, diag_sweep). Applied one at a time,
//     each op would make every block read and write its tile in shared
//     memory and wait at a barrier: a QFT pass of 96 controlled phases at
//     26 qubits in f32 is 96 x 2^26 x 16 B, ~100 GB of shared-memory
//     traffic, ~3 ms at the card's ~33 TB/s, ten times the pass's bytes.
//     And at ~33e12 lane instructions a second, the 0.32 ms bound leaves
//     ~175 instructions an amplitude for the whole pass, against 15-20 an
//     op when each op tests its controls and extracts its bits. So the
//     host merges each run of consecutive diagonal ops into few tables
//     (merge_diagonals: controls become index bits; the QFT's densest
//     run, 91 phases, -> 11 tables of <= 2^8 entries), and the kernel
//     applies a run of such records in one sweep, the amplitudes in
//     registers, with the per-record index parts that do not vary across
//     a thread's amplitudes staged once per block: about 6 instructions
//     an amplitude a record (an XOR, a shared-memory load of the entry, a
//     complex multiply).
//   2x2 and swap ops (the 2x2 arm, reg_sweep). Applied one at a time, each
//     makes the block read and write both planes of its tile in shared
//     memory and wait at a barrier, the same cost as a diagonal op. So the
//     host groups each run of them whose partner qubits fit a set Q of 3
//     (f32) or 2 (f64) in-tile qubits into one register sweep: a thread
//     holds the 2^|Q| amplitudes of its slice that differ in Q, applies the
//     run to them in registers and writes them back once. What bounds such
//     a run is then its arithmetic (16 FMAs a pair for a general 2x2, 8
//     for H, none for X), not the sweeps.
// A lane_u op is 128 complex multiply-adds per amplitude (about 6.9e10
// flop at 26 qubits): 1.03 ms at the 67 TFLOP/s FP32 rate (and at the FP64
// tensor-core rate, the same 67 TFLOP/s), 0.42 ms as 3xTF32 on the tensor
// cores (494.7/3 TFLOP/s), so passes that carry one are bound by
// operations.
//   f32: the tensor cores, mma.sync m16n8k8 in 3xTF32 (mma.cuh). The
//     product is OUT (rows x 128) = X (rows x 128) U^T, four real
//     products summed into two accumulators. U^T arrives split into TF32
//     hi and lo by the host, in fragment order (the coefficient block
//     ``encode_ops`` writes), and is streamed into shared memory by
//     cp.async in 4 panels of 32 k, two buffers deep. Tile plus panels
//     take 224 KiB: a run that carries a lane_u op launches an
//     instantiation of its own with one block per SM (128 registers a
//     thread); runs without one keep two blocks per SM.
//   f64: the tensor cores too, mma.sync m16n8k16 in FP64 (exact products;
//     Hopper has no FP64 wgmma), the same four products, in two sweeps over
//     the sum (half the output columns each, so that the sums fit 64
//     registers). U^T (256 KiB: too big to sit beside the tile) arrives
//     from the host in FP64 fragment order and streams through two 16 KiB
//     buffers, so two blocks still fit an SM and each hides the
//     other's tile load and store: f64 runs, with lane_u or without, share
//     one instantiation.
// A window op is 2^span complex multiply-adds per amplitude, 32 at most: a
// pass that carries one is bound by bytes once its products run on the
// tensor cores. From span 3 they do: in f64 window_dmma, FP64 mma.sync
// with U from the host in fragment order, staged in one chunk buffer; in
// f32 window_mma, 3xTF32 mma.sync with U split into TF32 hi and lo as the
// kernel stages it. Spans 1-2 (f64 tiles below 2^10, the f32 zone [12,
// 13) of the 2^13 tile) keep the FMA window_op.
//
// The kraus ops replace the kraus arms of _ops_body (pallas_gates.py:662,
// which applies each term's K and conj(K) to a copy and accumulates). Here
// every arity takes one design, the superoperator: the host builds
// S = sum_k s_k conj(K_k) (x) K_k (4^t x 4^t) in double and the kernel
// applies it as one dense op on the 2t in-tile qubits, in place (the
// per-term form would need a second tile-sized buffer, one block per SM).
// That is 4^t complex multiply-adds per amplitude: 4 (kraus1) and 16
// (kraus2) keep the pass bound by bytes; at 64 (t = 3, krausn) the FP32
// FMA work (and, in f64, the FP64 tensor-core work) is about as long as
// the pass's bytes. Which arm runs where:
//   t = 1, 2: kraus_op, FMA: <float, 4, 4> (16 outputs a thread) in f32,
//     <double, 2, 1> (2 outputs a thread) in f64;
//   t = 3: OUT (groups x 64) = X S^T on mma.sync m16n8k8, X gathered from
//     the tile by deposits into the qubit mask, S^T streamed from the
//     host's fragment-order table through the lane_u fold's two 16 KiB
//     chunk buffers (two blocks per SM still): krausn_dmma in FP64,
//     krausn_mma in 3xTF32 (S^T split into TF32 hi and lo by the host).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (quest_tpu_torch/_build.py does this at first use)

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kLaneBits = 7;
constexpr int kLanes = 1 << kLaneBits;
constexpr int kRec = 8;  // int64 fields per op record

enum OpKind : int { kMatrix = 0, kParity = 1, kSwap = 2, kDiagw = 3,
                    kLaneU = 4, kWindow = 5, kKraus1 = 6, kKraus2 = 7,
                    kKrausN = 8 };

// the flat index g with its bit blocks [lo1, lo1+k) and [lo2, lo2+k)
// exchanged (swap_bit_blocks as an index map; an involution)
__device__ __forceinline__ uint64_t swap_blocks(uint64_t g, int lo1, int lo2,
                                                int k) {
  if (k == 0) return g;
  const uint64_t m = (1ull << k) - 1;
  const uint64_t a = (g >> lo1) & m;
  const uint64_t b = (g >> lo2) & m;
  return (g & ~((m << lo1) | (m << lo2))) | (b << lo1) | (a << lo2);
}

// The flat index map of a pass's folded swaps on one tile: the bit block
// [T-k, T) exchanged with [hi, hi+k), then bit plo with bit phi (pk = 1;
// plo < T <= phi). A bit permutation, so map(tile_base | i) is
// map(tile_base) | map(i): the first part once per block, the second a
// few 32-bit operations per amplitude (none where nothing moves: a
// block-uniform branch around the copy loops).
struct FrameMap {
  uint64_t base;  // map(tile_base)
  uint32_t blk;   // the in-tile block [T-k, T)
  uint32_t pbit;  // in-tile bit plo (0: no pair)
  int lo, hi, plo, phi;
  bool moves;
  __device__ FrameMap(uint64_t tile_base, int T, int k, int hi_, int plo_,
                      int phi_, int pk)
      : base(swap_blocks(swap_blocks(tile_base, T - k, hi_, k), plo_, phi_,
                         pk)),
        blk(((1u << k) - 1) << (T - k)),
        pbit(static_cast<uint32_t>(pk) << plo_),
        lo(T - k), hi(hi_), plo(plo_), phi(phi_), moves(k != 0 || pk != 0) {}
  __device__ __forceinline__ uint64_t operator()(uint32_t i) const {
    return base | (i & ~(blk | pbit)) |
           (static_cast<uint64_t>((i & blk) >> lo) << hi) |
           (static_cast<uint64_t>((i & pbit) >> plo) << phi);
  }
};

// p with a zero bit inserted at position q
__device__ __forceinline__ uint32_t insert_zero(uint32_t p, int q) {
  return ((p >> q) << (q + 1)) | (p & ((1u << q) - 1));
}

// p with a zero bit inserted at every set bit of mask
__device__ __forceinline__ uint32_t insert_zeros(uint32_t p, uint32_t mask) {
  for (uint32_t m = mask; m; m &= m - 1) p = insert_zero(p, __ffs(m) - 1);
  return p;
}

// the low bits of v deposited, in order, at the set bits of mask
__device__ __forceinline__ uint32_t deposit(uint32_t v, uint32_t mask) {
  uint32_t out = 0;
  for (uint32_t m = mask; m; m &= m - 1, v >>= 1) {
    if (v & 1) out |= m & (0u - m);
  }
  return out;
}

// deposit(v + 1, mask) from deposit(v, mask)
__device__ __forceinline__ uint32_t next_deposit(uint32_t d, uint32_t mask) {
  return ((d | ~mask) + 1) & mask;
}

// four consecutive T (16-byte aligned) in one or two vector loads
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void ldg4(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
// two consecutive doubles (16-byte aligned) in one vector load
__device__ __forceinline__ void ldg2(const double* p, double (&v)[2]) {
  const double2 q = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = q.x; v[1] = q.y;
}

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// (ar, ai) += (ur + i ui)(xr + i xi) as four FMAs
template <typename T>
__device__ __forceinline__ void cmac(T& ar, T& ai, T ur, T ui, T xr, T xi) {
  ar = fmadd(ur, xr, ar);
  ar = fmadd(-ui, xi, ar);
  ai = fmadd(ur, xi, ai);
  ai = fmadd(ui, xr, ai);
}

template <typename T>
__device__ __forceinline__ void cmul_into(T& xr, T& xi, T fr, T fi) {
  const T r = xr * fr - xi * fi;
  const T i = xr * fi + xi * fr;
  xr = r;
  xi = i;
}

// lane_u in f32, on the tensor cores: OUT = X U^T for the tile's rows
// (rows = tile / 128 <= 64) as mma.sync m16n8k8 in 3xTF32. Warp w takes
// the m16 tile of rows 16 (w mod 4) and the 32 output columns 32 (w / 4),
// four n8 tiles, and holds their real and imaginary sums (32 floats a
// thread): out_r = xr Ur^T + xi (-Ui^T), out_i = xr Ui^T + xi Ur^T. Rows
// past the tile's are read as 0 and not stored (tiles of 2^7 to 2^10).
//
// The order of the sum over c is free as long as A and B take the same
// one. Within each 16 columns of a row, lane (g, t) reads c = 4t .. 4t+3
// with one 16-byte load; of these, 4t + 2h and 4t + 2h + 1 are its A
// values k = t and t + 4 of k step h. The host writes U^T split, for each
// output column n, in that order: at kLaneSplitOff, per plane (real,
// imaginary), per n, per chunk c of 16, per h, per t, the four values
// hi(U^T[16c+4t+2h][n]), hi(U^T[..+1][n]), lo(..), lo(..+1) -- lane (g, t)'s
// B fragment of k step (c, h) for column n = g of its n8 tile, one
// 16-byte load. A panel (32 values of c, both planes) is 80 KiB, staged
// with row stride kPanelLd = 80 floats (16 mod 32: the 8 lanes of a
// quarter warp, two n and four t, hit 32 different banks).
constexpr int kLaneSplitOff = 2 * kLanes * kLanes;  // after U^T re, im
constexpr int kPanelK = 32;
constexpr int kPanelLd = 2 * kPanelK + 16;
constexpr int kPanelPlane = kLanes * kPanelLd;       // floats
constexpr int kPanelFloats = 2 * kPanelPlane;
constexpr int kLaneMmaStage = 2 * kPanelFloats * 4;  // two panels, bytes
// 16-byte pieces of each plane a thread loads at once (the 2^13 tile)
constexpr int kTileVecs = (1 << 13) / (4 * kThreads);

// start copying panel p of the split U^T (cf: the split block) into buf
__device__ __forceinline__ void stage_lane_panel(float* buf,
                                                 const float* __restrict__ cf,
                                                 int p, int tid) {
  constexpr int kPieces = 2 * kPanelK / 4;  // 16-byte pieces per (plane, n)
  for (int v = tid; v < 2 * kLanes * kPieces; v += kThreads) {
    const int pn = v / kPieces, piece = v % kPieces;  // pn = plane * 128 + n
    quest_mma::copy16_async(
        buf + pn * kPanelLd + 4 * piece,
        cf + pn * (2 * kLanes) + p * (2 * kPanelK) + 4 * piece);
  }
}

__device__ __forceinline__ void lane_u_mma(float* sre, float* sim, float* wbuf,
                                           uint32_t tile,
                                           const float* __restrict__ cf,
                                           int tid) {
  const float* split = cf + kLaneSplitOff;
  const uint32_t rows = tile >> kLaneBits;
  const int warp = tid >> 5;
  const quest_mma::Lane l = quest_mma::lane_coords();
  const uint32_t row0 = 16 * (warp & 3) + l.g, row1 = row0 + 8;
  const int n0 = 32 * (warp >> 2);
  const bool active = 16 * static_cast<uint32_t>(warp & 3) < rows;
  const bool ok0 = row0 < rows, ok1 = row1 < rows;
  float accr[4][4], acci[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) accr[j][i] = acci[j][i] = 0.f;

  constexpr int kPanels = kLanes / kPanelK;
  stage_lane_panel(wbuf, split, 0, tid);
  quest_mma::async_commit();
  stage_lane_panel(wbuf + kPanelFloats, split, 1, tid);
  quest_mma::async_commit();
  for (int p = 0; p < kPanels; ++p) {
    quest_mma::async_wait<1>();  // panel p, this thread's part
    __syncthreads();             // every thread's part
    const float* br = wbuf + (p & 1) * kPanelFloats;
    const float* bi = br + kPanelPlane;
    if (active) {
#pragma unroll
      for (int cc = 0; cc < kPanelK / 16; ++cc) {
        const int col = kPanelK * p + 16 * cc + 4 * l.t;
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 r0 = ok0 ? *reinterpret_cast<const float4*>(sre + row0 * kLanes + col) : z;
        const float4 r1 = ok1 ? *reinterpret_cast<const float4*>(sre + row1 * kLanes + col) : z;
        const float4 i0 = ok0 ? *reinterpret_cast<const float4*>(sim + row0 * kLanes + col) : z;
        const float4 i1 = ok1 ? *reinterpret_cast<const float4*>(sim + row1 * kLanes + col) : z;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // a[0] = A[g][t], a[1] = A[g+8][t], a[2] = A[g][t+4], a[3] = A[g+8][t+4]
          const float xr[4] = {h ? r0.z : r0.x, h ? r1.z : r1.x,
                               h ? r0.w : r0.y, h ? r1.w : r1.y};
          const float xi[4] = {h ? i0.z : i0.x, h ? i1.z : i1.x,
                               h ? i0.w : i0.y, h ? i1.w : i1.y};
          const quest_mma::SplitA sr = quest_mma::split_a(xr);
          const quest_mma::SplitA si = quest_mma::split_a(xi);
          const int boff = 32 * cc + 16 * h + 4 * l.t;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = n0 + 8 * j + l.g;
            const quest_mma::SplitB ur = quest_mma::load_b_split(br + n * kPanelLd + boff);
            const quest_mma::SplitB ui = quest_mma::load_b_split(bi + n * kPanelLd + boff);
            quest_mma::mma_3xtf32(accr[j], sr, ur);
            quest_mma::mma_3xtf32(accr[j], si, quest_mma::negate(ui));
            quest_mma::mma_3xtf32(acci[j], sr, ui);
            quest_mma::mma_3xtf32(acci[j], si, ur);
          }
        }
      }
    }
    __syncthreads();  // panel p consumed (and, after the last, every read of the tile)
    if (p + 2 < kPanels) stage_lane_panel(wbuf + (p & 1) * kPanelFloats, split, p + 2, tid);
    quest_mma::async_commit();  // (empty at the end: keeps wait<1> uniform)
  }
  if (active) {
    // c[0] = C[g][2t], c[1] = C[g][2t+1], c[2] = C[g+8][2t], c[3] = C[g+8][2t+1]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + 8 * j + 2 * l.t;
      if (ok0) {
        *reinterpret_cast<float2*>(sre + row0 * kLanes + col) = make_float2(accr[j][0], accr[j][1]);
        *reinterpret_cast<float2*>(sim + row0 * kLanes + col) = make_float2(acci[j][0], acci[j][1]);
      }
      if (ok1) {
        *reinterpret_cast<float2*>(sre + row1 * kLanes + col) = make_float2(accr[j][2], accr[j][3]);
        *reinterpret_cast<float2*>(sim + row1 * kLanes + col) = make_float2(acci[j][2], acci[j][3]);
      }
    }
  }
}

// lane_u in f64, on the tensor cores: OUT = X U^T for the tile's rows
// (rows = tile / 128 <= 32) as mma.sync in FP64 (exact products, FP64
// sums: nothing split), in two sweeps over the sum, each for half of
// the output columns (sweep q: 64 q .. 64 q + 63). In a sweep, warp w
// takes the m16 tile of rows 16 (w & 1) and the n8 tile of columns 64 q +
// 8 (w >> 1), and holds its real and imaginary sums (8 doubles a thread):
// out_r = xr Ur^T + xi (-Ui^T), out_i = xr Ui^T + xi Ur^T. Rows past the
// tile's are read as 0 and not stored (tiles of 2^7 to 2^11: 1 to 16
// rows). One sweep over all 128 columns would hold 16 sums a thread; with
// its operands that is more than the 64 registers two blocks an SM leave
// (it spilled 148-192 bytes inside the k loop), so the sums of sweep 0
// wait in thread-local memory (64 bytes a thread, written and read once)
// until every read of the tile is done. A sweep streams only its half of
// U^T, so U^T still crosses L2 once a tile; the tile's A values are read
// twice.
//
// The k8 steps take the f32 fold's order of the sum over c: step s = 2 j +
// h gives lane (g, t) the columns c0 = 16 j + 4 t + 2 h and c0 + 1 as its
// A values k = t and t + 4, one 16-byte load from each of its two rows;
// the two steps of a chunk j run as one m16n8k16 (k = t .. t + 12: the
// columns 16 j + 4 t .. + 3), half the instructions of two m16n8k8.
// The rows of lanes g = 2i and 2i + 1 of a quarter warp are 1 KiB apart,
// in the same banks, so lanes of odd g load a chunk's two k steps in the
// other order and swap them in registers. The host writes U^T in the
// same order, one 8 KiB half panel per (sweep, k step) (after the TF32
// split: per q, per s, per plane (real, imaginary), per output column 64
// q + n, per t, U^T[c0][64 q + n] and U^T[c0 + 1][64 q + n]): lane (g,
// t)'s B fragment for column n = g of its n8 tile is one 16-byte load,
// and a quarter warp's 8 loads cover 128 consecutive bytes. U^T streams
// from L2 by cp.async through kChunkRing buffers, kChunkRing - 1 chunks
// ahead (a chunk: the half panels of k steps 2 j and 2 j + 1, 16 KiB), one
// barrier a chunk. Two buffers measured faster than three (the smaller
// stage leaves the SM more L1 for the local stash); 8 KiB buffers one step
// ahead left the stream bound by L2's latency. The ring takes 32 KiB
// beside the 64 KiB tile: two blocks share an SM, and one's tile load and
// store overlap the other's products.
constexpr int kLaneStepOff = kLaneSplitOff + 4 * kLanes * kLanes;  // after the split
constexpr int kHalf = kLanes / 2;              // output columns a sweep
constexpr int kHalfPanel = 2 * kHalf * 8;      // doubles: one (sweep, k step)
constexpr int kChunkPanel = 2 * kHalfPanel;    // doubles: one (sweep, chunk)
constexpr int kChunks = kLanes / 16;           // chunks a sweep
constexpr int kChunkRing = 2;
constexpr int kLaneDmmaStage = kChunkRing * kChunkPanel * 8;  // bytes

// start copying chunk i = (sweep, chunk) of U^T (steps: the f64 block)
// into buf: 32 bytes a thread
__device__ __forceinline__ void stage_chunk(double* buf,
                                            const double* __restrict__ steps,
                                            int i, int tid) {
  for (int v = tid; v < kChunkPanel / 2; v += kThreads) {
    quest_mma::copy16_async(buf + 2 * v, steps + i * kChunkPanel + 2 * v);
  }
}

__device__ __forceinline__ void lane_u_dmma(double* sre, double* sim,
                                            double* wbuf, uint32_t tile,
                                            const double* __restrict__ cf,
                                            int tid) {
  const double* steps = cf + kLaneStepOff;
  const uint32_t rows = tile >> kLaneBits;
  const int warp = tid >> 5;
  const quest_mma::Lane l = quest_mma::lane_coords();
  const uint32_t row0 = 16 * (warp & 1) + l.g, row1 = row0 + 8;
  const int n8 = 8 * (warp >> 1);  // the n8 tile's first column in a sweep
  const bool active = 16 * static_cast<uint32_t>(warp & 1) < rows;
  const bool ok0 = row0 < rows, ok1 = row1 < rows;
  double accr[4] = {0.0, 0.0, 0.0, 0.0}, acci[4] = {0.0, 0.0, 0.0, 0.0};
  volatile double kept[8];  // sweep 0's sums, in local memory, not registers

  constexpr int kN = 2 * kChunks;  // chunks of both sweeps
#pragma unroll
  for (int i = 0; i < kChunkRing - 1; ++i) {
    stage_chunk(wbuf + i * kChunkPanel, steps, i, tid);
    quest_mma::async_commit();
  }
  for (int i = 0; i < kN; ++i) {
    quest_mma::async_wait<kChunkRing - 2>();  // chunk i, this thread's part
    __syncthreads();  // every thread's part; chunk i - 1 consumed
    if (i + kChunkRing - 1 < kN) {
      stage_chunk(wbuf + (i + kChunkRing - 1) % kChunkRing * kChunkPanel, steps,
                  i + kChunkRing - 1, tid);
    }
    quest_mma::async_commit();  // (empty at the end: keeps the wait uniform)
    if (active) {
      const double* b = wbuf + i % kChunkRing * kChunkPanel + (n8 + l.g) * 8 + 2 * l.t;
      const int col0 = 16 * (i & (kChunks - 1)) + 4 * l.t;
      const double2 z = make_double2(0.0, 0.0);
      // odd rows g load the chunk's second k step first: rows g = 2i and
      // 2i + 1 of a quarter warp then hit other banks
      const int sw = 2 * (l.g & 1);
      double ur[2][2], ui[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const double2 vr = *reinterpret_cast<const double2*>(b + h * kHalfPanel);
        const double2 vi = *reinterpret_cast<const double2*>(b + h * kHalfPanel + kHalf * 8);
        ur[h][0] = vr.x; ur[h][1] = vr.y; ui[h][0] = vi.x; ui[h][1] = vi.y;
      }
      // the products of one plane of A at a time, each over both k steps
      // as one m16n8k16: xr Ur^T, xr Ui^T, then xi Ur^T, xi (-Ui^T)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const double* x = p ? sim : sre;
        const double2 a0 = ok0 ? *reinterpret_cast<const double2*>(x + row0 * kLanes + col0 + sw) : z;
        const double2 a1 = ok0 ? *reinterpret_cast<const double2*>(x + row0 * kLanes + col0 + 2 - sw) : z;
        const double2 b0 = ok1 ? *reinterpret_cast<const double2*>(x + row1 * kLanes + col0 + sw) : z;
        const double2 b1 = ok1 ? *reinterpret_cast<const double2*>(x + row1 * kLanes + col0 + 2 - sw) : z;
        const double2 r0[2] = {sw ? a1 : a0, sw ? a0 : a1};
        const double2 r1[2] = {sw ? b1 : b0, sw ? b0 : b1};
        // k = t, t + 4, t + 8, t + 12: the chunk's columns c0 .. c0 + 3
        const double xa[8] = {r0[0].x, r1[0].x, r0[0].y, r1[0].y,
                              r0[1].x, r1[1].x, r0[1].y, r1[1].y};
        const double u4[4] = {ur[0][0], ur[0][1], ur[1][0], ur[1][1]};
        const double sign = p ? -1.0 : 1.0;
        const double v4[4] = {sign * ui[0][0], sign * ui[0][1], sign * ui[1][0],
                              sign * ui[1][1]};
        quest_mma::mma_f64_k16(p ? acci : accr, xa, u4);
        quest_mma::mma_f64_k16(p ? accr : acci, xa, v4);
      }
      if (i == kChunks - 1) {  // sweep 0 done
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          kept[v] = accr[v];
          kept[4 + v] = acci[v];
          accr[v] = acci[v] = 0.0;
        }
      }
    }
  }
  __syncthreads();  // every read of the tile is done
  if (active) {
    // c[0] = C[g][2t], c[1] = C[g][2t+1], c[2] = C[g+8][2t], c[3] = C[g+8][2t+1]
    const int col = n8 + 2 * l.t;
    if (ok0) {
      *reinterpret_cast<double2*>(sre + row0 * kLanes + col) = make_double2(kept[0], kept[1]);
      *reinterpret_cast<double2*>(sim + row0 * kLanes + col) = make_double2(kept[4], kept[5]);
      *reinterpret_cast<double2*>(sre + row0 * kLanes + kHalf + col) = make_double2(accr[0], accr[1]);
      *reinterpret_cast<double2*>(sim + row0 * kLanes + kHalf + col) = make_double2(acci[0], acci[1]);
    }
    if (ok1) {
      *reinterpret_cast<double2*>(sre + row1 * kLanes + col) = make_double2(kept[2], kept[3]);
      *reinterpret_cast<double2*>(sim + row1 * kLanes + col) = make_double2(kept[6], kept[7]);
      *reinterpret_cast<double2*>(sre + row1 * kLanes + kHalf + col) = make_double2(accr[2], accr[3]);
      *reinterpret_cast<double2*>(sim + row1 * kLanes + kHalf + col) = make_double2(acci[2], acci[3]);
    }
  }
}

// krausn (t = 3) in f64, on the tensor cores: for every group base b(g) of
// the tile (g < groups = tile / 64, b = the tile index with the 6 mask
// bits clear), OUT[g][d] = sum_e X[g][e] S^T[e][d] with X[g][e] =
// x[b(g) + dep(e)], dep = deposit into mask, written back in place. The
// shape of lane_u_dmma's product with half its K and N and a gathered A:
// FP64 mma.sync (exact products), the same four real products into two
// accumulators, 8 sums a thread in two sweeps. Where lane_u_dmma's sweeps
// split the columns, these split the groups (sweep q: groups 32 q .. 32 q
// + 31, warp w taking the m16 tile of groups 32 q + 16 (w & 1) and the n8
// tile of columns 8 (w >> 1)): a sweep reads its own groups only, so its
// sums go back to the tile after one barrier at its end, and none wait
// for the other sweep. Sweeps over the columns, with the first sweep's
// sums held (in registers, or in thread-local memory as lane_u_dmma holds
// its own), spilled 60-92 bytes here and took a 28-qubit pass 6.4-6.5 ms
// against 4.65 (chip_lane_u_breakdown.py). S^T crosses L2 once a sweep.
// Groups past the tile's are read as 0 and not stored; a tile of 32
// groups or fewer (2^11 and below) takes one sweep, and below 16 groups
// (2^7 to 2^9) its m16 tiles are masked. What bounds it: a 28-qubit pass
// moves 4 GiB (2.56 ms at 3.35 TB/s) and its products take 2.05 ms at 67
// TFLOP/s; the pass takes 4.65 ms, the tile's load and store alone 2.83:
// the two blocks of an SM do not hide one's products under the other's
// load and store.
//
// Each step of 16 values of e is two m16n8k8 a plane, not one m16n8k16:
// half the gathered operands, and their addresses, live at once in the 64
// registers that two blocks an SM allow (one m16n8k16 a plane: 6.44 ms
// against 4.65). The four steps of a sweep are unrolled, so their offsets
// fold.
//
// The gathered A operand. Step kk gives lane (g, t) the values e = 16 kk +
// t + 4 m, m = 0..3 (k = t + 4 m, the fragments' own order; half h of the
// step takes m = 2 h, 2 h + 1), whose offsets dep(16 kk) + dep(4 m) +
// dep(t) are sums of single mask bits (dep of a sum of disjoint bits is the
// sum of their deposits): per thread, two row bases with dep(t) added and
// the bits of e 2 to 5 in registers. A warp's loads then put lanes t apart
// by the two lowest mask bits and lanes g by the lowest two others, which
// for the density path's masks (row qubits low, column qubits at the top
// of the tile) lands a half warp's 16 loads in 16 different 8-byte banks.
//
// S^T (64 KiB) does not fit beside the tile with two blocks an SM; it
// arrives from the host in FP64 fragment order after the f32 block (S^T
// real, imaginary): per step kk, per h, per plane, per column n, per t,
// S^T[16 kk + t + 8 h][n] and S^T[16 kk + t + 8 h + 4][n], lane (g, t)'s B
// values of one h for column n = g of its n8 tile in one 16-byte load, a
// quarter warp's 8 loads on 128 consecutive bytes. A step is a 16 KiB
// chunk, streamed through the lane_u fold's two cp.async buffers, one
// ahead: four chunks a sweep, one barrier each.
constexpr int kKrausG = 64;                      // S's side for t = 3
constexpr int kKrausPlane = kKrausG * 8;         // doubles: one (step, h, plane)
constexpr int kKrausStepOff = 2 * kKrausG * kKrausG;  // after S^T re, im
static_assert(4 * kKrausPlane == kChunkPanel, "a chunk is one k16 step");

// krausn_dmma's and krausn_mma's sums of one m16n8 tile back into the
// tile: c[0] = C[g][2t], c[1] = C[g][2t+1] at base0 + dep(d) for d = d0,
// d0 + 1, c[2], c[3] the same for group g + 8 at base1
template <typename T>
__device__ __forceinline__ void store_sums(T* sre, T* sim, const T (&accr)[4],
                                           const T (&acci)[4], uint32_t base0,
                                           uint32_t base1, bool ok0, bool ok1,
                                           uint32_t d0, uint32_t mask) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const uint32_t off = deposit(d0 + e, mask);
    if (ok0) {
      sre[base0 + off] = accr[e];
      sim[base0 + off] = acci[e];
    }
    if (ok1) {
      sre[base1 + off] = accr[2 + e];
      sim[base1 + off] = acci[2 + e];
    }
  }
}

__device__ __forceinline__ void krausn_dmma(double* sre, double* sim,
                                            double* wbuf, uint32_t tile,
                                            const double* __restrict__ cf,
                                            uint32_t mask, int tid) {
  const double* steps = cf + kKrausStepOff;
  const uint32_t groups = tile >> 6;
  // the thread index through an opaque move: what the arm derives from it
  // is then computed here, not hoisted out of the kernel's op loop, where
  // it would hold registers through every other op
  int me;
  asm volatile("mov.b32 %0, %1;" : "=r"(me) : "r"(tid));
  const int warp = me >> 5;
  const quest_mma::Lane l = {(me & 31) >> 2, me & 3};
  // the mask's bits, lowest first: dep(e) is the sum of those of e's bits
  uint32_t bit[6];
  uint32_t m = mask;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    bit[j] = m & (0u - m);
    m ^= bit[j];
  }
  const uint32_t dt = (l.t & 1 ? bit[0] : 0u) + (l.t & 2 ? bit[1] : 0u);
  const int n8 = 8 * (warp >> 1);
  const int nq = groups > 32 ? 2 : 1;  // sweeps of 32 groups
  stage_chunk(wbuf, steps, 0, me);
  quest_mma::async_commit();
  for (int q = 0; q < nq; ++q) {
    const uint32_t row0 = 32 * q + 16 * (warp & 1) + l.g;
    const bool active = 32 * static_cast<uint32_t>(q) + 16 * static_cast<uint32_t>(warp & 1) < groups;
    const bool ok0 = row0 < groups, ok1 = row0 + 8 < groups;
    const uint32_t a0 = (ok0 ? insert_zeros(row0, mask) : 0u) + dt;
    const uint32_t a1 = (ok1 ? insert_zeros(row0 + 8, mask) : 0u) + dt;
    double accr[4] = {0.0, 0.0, 0.0, 0.0}, acci[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      quest_mma::async_wait<0>();  // step kk, this thread's part
      __syncthreads();             // every thread's part; the step before consumed
      if (kk < 3 || q + 1 < nq) stage_chunk(wbuf + (kk + 1) % 2 * kChunkPanel, steps, (kk + 1) % 4, me);
      quest_mma::async_commit();   // (empty at the end: keeps the wait uniform)
      if (active) {
        const uint32_t dk = (kk & 1 ? bit[4] : 0u) + (kk & 2 ? bit[5] : 0u);
        const uint32_t o[4] = {dk, dk + bit[2], dk + bit[3], dk + bit[2] + bit[3]};
        const double* b = wbuf + kk % 2 * kChunkPanel + (n8 + l.g) * 8 + 2 * l.t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // b[0] = S^T[16 kk + t + 8 h][n], b[1] = S^T[.. + 4][n], real and imaginary
          const double2 r = *reinterpret_cast<const double2*>(b + 2 * h * kKrausPlane);
          const double2 im = *reinterpret_cast<const double2*>(b + (2 * h + 1) * kKrausPlane);
          const double u2[2] = {r.x, r.y}, v2[2] = {im.x, im.y}, w2[2] = {-im.x, -im.y};
          // a[0] = A[g][t], a[1] = A[g+8][t], a[2] = A[g][t+4], a[3] = A[g+8][t+4]
          // of the half: e = 16 kk + t + 8 h (+ 4); each plane's products
          // into named accumulators (a pointer choosing between the two
          // arrays kept them out of registers): xr Sr^T, xr Si^T, then xi
          // Sr^T, xi (-Si^T)
          const uint32_t p0 = o[2 * h], p1 = o[2 * h + 1];
          const double xr[4] = {ok0 ? sre[a0 + p0] : 0.0, ok1 ? sre[a1 + p0] : 0.0,
                                ok0 ? sre[a0 + p1] : 0.0, ok1 ? sre[a1 + p1] : 0.0};
          quest_mma::mma_f64(accr, xr, u2);
          quest_mma::mma_f64(acci, xr, v2);
          const double xi[4] = {ok0 ? sim[a0 + p0] : 0.0, ok1 ? sim[a1 + p0] : 0.0,
                                ok0 ? sim[a0 + p1] : 0.0, ok1 ? sim[a1 + p1] : 0.0};
          quest_mma::mma_f64(acci, xi, u2);
          quest_mma::mma_f64(accr, xi, w2);
        }
      }
    }
    __syncthreads();  // every read of the sweep's groups is done
    if (active) store_sums(sre, sim, accr, acci, a0 - dt, a1 - dt, ok0, ok1, n8 + 2 * l.t, mask);
  }
}

// krausn (t = 3) in f32, on the tensor cores: krausn_dmma's product, as
// mma.sync m16n8k8 in 3xTF32 (mma.cuh) with FP32 sums. S^T arrives split
// from the host (``kraus_superop_tf32_table``, after the f64 table): per
// step kk, per h, per plane, per column n, per t, hi(S^T[e0][n]),
// hi(S^T[e0 + 4][n]), lo(S^T[e0][n]), lo(S^T[e0 + 4][n]) with e0 = 16 kk +
// 8 h + t: lane (g, t)'s split B fragment of one plane in one 16-byte
// load, a quarter warp's 8 loads on 128 consecutive bytes. A step is again
// one 16 KiB chunk of the same two-buffer ring, so S^T crosses L2 once a
// sweep. The A operand is gathered as krausn_dmma gathers it (k step h of
// step kk: e = 16 kk + 8 h + t (+ 4), offsets summed from single mask
// bits) and split into TF32 hi and lo in registers, one plane at a time.
//
// A warp takes one m16 tile of groups and kN8 n8 tiles of columns (8 kN8
// sums a thread): the warps split a sweep's groups 2 kN8 ways and the
// columns 8 / kN8 ways, so a sweep is 32 kN8 groups, each written back
// after its own barrier; warps past a small tile's groups idle, and below
// 16 groups the m16 tiles are masked. fused_run_kernel<float, false> (two
// blocks per SM, every f32 run with krausn and without lane_u) takes kN8 =
// kKrausN8 = 2: 16 sums, two sweeps at the 2^13 tile. Each gathered and
// split A fragment then feeds two n8 tiles, which halves the tile's
// shared-memory reads of A and the sweeps' S^T stream beside krausn_dmma's
// shape (kN8 = 1: 8 sums, four sweeps; 4.1 ms a 28-qubit pass against
// 3.2-3.3, chip_lane_u_breakdown.py). The 16 sums fit its 64 registers
// only if what derives from the mask is not held across sweeps: the mask
// passes through an opaque move at each sweep and its bits are found again
// there (held, they spilled 12 bytes). The lane_u instantiation (a run
// with both, which no planner path makes) takes kN8 = 1: with 2 that
// instantiation spilled 4 bytes.
// What bounds it: a 28-qubit pass reads and writes a 2 GiB state (1.28 ms
// at 3.35 TB/s); its products, 1.37e11 flop, take 0.83 ms at the 3xTF32
// rate.
constexpr int kKrausSplitOff = kKrausStepOff + 2 * kKrausG * kKrausG;  // after the f64 table
constexpr int kKrausSplitPlane = kKrausG * 16;  // floats: one (step, h, plane)
static_assert(4 * kKrausSplitPlane == 2 * kChunkPanel, "a chunk is one k16 step");
constexpr int kKrausN8 = 2;  // n8 tiles a warp in fused_run_kernel<float, false>

template <int kN8>
__device__ __forceinline__ void krausn_mma(float* sre, float* sim, float* wbuf,
                                           uint32_t tile,
                                           const float* __restrict__ cf,
                                           uint32_t mask, int tid) {
  constexpr int kWm = 2 * kN8;       // warps across a sweep's groups
  constexpr int kSweep = 16 * kWm;   // groups a sweep
  // the chunk ring moves bytes: the split table in 16 KiB chunks
  const double* split = reinterpret_cast<const double*>(cf + kKrausSplitOff);
  double* ring = reinterpret_cast<double*>(wbuf);
  const uint32_t groups = tile >> 6;
  int me;  // the thread index through an opaque move, as in krausn_dmma
  asm volatile("mov.b32 %0, %1;" : "=r"(me) : "r"(tid));
  const int warp = me >> 5;
  const quest_mma::Lane l = {(me & 31) >> 2, me & 3};
  const int n0 = 8 * kN8 * (warp / kWm);  // the warp's first column
  const int sweeps = (groups + kSweep - 1) / kSweep;
  // dep(t) for the lane's k index t: the mask's two lowest bits
  const uint32_t lo0 = mask & (0u - mask), lo1 = (mask ^ lo0) & (0u - (mask ^ lo0));
  const uint32_t dt = (l.t & 1 ? lo0 : 0u) + (l.t & 2 ? lo1 : 0u);
  stage_chunk(ring, split, 0, me);
  quest_mma::async_commit();
  for (int q = 0; q < sweeps; ++q) {
    // the mask's bits, lowest first (dep(e) is the sum of those of e's
    // bits), found again each sweep from an opaque copy of the mask
    uint32_t bit[6];
    uint32_t m;
    asm volatile("mov.b32 %0, %1;" : "=r"(m) : "r"(mask));
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      bit[j] = m & (0u - m);
      m ^= bit[j];
    }
    const uint32_t m16 = kSweep * q + 16 * (warp % kWm);  // the warp's first group
    const uint32_t row0 = m16 + l.g;
    const bool active = m16 < groups;
    const bool ok0 = row0 < groups, ok1 = row0 + 8 < groups;
    const uint32_t a0 = (ok0 ? insert_zeros(row0, mask) : 0u) + dt;
    const uint32_t a1 = (ok1 ? insert_zeros(row0 + 8, mask) : 0u) + dt;
    float accr[kN8][4], acci[kN8][4];
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) accr[j][i] = acci[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      quest_mma::async_wait<0>();  // step kk, this thread's part
      __syncthreads();             // every thread's part; the step before consumed
      if (kk < 3 || q + 1 < sweeps) {
        stage_chunk(ring + (kk + 1) % 2 * kChunkPanel, split, (kk + 1) % 4, me);
      }
      quest_mma::async_commit();  // (empty at the end: keeps the wait uniform)
      if (active) {
        const uint32_t dk = (kk & 1 ? bit[4] : 0u) + (kk & 2 ? bit[5] : 0u);
        const float* b = wbuf + kk % 2 * (2 * kChunkPanel) + (n0 + l.g) * 16 + 4 * l.t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          quest_mma::SplitB ur[kN8], ui[kN8];
#pragma unroll
          for (int j = 0; j < kN8; ++j) {  // columns n0 + 8 j + g
            ur[j] = quest_mma::load_b_split(b + 2 * h * kKrausSplitPlane + 128 * j);
            ui[j] = quest_mma::load_b_split(b + (2 * h + 1) * kKrausSplitPlane + 128 * j);
          }
          // a[0] = A[g][t], a[1] = A[g+8][t], a[2] = A[g][t+4], a[3] = A[g+8][t+4]:
          // e = 16 kk + 8 h + t (+ 4); xr Sr^T, xr Si^T, then xi Sr^T, xi (-Si^T)
          const uint32_t e0 = dk + (h ? bit[3] : 0u), e4 = e0 + bit[2];
          const float xr[4] = {ok0 ? sre[a0 + e0] : 0.f, ok1 ? sre[a1 + e0] : 0.f,
                               ok0 ? sre[a0 + e4] : 0.f, ok1 ? sre[a1 + e4] : 0.f};
          const quest_mma::SplitA sr = quest_mma::split_a(xr);
#pragma unroll
          for (int j = 0; j < kN8; ++j) {
            quest_mma::mma_3xtf32(accr[j], sr, ur[j]);
            quest_mma::mma_3xtf32(acci[j], sr, ui[j]);
          }
          const float xi[4] = {ok0 ? sim[a0 + e0] : 0.f, ok1 ? sim[a1 + e0] : 0.f,
                               ok0 ? sim[a0 + e4] : 0.f, ok1 ? sim[a1 + e4] : 0.f};
          const quest_mma::SplitA si = quest_mma::split_a(xi);
#pragma unroll
          for (int j = 0; j < kN8; ++j) {
            quest_mma::mma_3xtf32(acci[j], si, ur[j]);
            quest_mma::mma_3xtf32(accr[j], si, quest_mma::negate(ui[j]));
          }
        }
      }
    }
    __syncthreads();  // every read of this sweep's groups is done
    if (active) {
#pragma unroll
      for (int j = 0; j < kN8; ++j) {
        store_sums(sre, sim, accr[j], acci[j], a0 - dt, a1 - dt, ok0, ok1, n0 + 8 * j + 2 * l.t,
                   mask);
      }
    }
  }
}

// window in f64, spans 3-5, on the tensor cores. An f64 window is always
// the zone [7, tile_bits) (the host checks it): lo = 7, B = 128 columns, D =
// 2^span = tile / 128 rows, and OUT[d][b] = sum_e U[d][e] X[e][b] with
// X[e][b] = x[(e << 7) | b], in place. FP64 mma.sync m16n8k8 (exact
// products) with U as the A operand (M = d, K = e) and X as the B operand
// (N = b), the four real products into two accumulators: out_r = Ur xr +
// Ui (-xi), out_i = Ur xi + Ui xr. Warp w owns the n8 block of columns 8 w
// .. 8 w + 7 (16 warps: all 128) and every d of it: D / 16 m16 tiles (one
// at D = 8, whose rows 8-15 are zero in the table and are not stored), 8
// sums each, 16 a thread at D = 32. A warp reads and writes only its own
// columns, so no other warp waits on it: no barrier between its reads and
// its writes (the op loop's barrier follows), and each x is read from
// shared memory once a tile (the FMA arm below reads each 16 times).
//
// U arrives from the host in A-fragment order (``window_f64_table``, after
// U real and imaginary in the op's block): per m16 tile mt, per k8 step
// ks, per plane, per half h, per lane (g, t), U[16 mt + g][8 ks + t + 4 h]
// and U[16 mt + g + 8][8 ks + t + 4 h] (0 past D): a lane's A values of one
// half in one 16-byte load, a quarter warp's 8 loads on 128 consecutive
// bytes. The table, 32 D doubles a m16 tile (16 KiB at D = 32: one chunk
// buffer of the lane_u fold's ring), is staged by cp.async, one wait and
// one barrier an op (the ring's arms wait for all of their groups).
//
// The B loads: lane (g, t) reads X[8 ks + t][8 w + g] and X[8 ks + t +
// 4][8 w + g]. The rows are 1 KiB apart, so the four lanes t of a column
// fall on the same banks (4-way conflicts); copying a warp's columns into
// padded rows first, and the other layout (U^T as the B operand, X as A,
// as window_dot.cu takes it), are timed by chip_lane_u_breakdown.py.
// What bounds it: a 26-qubit pass moves 2 GiB (0.64 ms at 3.35 TB/s); its
// products, 1.72e10 flop, take 0.26 ms at 67 TFLOP/s.
__device__ __forceinline__ void window_dmma(double* sre, double* sim, double* wbuf,
                                            const double* __restrict__ cf, int span,
                                            int tid) {
  const int D = 1 << span;
  const int ksteps = D >> 3, mtiles = D > 16 ? 2 : 1;
  const double* table = cf + 2 * D * D;  // after U real, imaginary
  for (int v = tid; v < 16 * D * mtiles; v += kThreads) {
    quest_mma::copy16_async(wbuf + 2 * v, table + 2 * v);
  }
  quest_mma::async_commit();
  quest_mma::async_wait<0>();
  __syncthreads();  // every thread's part of the table
  // the thread index through an opaque move, as in krausn_dmma: what the
  // arm derives from it is not hoisted out of the kernel's op loop
  int me;
  asm volatile("mov.b32 %0, %1;" : "=r"(me) : "r"(tid));
  const int lane = me & 31;
  const quest_mma::Lane l = {lane >> 2, lane & 3};
  const int col = 8 * (me >> 5) + l.g;  // the lane's column of B
  double accr[2][4], acci[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) accr[mt][i] = acci[mt][i] = 0.0;
  // c[0] = C[g][2t], c[1] = C[g][2t+1], c[2] = C[g+8][2t], c[3] = C[g+8][2t+1]:
  // the offset of the lane's first output (row g, column 8 w + 2t) waits
  // out the k loop in thread-local memory (4 bytes a thread, written and
  // read once an op). Found again from tid after the loop instead, it
  // left a 26-qubit pass at 0.82 ms against 0.77; left to the compiler,
  // its parts are spilled to the same place (8 bytes) at the stash's
  // speed (chip_lane_u_breakdown.py, "window64 offset ...")
  volatile int out0[1];
  out0[0] = (((me & 31) >> 2) << kLaneBits) + 8 * (me >> 5) + 2 * (me & 3);
  // not unrolled: the loads of later steps, hoisted, would spill
#pragma unroll 1
  for (int ks = 0; ks < ksteps; ++ks) {
    // b[0] = X[8 ks + t][col], b[1] = X[8 ks + t + 4][col]
    const int e0 = ((8 * ks + l.t) << kLaneBits) + col;
    const double xr[2] = {sre[e0], sre[e0 + (4 << kLaneBits)]};
    const double xi[2] = {sim[e0], sim[e0 + (4 << kLaneBits)]};
    const double nxi[2] = {-xi[0], -xi[1]};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt < mtiles) {
        // a[0] = A[g][t], a[1] = A[g+8][t], a[2] = A[g][t+4], a[3] = A[g+8][t+4]
        const double* a = wbuf + (mt * ksteps + ks) * 256 + 2 * lane;
        const double2 r0 = *reinterpret_cast<const double2*>(a);
        const double2 r1 = *reinterpret_cast<const double2*>(a + 64);
        const double ur[4] = {r0.x, r0.y, r1.x, r1.y};
        quest_mma::mma_f64(accr[mt], ur, xr);
        quest_mma::mma_f64(acci[mt], ur, xi);
        const double2 i0 = *reinterpret_cast<const double2*>(a + 128);
        const double2 i1 = *reinterpret_cast<const double2*>(a + 192);
        const double ui[4] = {i0.x, i0.y, i1.x, i1.y};
        quest_mma::mma_f64(acci[mt], ui, xr);
        quest_mma::mma_f64(accr[mt], ui, nxi);
      }
    }
  }
  __syncwarp();  // the warp's reads of its columns are done
  const int o = out0[0];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (mt < mtiles) {
      const int o0 = o + (16 * mt << kLaneBits), o1 = o0 + (8 << kLaneBits);
      *reinterpret_cast<double2*>(sre + o0) = make_double2(accr[mt][0], accr[mt][1]);
      *reinterpret_cast<double2*>(sim + o0) = make_double2(acci[mt][0], acci[mt][1]);
      if (D > 8) {
        *reinterpret_cast<double2*>(sre + o1) = make_double2(accr[mt][2], accr[mt][3]);
        *reinterpret_cast<double2*>(sim + o1) = make_double2(acci[mt][2], acci[mt][3]);
      }
    }
  }
}
static_assert(2 * 4 * 256 == kChunkPanel, "the D = 32 table is one chunk buffer");

// window in f32, spans 3-5, on the tensor cores: out[a][d][b] = sum_e
// U[d][e] x[a][e][b] on the index bits [lo, lo + span) (D = 2^span, B =
// 2^lo >= 128; a, the slab, the bits above lo + span: tile >> (lo + span)
// of them), in place. window_dmma's shape in 3xTF32 (mma.sync m16n8k8,
// mma.cuh; FP32 sums): U the A operand (M = d, K = e), X the B operand (N
// = b), out_r = Ur xr + Ui (-xi), out_i = Ur xi + Ui xr. A work item is one
// slab's n8 block of columns and every d of it: tile / (8 D) items, at
// least 16 (lo >= 7), warp w taking items w, w + 16, ... in turn; D / 16
// m16 tiles an item (one at D = 8, whose rows 8-15 are zero in the table
// and are not stored), 16 sums a thread at D = 32. A warp reads and writes
// only its item's columns, so its writes follow its reads after a
// __syncwarp(), with no block barrier; at the 2^13 tile (the zone [7, 12):
// two slabs) each warp takes two items and never holds more than 16 sums.
//
// U is split into TF32 hi and lo as it is staged, once an op, by the kernel
// itself, from U real and imaginary at the head of the op's block (what
// window_op and the plain version read): per (m16 tile mt, k8 step ks), per
// plane, hi then lo, per lane (g, t) its A values U[16 mt + g][8 ks + t],
// U[16 mt + g + 8][8 ks + t], U[16 mt + g][8 ks + t + 4], U[16 mt + g +
// 8][8 ks + t + 4] (0 past D): a lane's split fragment of a plane in two
// 16-byte loads, a warp's on 512 consecutive bytes (no bank conflicts).
// 2 KiB an (mt, ks), 16 KiB at D = 32, in the stage memory that the
// launch reserves for bit 2 (after the tile; the first 16 KiB of the
// lane_u panels in fused_run_kernel<float, true>). X is split in registers
// (split_b), two values a plane a k step.
//
// The B loads: lane (g, t) reads X[8 ks + t][b0 + g] and X[8 ks + t +
// 4][b0 + g], rows 2^lo floats apart: the four lanes t of a column hit one
// bank (4-way conflicts), as in window_dmma. chip_lane_u_breakdown.py
// (window32) times the pass without them and in the other layout.
// What bounds it: a 26-qubit pass moves 1 GiB (0.32 ms at 3.35 TB/s); its
// products, 1.72e10 flop, take 0.10 ms at the 3xTF32 rate.
constexpr int kWinStep = 512;  // floats of the staged table an (mt, ks)
static_assert(2 * 4 * kWinStep * 4 <= kLaneDmmaStage, "the D = 32 table fits the stage");

__device__ __forceinline__ void window_mma(float* sre, float* sim, float* wbuf, uint32_t tile,
                                           const float* __restrict__ cf, int lo, int span,
                                           int tid) {
  const int D = 1 << span;
  const int ksteps = D >> 3, mtiles = D > 16 ? 2 : 1;
  // (an arm before this one in the op list, lane_u_mma or krausn_mma, has
  // waited for every copy it staged into wbuf; this keeps it so)
  quest_mma::async_wait<0>();
  // one thread a (mt, ks, plane, lane): its four values, split
  for (int v = tid; v < 64 * mtiles * ksteps; v += kThreads) {
    const int lane = v & 31, plane = (v >> 5) & 1, mk = v >> 6;  // mk = mt * ksteps + ks
    const int d0 = 16 * (mk >> (span - 3)) + (lane >> 2);
    const int e0 = 8 * (mk & (ksteps - 1)) + (lane & 3);
    const float* u = cf + plane * D * D + d0 * D + e0;
    const bool pad = d0 + 8 >= D;  // rows g + 8 of the one m16 tile at D = 8
    const float a[4] = {__ldg(u), pad ? 0.f : __ldg(u + 8 * D), __ldg(u + 4),
                        pad ? 0.f : __ldg(u + 8 * D + 4)};
    const quest_mma::SplitA s = quest_mma::split_a(a);
    float* p = wbuf + mk * kWinStep + plane * 256 + 4 * lane;
    *reinterpret_cast<uint4*>(p) = make_uint4(s.hi[0], s.hi[1], s.hi[2], s.hi[3]);
    *reinterpret_cast<uint4*>(p + 128) = make_uint4(s.lo[0], s.lo[1], s.lo[2], s.lo[3]);
  }
  __syncthreads();  // every thread's part of the split table
  // the thread index through an opaque move, as in krausn_dmma: what the
  // arm derives from it is not hoisted out of the kernel's op loop
  int me;
  asm volatile("mov.b32 %0, %1;" : "=r"(me) : "r"(tid));
  const int lane = me & 31;
  const quest_mma::Lane l = {lane >> 2, lane & 3};
  const uint32_t items = tile >> (span + 3);
  const int nb = lo - 3;  // a slab's n8 blocks: 2^nb
  const float* table = wbuf + 4 * lane;
#pragma unroll 1
  for (uint32_t it = me >> 5; it < items; it += kThreads / 32) {
    // the item's first amplitude: its slab's, plus its n8 block's columns
    const uint32_t base = ((it >> nb) << (lo + span)) | ((it & ((1u << nb) - 1)) << 3);
    const uint32_t x0 = base + (static_cast<uint32_t>(l.t) << lo) + l.g;
    float accr[2][4], acci[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) accr[mt][i] = acci[mt][i] = 0.f;
    // not unrolled: the loads of later steps, hoisted, would spill
#pragma unroll 1
    for (int ks = 0; ks < ksteps; ++ks) {
      // b[0] = X[8 ks + t][b0 + g], b[1] = X[8 ks + t + 4][b0 + g]
      const uint32_t e = x0 + (static_cast<uint32_t>(8 * ks) << lo);
      const quest_mma::SplitB br = quest_mma::split_b(sre[e], sre[e + (4u << lo)]);
      const quest_mma::SplitB bi = quest_mma::split_b(sim[e], sim[e + (4u << lo)]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt < mtiles) {
          const float* a = table + (mt * ksteps + ks) * kWinStep;
          const quest_mma::SplitA ur = quest_mma::load_a_split(a, a + 128);
          quest_mma::mma_3xtf32(accr[mt], ur, br);
          quest_mma::mma_3xtf32(acci[mt], ur, bi);
          const quest_mma::SplitA ui = quest_mma::load_a_split(a + 256, a + 384);
          quest_mma::mma_3xtf32(acci[mt], ui, br);
          quest_mma::mma_3xtf32(accr[mt], ui, quest_mma::negate(bi));
        }
      }
    }
    __syncwarp();  // the warp's reads of its columns are done
    // c[0] = C[g][2t], c[1] = C[g][2t+1], c[2] = C[g+8][2t], c[3] = C[g+8][2t+1]
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt < mtiles) {
        const uint32_t o0 = base + (static_cast<uint32_t>(16 * mt + l.g) << lo) + 2 * l.t;
        const uint32_t o1 = o0 + (8u << lo);
        *reinterpret_cast<float2*>(sre + o0) = make_float2(accr[mt][0], accr[mt][1]);
        *reinterpret_cast<float2*>(sim + o0) = make_float2(acci[mt][0], acci[mt][1]);
        if (D > 8) {
          *reinterpret_cast<float2*>(sre + o1) = make_float2(accr[mt][2], accr[mt][3]);
          *reinterpret_cast<float2*>(sim + o1) = make_float2(acci[mt][2], acci[mt][3]);
        }
      }
    }
  }
}

// window: out[a][d][b] = sum_e U[d][e] x[a][e][b] on the index bits
// [lo, lo+span) (D = 2^span, B = 2^lo >= 128): spans 1 and 2 (below an
// m16 tile), in f32 and f64. cf holds U real
// then U imaginary (D x D each). A work item is kDg values of d by 4
// consecutive b: each vector load of x[a][e][b..b+3] feeds 4 * kDg complex
// FMAs, and a warp's threads share d, so U[d][e] is a broadcast. A thread
// holds kReps items until every read of the op is done: kDg * kReps * 4
// outputs (16 in f32, 8 in f64, whose tile is at most 2^12).
template <typename T, int kDg, int kReps>
__device__ __forceinline__ void window_op(T* sre, T* sim, uint32_t tile,
                                          const T* __restrict__ cf, int lo,
                                          int span, int tid) {
  const uint32_t D = 1u << span;
  const uint32_t nbg = (1u << lo) / 4;   // b groups
  const uint32_t ndg = D / kDg;          // d groups
  const uint32_t items = tile / (4 * kDg);
  const T* ur_p = cf;
  const T* ui_p = cf + D * D;
  T outr[kDg * kReps][4], outi[kDg * kReps][4];
#pragma unroll
  for (int s = 0; s < kDg * kReps; ++s)
#pragma unroll
    for (int v = 0; v < 4; ++v) outr[s][v] = outi[s][v] = T(0);
#pragma unroll
  for (int k = 0; k < kReps; ++k) {
    const uint32_t w = tid + k * kThreads;
    if (w < items) {
      const uint32_t dgi = (w / nbg) % ndg;
      const uint32_t col0 = ((w / (nbg * ndg)) * D << lo) | ((w % nbg) * 4);
      for (uint32_t e = 0; e < D; ++e) {
        T xr[4], xi[4];
        load4(sre + (col0 | (e << lo)), xr);
        load4(sim + (col0 | (e << lo)), xi);
#pragma unroll
        for (int dd = 0; dd < kDg; ++dd) {
          const uint32_t d = dgi * kDg + dd;
          const T ur = __ldg(ur_p + d * D + e), ui = __ldg(ui_p + d * D + e);
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            cmac(outr[k * kDg + dd][v], outi[k * kDg + dd][v], ur, ui, xr[v],
                 xi[v]);
          }
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kReps; ++k) {
    const uint32_t w = tid + k * kThreads;
    if (w < items) {
      const uint32_t dgi = (w / nbg) % ndg;
      const uint32_t col0 = ((w / (nbg * ndg)) * D << lo) | ((w % nbg) * 4);
#pragma unroll
      for (int dd = 0; dd < kDg; ++dd) {
        const uint32_t base = col0 | ((dgi * kDg + dd) << lo);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          sre[base + v] = outr[k * kDg + dd][v];
          sim[base + v] = outi[k * kDg + dd][v];
        }
      }
    }
  }
}

// kraus ops on t = 1 or 2 row qubits (t = 3 takes krausn_dmma in f64,
// krausn_mma in f32) as the superoperator S (G x G complex, G = 4^t) on
// the 2t in-tile qubits of ``mask``, whose bit j of S's index is the j-th
// lowest qubit of mask (the host orders S so): for every group base g (the
// tile index with the mask bits clear), out[g + dep(d)] = sum_e S[d][e]
// x[g + dep(e)], dep = deposit into mask. cf holds S^T real then S^T
// imaginary (G x G each), so kR consecutive d of one e are one vector
// load. A work item is kR values of d (a chunk) for kB groups strided by
// nbg: each x read feeds kR complex FMAs and each S read kB. The chunks of
// one group are consecutive items, so the threads that read a group share
// its x reads (broadcasts) and finish them in the same round, before the
// barrier after which they write. A round holds kR * kB outputs per
// thread: 16 in f32, 2 in f64. The op is kept out of line: inlined into
// the kernel it raised the f64 instantiation's register spills from 8 to
// 84 bytes, which the kernel's other ops then pay for.
template <typename T, int kR, int kB>
__device__ __noinline__ void kraus_op(T* sre, T* sim, uint32_t tile,
                                      const T* __restrict__ cf, int t,
                                      uint32_t mask, int tid) {
  const uint32_t G = 1u << (2 * t);
  const uint32_t nchunks = G / kR;  // a power of two <= 32: divides kThreads
  const uint32_t ngroups = tile >> (2 * t);
  const uint32_t nbg = (ngroups + kB - 1) / kB;
  const uint32_t items = nchunks * nbg;
  const T* st_r = cf;
  const T* st_i = cf + G * G;
  for (uint32_t w0 = 0; w0 < items; w0 += kThreads) {
    const uint32_t w = w0 + static_cast<uint32_t>(tid);
    const bool active = w < items;
    const uint32_t d0 = (w % nchunks) * kR;
    const uint32_t gb = w / nchunks;
    uint32_t base[kB];
    bool valid[kB];
    T outr[kB][kR], outi[kB][kR];
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const uint32_t g = gb + b * nbg;
      valid[b] = active && g < ngroups;
      base[b] = valid[b] ? insert_zeros(g, mask) : 0;
#pragma unroll
      for (int r = 0; r < kR; ++r) outr[b][r] = outi[b][r] = T(0);
    }
    if (active) {
      uint32_t off = 0;
      for (uint32_t e = 0; e < G; ++e) {
        T sr[kR], si[kR];
        if constexpr (kR == 4) {
          ldg4(st_r + e * G + d0, sr);
          ldg4(st_i + e * G + d0, si);
        } else {
          ldg2(st_r + e * G + d0, sr);
          ldg2(st_i + e * G + d0, si);
        }
#pragma unroll
        for (int b = 0; b < kB; ++b) {
          if (valid[b]) {
            const T xr = sre[base[b] + off], xi = sim[base[b] + off];
#pragma unroll
            for (int r = 0; r < kR; ++r) {
              cmac(outr[b][r], outi[b][r], sr[r], si[r], xr, xi);
            }
          }
        }
        off = next_deposit(off, mask);
      }
    }
    __syncthreads();  // every read of this round's groups is done
    if (active) {
      uint32_t off = deposit(d0, mask);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
#pragma unroll
        for (int b = 0; b < kB; ++b) {
          if (valid[b]) {
            sre[base[b] + off] = outr[b][r];
            sim[base[b] + off] = outi[b][r];
          }
        }
        off = next_deposit(off, mask);
      }
    }
    // the next round reads other groups only: no barrier needed here
  }
}

// The diagonal arm: a maximal run of consecutive elementwise records (a
// diagonal kMatrix, kParity, kDiagw) in one sweep of the tile. The host
// has merged the run into few kDiagw records without controls
// (merge_diagonals: tables of up to 2^8 entries, bit j of the index the
// j-th lowest qubit), which take the fast path; an op too wide for a
// table stays as it is and takes the generic path (its factor from the
// amplitude's whole index, as the per-op arms computed it). Each thread
// walks its K = tile / kThreads amplitudes (i = tid + kThreads s, slot s
// < K) in groups of KG held in registers: it reads each amplitude from
// shared memory once, multiplies it by every record's entry for its
// index, in record order, and writes it once.
//
// Fast path. A record's index is a gather of up to 8 bits of the
// amplitude's global index. The bits below 9 (kThreads) come from the
// thread (lane bits 0-4, warp bits 5-8), those above the tile from the
// block: both are fixed for a thread and a record, so staging writes, per
// record, the index part of each of the 32 lanes and of each of the 16
// warps (the block's bits above the tile ORed into the latter). Only the
// tile bits [9, T) vary across a thread's amplitudes: a group walks them
// in Gray order, so each step flips one of them and the index changes by
// one XOR (byte b of ``steps``: the index bits that tile bit 9 + b sets).
// Per record and amplitude: an XOR, a shared-memory load of the entry and
// a complex multiply. The lanes of a warp read at most 32 neighbouring
// entries (their qubits take the table's low bits): no bank conflict
// beyond the entry's width.
//
// Staging, once per block: a chunk of up to kDiagRecs (= one warp's
// lanes) records and their tables goes into the stage after the tile
// (kDiagStage bytes). Every warp reads the chunk's records, one a lane,
// and sizes it with a prefix sum of the table sizes (no thread walks the
// records one by one, and no warp waits for another); then the tables
// arrive by cp.async, all of them in flight at once, while 48 threads a
// record compute its lane and warp parts. A run whose tables fit is one
// chunk: one barrier after the staging, none in the sweep, one after it.
// A longer run takes further chunks, each staged in turn.
constexpr int kThreadBits = 9;  // log2(kThreads): tile bits from the thread index
constexpr int kDiagRecs = 32;   // records a chunk stages: one warp's lanes
constexpr int kDiagStage = kLaneDmmaStage;
constexpr int kDiagFast = 0, kDiagSkip = 1, kDiagGeneric = 2;
// Amplitudes a thread holds in registers at once in the sweep, of its K =
// 2^13 / kThreads (f32) or 2^12 / kThreads (f64)
constexpr int kDiagHeld32 = 16;
constexpr int kDiagHeld64 = 4;

struct DiagRec {
  uint8_t lane[32];  // the index bits from lane bits 0-4 of the amplitude
  uint8_t warp[16];  // from warp bits 5-8, with the block's bits above the tile
  uint32_t steps;    // byte b: the index bits that tile bit 9 + b sets
  uint32_t tab;      // the record's first table entry in the chunk's tables
  uint32_t src;      // its coefficients' offset
  uint8_t mode;      // kDiagFast, kDiagSkip (controls above the tile miss), kDiagGeneric
  uint8_t pad[3];
};
static_assert(sizeof(DiagRec) == 64, "a staged record is 64 bytes");
constexpr int kDiagHead = kDiagRecs * sizeof(DiagRec);  // the records, then the tables

template <typename T> struct Cplx;
template <> struct Cplx<float> { using type = float2; };
template <> struct Cplx<double> { using type = double2; };

__device__ __forceinline__ bool elementwise(const long long* r) {
  const int kind = static_cast<int>(r[0]);
  return kind == kParity || kind == kDiagw || (kind == kMatrix && (r[7] & 1));
}

// a kDiagw record without controls: the fast path
__device__ __forceinline__ bool diag_fast(const long long* r) {
  return r[0] == kDiagw && r[3] == 0;
}

// An elementwise record that takes no table (a diagonal 2x2 or parity op
// with any controls, or a kDiagw with controls) on the amplitude x of
// in-tile index i, from its whole index (its controls above the tile hold
// in this block).
template <typename T>
__device__ __forceinline__ void diag_generic(T& xr, T& xi, const long long* r, const T* cf,
                                             uint32_t i, uint32_t tile, uint64_t role_base) {
  const uint32_t lmask = static_cast<uint32_t>(r[3]) & (tile - 1);
  const uint32_t lval = static_cast<uint32_t>(r[4]) & (tile - 1);
  if ((i & lmask) != lval) return;
  const int kind = static_cast<int>(r[0]);
  const uint64_t gi = role_base | i;
  T fr, fi;
  if (kind == kMatrix) {
    const bool one = (gi >> r[1]) & 1;
    fr = cf[one ? 6 : 0];
    fi = cf[one ? 7 : 1];
  } else if (kind == kParity) {
    fr = cf[0];
    fi = (__popcll(gi & static_cast<uint64_t>(r[5])) & 1) ? cf[1] : -cf[1];
  } else {
    const int t = static_cast<int>(r[1]);
    const uint64_t packed = static_cast<uint64_t>(r[2]);
    uint32_t k = 0;
    for (int j = 0; j < t; ++j) {
      k |= static_cast<uint32_t>((gi >> ((packed >> (6 * j)) & 63)) & 1) << j;
    }
    fr = cf[2 * k];
    fi = cf[2 * k + 1];
  }
  cmul_into(xr, xi, fr, fi);
}

// The run of elementwise records that starts at record o0 of the table
// ``ops`` (num_ops records); returns the record after the last one it
// applied. ``sre``:
// the tile's real plane, then its imaginary plane and the stage
// (kDiagStage bytes that no other arm uses during the sweep).
template <typename T>
__device__ __forceinline__ int diag_sweep(T* sre, int tile_bits, uint64_t role_base,
                                          const long long* __restrict__ ops, int o0,
                                          int num_ops, const T* __restrict__ coeffs,
                                          int tid_in) {
  using C = typename Cplx<T>::type;
  // the thread index, the tile and the block's bits through opaque moves,
  // as in krausn_dmma: what the sweep derives from them is computed here, not
  // hoisted out of the kernel's op loop, where it would hold registers
  // through every other op
  int tid, tb;
  asm volatile("mov.b32 %0, %1;" : "=r"(tid) : "r"(tid_in));
  asm volatile("mov.b32 %0, %1;" : "=r"(tb) : "r"(tile_bits));
  asm volatile("mov.b64 %0, %0;" : "+l"(role_base));
  const uint32_t tile = 1u << tb;
  T* sim = sre + tile;
  unsigned char* stage = reinterpret_cast<unsigned char*>(sim + tile);
  constexpr int K = (sizeof(T) == 4 ? 1 << 13 : 1 << 12) / kThreads;
  constexpr int KG = sizeof(T) == 4 ? kDiagHeld32 : kDiagHeld64;
  constexpr int kGroupBits = KG == 16 ? 4 : KG == 8 ? 3 : KG == 4 ? 2 : KG == 2 ? 1 : 0;
  static_assert(KG == 1 << kGroupBits && K % KG == 0, "groups of a power of two");
  constexpr uint32_t kCap = (kDiagStage - kDiagHead) / sizeof(C);
  DiagRec* meta = reinterpret_cast<DiagRec*>(stage);
  C* tabs = reinterpret_cast<C*>(stage + kDiagHead);
  const int lane = tid & 31, warp = tid >> 5;
  const long long* r0 = ops + kRec * o0;
  const int left = num_ops - o0;
  int o = 0;  // records applied
  for (bool first = true; o < left && elementwise(r0 + kRec * o); first = false) {
    if (!first) __syncthreads();  // the last chunk's reads of the stage are done
    // every warp reads the chunk's records, lane k record o + k, so that
    // each has the chunk's size and its records' places without waiting
    // for another: the chunk ends before the first record that is not
    // elementwise or whose table does not fit
    const long long* r = r0 + kRec * (o + lane);
    const bool ew = o + lane < left && elementwise(r);
    const bool fast = ew && diag_fast(r);
    const int t = fast ? static_cast<int>(r[1]) : -1;  // its table's index bits
    constexpr uint32_t kPiece = 16 / sizeof(C);          // entries a 16-byte piece
    const uint32_t need = fast ? ((1u << t) + kPiece - 1) / kPiece * kPiece : 0u;
    uint32_t end = need;  // the inclusive prefix sum of the table sizes
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t v = __shfl_up_sync(0xffffffffu, end, d);
      if (lane >= d) end += v;
    }
    const uint32_t stop = __ballot_sync(0xffffffffu, !(ew && end <= kCap));
    const int n = stop ? __ffs(stop) - 1 : 32;
    const uint32_t tab = end - need;
    const uint32_t src = ew ? static_cast<uint32_t>(r[6]) : 0u;
    if (warp == 0 && lane < n) {  // what the sweep reads of each record
      DiagRec& m = meta[lane];
      m.tab = tab;
      m.src = src;
      if (fast) {
        const uint64_t packed = static_cast<uint64_t>(r[2]);
        uint32_t steps = 0;
        for (int j = 0; j < t; ++j) {
          const int q = static_cast<int>((packed >> (6 * j)) & 63);
          if (q >= kThreadBits && q < tb) steps |= 1u << (8 * (q - kThreadBits) + j);
        }
        m.steps = steps;
        m.mode = kDiagFast;
      } else {
        const uint64_t above = ~static_cast<uint64_t>(tile - 1);
        const uint64_t cmask = static_cast<uint64_t>(r[3]), cval = static_cast<uint64_t>(r[4]);
        m.mode = (role_base & cmask & above) != (cval & above) ? kDiagSkip : kDiagGeneric;
      }
    }
    // the tables, by cp.async in 16-byte pieces (a block's coefficients
    // start 4-element aligned and are padded to 4 elements): all of the
    // chunk's in flight at once, holding no registers
    for (int k = 0; k < n; ++k) {
      const int tk = __shfl_sync(0xffffffffu, t, k);
      const uint32_t tabk = __shfl_sync(0xffffffffu, tab, k);
      const uint32_t srck = __shfl_sync(0xffffffffu, src, k);
      if (tk < 0) continue;
      const int pieces = ((1 << tk) + kPiece - 1) / kPiece;
      for (int x = tid; x < pieces; x += kThreads) {
        quest_mma::copy16_async(tabs + tabk + kPiece * x, coeffs + srck + 2 * kPiece * x);
      }
    }
    quest_mma::async_commit();
    // the lane and warp parts: 48 threads a record
    for (int w0 = 0; w0 < 48 * n; w0 += kThreads) {
      const int w = w0 + tid;
      const int k = w < 48 * n ? w / 48 : 0, p = w % 48;
      const int tk = __shfl_sync(0xffffffffu, t, k);
      if (w >= 48 * n || tk < 0) continue;
      const uint64_t packed = static_cast<uint64_t>(r0[kRec * (o + k) + 2]);
      const uint32_t v = p < 32 ? p : (p - 32) << 5;  // the part's bits of the thread index
      uint32_t idx = 0;
      for (int j = 0; j < tk; ++j) {
        const int q = static_cast<int>((packed >> (6 * j)) & 63);
        if (q >= tb) {
          if (p >= 32) idx |= static_cast<uint32_t>((role_base >> q) & 1) << j;
        } else if (q < kThreadBits) {
          idx |= ((v >> q) & 1) << j;
        }
      }
      if (p < 32) {
        meta[k].lane[p] = static_cast<uint8_t>(idx);
      } else {
        meta[k].warp[p - 32] = static_cast<uint8_t>(idx);
      }
    }
    quest_mma::async_wait<0>();
    __syncthreads();
    // each group of KG of the thread's amplitudes, slots s0 .. s0 + KG - 1:
    // read once, every record, written once
#pragma unroll 1
    for (int s0 = 0; s0 < K; s0 += KG) {
      if (static_cast<uint32_t>(tid) + kThreads * s0 >= tile) break;
      T xr[KG], xi[KG];
#pragma unroll
      for (int a = 0; a < KG; ++a) {
        const uint32_t i = static_cast<uint32_t>(tid) + kThreads * (s0 + a);
        xr[a] = i < tile ? sre[i] : T(0);
        xi[a] = i < tile ? sim[i] : T(0);
      }
      for (int k = 0; k < n; ++k) {
        const DiagRec& m = meta[k];
        const int mode = m.mode;
        if (mode == kDiagFast) {
          const C* tab = tabs + m.tab;
          const uint32_t steps = m.steps;
          uint32_t idx = m.lane[lane] | m.warp[warp];
#pragma unroll
          for (int b = kGroupBits; (1 << b) < K; ++b) {  // the group's fixed slot bits
            if ((s0 >> b) & 1) idx ^= (steps >> (8 * b)) & 0xff;
          }
#pragma unroll
          for (int a = 0; a < KG; ++a) {
            // Gray order: step a flips slot bit ctz(a), tile bit 9 + ctz(a)
            if (a) idx ^= (steps >> (8 * (__ffs(a) - 1))) & 0xff;
            const int g = a ^ (a >> 1);
            const C f = tab[idx];
            cmul_into(xr[g], xi[g], f.x, f.y);
          }
        } else if (mode == kDiagGeneric) {
          // an op too wide for a table (rare): through shared memory, one
          // amplitude at a time, so that it holds few registers
          const long long* r = r0 + kRec * (o + k);
#pragma unroll
          for (int a = 0; a < KG; ++a) {
            const uint32_t i = static_cast<uint32_t>(tid) + kThreads * (s0 + a);
            if (i < tile) {
              sre[i] = xr[a];
              sim[i] = xi[a];
            }
          }
#pragma unroll 1
          for (int a = 0; a < KG; ++a) {
            const uint32_t i = static_cast<uint32_t>(tid) + kThreads * (s0 + a);
            if (i < tile) diag_generic(sre[i], sim[i], r, coeffs + m.src, i, tile, role_base);
          }
#pragma unroll
          for (int a = 0; a < KG; ++a) {
            const uint32_t i = static_cast<uint32_t>(tid) + kThreads * (s0 + a);
            if (i < tile) {
              xr[a] = sre[i];
              xi[a] = sim[i];
            }
          }
        }
      }
#pragma unroll
      for (int a = 0; a < KG; ++a) {
        const uint32_t i = static_cast<uint32_t>(tid) + kThreads * (s0 + a);
        if (i < tile) {
          sre[i] = xr[a];
          sim[i] = xi[a];
        }
      }
    }
    o += n;
  }
  return o0 + o;
}

// The 2x2 arm (reg_sweep): a run of non-diagonal 2x2 and swap records in
// one sweep of the tile whose amplitudes stay in registers from the first
// record to the last.
//
// The host groups the records (group_sweeps, below the plan): a sweep
// holds consecutive 2x2 and swap records whose partner qubits lie in one
// set Q of W in-tile qubits, W = sweep_bits<T>() (3 in f32, 2 in f64: the
// widest that fit 64 registers; f32 at 4 and f64 at 3 spilled). Its first
// record carries, in fields that matrix and swap records leave free (p = 0
// for float, 1 for double), Q's mask (r[5] bits [16 p, 16 p + 16)) and its
// record count (r[7] bits [16 + 16 p, 32 + 16 p)). Elementwise records
// stay outside: the diagonal arm takes them (PERF.md: a sweep that took
// them through shared memory was no faster). A thread takes a group: the
// 2^W amplitudes whose indices differ only in Q, its group index deposited
// into the tile bits outside Q (the thread index's lowest bits into the
// lowest of them, so that a warp's lanes differ there: with Q above bit
// 4, each register step's shared-memory accesses fall in 32 distinct
// banks; the host pads Q from qubit 5 up). Two groups a thread at the
// 2^13 f32 and the 2^12 f64 tile. A group is read from shared memory
// once, every record of the sweep applied to it in registers, and written
// back once: no barrier inside the sweep (the groups partition the tile),
// one after it. A sweep of one record (reg_lone) takes Q = its own
// partner qubits, unpadded: a pair for a 2x2, a quad for a swap of which
// it reads and writes only the two registers that move, the record
// decoded once a thread (PERF.md: padded to W, with the registers it acts
// on masked, it ran 3-12% slower than the per-op branches on the QFT).
//   a 2x2 on q in Q      its 2^(W-1) register pairs (bit j of the register
//                        index, j = q's place in Q), in the form the host
//                        marks (r[7] bits 1-2): 16 multiply-adds a pair, 8
//                        for a real matrix (H), an exchange for X;
//   a swap of q1, q2     a permutation of the registers (selects where a
//                        control decides).
// Controls above the tile resolve once per block (a record whose controls
// there miss is skipped, block-uniformly), those in the tile outside Q
// once per group, those in Q per register pair (a mask over the register
// index). The register bit of a target is a runtime value, so each 2x2
// (and swap) dispatches to an instantiation per bit (pair), by if chains.
//
// Cost model, and what the card showed (PERF.md, H100 80GB HBM3 at 700
// W). Per sweep each amplitude it acts on crosses shared memory twice: at
// most 2^T x 2 x sizeof(T) x 2 bytes a tile, as ONE per-op sweep of the
// old arm did. At 26 qubits that is ~37 us a sweep in f32 (8192 tiles, 62
// an SM, at 128 bytes a clock), ~75 us in f64. Per 2x2, 16 FMAs a pair:
// 16 us in f32 at 67 TFLOP/s, 32 us in f64 at the 34 TFLOP/s outside the
// tensor cores, so the arithmetic, not the sweeps, bounds a run of 2x2s:
// the [7, 12) run's 14 2x2s in f32 spend ~0.25 ms in sweeps and ~0.4 ms
// in arithmetic and record decoding beside its 0.32 ms of HBM bytes.
constexpr int kSweepField = 16;  // bits of each precision's Q and count fields

template <typename T>
__host__ __device__ constexpr int sweep_place() { return sizeof(T) == 4 ? 0 : 1; }

// the width W of a register sweep (the host's SWEEP_BITS)
template <typename T>
__host__ __device__ constexpr int sweep_bits() { return sizeof(T) == 4 ? 3 : 2; }

// the index bits that register index a sets: qbit[j] where bit j of a is set
template <int W>
__device__ __forceinline__ uint32_t reg_bits(int a, const uint32_t (&qbit)[W]) {
  uint32_t d = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if ((a >> j) & 1) d |= qbit[j];
  }
  return d;
}

// The forms of a non-diagonal 2x2 that ``encode_ops`` marks in r[7] bits
// 1-2, each with its own arithmetic a register pair: a general matrix 16
// multiply-adds; a real one (Hadamard, Ry) 8; X (a CNOT's target) none, an
// exchange. (An Rx form of 8 more made ptxas spill 12 bytes in <float,
// false>: PERF.md.)
constexpr int kFormGeneral = 0, kFormReal = 1, kFormX = 3;

// the 2x2 cf (m00..m11, re/im) of form F on register bit J, on the pairs
// whose register index a meets the controls in Q: (a & cm) == cv
template <typename T, int W, int J, int F>
__device__ __forceinline__ void reg_2x2(T (&xr)[1 << W], T (&xi)[1 << W],
                                        const T* __restrict__ cf, uint32_t cm, uint32_t cv) {
  const T m00r = cf[0], m00i = cf[1], m01r = cf[2], m01i = cf[3];
  const T m10r = cf[4], m10i = cf[5], m11r = cf[6], m11i = cf[7];
#pragma unroll
  for (int a = 0; a < (1 << W); ++a) {
    if ((a >> J) & 1) continue;
    constexpr int kB = 1 << J;
    const bool on = (static_cast<uint32_t>(a) & cm) == cv;
    const T a0r = xr[a], a0i = xi[a], a1r = xr[a | kB], a1i = xi[a | kB];
    if constexpr (F == kFormX) {
      xr[a] = on ? a1r : a0r;
      xi[a] = on ? a1i : a0i;
      xr[a | kB] = on ? a0r : a1r;
      xi[a | kB] = on ? a0i : a1i;
    } else {
      if (!on) continue;
      if constexpr (F == kFormReal) {
        xr[a] = m00r * a0r + m01r * a1r;
        xi[a] = m00r * a0i + m01r * a1i;
        xr[a | kB] = m10r * a0r + m11r * a1r;
        xi[a | kB] = m10r * a0i + m11r * a1i;
      } else {
        xr[a] = m00r * a0r - m00i * a0i + m01r * a1r - m01i * a1i;
        xi[a] = m00r * a0i + m00i * a0r + m01r * a1i + m01i * a1r;
        xr[a | kB] = m10r * a0r - m10i * a0i + m11r * a1r - m11i * a1i;
        xi[a | kB] = m10r * a0i + m10i * a0r + m11r * a1i + m11i * a1r;
      }
    }
  }
}

// (if chains, not switches: a switch compiles to an indirect branch, and
// with one in the op loop ptxas spills in every arm)
template <typename T, int W, int F>
__device__ __forceinline__ void reg_2x2_at(int j, T (&xr)[1 << W], T (&xi)[1 << W],
                                           const T* __restrict__ cf, uint32_t cm,
                                           uint32_t cv) {
  if (j == 0) {
    reg_2x2<T, W, 0, F>(xr, xi, cf, cm, cv);
  } else if (j == 1) {
    reg_2x2<T, W, 1, F>(xr, xi, cf, cm, cv);
  } else if constexpr (W > 2) {
    if (j == 2) {
      reg_2x2<T, W, 2, F>(xr, xi, cf, cm, cv);
    } else if constexpr (W > 3) {
      reg_2x2<T, W, 3, F>(xr, xi, cf, cm, cv);
    }
  }
}

// a 2x2 of the form ``form`` on register bit J
template <typename T, int W, int J>
__device__ __forceinline__ void reg_2x2_form(int form, T (&xr)[1 << W], T (&xi)[1 << W],
                                             const T* __restrict__ cf, uint32_t cm,
                                             uint32_t cv) {
  if (form == kFormX) {
    reg_2x2<T, W, J, kFormX>(xr, xi, cf, cm, cv);
  } else if (form == kFormReal) {
    reg_2x2<T, W, J, kFormReal>(xr, xi, cf, cm, cv);
  } else {
    reg_2x2<T, W, J, kFormGeneral>(xr, xi, cf, cm, cv);
  }
}

// a 2x2 of the form ``form`` on register bit j
template <typename T, int W>
__device__ __forceinline__ void reg_2x2_on(int form, int j, T (&xr)[1 << W], T (&xi)[1 << W],
                                           const T* __restrict__ cf, uint32_t cm,
                                           uint32_t cv) {
  if (form == kFormX) {
    reg_2x2_at<T, W, kFormX>(j, xr, xi, cf, cm, cv);
  } else if (form == kFormReal) {
    reg_2x2_at<T, W, kFormReal>(j, xr, xi, cf, cm, cv);
  } else {
    reg_2x2_at<T, W, kFormGeneral>(j, xr, xi, cf, cm, cv);
  }
}

// SWAP of register bits J1 < J2 on the registers that meet the controls
template <typename T, int W, int J1, int J2>
__device__ __forceinline__ void reg_swap(T (&xr)[1 << W], T (&xi)[1 << W], uint32_t cm,
                                         uint32_t cv) {
#pragma unroll
  for (int a = 0; a < (1 << W); ++a) {
    if (!((a >> J1) & 1) || ((a >> J2) & 1)) continue;  // a: bit J1 set, bit J2 clear
    constexpr int kFlip = (1 << J1) | (1 << J2);
    const bool on = (static_cast<uint32_t>(a) & cm) == cv;
    const T ar = xr[a], ai = xi[a], br = xr[a ^ kFlip], bi = xi[a ^ kFlip];
    xr[a] = on ? br : ar;
    xi[a] = on ? bi : ai;
    xr[a ^ kFlip] = on ? ar : br;
    xi[a ^ kFlip] = on ? ai : bi;
  }
}

template <typename T, int W, int J1>
__device__ __forceinline__ void reg_swap_from(int j2, T (&xr)[1 << W], T (&xi)[1 << W],
                                              uint32_t cm, uint32_t cv) {
  if constexpr (J1 < 1) {
    if (j2 == 1) {
      reg_swap<T, W, J1, 1>(xr, xi, cm, cv);
      return;
    }
  }
  if constexpr (J1 < 2 && W > 2) {
    if (j2 == 2) {
      reg_swap<T, W, J1, 2>(xr, xi, cm, cv);
      return;
    }
  }
  if constexpr (J1 < 3 && W > 3) {
    if (j2 == 3) reg_swap<T, W, J1, 3>(xr, xi, cm, cv);
  }
}

// the swap of register bits j1 and j2 (j1 != j2)
template <typename T, int W>
__device__ __forceinline__ void reg_swap_on(int j1, int j2, T (&xr)[1 << W],
                                            T (&xi)[1 << W], uint32_t cm, uint32_t cv) {
  if (j1 > j2) {
    const int t = j1;
    j1 = j2;
    j2 = t;
  }
  if (j1 == 0) {
    reg_swap_from<T, W, 0>(j2, xr, xi, cm, cv);
  } else if (j1 == 1) {
    reg_swap_from<T, W, 1>(j2, xr, xi, cm, cv);
  } else if constexpr (W > 3) {
    reg_swap_from<T, W, 2>(j2, xr, xi, cm, cv);
  }
}

// g with a zero inserted at each of Q's bits: the in-tile index of group
// g's register 0
template <int W>
__device__ __forceinline__ uint32_t deposit_zeros(uint32_t g, const uint32_t (&qbit)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint32_t low = g & (qbit[j] - 1);
    g = ((g - low) << 1) | low;
  }
  return g;
}

// The group's registers to (store) or from its slots in shared memory, the
// addresses found again each time, not held from an earlier access
template <typename T, int W, bool kStore>
__device__ __forceinline__ void group_io(T* sre, T* sim, uint32_t base, uint32_t (&qbit)[W],
                                         T (&xr)[1 << W], T (&xi)[1 << W]) {
  asm volatile("mov.b32 %0, %0;" : "+r"(base));
#pragma unroll
  for (int j = 0; j < W; ++j) asm volatile("mov.b32 %0, %0;" : "+r"(qbit[j]));
#pragma unroll
  for (int a = 0; a < (1 << W); ++a) {
    const uint32_t i = base | reg_bits(a, qbit);
    if constexpr (kStore) {
      sre[i] = xr[a];
      sim[i] = xi[a];
    } else {
      xr[a] = sre[i];
      xi[a] = sim[i];
    }
  }
}

// The controls of record r that lie in Q, over the register index (cm,
// cv), from its in-tile control mask and values
template <int W>
__device__ __forceinline__ void reg_controls(uint32_t lmask, uint32_t lval,
                                             const uint32_t (&qbit)[W], uint32_t& cm,
                                             uint32_t& cv) {
  cm = cv = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    cm |= (lmask & qbit[j]) ? 1u << j : 0u;
    cv |= (lval & qbit[j]) ? 1u << j : 0u;
  }
}

// The sweep of W-bit Q ``qmask_in`` over the ``count`` 2x2 and swap
// records from r0; ``sre``: the tile's real plane, then its imaginary
// plane.
template <typename T, int W>
__device__ __forceinline__ void reg_sweep(T* sre, int tile_bits, uint64_t role_base,
                                          const long long* __restrict__ r0, int count,
                                          uint32_t qmask_in, const T* __restrict__ coeffs,
                                          int tid_in) {
  // through opaque moves, as in diag_sweep: what the sweep derives from
  // them stays here, not hoisted into the kernel's op loop
  int tid, tb;
  uint32_t qmask;
  asm volatile("mov.b32 %0, %1;" : "=r"(tid) : "r"(tid_in));
  asm volatile("mov.b32 %0, %1;" : "=r"(tb) : "r"(tile_bits));
  asm volatile("mov.b32 %0, %1;" : "=r"(qmask) : "r"(qmask_in));
  asm volatile("mov.b64 %0, %0;" : "+l"(role_base));
  const uint32_t tile = 1u << tb;
  T* sim = sre + tile;
  const uint64_t above = ~static_cast<uint64_t>(tile - 1);
  uint32_t qbit[W];  // Q's qubits as index bits, lowest first
  {
    uint32_t m = qmask;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      qbit[j] = m & (0u - m);
      m &= m - 1;
    }
  }
  const uint32_t groups = tile >> W;
  for (uint32_t g = tid; g < groups; g += kThreads) {
    const uint32_t base = deposit_zeros<W>(g, qbit);
    T xr[1 << W], xi[1 << W];
    group_io<T, W, false>(sre, sim, base, qbit, xr, xi);
    for (int k = 0; k < count; ++k) {
      const long long* r = r0 + kRec * k;
      const uint64_t cmask = static_cast<uint64_t>(r[3]);
      const uint64_t cval = static_cast<uint64_t>(r[4]);
      // controls above the tile: the identity on this whole tile where they miss
      if ((role_base & cmask & above) != (cval & above)) continue;
      const uint32_t lmask = static_cast<uint32_t>(cmask) & (tile - 1);
      const uint32_t lval = static_cast<uint32_t>(cval) & (tile - 1);
      if ((base & lmask) != (lval & ~qmask)) continue;  // controls outside Q miss
      uint32_t cm, cv;
      reg_controls<W>(lmask, lval, qbit, cm, cv);
      const int j1 = __popc(qmask & ((1u << static_cast<uint32_t>(r[1])) - 1));
      if (static_cast<int>(r[0]) == kMatrix) {
        reg_2x2_on<T, W>(static_cast<int>(r[7] >> 1) & 3, j1, xr, xi, coeffs + r[6], cm, cv);
      } else {  // a swap
        reg_swap_on<T, W>(j1, __popc(qmask & ((1u << static_cast<uint32_t>(r[2])) - 1)), xr,
                          xi, cm, cv);
      }
    }
    group_io<T, W, true>(sre, sim, base, qbit, xr, xi);
  }
}

// A sweep of one record (a lone 2x2 or swap), at its own width: Q is the
// record's partner qubits, so a group is a pair for a 2x2 and a quad for a
// swap, of which only registers 1 and 2 move; the record is decoded once
// a thread, and a group its controls miss is skipped (no control lies in
// Q).
template <typename T>
__device__ __forceinline__ void reg_lone(T* sre, int tile_bits, uint64_t role_base,
                                         const long long* __restrict__ r, uint32_t qmask_in,
                                         const T* __restrict__ coeffs, int tid_in) {
  int tid, tb;
  uint32_t qmask;
  asm volatile("mov.b32 %0, %1;" : "=r"(tid) : "r"(tid_in));
  asm volatile("mov.b32 %0, %1;" : "=r"(tb) : "r"(tile_bits));
  asm volatile("mov.b32 %0, %1;" : "=r"(qmask) : "r"(qmask_in));
  asm volatile("mov.b64 %0, %0;" : "+l"(role_base));
  const uint32_t tile = 1u << tb;
  T* sim = sre + tile;
  const uint64_t above = ~static_cast<uint64_t>(tile - 1);
  const uint64_t cmask = static_cast<uint64_t>(r[3]);
  const uint64_t cval = static_cast<uint64_t>(r[4]);
  if ((role_base & cmask & above) != (cval & above)) return;  // block-uniform
  const uint32_t lmask = static_cast<uint32_t>(cmask) & (tile - 1);
  const uint32_t lval = static_cast<uint32_t>(cval) & (tile - 1);
  if (static_cast<int>(r[0]) == kSwap) {
    uint32_t qbit[2] = {qmask & (0u - qmask), qmask & (qmask - 1)};
    for (uint32_t g = tid; g < (tile >> 2); g += kThreads) {
      const uint32_t base = deposit_zeros<2>(g, qbit);
      if ((base & lmask) != lval) continue;
      const uint32_t i1 = base | qbit[0], i2 = base | qbit[1];
      const T ar = sre[i1], ai = sim[i1];
      sre[i1] = sre[i2];
      sim[i1] = sim[i2];
      sre[i2] = ar;
      sim[i2] = ai;
    }
  } else {
    const uint32_t qbit[1] = {qmask};
    const int form = static_cast<int>(r[7] >> 1) & 3;
    const T* cf = coeffs + r[6];
    for (uint32_t g = tid; g < (tile >> 1); g += kThreads) {
      const uint32_t base = deposit_zeros<1>(g, qbit);
      if ((base & lmask) != lval) continue;
      T xr[2] = {sre[base], sre[base | qmask]}, xi[2] = {sim[base], sim[base | qmask]};
      reg_2x2_form<T, 1, 0>(form, xr, xi, cf, 0u, 0u);
      sre[base] = xr[0];
      sim[base] = xi[0];
      sre[base | qmask] = xr[1];
      sim[base | qmask] = xi[1];
    }
  }
}

// The register sweep that record ``r`` (a non-diagonal 2x2 or a swap)
// opens; returns its record count.
template <typename T>
__device__ __forceinline__ int reg_sweep_at(T* sre, int tile_bits, uint64_t role_base,
                                            const long long* __restrict__ r,
                                            const T* __restrict__ coeffs, int tid) {
  constexpr int p = sweep_place<T>();
  const uint32_t qmask = static_cast<uint32_t>(
      (static_cast<uint64_t>(r[5]) >> (kSweepField * p)) & 0xffff);
  const int count = static_cast<int>(
      (static_cast<uint64_t>(r[7]) >> (kSweepField * (p + 1))) & 0xffff);
  // every 2x2 and swap record lies in a sweep that the host marked: a lone
  // one at its own qubits, a longer one at the precision's width
  if (count == 1) {
    const uint32_t own = (1u << static_cast<uint32_t>(r[1])) |
                         (static_cast<int>(r[0]) == kSwap ? 1u << static_cast<uint32_t>(r[2]) : 0u);
    if (qmask != own || (qmask >> tile_bits)) __trap();
    reg_lone<T>(sre, tile_bits, role_base, r, qmask, coeffs, tid);
    return 1;
  }
  if (count == 0 || (qmask >> tile_bits) || __popc(qmask) != sweep_bits<T>()) __trap();
  reg_sweep<T, sweep_bits<T>()>(sre, tile_bits, role_base, r, count, qmask, coeffs, tid);
  return count;
}

// The dense ops hold at most 16 outputs per thread, so a tile is at most
// 16 * kThreads = 2^13 amplitudes (2^12 in f64). Dynamic shared memory:
// both planes of the tile, plus, for a run with a t = 3 kraus op or an
// f64 run with lane_u, kLaneDmmaStage bytes (two blocks per SM still), and
// for an f32 run with lane_u kLaneMmaStage (the kLaneMma instantiation: one
// block per SM, which leaves the compiler 128 registers a thread; a t = 3
// kraus op in it streams S^T through the first 32 KiB of its panels).
template <typename T, bool kLaneMma>
__global__ void __launch_bounds__(kThreads, kLaneMma ? 1 : 2)
fused_run_kernel(const T* src, T* dst, int local_n, uint64_t shard_base,
                 int tile_bits, const long long* __restrict__ ops,
                 int num_ops, const T* __restrict__ coeffs, int load_k,
                 int load_hi, int store_k, int store_hi, int pair_lo,
                 int pair_hi) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t tile = 1u << tile_bits;
  T* sre = reinterpret_cast<T*>(smem_raw);
  T* sim = sre + tile;
  const uint64_t N = 1ull << local_n;  // amplitudes of one plane of the shard
  // the lane: a whole (2, N) state of a batch, every lane under the same
  // op table (one launch serves a batch of parameter sweeps' static runs)
  src += 2 * N * blockIdx.y;
  dst += 2 * N * blockIdx.y;
  // the tile's address in the shard, and its index bits >= T in the whole
  // state (shard_base = shard_index << local_n): the first for loads and
  // stores, the second for every op's roles
  const uint64_t tile_base = static_cast<uint64_t>(blockIdx.x) << tile_bits;
  const uint64_t role_base = shard_base | tile_base;
  const uint64_t tile_mask = tile - 1;
  const int tid = threadIdx.x;
  const int pair_k = pair_lo != pair_hi;  // the 1-bit exchange, both sides

  const FrameMap load(tile_base, tile_bits, load_k, load_hi, pair_lo, pair_hi,
                      pair_k);
  if (load.moves) {
    for (uint32_t i = tid; i < tile; i += kThreads) {
      const uint64_t s = load(i);
      sre[i] = src[s];
      sim[i] = src[N + s];
    }
  } else if constexpr (kLaneMma) {
    // one block per SM: nothing else hides the load, so the whole tile is
    // in flight at once (16-byte loads, all issued before any store)
    for (uint32_t i0 = 4 * tid; i0 < tile; i0 += kTileVecs * 4 * kThreads) {
      float4 re[kTileVecs], im[kTileVecs];
#pragma unroll
      for (int k = 0; k < kTileVecs; ++k) {
        const uint32_t i = i0 + k * 4 * kThreads;
        if (i < tile) {
          re[k] = *reinterpret_cast<const float4*>(src + (tile_base | i));
          im[k] = *reinterpret_cast<const float4*>(src + N + (tile_base | i));
        }
      }
#pragma unroll
      for (int k = 0; k < kTileVecs; ++k) {
        const uint32_t i = i0 + k * 4 * kThreads;
        if (i < tile) {
          *reinterpret_cast<float4*>(sre + i) = re[k];
          *reinterpret_cast<float4*>(sim + i) = im[k];
        }
      }
    }
  } else {
    for (uint32_t i = tid; i < tile; i += kThreads) {
      sre[i] = src[tile_base | i];
      sim[i] = src[N + (tile_base | i)];
    }
  }
  __syncthreads();

  for (int o = 0; o < num_ops; ++o) {
    const long long* r = ops + kRec * o;
    if (elementwise(r)) {  // the run of elementwise records from here: one sweep
      o = diag_sweep<T>(sre, tile_bits, role_base, ops, o, num_ops, coeffs, tid) - 1;
      __syncthreads();
      continue;
    }
    const int kind = static_cast<int>(r[0]);
    if (kind == kMatrix || kind == kSwap) {  // the register sweep it opens: its records at once
      o += reg_sweep_at<T>(sre, tile_bits, role_base, r, coeffs, tid) - 1;
      __syncthreads();
      continue;
    }
    const uint64_t cmask = static_cast<uint64_t>(r[3]);
    const uint64_t cval = static_cast<uint64_t>(r[4]);
    // controls above the tile resolve per tile: where they miss, the op
    // is the identity on this whole tile (a block-uniform branch)
    if ((role_base & cmask & ~tile_mask) != (cval & ~tile_mask)) continue;
    const T* cf = coeffs + r[6];

    if (kind == kLaneU) {
      if constexpr (sizeof(T) == 8) {
        lane_u_dmma(sre, sim, sim + tile, tile, cf, tid);
      } else if constexpr (kLaneMma) {
        lane_u_mma(sre, sim, sim + tile, tile, cf, tid);
      } else {
        __trap();  // the launcher sends every f32 run with lane_u to kLaneMma
      }
    } else if (kind == kWindow) {
      const int lo = static_cast<int>(r[1]), span = static_cast<int>(r[2]);
      if constexpr (sizeof(T) == 8) {
        if (span >= 3) {
          // lo = 7, lo + span = tile_bits: the host refuses any other f64 window
          if (lo != kLaneBits || tile != (static_cast<uint32_t>(kLanes) << span)) __trap();
          window_dmma(sre, sim, sim + tile, cf, span, tid);
        } else {
          window_op<T, 2, 1>(sre, sim, tile, cf, lo, span, tid);
        }
      } else {  // in either f32 instantiation: a lane_u run may hold a window
        if (span >= 3) {
          window_mma(sre, sim, sim + tile, tile, cf, lo, span, tid);
        } else if (span == 2) {
          window_op<T, 4, 1>(sre, sim, tile, cf, lo, span, tid);
        } else {  // a span-1 zone (D = 2): two items per thread
          window_op<T, 2, 2>(sre, sim, tile, cf, lo, span, tid);
        }
      }
    } else if (kind == kKraus1 || kind == kKraus2 || kind == kKrausN) {
      const int t = static_cast<int>(r[1]);
      const uint32_t mask = static_cast<uint32_t>(r[5]);
      if constexpr (sizeof(T) == 8) {
        if (t == 3) {
          krausn_dmma(sre, sim, sim + tile, tile, cf, mask, tid);
        } else {
          kraus_op<T, 2, 1>(sre, sim, tile, cf, t, mask, tid);
        }
      } else {
        if (t == 3) {  // in either f32 instantiation: a lane_u run may hold one
          krausn_mma<kLaneMma ? 1 : kKrausN8>(sre, sim, sim + tile, tile, cf, mask, tid);
        } else {
          kraus_op<T, 4, 4>(sre, sim, tile, cf, t, mask, tid);
        }
      }
    }
    __syncthreads();
  }

  const FrameMap store(tile_base, tile_bits, store_k, store_hi, pair_lo,
                       pair_hi, pair_k);
  if (store.moves) {
    for (uint32_t i = tid; i < tile; i += kThreads) {
      const uint64_t d = store(i);
      dst[d] = sre[i];
      dst[N + d] = sim[i];
    }
  } else if constexpr (kLaneMma) {
    for (uint32_t i = 4 * tid; i < tile; i += 4 * kThreads) {
      *reinterpret_cast<float4*>(dst + (tile_base | i)) = *reinterpret_cast<const float4*>(sre + i);
      *reinterpret_cast<float4*>(dst + N + (tile_base | i)) = *reinterpret_cast<const float4*>(sim + i);
    }
  } else {
    for (uint32_t i = tid; i < tile; i += kThreads) {
      dst[tile_base | i] = sre[i];
      dst[N + (tile_base | i)] = sim[i];
    }
  }
}

// What a run's ops stage through shared memory beyond the tile (the
// ``staged`` flags of the launch): bit 0, a lane_u op; bit 1, a kraus op on
// t = 3 row qubits; bit 2, a window op of span 3 or more (its U, in either
// precision: window_dmma's table, window_mma's split table); bit 3, an
// elementwise record (diag_sweep's staged records and tables).
constexpr int kStagedLaneU = 1;
constexpr int kStagedKrausN = 2;
constexpr int kStagedWindow = 4;
constexpr int kStagedDiag = 8;

// The instantiation a run takes and its dynamic shared memory, chosen by
// what the run holds: an f32 run with lane_u (and krausn or windows or
// not) takes the one with one block per SM; every other run, runs with
// krausn, a window of span 3 or more or elementwise records and f64 runs
// with lane_u too, two blocks per SM.
template <typename T>
auto pick(int tile_bits, int staged, int* smem) {
  auto kernel = fused_run_kernel<T, false>;
  int stage = 0;
  if constexpr (sizeof(T) == 4) {
    if (staged & kStagedLaneU) {
      kernel = fused_run_kernel<T, true>;
      stage = kLaneMmaStage;  // holds krausn_mma's chunk ring and window_mma's table too
    } else if (staged & (kStagedKrausN | kStagedWindow | kStagedDiag)) {
      stage = kLaneDmmaStage;
    }
  } else {
    if (staged & (kStagedLaneU | kStagedKrausN | kStagedWindow | kStagedDiag)) {
      stage = kLaneDmmaStage;
    }
  }
  *smem = static_cast<int>(2 * sizeof(T) << tile_bits) + stage;
  return kernel;
}

// How many thread blocks of a run fit one SM at once (the occupancy API,
// for the instantiation and shared memory the run takes), or -(a
// cudaError_t).
template <typename T>
int blocks_per_sm(int tile_bits, int staged) {
  int smem = 0, blocks = 0;
  const auto kernel = pick<T>(tile_bits, staged, &smem);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// n: the qubits of the whole state, which bound the ops' qubits; local_n:
// those of the shard this launch runs on (its grid is 2^(local_n - T)
// blocks by lanes), shard_index its place among the 2^(n - local_n) shards;
// lanes: the states of the batch at src and dst, one after another.
template <typename T>
int launch(int max_bits, const T* src, T* dst, int n, int local_n,
           long long shard_index, int tile_bits, const long long* ops,
           int num_ops, const T* coeffs, int load_k, int load_hi,
           int store_k, int store_hi, int pair_lo, int pair_hi,
           int staged, void* stream, int lanes) {
  if (lanes < 1 || lanes > 65535 ||
      tile_bits < kLaneBits || tile_bits > max_bits ||
      local_n < tile_bits || n < local_n || n > 40 || num_ops < 0 ||
      shard_index < 0 || shard_index >= (1ll << (n - local_n)) ||
      (load_k && load_hi + load_k > local_n) ||
      (store_k && store_hi + store_k > local_n) ||
      (pair_lo != pair_hi && (pair_lo < 0 || pair_lo >= tile_bits ||
                              pair_hi < tile_bits || pair_hi >= local_n))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int smem = 0;
  const auto kernel = pick<T>(tile_bits, staged, &smem);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(1u << (local_n - tile_bits), static_cast<unsigned>(lanes));
  const uint64_t shard_base = static_cast<uint64_t>(shard_index) << local_n;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      src, dst, local_n, shard_base, tile_bits, ops, num_ops, coeffs,
      load_k, load_hi, store_k, store_hi, pair_lo, pair_hi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Both return the cudaError_t of the launch (0 = launched). src and dst
// hold one shard, (2, 2^local_n), of an n-qubit state: shard shard_index
// (local_n = n, shard_index = 0 for a state on one device). pair_lo <
// tile_bits <= pair_hi: bits exchanged on load and on store (pair_lo ==
// pair_hi: none). staged: what the op table holds that streams its matrix
// through shared memory, bit 0 a lane_u op (in f32, the tensor-core
// instantiation), bit 1 a kraus op on 3 row qubits (krausn_dmma,
// krausn_mma), bit 2 a window op of span 3 or more (window_dmma,
// window_mma), bit 3 an elementwise record (diag_sweep's tables).
// A run whose flags miss such an op writes past its shared memory. lanes
// (1 to 65535): the states of a batch at src and dst, each (2, 2^local_n)
// and contiguous one after another, all under the same op table.
int quest_fused_run_f32(const float* src, float* dst, int n, int local_n,
                        long long shard_index, int tile_bits,
                        const long long* ops, int num_ops,
                        const float* coeffs, int load_k, int load_hi,
                        int store_k, int store_hi, int pair_lo, int pair_hi,
                        int staged, void* stream, int lanes) {
  return launch<float>(13, src, dst, n, local_n, shard_index, tile_bits, ops,
                       num_ops, coeffs, load_k, load_hi, store_k, store_hi,
                       pair_lo, pair_hi, staged, stream, lanes);
}

int quest_fused_run_f64(const double* src, double* dst, int n, int local_n,
                        long long shard_index, int tile_bits,
                        const long long* ops, int num_ops,
                        const double* coeffs, int load_k, int load_hi,
                        int store_k, int store_hi, int pair_lo, int pair_hi,
                        int staged, void* stream, int lanes) {
  return launch<double>(12, src, dst, n, local_n, shard_index, tile_bits,
                        ops, num_ops, coeffs, load_k, load_hi, store_k,
                        store_hi, pair_lo, pair_hi, staged, stream, lanes);
}

// thread blocks per SM of a run of float (f64 = 0) or double (f64 = 1)
// at tile_bits with the staged flags of the launch; < 0: -(the cudaError_t)
int quest_fused_run_blocks_per_sm(int f64, int tile_bits, int staged) {
  return f64 ? blocks_per_sm<double>(tile_bits, staged)
             : blocks_per_sm<float>(tile_bits, staged);
}

const char* quest_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
