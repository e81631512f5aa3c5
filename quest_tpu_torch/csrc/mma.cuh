// Warp-level tensor-core helpers for Hopper (sm_90a): the fragment
// loads and stores of mma.sync m16n8k8, the 3xTF32 split, the mma.sync
// wrappers for FP64 (m16n8k8 and m16n8k16) and TF32, and the cp.async
// copies that stage operands into shared memory.
//
// One shape serves both precisions: mma.sync.aligned.m16n8k8.row.col
// with .f64 operands and accumulator (exact FP64 FMA arithmetic, PTX ISA
// 7.8, sm_90) or .tf32 operands and an .f32 accumulator. Both lay their
// fragments out alike (CUTLASS's SM90_16x8x8_F64F64F64F64_TN and
// SM80_16x8x8_F32TF32TF32F32_TN traits). With lane = 4 g + t:
//   A (16 x 8): a[0] = A[g][t], a[1] = A[g+8][t], a[2] = A[g][t+4],
//               a[3] = A[g+8][t+4];
//   B (8 x 8):  b[0] = B[t][g], b[1] = B[t+4][g];
//   C (16 x 8): c[0] = C[g][2t], c[1] = C[g][2t+1], c[2] = C[g+8][2t],
//               c[3] = C[g+8][2t+1].
//
// Shared-memory layouts. ldmatrix moves 16-bit elements, so 32- and
// 64-bit operands are read with plain vector loads (the pair layout
// below), from row-padded arrays whose padding keeps a warp's accesses
// free of bank conflicts:
//   load_a_pairs reads row k of the panel at p[k * ld]: f32 pairs are
//     8-byte words, and ld = 8 (mod 32) floats puts each half-warp's words
//     (4 t + g) in 16 different bank pairs; f64 pairs are 16-byte units,
//     and ld = 4 (mod 16) doubles puts each quarter-warp's units (2 t + g)
//     in 8 different bank quads;
//   store_c_pairs writes row n at p[n * ld]: ld = 4 (mod 16) floats or
//     ld = 2 (mod 8) doubles, by the same count, without conflicts.
//
// 3xTF32. A TF32 operand keeps 10 of FP32's 23 mantissa bits. Each FP32
// value a is split as a = hi + lo, hi = rna(a) (the rounding of
// cvt.rna.tf32.f32) and lo = a - hi (exact), which the tensor core reads
// as TF32, dropping its low 13 bits; a product is hi*hi + hi*lo + lo*hi,
// summed in FP32: lo*lo and the bits dropped from lo, each about 2^-21 of
// the product or less, are lost.
//
// The tensor core's FP32 accumulation truncates: mma.sync rounds c + a b
// toward zero, not to nearest. Chained onto one running sum, every k step
// shrinks the sum by up to a unit in its last place, always toward zero:
// a one-signed loss of norm (3.1e-6 a one-op lane_u pass of 96 chained
// products, 7.6e-7 a span-5 window pass; chip_lane_u_breakdown.py
// drift32). So mma_3xtf32 never chains onto the caller's sum: each of the
// three products goes into a zeroed fragment, whose truncation is a unit
// of that product, not of the sum, and reaches the sum by an FP32 add,
// which rounds to nearest (45x / 10x less loss a pass; the 26q f32 main
// path drifts 1.75x its plain version after 8 runs, not 14.7x).

#pragma once

#include <stdint.h>

namespace quest_mma {

struct Lane {
  int g, t;  // lane = 4 g + t
};

__device__ __forceinline__ Lane lane_coords() {
  const int l = threadIdx.x & 31;
  return {l >> 2, l & 3};
}

// two consecutive values: float2 or double2
template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

// The M dimension of a product is a free index: an A row m may stand for
// any column of the panel, as long as C row m is written back to it. The
// pair layout takes A row g to column 2 g and A row g + 8 to column
// 2 g + 1 of a 16-column tile, so that a lane's two A values of one k, and
// its two C values of one n, sit side by side: one 8-byte (f32) or
// 16-byte (f64) access each.

// the A fragment of A[m][k] = p[k * ld + col(m)], pair layout
template <typename T>
__device__ __forceinline__ void load_a_pairs(const T* p, int ld, Lane l, T a[4]) {
  using V = typename Pair<T>::type;
  const T* q = p + l.t * ld + 2 * l.g;
  const V x = *reinterpret_cast<const V*>(q);
  const V y = *reinterpret_cast<const V*>(q + 4 * ld);
  a[0] = x.x;
  a[1] = x.y;
  a[2] = y.x;
  a[3] = y.y;
}

// the B fragment of B[k][n] = p[n * ld + k]
template <typename T>
__device__ __forceinline__ void load_b_nmajor(const T* p, int ld, Lane l, T b[2]) {
  const T* q = p + l.g * ld + l.t;
  b[0] = q[0];
  b[1] = q[4];
}

// C[m][n] -> p[n * ld + col(m)], pair layout
template <typename T>
__device__ __forceinline__ void store_c_pairs(T* p, int ld, Lane l, const T c[4]) {
  using V = typename Pair<T>::type;
  T* q = p + 2 * l.t * ld + 2 * l.g;
  *reinterpret_cast<V*>(q) = V{c[0], c[2]};
  *reinterpret_cast<V*>(q + ld) = V{c[1], c[3]};
}

// round to TF32, nearest with ties away from zero: the value of
// cvt.rna.tf32.f32 for every finite x (a .b32 with the low 13 mantissa
// bits zero: a float), in two integer operations, where the conversion
// itself runs at a fraction of their rate: half a unit of the last kept
// place added to the magnitude, the dropped bits cleared
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi TF32, lo read as TF32 by the tensor core
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b, FP64 operands and accumulator
__device__ __forceinline__ void mma_f64(double c[4], const double a[4], const double b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// c += a b, FP64 m16n8k16 (sm_90): the m16n8k8 layout with k extended,
// a[i] = A[g + 8 (i & 1)][t + 4 (i >> 1)], b[i] = B[t + 4 i][g]
__device__ __forceinline__ void mma_f64_k16(double c[4], const double a[8], const double b[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
        "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// c += a b, TF32 operands, FP32 accumulator
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// split operands of 3xTF32
struct SplitA {
  uint32_t hi[4], lo[4];
};
struct SplitB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ SplitA split_a(const float a[4]) {
  SplitA s;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], s.hi[i], s.lo[i]);
  return s;
}

// a B fragment's two values split in registers
__device__ __forceinline__ SplitB split_b(float b0, float b1) {
  SplitB s;
  split_tf32(b0, s.hi[0], s.lo[0]);
  split_tf32(b1, s.hi[1], s.lo[1]);
  return s;
}

// an A fragment split ahead of time: hi[0..3] at hi, lo[0..3] at lo, one
// 16-byte load each (both 16-byte aligned)
__device__ __forceinline__ SplitA load_a_split(const float* hi, const float* lo) {
  const uint4 h = *reinterpret_cast<const uint4*>(hi);
  const uint4 l = *reinterpret_cast<const uint4*>(lo);
  return SplitA{{h.x, h.y, h.z, h.w}, {l.x, l.y, l.z, l.w}};
}

// -b, exactly: the split of -x is the split of x with both signs flipped
__device__ __forceinline__ SplitB negate(const SplitB& b) {
  return SplitB{{b.hi[0] ^ 0x80000000u, b.hi[1] ^ 0x80000000u},
                {b.lo[0] ^ 0x80000000u, b.lo[1] ^ 0x80000000u}};
}

// a B fragment split ahead of time: hi[0], hi[1], lo[0], lo[1] at p, one
// 16-byte load (p 16-byte aligned)
__device__ __forceinline__ SplitB load_b_split(const float* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  return SplitB{{v.x, v.y}, {v.z, v.w}};
}

// c += a b in 3xTF32, each product into a zeroed fragment added to c (see
// above): the small terms first, then hi*hi
__device__ __forceinline__ void mma_3xtf32(float c[4], const SplitA& a, const SplitB& b) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, a.lo, b.hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c[i] += d[i];
    d[i] = 0.f;
  }
  mma_tf32(d, a.hi, b.lo);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c[i] += d[i];
    d[i] = 0.f;
  }
  mma_tf32(d, a.hi, b.hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += d[i];
}

// cp.async: a 16-byte copy from global to shared memory that does not
// hold up the issuing thread; a commit closes a group of them, and
// wait_group<N> lets at most the N newest groups still be in flight
__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(gmem));
}
__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace quest_mma
