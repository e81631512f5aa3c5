// Dense unitary on a contiguous qubit window: every column of the planar
// (2, 2^n) state, viewed as (A, D, B) with D = 2^span (the window [lo, hi],
// span = hi - lo + 1 <= 6) and B = 2^lo >= 128, becomes U @ column.
//
// Replaces the TPU kernel quest_tpu/ops/pallas_gates.py::window_dot
// (_window_dot and _make_window_dot_kernel), which applies
// W4 = [[Ur, -Ui], [Ui, Ur]] to a (2D, bc) panel per grid program as one
// MXU dot at Precision.HIGHEST. conj != 0 applies conj(U) (the density
// shadow).
//
// What bounds it on an H100: the pass moves 2 x state bytes (each
// amplitude read once and written once), 0.32 ms for a 26-qubit f32 state
// and 0.64 ms for f64 at 3.35 TB/s, and does 8 D flops per amplitude. At
// D = 64 that is 0.51 ms on the 67 TFLOP/s FP64 tensor cores (twice the
// 34 TFLOP/s of FP64 FMA outside them) and 0.21 ms as 3xTF32 (three
// passes at 494.7 TFLOP/s): below the bytes in both, so a window is bound
// by bytes once its products run on the tensor cores.
//
// Spans 3-6 (D = 8 ... 64): the tensor cores, mma.sync m16n8k8 (mma.cuh),
// FP64 operands and accumulator for double, 3xTF32 for float (the
// reference dot is full precision, and one TF32 pass keeps only 10
// mantissa bits). The complex product is four real ones:
// out_re = Ur x_re - Ui x_im and out_im = Ur x_im + Ui x_re, run
// transposed as out^T = x^T U^T so that U is the B operand:
//   - blocks are persistent, one or two per SM, each walking work items
//     (an `a` and BC consecutive `b` columns, D x BC = 4096 f32 or 2048
//     f64 amplitudes a plane) with a grid stride;
//   - U is staged into shared memory once per block (conj applied, and in
//     f32 split into TF32 hi and lo there), and each warp then holds the
//     B fragments of its 8 rows of U in registers for the whole kernel:
//     warp w takes rows 8 (w mod D/8) and a 1/(64/D) share of the columns;
//   - a ring of panels: each item's (D x BC) panel, both planes, is copied
//     into shared memory by 16-byte cp.async copies coalesced over b,
//     kStages - 1 items ahead of the one computed;
//   - a warp reads its A fragments (16 columns x 8 rows of the panel) from
//     the panel in mma.cuh's pair layout, splits them once in f32, and
//     accumulates Ur x_re, Ui x_im, Ui x_re and Ur x_im in four fragment
//     sets; the results go to a staging buffer in shared memory, and the
//     block then writes the item back with 16-byte stores coalesced over b;
//   - a panel is read whole into shared memory before any output of it is
//     written, and a block writes only its own columns, so the kernel runs
//     in place.
// Spans 1 and 2 (D = 2, 4) are below an MMA tile; they do 8 D <= 32 flops
// per amplitude, are bound by bytes, and keep the FMA kernel below (R
// rows x 4 columns per thread, U^T in shared memory).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc (quest_tpu_torch/_build.py does this at
//        first use)

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;  // consecutive output columns per thread (FMA path)
constexpr int kLaneBits = 7;
constexpr int kMaxSpan = 6;

// ---------------------------------------------------------------------------
// shared pieces
// ---------------------------------------------------------------------------

using quest_mma::async_commit;
using quest_mma::async_wait;
using quest_mma::copy16_async;

// the grid of a persistent kernel with `smem` bytes of dynamic shared
// memory: every block that fits on the SMs at once, at most one per item
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, size_t smem, uint64_t num_work, int sms,
                            unsigned* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const uint64_t slots = static_cast<uint64_t>(sms) * per_sm;
  *grid = static_cast<unsigned>(num_work < slots ? num_work : slots);
  return cudaSuccess;
}

// flat index of (a, 0, b0) of work item w (chunk_bits = lo - bc_bits)
__device__ __forceinline__ uint64_t item_base(uint64_t w, int lo, int span,
                                              int bc_bits) {
  const int chunk_bits = lo - bc_bits;
  return ((w >> chunk_bits) << (lo + span)) +
         ((w & ((1ull << chunk_bits) - 1)) << bc_bits);
}

// ---------------------------------------------------------------------------
// spans 3-6: tensor cores
// ---------------------------------------------------------------------------

// per precision: panel ring depth, blocks per SM, the row paddings of the
// panel (A operand) and the output staging (C) that keep mma.cuh's loads
// and stores free of bank conflicts, and log2 of the amplitudes of a
// panel plane (both kernels')
template <typename T> struct MmaCfg;
template <> struct MmaCfg<double> {
  static constexpr int kStages = 4, kBlocks = 1, kPanelPad = 4, kOutPad = 2,
                       kPanelBits = 11;
};
template <> struct MmaCfg<float> {
  static constexpr int kStages = 2, kBlocks = 2, kPanelPad = 8, kOutPad = 4,
                       kPanelBits = 12;
};

// a warp's 8 rows of U as B fragments for one k step (8 columns of U)
template <typename T> struct UFrag;
template <> struct UFrag<double> {
  double r[2], i[2];
};
template <> struct UFrag<float> {
  quest_mma::SplitB r, i;
};

// the four accumulators of one 16-column tile: Ur x_re, Ui x_im, Ui x_re
// and Ur x_im (summed as the plain version sums them)
template <typename T>
struct Acc {
  T rr[4], ii[4], ir[4], ri[4];
};

__device__ __forceinline__ void product(Acc<double>& c, const double xr[4],
                                        const double xi[4], const UFrag<double>& u) {
  quest_mma::mma_f64(c.rr, xr, u.r);
  quest_mma::mma_f64(c.ii, xi, u.i);
  quest_mma::mma_f64(c.ir, xr, u.i);
  quest_mma::mma_f64(c.ri, xi, u.r);
}

__device__ __forceinline__ void product(Acc<float>& c, const float xr[4],
                                        const float xi[4], const UFrag<float>& u) {
  const quest_mma::SplitA sr = quest_mma::split_a(xr);
  const quest_mma::SplitA si = quest_mma::split_a(xi);
  quest_mma::mma_3xtf32(c.rr, sr, u.r);
  quest_mma::mma_3xtf32(c.ii, si, u.i);
  quest_mma::mma_3xtf32(c.ir, sr, u.i);
  quest_mma::mma_3xtf32(c.ri, si, u.r);
}

// stage U (conj applied) into shared memory, then load this warp's B
// fragments: B[k][n] = U[r0 + n][8 s + k] for k step s
template <int D>
__device__ __forceinline__ void stage_u(const double* mat, int conj, void* smem,
                                        int r0, quest_mma::Lane l,
                                        UFrag<double> (&u)[D / 8]) {
  double* ur = static_cast<double*>(smem);
  double* ui = ur + D * D;
  for (int e = threadIdx.x; e < D * D; e += kThreads) {
    ur[e] = mat[e];
    ui[e] = conj ? -mat[D * D + e] : mat[D * D + e];
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < D / 8; ++s) {
    quest_mma::load_b_nmajor(ur + r0 * D + 8 * s, D, l, u[s].r);
    quest_mma::load_b_nmajor(ui + r0 * D + 8 * s, D, l, u[s].i);
  }
}

// f32: U split into TF32 hi and lo once, as it is staged
template <int D>
__device__ __forceinline__ void stage_u(const float* mat, int conj, void* smem,
                                        int r0, quest_mma::Lane l,
                                        UFrag<float> (&u)[D / 8]) {
  uint32_t* rh = static_cast<uint32_t*>(smem);
  uint32_t* rl = rh + D * D;
  uint32_t* ih = rl + D * D;
  uint32_t* il = ih + D * D;
  for (int e = threadIdx.x; e < D * D; e += kThreads) {
    quest_mma::split_tf32(mat[e], rh[e], rl[e]);
    quest_mma::split_tf32(conj ? -mat[D * D + e] : mat[D * D + e], ih[e], il[e]);
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < D / 8; ++s) {
    const int o = r0 * D + 8 * s;
    quest_mma::load_b_nmajor(rh + o, D, l, u[s].r.hi);
    quest_mma::load_b_nmajor(rl + o, D, l, u[s].r.lo);
    quest_mma::load_b_nmajor(ih + o, D, l, u[s].i.hi);
    quest_mma::load_b_nmajor(il + o, D, l, u[s].i.lo);
  }
}

template <typename T, int SPAN>
__global__ void __launch_bounds__(kThreads, MmaCfg<T>::kBlocks)
window_mma_kernel(T* __restrict__ amps, const T* __restrict__ mat, uint64_t num,
                  int lo, int bc_bits, int conj, uint64_t num_work) {
  using Cfg = MmaCfg<T>;
  constexpr int D = 1 << SPAN;
  constexpr int kSteps = D / 8;          // k steps of 8 rows of the panel
  constexpr int kRowGroups = D / 8;      // warps across U's rows
  constexpr int kColSplit = kWarps / kRowGroups;  // warps across the columns
  constexpr int kPer16 = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int BC = 1 << bc_bits;
  const int ld = BC + Cfg::kPanelPad;    // panel row stride
  const int ldo = BC + Cfg::kOutPad;     // staging row stride
  const int panel = 2 * D * ld;          // both planes of one panel
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* out = ring + Cfg::kStages * panel;  // 2 x D x ldo

  const int warp = threadIdx.x >> 5;
  const quest_mma::Lane l = quest_mma::lane_coords();
  const int r0 = 8 * (warp % kRowGroups);
  const int cols = BC / kColSplit;
  const int c_begin = (warp / kRowGroups) * cols;

  UFrag<T> u[kSteps];
  stage_u<D>(mat, conj, smem_raw, r0, l, u);
  __syncthreads();  // every warp has its fragments: the ring may be filled

  const int nvec = (D * BC) / kPer16;  // 16-byte pieces of a plane
  const uint64_t B = 1ull << lo;
  // start copying work item w's panel into ring stage `stage`
  auto fetch = [&](uint64_t w, int stage) {
    const uint64_t base = item_base(w, lo, SPAN, bc_bits);
    T* dst = ring + stage * panel;
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
      const int e = v * kPer16;
      const int row = e >> bc_bits, col = e & (BC - 1);
      const uint64_t g = base + row * B + col;
      copy16_async(dst + row * ld + col, amps + g);
      copy16_async(dst + (D + row) * ld + col, amps + num + g);
    }
  };

  const uint64_t stride = gridDim.x;
#pragma unroll
  for (int j = 0; j < Cfg::kStages - 1; ++j) {
    const uint64_t w = blockIdx.x + j * stride;
    if (w < num_work) fetch(w, j);
    async_commit();
  }
  int stage = 0;
  for (uint64_t w = blockIdx.x; w < num_work; w += stride) {
    async_wait<Cfg::kStages - 2>();  // this item's panel, this thread's part
    __syncthreads();  // every thread's part; the stage refilled next is free
    {
      const uint64_t wn = w + (Cfg::kStages - 1) * stride;
      const int sn = stage == 0 ? Cfg::kStages - 1 : stage - 1;
      if (wn < num_work) fetch(wn, sn);
      async_commit();
    }
    const T* xr = ring + stage * panel;
    const T* xi = xr + D * ld;
    for (int c0 = c_begin; c0 < c_begin + cols; c0 += 16) {
      Acc<T> acc = {};
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        T ar[4], ai[4];
        quest_mma::load_a_pairs(xr + 8 * s * ld + c0, ld, l, ar);
        quest_mma::load_a_pairs(xi + 8 * s * ld + c0, ld, l, ai);
        product(acc, ar, ai, u[s]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc.rr[i] -= acc.ii[i];
        acc.ri[i] += acc.ir[i];
      }
      quest_mma::store_c_pairs(out + r0 * ldo + c0, ldo, l, acc.rr);
      quest_mma::store_c_pairs(out + (D + r0) * ldo + c0, ldo, l, acc.ri);
    }
    __syncthreads();  // the item's outputs staged
    const uint64_t base = item_base(w, lo, SPAN, bc_bits);
    for (int v = threadIdx.x; v < 2 * nvec; v += kThreads) {
      const int plane = v >= nvec;
      const int e = (v - plane * nvec) * kPer16;
      const int row = e >> bc_bits, col = e & (BC - 1);
      *reinterpret_cast<uint4*>(amps + plane * num + base + row * B + col) =
          *reinterpret_cast<const uint4*>(out + (plane * D + row) * ldo + col);
    }
    stage = stage + 1 == Cfg::kStages ? 0 : stage + 1;
  }
  async_wait<0>();
}

// shared memory of window_mma_kernel: the panel ring and the staging
// buffer, and at least U's staging (f64: Ur, Ui; f32: their hi and lo)
template <typename T>
size_t mma_smem(int span, int bc_bits) {
  using Cfg = MmaCfg<T>;
  const size_t D = size_t(1) << span, BC = size_t(1) << bc_bits;
  const size_t ring =
      Cfg::kStages * 2 * D * (BC + Cfg::kPanelPad) + 2 * D * (BC + Cfg::kOutPad);
  const size_t u = (sizeof(T) == 4 ? 4 : 2) * D * D;
  return sizeof(T) * (ring > u ? ring : u);
}

template <typename T, int SPAN>
int launch_mma(T* amps, const T* mat, int n, int lo, int conj, int sms,
               void* stream) {
  const int cap = MmaCfg<T>::kPanelBits - SPAN;
  const int bc_bits = lo < cap ? lo : cap;
  auto kernel = window_mma_kernel<T, SPAN>;
  const size_t smem = mma_smem<T>(SPAN, bc_bits);
  const uint64_t num_work = 1ull << (n - SPAN - bc_bits);
  unsigned grid = 0;
  const cudaError_t err = persistent_grid(kernel, smem, num_work, sms, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      amps, mat, 1ull << n, lo, bc_bits, conj, num_work);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// spans 1-2: FMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ float fmadd(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return fma(a, b, c); }

// four consecutive values, 16-byte aligned: one float4 or two double2
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void load4(const double* p, double v[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(double* p, const double v[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}
__device__ __forceinline__ void load2(const float* p, float v[2]) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  v[0] = q.x; v[1] = q.y;
}
__device__ __forceinline__ void load2(const double* p, double v[2]) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x; v[1] = q.y;
}

// four consecutive values (16 bytes of float, 32 of double), asynchronously
template <typename T>
__device__ __forceinline__ void copy4_async(T* smem, const T* gmem) {
  constexpr int kPer16 = 16 / sizeof(T);
#pragma unroll
  for (int h = 0; h < kCols; h += kPer16) copy16_async(smem + h, gmem + h);
}

// R consecutive values (R = 2 or 4), aligned to R
template <int R, typename T>
__device__ __forceinline__ void load_rows(const T* p, T v[R]) {
  if constexpr (R == 4) {
    load4(p, v);
  } else {
    load2(p, v);
  }
}

// D = 2^span <= 4 rows: U transposed in shared memory (urt[k * D + d] =
// Ur[d][k]), each work item's (D x BC) panel, both planes, copied in by
// cp.async into one of two buffers (the next item's streams in while this
// one computes), each thread an R x 4 tile of outputs (R = 2 when D = 2)
// written straight back with 16-byte stores
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
window_fma_kernel(T* __restrict__ amps, const T* __restrict__ mat,
                  uint64_t num, int lo, int span, int bc_bits, int conj,
                  uint64_t num_work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = 1 << span;
  const int BC = 1 << bc_bits;
  T* urt = reinterpret_cast<T*>(smem_raw);
  T* uit = urt + D * D;
  T* panels = uit + D * D;  // 2 D^2 values in: 16-byte aligned
  const int panel = 2 * D * BC;  // both planes of one work item's panel

  for (int i = threadIdx.x; i < D * D; i += kThreads) {
    const int r = i >> span, c = i & (D - 1);
    const T v = mat[D * D + i];
    urt[c * D + r] = mat[i];
    uit[c * D + r] = conj ? -v : v;
  }

  const int cgroups = BC / kCols;
  const int ntiles = (D / R) * cgroups;
  const int nvec = (D * BC) / kCols;
  // start copying work item w's panel into buffer dst (16 bytes a copy)
  auto fetch = [&](uint64_t w, T* dst) {
    const uint64_t base = item_base(w, lo, span, bc_bits);
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
      const int e = v * kCols;
      const uint64_t g = base + (static_cast<uint64_t>(e >> bc_bits) << lo) +
                         (e & (BC - 1));
      copy4_async(dst + e, amps + g);
      copy4_async(dst + D * BC + e, amps + num + g);
    }
  };

  int cur = 0;
  if (blockIdx.x < num_work) fetch(blockIdx.x, panels);
  async_commit();
  for (uint64_t w = blockIdx.x; w < num_work; w += gridDim.x) {
    if (w + gridDim.x < num_work) fetch(w + gridDim.x, panels + (cur ^ 1) * panel);
    async_commit();
    async_wait<1>();
    __syncthreads();  // U staged and this item's panel landed, every thread's part
    const T* xr = panels + cur * panel;
    const T* xi = xr + D * BC;
    const uint64_t base = item_base(w, lo, span, bc_bits);
    for (int t = threadIdx.x; t < ntiles; t += kThreads) {
      const int c0 = (t % cgroups) * kCols;
      const int d0 = (t / cgroups) * R;
      T ar[R][kCols] = {}, ai[R][kCols] = {};
      for (int k = 0; k < D; ++k) {
        T pr[kCols], pi[kCols];
        T mr[R], mi[R];
        load4(xr + k * BC + c0, pr);
        load4(xi + k * BC + c0, pi);
        load_rows<R>(urt + k * D + d0, mr);
        load_rows<R>(uit + k * D + d0, mi);
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            ar[r][j] = fmadd(mr[r], pr[j], ar[r][j]);
            ar[r][j] = fmadd(-mi[r], pi[j], ar[r][j]);
            ai[r][j] = fmadd(mr[r], pi[j], ai[r][j]);
            ai[r][j] = fmadd(mi[r], pr[j], ai[r][j]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint64_t g = base + (static_cast<uint64_t>(d0 + r) << lo) + c0;
        store4(amps + g, ar[r]);
        store4(amps + num + g, ai[r]);
      }
    }
    __syncthreads();  // every thread done reading this panel: it is refilled next
    cur ^= 1;
  }
}

template <typename T, int R>
int launch_fma(T* amps, const T* mat, int n, int lo, int span, int conj, int sms,
               void* stream) {
  const int cap = MmaCfg<T>::kPanelBits - span;
  const int bc_bits = lo < cap ? lo : cap;
  const size_t D = size_t(1) << span;
  auto kernel = window_fma_kernel<T, R>;
  const size_t smem = sizeof(T) * (2 * D * D + ((4 * D) << bc_bits));
  const uint64_t num_work = 1ull << (n - span - bc_bits);
  unsigned grid = 0;
  const cudaError_t err = persistent_grid(kernel, smem, num_work, sms, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      amps, mat, 1ull << n, lo, span, bc_bits, conj, num_work);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(T* amps, const T* mat, int n, int lo, int span, int conj,
           void* stream) {
  if (lo < kLaneBits || span < 1 || span > kMaxSpan || lo + span > n ||
      n > 40) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (span) {
    case 1: return launch_fma<T, 2>(amps, mat, n, lo, span, conj, sms, stream);
    case 2: return launch_fma<T, 4>(amps, mat, n, lo, span, conj, sms, stream);
    case 3: return launch_mma<T, 3>(amps, mat, n, lo, conj, sms, stream);
    case 4: return launch_mma<T, 4>(amps, mat, n, lo, conj, sms, stream);
    case 5: return launch_mma<T, 5>(amps, mat, n, lo, conj, sms, stream);
    default: return launch_mma<T, 6>(amps, mat, n, lo, conj, sms, stream);
  }
}

}  // namespace

extern "C" {

// Both apply the planar (2, 2^span, 2^span) matrix `mat` (real plane then
// imaginary plane, row-major; conj != 0: its conjugate) to the qubits
// [lo, lo + span) of the planar (2, 2^n) state `amps`, in place, on
// `stream`, and return the cudaError_t of the launch (0 = launched).
int quest_window_dot_f32(float* amps, const float* mat, int n, int lo,
                         int span, int conj, void* stream) {
  return launch<float>(amps, mat, n, lo, span, conj, stream);
}

int quest_window_dot_f64(double* amps, const double* mat, int n, int lo,
                         int span, int conj, void* stream) {
  return launch<double>(amps, mat, n, lo, span, conj, stream);
}

const char* quest_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
