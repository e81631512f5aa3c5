// Dense unitary on a contiguous qubit window: every column of the planar
// (2, 2^n) state, viewed as (A, D, B) with D = 2^span (the window [lo, hi],
// span = hi - lo + 1 <= 6) and B = 2^lo >= 128, becomes U @ column.
//
// Replaces the TPU kernel quest_tpu/ops/pallas_gates.py::window_dot
// (_window_dot and _make_window_dot_kernel), which applies
// W4 = [[Ur, -Ui], [Ui, Ur]] to a (2D, bc) panel per grid program as one
// MXU dot at Precision.HIGHEST. Here the complex product is written out:
// out_re = Ur x_re - Ui x_im, out_im = Ur x_im + Ui x_re, in FP32 FMA for
// float (no TF32: the reference dot is full precision) and FP64 FMA for
// double. conj != 0 applies conj(U) (the density shadow).
//
// Design. Blocks are persistent: one per resident slot on each SM, each
// walking work items (an `a` and a chunk of BC consecutive `b` columns)
// with a grid stride, so U is staged into shared memory once per block:
// Ur and Ui transposed, so that a thread reads the R rows it needs of one
// column as one vector load (at most 2 x 64 x 64 values, 32 KiB f32 /
// 64 KiB f64). A work item's (D x BC) input panel, both planes, is copied
// into shared memory by asynchronous 16-byte copies (cp.async) coalesced
// over b, into one of two buffers: the next item's panel streams in while
// the block computes this one (one buffer where two would leave room for
// only one block per SM: f64 at D = 64). Each thread computes an R x 4
// tile of outputs (R = 4 rows, 2 when D = 2; 4 consecutive columns) from
// the panel and writes it straight back with 16-byte stores. A block reads and
// writes only its own columns, and a panel is read whole into shared
// memory before any output of it is written, so the kernel runs in place.
// D x BC is 4096 (f32) or 2048 (f64) amplitudes, BC = min(B, that / D).
//
// What bounds it on an H100: the pass moves 2 x state bytes (each
// amplitude read once and written once), 0.32 ms for a 26-qubit f32 state
// at 3.35 TB/s, and does 8 D flops per amplitude: at D = 64, 0.51 ms at
// the 67 TFLOP/s FP32 rate, so the widest f32 windows are bound by
// operations and the rest by bytes. Tensor-core MMA (3xTF32, FP64 MMA),
// TMA and wgmma are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (quest_tpu_torch/_build.py does this at first use)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;  // consecutive output columns per thread
constexpr int kLaneBits = 7;
constexpr int kMaxSpan = 6;

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

// cp.async: a 16-byte copy from global to shared memory that does not
// hold up the issuing thread; a commit closes a group of them, and the
// wait lets at most the newest group still be in flight
__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(gmem));
}
// four consecutive values (16 bytes of float, 32 of double), asynchronously
template <typename T>
__device__ __forceinline__ void copy4_async(T* smem, const T* gmem) {
  constexpr int kPer16 = 16 / sizeof(T);
#pragma unroll
  for (int h = 0; h < kCols; h += kPer16) copy16_async(smem + h, gmem + h);
}
__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
window_dot_kernel(T* __restrict__ amps, const T* __restrict__ mat,
                  uint64_t num, int lo, int span, int bc_bits, int conj,
                  uint64_t num_work, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = 1 << span;
  const int BC = 1 << bc_bits;
  // U transposed (urt[k * D + d] = Ur[d][k]): a thread reads its R rows of
  // column k as one vector load, the same address across a warp's lanes
  // of one row group (a broadcast)
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

  const int chunk_bits = lo - bc_bits;
  const uint64_t chunk_mask = (1ull << chunk_bits) - 1;
  const int cgroups = BC / kCols;
  const int ntiles = (D / R) * cgroups;
  const int nvec = (D * BC) / kCols;
  // flat index of (a, 0, b0) of work item w
  auto base_of = [&](uint64_t w) {
    return ((w >> chunk_bits) << (lo + span)) + ((w & chunk_mask) << bc_bits);
  };
  // start copying work item w's panel into buffer dst (16 bytes a copy)
  auto fetch = [&](uint64_t w, T* dst) {
    const uint64_t base = base_of(w);
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
      const int e = v * kCols;
      const uint64_t g = base + (static_cast<uint64_t>(e >> bc_bits) << lo) +
                         (e & (BC - 1));
      copy4_async(dst + e, amps + g);
      copy4_async(dst + D * BC + e, amps + num + g);
    }
  };

  int cur = 0;
  if (stages == 2 && blockIdx.x < num_work) fetch(blockIdx.x, panels);
  async_commit();
  for (uint64_t w = blockIdx.x; w < num_work; w += gridDim.x) {
    if (stages == 2) {
      // the next item's panel streams in while this one computes
      if (w + gridDim.x < num_work) fetch(w + gridDim.x, panels + (cur ^ 1) * panel);
      async_commit();
      async_wait_all_but_newest();
    } else {
      fetch(w, panels);
      async_commit();
      async_wait_all();
    }
    __syncthreads();  // U staged and this item's panel landed, every thread's part
    const T* xr = panels + cur * panel;
    const T* xi = xr + D * BC;
    const uint64_t base = base_of(w);
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
    cur ^= stages - 1;
  }
}

template <typename T, int R>
int launch_rows(T* amps, const T* mat, int n, int lo, int span, int conj,
                void* stream) {
  const int panel_bits = sizeof(T) == 4 ? 12 : 11;
  const int bc_bits = lo < panel_bits - span ? lo : panel_bits - span;
  const size_t D = size_t(1) << span;
  auto kernel = window_dot_kernel<T, R>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // two panel buffers where two blocks still fit an SM with them, else one
  // (f64 at D = 64, whose U alone is 64 KiB)
  int stages = 2, per_sm = 0;
  size_t smem = 0;
  for (; stages >= 1; --stages) {
    smem = sizeof(T) * (2 * D * D + ((2 * stages * D) << bc_bits));
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm >= 2 || stages == 1) break;
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const uint64_t num_work = 1ull << (n - span - bc_bits);
  const uint64_t slots = static_cast<uint64_t>(sms) * per_sm;
  const unsigned grid = static_cast<unsigned>(num_work < slots ? num_work : slots);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      amps, mat, 1ull << n, lo, span, bc_bits, conj, num_work, stages);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(T* amps, const T* mat, int n, int lo, int span, int conj,
           void* stream) {
  if (lo < kLaneBits || span < 1 || span > kMaxSpan || lo + span > n ||
      n > 40) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return span == 1 ? launch_rows<T, 2>(amps, mat, n, lo, span, conj, stream)
                   : launch_rows<T, 4>(amps, mat, n, lo, span, conj, stream);
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
