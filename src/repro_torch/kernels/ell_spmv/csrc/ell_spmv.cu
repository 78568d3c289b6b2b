// Block-ELL semiring SpMV / SpMM for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/ell_spmv/kernel.py::ell_spmv
// (its pl.pallas_call, bodies _minplus_body and _plustimes_body). It
// computes exactly what that kernel computes:
//
//   minplus_i32   : y[r, b] = min_k ( x[cols[r, k], b] + vals[r, k] )   int32, SSSP relax
//   plustimes_f32 : y[r, b] = sum_k ( x[cols[r, k], b] * vals[r, k] )   f32,   PageRank gather
//
// cols and vals are [R, D] row-major, x is [M, B] row-major and y is
// [R, B] (B = 1 is the SpMV form, x [M] -> y [R]). Padding protocol of
// the callers: pad columns point at the sentinel slot of x (the last one,
// holding 0), pad weights are INF = 2^30 for min-plus and 0 or 1 for
// plus-times. Every cols entry must lie in [0, M): the kernel checks each
// one, never reads past x, and stops with a device-side assert (as
// PyTorch's own index kernels do) when one lies outside.
//
// The TPU kernel keeps all of x resident in VMEM and walks row blocks in
// order. Here x stays in HBM / L2 and every thread gathers from it; blocks
// run in any order and each y element is written by exactly one thread, so
// there are no atomics and no cross-block state.
//
// Bound: memory. The function must read cols and vals once, read x at
// least once and write y once: (2*R*D + M*B + R*B) * 4 bytes, over
// 3.35 TB/s on an H100 SXM. Its R*D*B adds and mins (or multiply-adds) are
// far below the card's peak rate for either type. What this simple design
// does about that bound: nothing yet. For B = 1 the x gathers are random
// and uncoalesced, and the thread-per-row form reads cols and vals with a
// stride of D elements between neighbouring threads.
//
// Launch shapes (fixed, 256 threads per block):
//   * B > 1, or D <= 32: one thread per (row, lane). B consecutive threads
//     share a row, so for the SpMM form their x loads x[c * B + b] are
//     contiguous across the lanes.
//   * B == 1 and D > 32 (the 128 and 512 buckets, wide dense views): one
//     warp per row, a strided loop over k, then a __shfl_xor_sync
//     reduction; lane 0 writes y.
// Rows are bounds-checked here, so R need not be a multiple of any block
// (the TPU kernel's R % block_rows == 0 does not carry over). The
// Schedule.block_rows knob reaches the Python wrapper and is ignored there:
// it never changes the launch shape or a result.
//
// Each exported function returns cudaGetLastError() after its launch (0 on
// success); a launch that CUDA refuses never runs and is reported only
// there.

#include <cuda_runtime.h>

#include <cassert>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;

struct MinPlus {
  using T = int;
  __device__ static T identity() { return INT_MAX; }
  // the sum wraps modulo 2^32 exactly like torch's int32 add
  __device__ static T combine(T acc, T x, T v) {
    T s = static_cast<T>(static_cast<unsigned>(x) + static_cast<unsigned>(v));
    return s < acc ? s : acc;
  }
  __device__ static T reduce(T a, T b) { return a < b ? a : b; }
};

struct PlusTimes {
  using T = float;
  __device__ static T identity() { return 0.0f; }
  __device__ static T combine(T acc, T x, T v) { return acc + x * v; }
  __device__ static T reduce(T a, T b) { return a + b; }
};

// 0 <= col < M. A column outside reads slot 0 instead and the thread
// asserts once after its loop: an assert inside the loop, a branch to a
// call on every element, made the thread-per-row kernels up to 2.9x slower
// on the H100 (PERF.md).
__device__ __forceinline__ bool in_range(int col, int M) {
  return static_cast<unsigned>(col) < static_cast<unsigned>(M);
}

template <class S>
__global__ void __launch_bounds__(kThreads)
ell_row_lane(const int* __restrict__ cols, const typename S::T* __restrict__ vals,
             const typename S::T* __restrict__ x, typename S::T* __restrict__ y,
             int R, int D, int M, int B) {
  using T = typename S::T;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(R) * B) return;
  const long long r = t / B;
  const long long b = t - r * B;
  const int* c = cols + r * D;
  const T* v = vals + r * D;
  T acc = S::identity();
  bool bad = false;
  for (int k = 0; k < D; ++k) {
    const int col = c[k];
    const bool ok = in_range(col, M);
    bad |= !ok;
    acc = S::combine(acc, x[static_cast<long long>(ok ? col : 0) * B + b], v[k]);
  }
  assert(!bad);
  y[t] = acc;  // y is [R, B] row-major: element (r, b) sits at r * B + b == t
}

template <class S>
__global__ void __launch_bounds__(kThreads)
ell_warp_row(const int* __restrict__ cols, const typename S::T* __restrict__ vals,
             const typename S::T* __restrict__ x, typename S::T* __restrict__ y,
             int R, int D, int M) {
  using T = typename S::T;
  // blockDim is a multiple of 32, so the row index is uniform in a warp and
  // the early return keeps whole warps together for the shuffles below
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= R) return;
  const int* c = cols + row * D;
  const T* v = vals + row * D;
  T acc = S::identity();
  bool bad = false;
  for (int k = lane; k < D; k += kWarp) {
    const int col = c[k];
    const bool ok = in_range(col, M);
    bad |= !ok;
    acc = S::combine(acc, x[ok ? col : 0], v[k]);
  }
  assert(!bad);
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    acc = S::reduce(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  if (lane == 0) y[row] = acc;
}

template <class S>
cudaError_t launch(const void* cols, const void* vals, const void* x, void* y,
                   int R, int D, int M, int B, void* stream) {
  using T = typename S::T;
  if (R <= 0 || D <= 0 || M <= 0 || B <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(cols);
  const T* v = static_cast<const T*>(vals);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  if (B == 1 && D > kWarp) {
    const long long threads = static_cast<long long>(R) * kWarp;
    const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    ell_warp_row<S><<<blocks, kThreads, 0, s>>>(c, v, xx, yy, R, D, M);
  } else {
    const long long threads = static_cast<long long>(R) * B;
    const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    ell_row_lane<S><<<blocks, kThreads, 0, s>>>(c, v, xx, yy, R, D, M, B);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int ell_minplus_i32(const void* cols, const void* vals, const void* x,
                               void* y, int R, int D, int M, int B, void* stream) {
  return static_cast<int>(launch<MinPlus>(cols, vals, x, y, R, D, M, B, stream));
}

extern "C" int ell_plustimes_f32(const void* cols, const void* vals, const void* x,
                                 void* y, int R, int D, int M, int B, void* stream) {
  return static_cast<int>(launch<PlusTimes>(cols, vals, x, y, R, D, M, B, stream));
}

extern "C" const char* ell_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
