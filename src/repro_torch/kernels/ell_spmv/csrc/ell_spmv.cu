// Block-ELL semiring SpMV / SpMM and the sliced-ELL pull sweep for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/ell_spmv/kernel.py:76 (its
// pl.pallas_call, bodies _minplus_body and _plustimes_body), and in the
// sweep also the XLA scatters of the reference's hub tail
// (repro/kernels/ell_spmv/ops.py:167-169 and 272-273) and of its bucket
// outputs. Two entries:
//
// 1. The rectangular entry (ell_minplus_i32, ell_plustimes_f32) computes
//    exactly what the TPU kernel computes, pad cells included:
//
//      minplus_i32   : y[r, b] = min_k ( x[cols[r, k], b] + vals[r, k] )   int32
//      plustimes_f32 : y[r, b] = sum_k ( x[cols[r, k], b] * vals[r, k] )   f32
//
//    cols and vals are [R, D] row-major, x is [M, B] row-major and y is
//    [R, B] (B = 1 is the SpMV form). Pad columns point at the sentinel
//    slot of x (the last one, holding 0). Every cols entry must lie in
//    [0, M); a column outside stops the kernel with a device-side assert.
//    Launch: B > 1 or D <= 32, one thread per (row, lane); B == 1 and
//    D > 32, one warp per row, a strided loop over k and a
//    __shfl_xor_sync reduction. The dense ops and the batched [B, N]
//    sliced ops use it.
//
// 2. The sweep (ell_sweep_minplus_i32, ell_sweep_plustimes_f32) runs the
//    single-vector pull sweep of a reverse sliced-ELL view in one launch
//    plus one small combine launch: every degree bucket, the COO hub tail
//    and the rows of in-degree 0, each output row written exactly once,
//    no atomics:
//
//      minplus_i32   : y[v] = min(dist[v], INF, min over in-edges (x[u] + w))
//      plustimes_f32 : y[v] = sum over in-edges x[u]     (unit weights: no
//                                                         weights are read)
//
//    x, dist and y are [N]; there is no sentinel slot, because pads are
//    never gathered. The plan (kernels/ell_spmv/plan.py) lays the grid
//    out: hub chunks first, then the buckets widest first, then the zero
//    rows.
//    * Bucket rows: a team of min(32, D/4) lanes (a power of two) per
//      row, each lane loading 4 columns as one 16-byte int4, neighbouring
//      lanes on neighbouring 16 bytes; the team reduces with
//      __shfl_xor_sync and one lane writes y[row id]. Pads trail the real
//      columns, so a row stops at its first sentinel column (col == N):
//      neither its weights nor x are read past it (a 32-lane team stops
//      after the pass in which any lane met it). Row padding (row id N)
//      is skipped.
//    * Hub tail: sorted by row, walked as row segments. One block per
//      chunk of `chunk` entries reduces its chunk segment by segment
//      (lane-contiguous loads, so one gather instruction covers 32
//      consecutive columns of a sorted row; a fixed-order block
//      reduction): a segment inside the chunk is written directly, the
//      piece of a segment that crosses the chunk's edge goes to a partial
//      slot, and the combine launch folds each spanning segment's
//      partials in chunk order. f32 sums are therefore deterministic.
//    * Column check: one per vector of columns, against [0, N] in the
//      buckets (N is the sentinel and ends the row) and [0, N) in the hub
//      tail, asserted once after the loop.
//
// Int32 sums wrap modulo 2^32 exactly like torch's int32 add; the
// reference keeps candidates below 2^31 (INF = 2^30 plus a weight).
//
// Bound (sweep): memory. It must read each real edge's column (and
// weight, for min-plus) once, the bucket row ids once, x and dist once and
// write y once: on RMAT 22 (65,243,754 edges, 1,993,536 bucket rows, N =
// 4,194,304) 580 MB for min-plus, 0.173 ms at 3.35 TB/s, and 303 MB for
// plus-times, 0.090 ms. Each random 4-byte gather of x also pulls a
// 32-byte sector from L2 (x, 16.8 MB, stays in the 50 MB L2): 2.09 GB per
// sweep, which at the L2 rate is the larger figure (chip_smoke.py measures
// a floor on that rate and prints both): the sweep is bound by its random
// gathers. What the design does about it: only real cells are read (pads
// cost at most the rest of the last pass of a row), cols and weights
// stream through with evict-first loads (__ldcs) so they do not push x out
// of L2, x is read through the read-only path (__ldg) with all but 32
// bytes of the SM's shared memory given to L1, which keeps the most
// gathered x entries, hub rows are gathered in column order so that
// neighbouring lanes share sectors, and each output is one plain store.
//
// Each exported function returns cudaGetLastError() after its launches (0
// on success); a launch that CUDA refuses never runs and is reported only
// there.

#include <cuda_runtime.h>

#include <cassert>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kInf = 1 << 30;   // INF_I32 of the graph layer

struct MinPlus {
  using T = int;
  __device__ static T identity() { return INT_MAX; }
  // the sum wraps modulo 2^32 exactly like torch's int32 add
  __device__ static T combine(T acc, T x, T v) {
    T s = static_cast<T>(static_cast<unsigned>(x) + static_cast<unsigned>(v));
    return s < acc ? s : acc;
  }
  __device__ static T reduce(T a, T b) { return a < b ? a : b; }
  // the sweep: one edge's candidate, and a row's output
  static constexpr bool kWeighted = true;
  __device__ static T take(T acc, T x, int w) { return combine(acc, x, w); }
  __device__ static T finish(T acc, const T* dist, int row) {
    T d = dist[row];
    d = d < kInf ? d : kInf;
    return acc < d ? acc : d;
  }
};

struct PlusTimes {
  using T = float;
  __device__ static T identity() { return 0.0f; }
  __device__ static T combine(T acc, T x, T v) { return acc + x * v; }
  __device__ static T reduce(T a, T b) { return a + b; }
  static constexpr bool kWeighted = false;   // PageRank's unit weights
  __device__ static T take(T acc, T x, int) { return acc + x; }
  __device__ static T finish(T acc, const T*, int) { return acc; }
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


// ---------------------------------------------------------------------------
// The sliced-ELL pull sweep
// ---------------------------------------------------------------------------

constexpr int kMaxBuckets = 16;   // MAX_BUCKETS in plan.py
constexpr int kWarps = kThreads / kWarp;
constexpr int kHubUnroll = 4;   // hub loads in flight per thread

// One bucket of the view; the plan gives lanes and the block range. The
// ctypes mirror is kernel.py's _Bucket, checked by ell_sweep_args_bytes().
struct SweepBucket {
  const int* cols;   // [R, D]
  const int* wts;    // [R, D]; not read by plus-times
  const int* rows;   // [R]
  int R;
  int D;             // a multiple of 4
  int lanes_log2;
  int first_block;
  int num_blocks;
};

struct SweepArgs {
  SweepBucket bucket[kMaxBuckets];
  const int* hub_cols;         // [num_hub]
  const int* hub_wts;          // [num_hub]; not read by plus-times
  const int* seg_rows;         // [S]
  const int* seg_ptr;          // [S + 1]
  const int* chunk_seg;        // [num_chunks]
  const int* span_rows;        // [num_span]
  const int* span_first_slot;  // [num_span]
  const int* span_last_chunk;  // [num_span]
  const int* zero_rows;        // [num_zero]
  const void* x;               // [N]
  const void* dist;            // [N]; min-plus only
  void* y;                     // [N]
  void* partial;               // [2 * num_chunks]
  int num_buckets;
  int num_hub;
  int chunk;
  int num_chunks;
  int num_span;
  int num_zero;
  int zero_first_block;
  int num_blocks;
  int N;
};

// The candidates of 4 columns with their weights: real columns lie in
// [0, N); a column outside is skipped here and flagged by the caller.
template <class S>
__device__ __forceinline__ typename S::T take4(typename S::T acc, const int4& c, const int4& w,
                                               const typename S::T* __restrict__ x, int N) {
  if (static_cast<unsigned>(c.x) < static_cast<unsigned>(N)) acc = S::take(acc, __ldg(x + c.x), w.x);
  if (static_cast<unsigned>(c.y) < static_cast<unsigned>(N)) acc = S::take(acc, __ldg(x + c.y), w.y);
  if (static_cast<unsigned>(c.z) < static_cast<unsigned>(N)) acc = S::take(acc, __ldg(x + c.z), w.z);
  if (static_cast<unsigned>(c.w) < static_cast<unsigned>(N)) acc = S::take(acc, __ldg(x + c.w), w.w);
  return acc;
}

// true when some column of the vector lies outside [0, limit]
__device__ __forceinline__ bool vec_out_of(const int4& c, int limit) {
  const unsigned l = static_cast<unsigned>(limit);
  return (static_cast<unsigned>(c.x) > l) | (static_cast<unsigned>(c.y) > l) |
         (static_cast<unsigned>(c.z) > l) | (static_cast<unsigned>(c.w) > l);
}

template <class S>
__device__ __forceinline__ void sweep_bucket(const SweepArgs& a, const SweepBucket& bk,
                                             int local_block) {
  using T = typename S::T;
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const int N = a.N;
  const int lanes = 1 << bk.lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const long long row =
      (static_cast<long long>(local_block) * kThreads + threadIdx.x) >> bk.lanes_log2;
  const int rid = row < bk.R ? __ldcs(bk.rows + row) : N;
  // lanes of row padding (id N) or past R only take part in the shuffles;
  // with 32 lanes a row owns its warp, so `live` is uniform there
  const bool live = static_cast<unsigned>(rid) < static_cast<unsigned>(N);
  bool bad = static_cast<unsigned>(rid) > static_cast<unsigned>(N);
  T acc = S::identity();
  if (live) {
    const int vecs = bk.D >> 2;
    const int4* c4 = reinterpret_cast<const int4*>(bk.cols + row * bk.D);
    const int4* w4 = reinterpret_cast<const int4*>(bk.wts + row * bk.D);
    for (int base = 0; base < vecs; base += lanes) {
      const int v = base + lane;
      bool end = false;
      if (v < vecs) {
        const int4 c = __ldcs(c4 + v);
        bad |= vec_out_of(c, N);
        end = static_cast<unsigned>(c.w) >= static_cast<unsigned>(N);
        if (static_cast<unsigned>(c.x) < static_cast<unsigned>(N)) {
          const int4 w = S::kWeighted ? __ldcs(w4 + v) : make_int4(1, 1, 1, 1);
          acc = take4<S>(acc, c, w, x, N);
        }
      }
      // fewer than 32 lanes: the row fits in one pass (lanes >= D / 4)
      if (lanes == kWarp && __any_sync(0xffffffffu, end)) break;
    }
  }
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    acc = S::reduce(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  assert(!bad);
  if (live && lane == 0) {
    static_cast<T*>(a.y)[rid] = S::finish(acc, static_cast<const T*>(a.dist), rid);
  }
}

// Sum (or min) over the block in a fixed order; the result is in thread 0.
template <class S>
__device__ __forceinline__ typename S::T block_reduce(typename S::T v, typename S::T* smem) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v = S::reduce(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? smem[lane] : S::identity();
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      v = S::reduce(v, __shfl_xor_sync(0xffffffffu, v, off));
    }
  }
  __syncthreads();   // smem is reused by the next segment
  return v;
}

template <class S>
__device__ __forceinline__ void sweep_hub_chunk(const SweepArgs& a, int k) {
  using T = typename S::T;
  __shared__ T smem[kWarps];
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const int N = a.N;
  const int cb = k * a.chunk;   // plan.py keeps num_hub + chunk below 2^31
  const int ce = min(cb + a.chunk, a.num_hub);
  const int first_seg = a.chunk_seg[k];
  bool bad = false;
  for (int s = first_seg;; ++s) {
    const int s0 = a.seg_ptr[s];
    const int s1 = a.seg_ptr[s + 1];
    const int lo = max(s0, cb);
    const int hi = min(s1, ce);
    T acc = S::identity();
    // lane-contiguous entries, kHubUnroll loads in flight per thread: one
    // gather instruction covers 32 consecutive columns of the sorted row,
    // which share L2 sectors where the row is dense (measured faster on
    // RMAT 22's hub tail than 16-byte vectors per lane; PERF.md)
    for (int e = lo + threadIdx.x; e < hi; e += kHubUnroll * kThreads) {
      int c[kHubUnroll], w[kHubUnroll];
#pragma unroll
      for (int u = 0; u < kHubUnroll; ++u) {
        const int eu = e + u * kThreads;
        c[u] = eu < hi ? __ldcs(a.hub_cols + eu) : N;
        w[u] = S::kWeighted && eu < hi ? __ldcs(a.hub_wts + eu) : 1;
      }
#pragma unroll
      for (int u = 0; u < kHubUnroll; ++u) {
        const bool real = static_cast<unsigned>(c[u]) < static_cast<unsigned>(N);
        bad |= !real & (e + u * kThreads < hi);
        if (real) acc = S::take(acc, __ldg(x + c[u]), w[u]);
      }
    }
    acc = block_reduce<S>(acc, smem);
    if (threadIdx.x == 0) {
      if (lo == s0 && hi == s1) {
        const int row = a.seg_rows[s];
        static_cast<T*>(a.y)[row] = S::finish(acc, static_cast<const T*>(a.dist), row);
      } else {
        static_cast<T*>(a.partial)[2 * k + (s != first_seg)] = acc;
      }
    }
    if (s1 >= ce) break;
  }
  assert(!bad);
}

template <class S>
__global__ void __launch_bounds__(kThreads) ell_sweep(const SweepArgs a) {
  using T = typename S::T;
  const int blk = blockIdx.x;
  if (blk < a.num_chunks) {
    sweep_hub_chunk<S>(a, blk);
    return;
  }
  if (blk >= a.zero_first_block) {   // rows of in-degree 0
    const int i = (blk - a.zero_first_block) * kThreads + threadIdx.x;
    if (i < a.num_zero) {
      const int row = a.zero_rows[i];
      static_cast<T*>(a.y)[row] = S::finish(S::identity(), static_cast<const T*>(a.dist), row);
    }
    return;
  }
  // find this block's bucket; static indices keep the table in the
  // parameter space
  SweepBucket bk = a.bucket[0];
#pragma unroll
  for (int i = 1; i < kMaxBuckets; ++i) {
    if (i < a.num_buckets && blk >= a.bucket[i].first_block &&
        blk < a.bucket[i].first_block + a.bucket[i].num_blocks) {
      bk = a.bucket[i];
    }
  }
  sweep_bucket<S>(a, bk, blk - bk.first_block);
}

// Each spanning hub segment: its first chunk's partial slot, then slot 2k
// of every later chunk, folded in chunk order.
template <class S>
__global__ void __launch_bounds__(kThreads) ell_sweep_combine(const SweepArgs a) {
  using T = typename S::T;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= a.num_span) return;
  const T* partial = static_cast<const T*>(a.partial);
  const int first = a.span_first_slot[j];
  const int last = a.span_last_chunk[j];
  T acc = partial[first];
  for (int k = first / 2 + 1; k <= last; ++k) acc = S::reduce(acc, partial[2 * k]);
  const int row = a.span_rows[j];
  static_cast<T*>(a.y)[row] = S::finish(acc, static_cast<const T*>(a.dist), row);
}

template <class S>
cudaError_t launch_sweep(const SweepArgs* args, void* stream) {
  if (args == nullptr || args->num_buckets < 0 || args->num_buckets > kMaxBuckets ||
      args->N <= 0 || args->num_blocks < 0) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  // the sweep needs 32 bytes of shared memory: give the rest of the SM's
  // 256 KB to L1, which keeps the most-gathered x entries (measured faster
  // on RMAT 22 than the default split; PERF.md)
  const cudaError_t carve = cudaFuncSetAttribute(
      ell_sweep<S>, cudaFuncAttributePreferredSharedMemoryCarveout, 0);
  if (carve != cudaSuccess) return carve;
  if (args->num_blocks > 0) {
    ell_sweep<S><<<args->num_blocks, kThreads, 0, s>>>(*args);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (args->num_span > 0) {
    ell_sweep_combine<S><<<(args->num_span + kThreads - 1) / kThreads, kThreads, 0, s>>>(*args);
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

extern "C" int ell_sweep_minplus_i32(const void* args, void* stream) {
  return static_cast<int>(launch_sweep<MinPlus>(static_cast<const SweepArgs*>(args), stream));
}

extern "C" int ell_sweep_plustimes_f32(const void* args, void* stream) {
  return static_cast<int>(launch_sweep<PlusTimes>(static_cast<const SweepArgs*>(args), stream));
}

// the size the ctypes mirror of SweepArgs must have
extern "C" int ell_sweep_args_bytes() { return static_cast<int>(sizeof(SweepArgs)); }
