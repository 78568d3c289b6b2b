// Triangle count as a masked blocked matrix product for Hopper (sm_90a),
// plain C interface.
//
// Replaces the TPU kernel repro/kernels/tc_matmul/kernel.py::tc_matmul
// (its pl.pallas_call, body _tc_body). It computes what that kernel
// computes, for L the strict lower triangle of a 0/1 adjacency [N, N]
// (f32, row-major):
//
//   partial[I, J] = sum over the tile (I, J) of (L @ L) * L,   count = sum partial
//
// The TPU kernel walks the grid (I, J, K) in order and carries the C tile
// of (I, J) in VMEM scratch across its K axis. Blocks here run in parallel
// and in no order, so one block owns one 128 x 128 output tile (I, J) and
// loops over K itself; its C tile stays in registers (8 x 8 per thread) and
// only the masked, reduced partial leaves the block. The sum of the
// partials is a torch reduction outside, as it is a jnp.sum outside the
// Pallas call.
//
// The kernel reads only the strict lower triangle of its input: an entry
// (r, c) with r <= c counts as 0. On a strictly lower input, which is the
// contract, that is the same function; it lets the kernel skip the tiles
// the structure makes zero. L[i, k] needs tile I >= K, L[k, j] needs
// K >= J and the mask L[i, j] needs I >= J, so block (I, J) runs K = J .. I
// and a block with J > I writes 0: of the nb^3 tile products of the dense
// form, nb (nb + 1) (nb + 2) / 6 remain.
//
// Exactness: every product is 0 or 1 and every C entry is at most N, so C
// is exact in f32 below N = 2^24; each thread adds its masked C entries in
// f64 and the block reduces in f64, so a partial is exact where the TPU
// kernel's f32 partial rounds above 2^24. The partials are f64.
//
// Bound: operations. The dense form is 2 N^3 FLOPs (8.80e12 at N = 16,384,
// 8.9 ms at the H100 SXM's 989 TFLOP/s for bf16, exact for 0/1 operands and
// sums up to N), against N^2 * 4 bytes read once (1.07 GB, 0.32 ms at
// 3.35 TB/s); the tiles the strict lower structure leaves are a sixth of
// that. What this design does about it: little yet. The products run on
// plain f32 FMA (SIMT) at most at 67 TFLOP/s: per K step a block stages an
// A_ik column panel (transposed) and an A_kj row panel, 128 x 8 each, in
// shared memory, and each thread runs an 8 x 8 outer product per k.
// Not yet: tensor cores (tf32 or bf16 are exact on 0/1), double-buffered
// panels, cp.async or TMA.
//
// Ragged edges are masked (N need not be a multiple of 128). Each exported
// function returns cudaGetLastError() after its launch (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kT = 128;                      // output tile edge
constexpr int kTK = 8;                       // K depth of one staged panel
constexpr int kThreads = 256;                // 16 x 16 threads, 8 x 8 outputs each
constexpr int kMicro = 8;

// L[r, c] of the strict lower triangle, 0 outside [0, N)
__device__ __forceinline__ float lower_at(const float* A, int N, int r, int c) {
  return (r < N && c < N && r > c) ? A[static_cast<long long>(r) * N + c] : 0.f;
}

__global__ void __launch_bounds__(kThreads)
tc_tile(const float* __restrict__ A, double* __restrict__ partials, int N, int nb) {
  __shared__ float As[kTK][kT + 4];          // A_ik transposed: As[k][i]; +4 spreads the stores
  __shared__ float Bs[kTK][kT];              // A_kj: Bs[k][j]
  __shared__ double red[kThreads / 32];

  const int J = blockIdx.x, I = blockIdx.y;
  const int tid = threadIdx.x;
  if (J > I) {                               // the mask tile is zero
    if (tid == 0) partials[static_cast<long long>(I) * nb + J] = 0.0;
    return;
  }
  const int tx = tid % 16, ty = tid / 16;    // thread owns rows ty + 16 r, cols tx + 16 c
  const int i0 = I * kT, j0 = J * kT;

  float c[kMicro][kMicro];
#pragma unroll
  for (int r = 0; r < kMicro; ++r)
#pragma unroll
    for (int q = 0; q < kMicro; ++q) c[r][q] = 0.f;

  // K runs over columns J*128 .. (I+1)*128 - 1, one 8-deep panel at a time
  const int k_end = min((I + 1) * kT, N);
  for (int k0 = j0; k0 < k_end; k0 += kTK) {
#pragma unroll
    for (int m = 0; m < kT * kTK / kThreads; ++m) {
      const int e = tid + m * kThreads;
      const int ai = e / kTK, ak = e % kTK;  // A panel: 8 consecutive k per row
      As[ak][ai] = lower_at(A, N, i0 + ai, k0 + ak);
      const int bk = e / kT, bj = e % kT;    // B panel: 128 consecutive j per row
      Bs[bk][bj] = lower_at(A, N, k0 + bk, j0 + bj);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTK; ++k) {
      float a[kMicro], b[kMicro];
#pragma unroll
      for (int r = 0; r < kMicro; ++r) a[r] = As[k][ty + 16 * r];
#pragma unroll
      for (int q = 0; q < kMicro; ++q) b[q] = Bs[k][tx + 16 * q];
#pragma unroll
      for (int r = 0; r < kMicro; ++r)
#pragma unroll
        for (int q = 0; q < kMicro; ++q) c[r][q] = fmaf(a[r], b[q], c[r][q]);
    }
    __syncthreads();
  }

  // mask by L_ij and reduce: f64 per thread, per warp, per block
  double sum = 0.0;
#pragma unroll
  for (int r = 0; r < kMicro; ++r)
#pragma unroll
    for (int q = 0; q < kMicro; ++q)
      sum += static_cast<double>(c[r][q]) *
             static_cast<double>(lower_at(A, N, i0 + ty + 16 * r, j0 + tx + 16 * q));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (tid % 32 == 0) red[tid / 32] = sum;
  __syncthreads();
  if (tid == 0) {
    double total = 0.0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += red[w];
    partials[static_cast<long long>(I) * nb + J] = total;
  }
}

}  // namespace

// partials must hold nb * nb doubles, nb = ceil(N / 128)
extern "C" int tc_matmul_f32(const void* lower, void* partials, int N, void* stream) {
  if (N <= 0) return cudaErrorInvalidValue;
  const int nb = (N + kT - 1) / kT;
  if (nb > 65535) return cudaErrorInvalidValue;
  tc_tile<<<dim3(nb, nb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lower), static_cast<double*>(partials), N, nb);
  return cudaGetLastError();
}

extern "C" int tc_matmul_tile() { return kT; }

extern "C" const char* tc_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
