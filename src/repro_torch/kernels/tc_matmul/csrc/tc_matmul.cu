// Triangle count as a masked blocked matrix product for Hopper (sm_90a):
// int8 wgmma over only the lower-triangle work, plain C interface.
//
// Replaces the TPU kernel repro/kernels/tc_matmul/kernel.py::tc_matmul
// (its pl.pallas_call, body _tc_body). It computes what that kernel
// computes, for L the strict lower triangle of a 0/1 adjacency [N, N]
// (f32, row-major):
//
//   count = sum( (L @ L) * L )
//
// The kernel reads only the strict lower triangle of its input: an entry
// (r, c) with r <= c counts as 0. On a strictly lower input, which is the
// contract, that is the same function. A strictly lower entry that is
// neither 0.0 nor 1.0 stops the pack pass with a device-side assert: the
// int8 copy would otherwise count it as something else without a sound.
//
// Two launches:
//
//   1. pack: f32 L -> two int8 copies in the caller's scratch, L8
//      (row-major) and L8T (its transpose), each [Np, Np] with Np = N
//      rounded up to 128 and zeros past N. int8 wgmma takes only K-major
//      operands; the B operand L[K tile, J tile] is N-major in row-major L,
//      so it comes from L8T. The padding keeps TMA's row strides multiples
//      of 16 bytes. One block per 128 x 128 tile on or below the diagonal:
//      the products never read the tiles above it, of L8, or those below it,
//      of L8T, so those stay unwritten.
//   2. products: the TPU kernel walks its grid (I, J, K) in order and
//      carries the C tile of (I, J) in VMEM across K; blocks here run in
//      parallel and in no order. Output tile (I, J), J <= I, needs K tiles
//      J .. I (L[i, k] needs K <= I, L[k, j] needs K >= J). The epilogue
//      sum(acc * L_IJ) is linear in acc, so the K range splits into work
//      units (I, J, K0, nK) with no reduction between blocks: each unit
//      writes its own masked partials, one int64 per consumer warp. The
//      caller builds the unit list (longest first, neighbours in K together
//      so the tiles in flight share the L2 cache) and sums the partials. A
//      persistent grid, one block per SM, walks the list with a stride of
//      the grid.
//
// A block is three warpgroups. Warpgroup 0 is the producer: one thread
// starts the TMA loads of the A tile L8[I, K] and the B tile L8T[J, K] (128 x
// 128 bytes each, 128-byte swizzle) into a ring of kStages stages, each
// guarded by a "full" mbarrier (TMA transaction bytes) and an "empty" one
// (one arrival per consumer warp). Warpgroups 1 and 2 are the consumers,
// rows 0-63 and 64-127 of the output tile: per stage four
// wgmma.m64n128k32.s32.s8.s8 from shared memory into int32 accumulators
// (64 per thread), then the stage goes back to the producer. Exact for any
// N: a C entry is at most N.
//
// Bound: operations. The strict-lower triples i > k > j number
// N(N-1)(N-2)/6, two operations each (a multiply and an add): 1.466e12 at
// N = 16,384, 0.741 ms at the H100 SXM's 1,979 TOP/s for int8 (1.482 ms at
// bf16's 989 TFLOP/s); one read of f32 L is 1.07 GB, 0.32 ms at 3.35 TB/s.
// What the design does about it: the products run on int8 tensor cores fed
// by TMA through a 4-stage ring, over a sixth of the dense tile products.
// What it leaves: 128 x 128 output tiles read 32 KB per tile product from
// L2; each stage waits for its products to finish (wgmma.wait_group 0)
// before it is released, and releasing it one step later, or a deeper
// ring, measured no faster.
//
// Each exported function returns cudaGetLastError() after its launches (0
// on success).

#include <cassert>
#include <cstdint>

#include "../../common/hopper.cuh"

namespace {

constexpr int kT = 128;                      // tile edge (rows, columns, K)
constexpr int kStages = 4;                   // TMA ring depth
constexpr int kTileBytes = kT * kT;          // one int8 tile
constexpr int kStageBytes = 2 * kTileBytes;  // A + B
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 384;                // producer + 2 consumer warpgroups
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;

// ---------------------------------------------------------------------------
// 1. pack
// ---------------------------------------------------------------------------

constexpr int kPackThreads = 256;
constexpr int kPackStride = kT + 4;          // shared row, bytes

__global__ void __launch_bounds__(kPackThreads)
pack_lower(const float* __restrict__ L, int8_t* __restrict__ L8, int8_t* __restrict__ L8T,
           int N, int Np) {
  __shared__ __align__(16) int8_t t[kT * kPackStride];
  // blockIdx.x enumerates the tiles (I, J), J <= I, row by row
  const int tile = blockIdx.x;
  int I = static_cast<int>((sqrtf(8.f * tile + 1.f) - 1.f) * 0.5f);
  while ((I + 1) * (I + 2) / 2 <= tile) ++I;
  while (I * (I + 1) / 2 > tile) --I;
  const int J = tile - I * (I + 1) / 2;
  const int r0 = I * kT, c0 = J * kT;

  bool bad = false;
  const bool vec = (N % 4) == 0;             // float4 loads stay aligned
  for (int e = threadIdx.x; e < kT * (kT / 4); e += kPackThreads) {
    const int r = e / (kT / 4), c = (e % (kT / 4)) * 4;
    const int gr = r0 + r, gc = c0 + c;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (gr < N) {
      const float* src = L + static_cast<long long>(gr) * N + gc;
      if (vec && gc + 3 < N) {
        const float4 x = *reinterpret_cast<const float4*>(src);
        v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = gc + q < N ? src[q] : 0.f;
      }
    }
    uint32_t packed = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool keep = gr > gc + q;         // strict lower; zero past N was loaded
      const float x = keep ? v[q] : 0.f;
      bad |= (x != 0.f && x != 1.f);
      packed |= static_cast<uint32_t>(x == 1.f) << (8 * q);
    }
    *reinterpret_cast<uint32_t*>(t + r * kPackStride + c) = packed;
    *reinterpret_cast<uint32_t*>(L8 + static_cast<long long>(gr) * Np + gc) = packed;
  }
  __syncthreads();
  // L8T[c0 + c, r0 + r] = t[r, c]: thread = (column c, 32 rows), 32 bytes out
  for (int e = threadIdx.x; e < kT * (kT / 32); e += kPackThreads) {
    const int c = e % kT, rb = (e / kT) * 32;
    uint32_t w[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      uint32_t x = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        x |= static_cast<uint32_t>(static_cast<uint8_t>(t[(rb + 4 * q + b) * kPackStride + c]))
             << (8 * b);
      }
      w[q] = x;
    }
    uint4* dst = reinterpret_cast<uint4*>(L8T + static_cast<long long>(c0 + c) * Np + r0 + rb);
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
  assert(!bad);                              // a strictly lower entry not in {0, 1}
}

// ---------------------------------------------------------------------------
// 2. products
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
tc_wgmma(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
         const int4* __restrict__ units, int n_units, const int8_t* __restrict__ L8, int Np,
         long long* __restrict__ partials) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  auto tile_a = [&](int s) { return smem + s * kStageBytes; };
  auto tile_b = [&](int s) { return smem + s * kStageBytes + kTileBytes; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        const int4 w = units[u];             // (I, J, K0, nK)
        for (int kt = 0; kt < w.w; ++kt) {
          hopper::mbar_wait(&empty[s], phase ^ 1);
          hopper::mbar_arrive_expect_tx(&full[s], kStageBytes);
          const int k = (w.z + kt) * kT;
          hopper::tma_load_2d(tile_a(s), &map_a, &full[s], k, w.x * kT);
          hopper::tma_load_2d(tile_b(s), &map_b, &full[s], k, w.y * kT);
          if (++s == kStages) { s = 0; phase ^= 1; }
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of the output tile
  const int cw = wg - 1;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  int s = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int4 w = units[u];
    // this thread's mask entries L8[row, col .. col + 1], fetched before the
    // products so their latency hides behind them
    const int row = w.x * kT + cw * 64 + warp * 16 + g;
    const int8_t* m_lo = L8 + static_cast<long long>(row) * Np + w.y * kT + 2 * tq;
    const int8_t* m_hi = m_lo + 8LL * Np;
    uint16_t mask[2][kT / 8];
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
      mask[0][j] = *reinterpret_cast<const uint16_t*>(m_lo + 8 * j);
      mask[1][j] = *reinterpret_cast<const uint16_t*>(m_hi + 8 * j);
    }

    int32_t acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    for (int kt = 0; kt < w.w; ++kt) {
      hopper::mbar_wait(&full[s], phase);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kT / 32; ++kk) {
        const uint64_t da = hopper::make_desc(tile_a(s) + cw * 64 * kT + kk * 32, 16, 1024,
                                              hopper::kSwizzle128B);
        const uint64_t db =
            hopper::make_desc(tile_b(s) + kk * 32, 16, 1024, hopper::kSwizzle128B);
        hopper::wgmma_m64n128k32_s8(acc, da, db);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
      if (++s == kStages) { s = 0; phase ^= 1; }
    }

    // masked sum of this thread's 64 entries, then of the warp's
    int32_t sum = 0;
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
      sum += acc[4 * j + 0] * (mask[0][j] & 0xff) + acc[4 * j + 1] * (mask[0][j] >> 8) +
             acc[4 * j + 2] * (mask[1][j] & 0xff) + acc[4 * j + 3] * (mask[1][j] >> 8);
    }
    long long total = sum;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(0xffffffffu, total, off);
    if (lane == 0) partials[static_cast<long long>(u) * kConsumerWarps + cw * 4 + warp] = total;
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 0;
  }
  return n;
}

}  // namespace

// lower: [N, N] f32; l8, l8t: [Np, Np] int8 scratch, Np = ceil(N / 128) * 128;
// units: [n_units] int4 (I, J, K0, nK) in 128-tiles; partials: n_units * 8
// int64, written whole.
extern "C" int tc_matmul_f32(const void* lower, void* l8, void* l8t, const void* units,
                             int n_units, void* partials, int N, void* stream) {
  if (N <= 0 || n_units <= 0) return cudaErrorInvalidValue;
  const int nb = (N + kT - 1) / kT, Np = nb * kT;
  auto s = static_cast<cudaStream_t>(stream);
  pack_lower<<<nb * (nb + 1) / 2, kPackThreads, 0, s>>>(
      static_cast<const float*>(lower), static_cast<int8_t*>(l8), static_cast<int8_t*>(l8t), N,
      Np);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap map_a, map_b;
  const uint64_t dims[2] = {static_cast<uint64_t>(Np), static_cast<uint64_t>(Np)};
  const uint64_t strides[1] = {static_cast<uint64_t>(Np)};
  const uint32_t box[2] = {kT, kT};
  if ((err = hopper::make_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, l8, dims, strides, box,
                              CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
      (err = hopper::make_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, l8t, dims, strides, box,
                              CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess) {
    return err;
  }
  err = cudaFuncSetAttribute(tc_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int grid = n_units < sms ? n_units : sms;
  tc_wgmma<<<grid, kThreads, kSmemBytes, s>>>(map_a, map_b, static_cast<const int4*>(units),
                                               n_units, static_cast<const int8_t*>(l8), Np,
                                               static_cast<long long*>(partials));
  return cudaGetLastError();
}

extern "C" int tc_matmul_tile() { return kT; }

extern "C" int tc_matmul_warps() { return kConsumerWarps; }

// dynamic shared memory of the products kernel (ptxas reports only static)
extern "C" int tc_matmul_smem_bytes() { return kSmemBytes; }

extern "C" const char* tc_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
