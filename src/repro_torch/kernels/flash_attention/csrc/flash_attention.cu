// Blocked (flash) attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention (its pl.pallas_call, body _attn_body). It computes what
// that kernel computes:
//
//   o[b, i, :] = sum_j softmax_j( q[b, i, :] . k[b, j, :] * scale ) v[b, j, :]
//
// over q [BH, SQ, D] and k, v [BH, SKV, D], row-major and contiguous, with
// the output [BH, SQ, D] in q's type. Causal: query i sees kv position j
// iff j <= i + (SKV - SQ); a masked score is -1e30 (the reference's
// NEG_INF), the running max starts at -1e30, and the output is
// acc / max(l, 1e-30), exactly the reference's arithmetic. KV tiles that lie
// wholly above the causal diagonal are skipped, as the reference skips them.
// The running max, the denominator and the accumulator stay in f32.
//
// The TPU kernel runs its KV grid axis in order and carries m, l and acc in
// VMEM scratch from one grid step to the next. Blocks here run in parallel
// and in no order, so one block owns one (bh, query tile) and walks the KV
// tiles itself, up to the causal limit: m, l and acc live in registers for
// the whole walk and nothing crosses blocks. Query tiles start longest
// walk first (blockIdx.y counts down the tiles, blockIdx.x runs over the
// heads, and x varies fastest in the launch order).
//
// Bound: operations. One call does 4 * D * (the (i, j) pairs it keeps)
// FLOPs: 4.40e12 for BH 16, SQ = SKV = 32,768, D 128, causal, 4.45 ms at
// the H100 SXM's 989 TFLOP/s for bf16, against 537 MB of q, k, v and o,
// 0.16 ms at 3.35 TB/s. What this design does about it:
//   * bf16 (every D in {32, 64, 128}): wgmma fed by TMA, warp-specialised.
//     A block is three warpgroups and owns 128 query rows. Warpgroup 0 is
//     the producer: it drops its registers to 40 (setmaxnreg) and one thread
//     starts the TMA loads, Q once, then K and V tiles of 128 rows through a
//     ring of two stages, each with its own "full" mbarrier for K and for V
//     (so S = Q K^T can start while V still lands) and an "empty" one (one
//     arrival per consumer warp). Warpgroups 1 and 2 (232 registers each)
//     own 64 query rows each: S = Q K^T on wgmma m64n128k16 with both
//     operands in shared memory (K-major), softmax in registers, then
//     O += P V on wgmma m64nDk16 with P as the register A operand (the
//     scores' accumulator layout is that operand's layout, packed to bf16)
//     and V an MN-major B operand through the descriptor's transpose bit.
//     The maps are 3-d, [BH, S, D], so a ragged SQ or SKV loads zeros from
//     its own head and never the next head's rows. Rows of one column block
//     are 128 bytes (D >= 64, 128-byte swizzle; D = 128 is two blocks) or 64
//     bytes (D = 32, 64-byte swizzle), and the descriptors name the same
//     swizzle. The causal compare runs only on tiles that straddle the
//     diagonal or the end of SKV, and the test is made once per tile (a
//     test per score compiles to a branch around every score, paid on
//     every tile).
//     Not yet: overlap of one tile's softmax with the next tile's products
//     inside a warpgroup, and scheduling of the two warpgroups in turns.
//   * f32: plain FMA (SIMT), for the reference's f32 tests. A warp owns 4
//     query rows; lane j scores kv column j of a 32-column tile, and the
//     lanes share P.V by shuffles, lane l owning columns l, l + 32, ...
//
// Ragged edges: SQ and SKV need not be multiples of the tiles (a 32-token
// prompt gives SQ = 32 < 128). Query rows past SQ load zeros and are not
// stored; kv columns past SKV score -inf, so they add nothing even to a row
// that is wholly masked so far (their V rows load as zeros).
//
// Each exported function returns cudaGetLastError() after its launch (0 on
// success); a launch that CUDA refuses never runs and is reported only
// there. D must be 32, 64 or 128; q, k, v and o must be 16-byte aligned
// (the tensor maps' base).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "../../common/hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;            // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int SQ, SKV, causal;
  float scale;
};

// KV tiles of width BK that a query tile [q0, q0 + BQ) must visit: all of
// them, or with the causal mask those up to the last column its last row
// sees (at least one, as the reference always runs its first tile).
template <int BQ, int BK>
__device__ __forceinline__ int kv_tiles(int q0, const Params& p) {
  int n = (p.SKV + BK - 1) / BK;
  if (p.causal) {
    const int q_last = min(q0 + BQ, p.SQ) - 1;
    const int last_col = q_last + (p.SKV - p.SQ);
    n = min(n, last_col < 0 ? 1 : last_col / BK + 1);
  }
  return n;
}

// --------------------------------------------------------------------------
// bf16: wgmma + TMA, warp-specialised
// --------------------------------------------------------------------------

constexpr int kBQ = 128;                     // query rows per block, 64 per consumer
constexpr int kBK = 128;                     // kv rows per tile
constexpr int kStagesKV = 2;                 // K/V ring depth
constexpr int kWsThreads = 384;              // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;

// shared-memory geometry of one head dim: a tile [rows, D] is kBlocks
// column blocks, each [rows, kCols] with rows of kSwBytes bytes
template <int D>
struct Tiles {
  static constexpr int kSwBytes = 2 * D >= 128 ? 128 : 64;
  static constexpr int kCols = kSwBytes / 2;
  static constexpr int kBlocks = D / kCols;
  static constexpr uint32_t kLayout = kSwBytes == 128 ? hopper::kSwizzle128B
                                                      : hopper::kSwizzle64B;
  static constexpr uint32_t kAtom = 8 * kSwBytes;   // 8 rows: the swizzle atom
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;
  static constexpr int kBars = 1 + 3 * kStagesKV;
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStagesKV * kKVBytes + 8 * kBars;
};

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// O += P V for one k16 chunk of P
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  if constexpr (D == 128) hopper::wgmma_m64n128k16_bf16_rs(o, a, desc_v);
  else if constexpr (D == 64) hopper::wgmma_m64n64k16_bf16_rs(o, a, desc_v);
  else hopper::wgmma_m64n32k16_bf16_rs(o, a, desc_v);
}

// Scores into the log2 domain and the running row maxima. Thread layout:
// score 4n + e is row row_lo + 8 (e / 2), column col0 + 8n + (e % 2). kMask
// applies the reference's masks: -inf past SKV, -1e30 (its NEG_INF) above
// the causal diagonal (exp2(-1e30 - m) = 0 too).
template <bool kMask>
__device__ __forceinline__ void scale_max(float (&sc)[kBK / 2], float (&mx)[2], float scale2,
                                          const Params& p, int col0, int row_lo, int offset) {
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * n + e] * scale2;
      if constexpr (kMask) {
        const int col = col0 + n * 8 + (e & 1);
        const int row = row_lo + 8 * (e >> 1);
        if (col >= p.SKV) x = -INFINITY;
        else if (p.causal && col > row + offset) x = kNegInf;
      }
      sc[4 * n + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v, Params p) {
  using T = Tiles<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* q_tile = smem;
  auto k_tile = [&](int s) { return smem + T::kQBytes + s * 2 * T::kKVBytes; };
  auto v_tile = [&](int s) { return k_tile(s) + T::kKVBytes; };
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + T::kQBytes + 2 * kStagesKV * T::kKVBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStagesKV;
  uint64_t* empty = v_full + kStagesKV;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int n_tiles = kv_tiles<kBQ, kBK>(q0, p);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStagesKV; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: Q once, then the K and V tiles through the ring
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(q_full, T::kQBytes);
#pragma unroll
      for (int b = 0; b < T::kBlocks; ++b) {
        hopper::tma_load_3d(q_tile + b * kBQ * T::kSwBytes, &map_q, q_full, b * T::kCols, q0, bh);
      }
      int s = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < n_tiles; ++kt) {
        hopper::mbar_wait(&empty[s], phase ^ 1);
        hopper::mbar_arrive_expect_tx(&k_full[s], T::kKVBytes);
#pragma unroll
        for (int b = 0; b < T::kBlocks; ++b) {
          hopper::tma_load_3d(k_tile(s) + b * kBK * T::kSwBytes, &map_k, &k_full[s],
                              b * T::kCols, kt * kBK, bh);
        }
        hopper::mbar_arrive_expect_tx(&v_full[s], T::kKVBytes);
#pragma unroll
        for (int b = 0; b < T::kBlocks; ++b) {
          hopper::tma_load_3d(v_tile(s) + b * kBK * T::kSwBytes, &map_v, &v_full[s],
                              b * T::kCols, kt * kBK, bh);
        }
        if (++s == kStagesKV) { s = 0; phase ^= 1; }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows q0 + 64 cw .. q0 + 64 cw + 63
  hopper::setmaxnreg_inc<232>();
  const int cw = wg - 1;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;     // accumulator row group, thread in group
  const int row_first = q0 + cw * 64;
  const int row_lo = row_first + warp * 16 + g, row_hi = row_lo + 8;
  const float scale2 = p.scale * kLog2e;     // scores kept in the log2 domain
  const int offset = p.SKV - p.SQ;

  float m[2] = {kNegInf, kNegInf};           // running max of rows row_lo, row_hi
  float l[2] = {0.f, 0.f};                   // this thread's share of the denominators
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float sc[kBK / 2];                         // S: 64 x 128 per warpgroup
  uint32_t pa[kBK / 16][4];                  // P as bf16 A fragments, one per k16 chunk

  hopper::mbar_wait(q_full, 0);
  int s = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;

    // S = Q K^T
    hopper::mbar_wait(&k_full[s], phase);
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int b = kk * 16 / T::kCols, cb = (kk * 16 % T::kCols) * 2;
      const uint64_t da = hopper::make_desc(q_tile + b * kBQ * T::kSwBytes +
                                                cw * 64 * T::kSwBytes + cb,
                                            16, T::kAtom, T::kLayout);
      const uint64_t db = hopper::make_desc(k_tile(s) + b * kBK * T::kSwBytes + cb, 16,
                                            T::kAtom, T::kLayout);
      hopper::wgmma_m64n128k16_bf16_ss(sc, da, db, kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // scale, mask (only where the tile straddles the diagonal or SKV: the
    // test is made once per tile, so the other tiles carry no compare), row
    // max over the four threads that share a row
    float mx[2] = {m[0], m[1]};
    if (k0 + kBK > p.SKV || (p.causal && k0 + kBK - 1 > row_first + offset)) {
      scale_max<true>(sc, mx, scale2, p, k0 + t * 2, row_lo, offset);
    } else {
      scale_max<false>(sc, mx, scale2, p, k0 + t * 2, row_lo, offset);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
    }
    const float alpha[2] = {exp2f(m[0] - mx[0]), exp2f(m[1] - mx[1])};
    m[0] = mx[0];
    m[1] = mx[1];

    // P = exp2(S - m) packed to bf16: score tiles 2c and 2c + 1 are exactly
    // the k16 chunk c of the A operand of P V
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      const float p0 = exp2f(sc[4 * n + 0] - m[0]), p1 = exp2f(sc[4 * n + 1] - m[0]);
      const float p2 = exp2f(sc[4 * n + 2] - m[1]), p3 = exp2f(sc[4 * n + 3] - m[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pa[n / 2][(n & 1) * 2 + 0] = pack_f32(p0, p1);
      pa[n / 2][(n & 1) * 2 + 1] = pack_f32(p2, p3);
    }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 0] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }

    // O += P V; then the stage goes back to the producer
    hopper::mbar_wait(&v_full[s], phase);
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < kBK / 16; ++c) {
      const uint64_t dv = hopper::make_desc(v_tile(s) + c * 16 * T::kSwBytes,
                                            kBK * T::kSwBytes, T::kAtom, T::kLayout);
      wgmma_pv<D>(o, pa[c], dv);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
    if (++s == kStagesKV) { s = 0; phase ^= 1; }
  }

  // denominators: the four threads of a row group hold a share each
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    l[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
  auto* O = static_cast<__nv_bfloat16*>(p.o) + static_cast<long long>(bh) * p.SQ * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + t * 2;
    if (row_lo < p.SQ) {
      *reinterpret_cast<__nv_bfloat162*>(O + static_cast<long long>(row_lo) * D + col) =
          __floats2bfloat162_rn(o[4 * j + 0] * l[0], o[4 * j + 1] * l[0]);
    }
    if (row_hi < p.SQ) {
      *reinterpret_cast<__nv_bfloat162*>(O + static_cast<long long>(row_hi) * D + col) =
          __floats2bfloat162_rn(o[4 * j + 2] * l[1], o[4 * j + 3] * l[1]);
    }
  }
}

template <int D>
cudaError_t launch_bf16(const Params& p, int BH, cudaStream_t stream) {
  using T = Tiles<D>;
  const CUtensorMapSwizzle swizzle =
      T::kSwBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap maps[3];
  const void* bases[3] = {p.q, p.k, p.v};
  for (int i = 0; i < 3; ++i) {
    const uint64_t rows = i == 0 ? p.SQ : p.SKV;
    const uint64_t dims[3] = {D, rows, static_cast<uint64_t>(BH)};
    const uint64_t strides[2] = {D * 2, rows * D * 2};
    const uint32_t box[3] = {T::kCols, static_cast<uint32_t>(i == 0 ? kBQ : kBK), 1};
    const cudaError_t err = hopper::make_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                                             bases[i], dims, strides, box, swizzle);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (p.SQ + kBQ - 1) / kBQ);
  flash_fwd_bf16<D><<<grid, kWsThreads, T::kSmem, stream>>>(maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// f32: plain FMA
// --------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ32 = kWarps * kRowsPerWarp; // 16 query rows per block
constexpr int kBK32 = 32;                    // one kv column per lane

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(Params p) {
  constexpr int L = D / 32;                  // output columns per lane
  __shared__ float Qs[kBQ32][D];
  __shared__ float Ks[kBK32][D + 1];         // +1: lanes read distinct rows
  __shared__ float Vs[kBK32][D];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ32;
  const long long bh = blockIdx.y;
  const float* Q = static_cast<const float*>(p.q) + bh * p.SQ * D;
  const float* K = static_cast<const float*>(p.k) + bh * p.SKV * D;
  const float* V = static_cast<const float*>(p.v) + bh * p.SKV * D;
  float* O = static_cast<float*>(p.o) + bh * p.SQ * D;

  for (int e = threadIdx.x; e < kBQ32 * D; e += kThreads) {
    const int r = e / D, c = e % D;
    Qs[r][c] = q0 + r < p.SQ ? Q[static_cast<long long>(q0 + r) * D + c] : 0.f;
  }

  const int offset = p.SKV - p.SQ;
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][L];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < L; ++i) acc[r][i] = 0.f;
  }

  const int n_tiles = kv_tiles<kBQ32, kBK32>(q0, p);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK32;
    __syncthreads();                         // Qs written / the last tile read
    for (int e = threadIdx.x; e < kBK32 * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < p.SKV;
      Ks[r][c] = in ? K[static_cast<long long>(k0 + r) * D + c] : 0.f;
      Vs[r][c] = in ? V[static_cast<long long>(k0 + r) * D + c] : 0.f;
    }
    __syncthreads();

    const int col = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qr = warp * kRowsPerWarp + r;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(Qs[qr][d], Ks[lane][d], s);
      s *= p.scale;
      if (col >= p.SKV) s = -INFINITY;
      else if (p.causal && col > q0 + qr + offset) s = kNegInf;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float pj = expf(s - m_new);
      const float alpha = expf(m[r] - m_new);
      float ps = pj;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(kFull, ps, off);
      l[r] = l[r] * alpha + ps;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < L; ++i) acc[r][i] *= alpha;
      for (int j = 0; j < kBK32; ++j) {
        const float pb = __shfl_sync(kFull, pj, j);
#pragma unroll
        for (int i = 0; i < L; ++i) acc[r][i] = fmaf(pb, Vs[j][lane + 32 * i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row >= p.SQ) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < L; ++i) {
      O[static_cast<long long>(row) * D + lane + 32 * i] = acc[r][i] * inv;
    }
  }
}

cudaError_t check(int BH, int SQ, int SKV) {
  if (BH <= 0 || BH > 65535 || SQ <= 0 || SKV <= 0) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    int BH, int SQ, int SKV, int D, int causal,
                                    float scale, void* stream) {
  if (check(BH, SQ, SKV) != cudaSuccess || (SQ + kBQ - 1) / kBQ > 65535) {
    return cudaErrorInvalidValue;
  }
  const Params p{q, k, v, o, SQ, SKV, causal, scale};
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_bf16<32>(p, BH, s);
    case 64: return launch_bf16<64>(p, BH, s);
    case 128: return launch_bf16<128>(p, BH, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                   int BH, int SQ, int SKV, int D, int causal,
                                   float scale, void* stream) {
  if (check(BH, SQ, SKV) != cudaSuccess) return cudaErrorInvalidValue;
  const Params p{q, k, v, o, SQ, SKV, causal, scale};
  const dim3 grid((SQ + kBQ32 - 1) / kBQ32, BH);
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: flash_fwd_f32<32><<<grid, kThreads, 0, s>>>(p); break;
    case 64: flash_fwd_f32<64><<<grid, kThreads, 0, s>>>(p); break;
    case 128: flash_fwd_f32<128><<<grid, kThreads, 0, s>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// dynamic shared memory of the bf16 kernel at head dim D (ptxas reports
// only static), 0 for a D it does not take
extern "C" int flash_attention_bf16_smem_bytes(int D) {
  switch (D) {
    case 32: return Tiles<32>::kSmem;
    case 64: return Tiles<64>::kSmem;
    case 128: return Tiles<128>::kSmem;
    default: return 0;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
