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
// and in no order, so one block owns one (bh, 64-row query tile) and walks
// the KV tiles itself, up to the causal limit: m, l and acc live in
// registers for the whole walk and nothing crosses blocks. Query tiles are
// issued in reverse, so the longest causal walks start first.
//
// Bound: operations. One call does 4 * D * (the (i, j) pairs it keeps)
// FLOPs: 4.40e12 for BH 16, SQ = SKV = 32,768, D 128, causal, 4.45 ms at
// the H100 SXM's 989 TFLOP/s for bf16, against 537 MB of q, k, v and o,
// 0.16 ms at 3.35 TB/s. What this design does about it:
//   * bf16: both products run on the tensor cores through mma.sync
//     m16n8k16 (bf16 in, f32 out). Each of the 4 warps owns 16 query rows;
//     its Q fragments stay in registers for the whole walk, the scores S
//     come out in the accumulator layout, and P is packed to bf16 straight
//     from those registers into the A operand of P.V (no trip through shared
//     memory). K and V tiles are staged in shared memory with rows padded
//     by 16 bytes, so the fragment reads are free of bank conflicts.
//     Not yet: wgmma, TMA, double-buffered tiles, warp specialisation —
//     the loads of a tile do not overlap its products.
//   * f32: plain FMA (SIMT), for the reference's f32 tests. A warp owns 4
//     query rows; lane j scores kv column j of a 32-column tile, and the
//     lanes share P.V by shuffles, lane l owning columns l, l + 32, ...
//
// Ragged edges are masked here: SQ and SKV need not be multiples of the
// tiles (a 32-token prompt gives SQ = 32 < 64). Query rows past SQ load
// zeros and are not stored; kv columns past SKV score -inf, so they add
// nothing even to a row that is wholly masked so far.
//
// Each exported function returns cudaGetLastError() after its launch (0 on
// success); a launch that CUDA refuses never runs and is reported only
// there. D must be 32, 64 or 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

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
// bf16: mma.sync m16n8k16 on the tensor cores
// --------------------------------------------------------------------------

constexpr int kBQ = 64;                      // query rows per block
constexpr int kBK = 64;                      // kv rows per tile
constexpr int kWarps = 4;                    // 16 query rows per warp
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [r0, r0 + 64) of a [rows, D] bf16 matrix into shared memory with
// row stride S, 16 bytes per thread and step; rows past `rows` are zero
template <int D, int S>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int r0, int rows) {
  constexpr int kVec = D / 8;                // uint4 (8 bf16) per row
  for (int e = threadIdx.x; e < kBK * kVec; e += kThreads) {
    const int r = e / kVec, c = (e % kVec) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<long long>(r0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * S + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(Params p) {
  constexpr int S = D + 8;                   // padded row: +16 bytes
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK * S];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBK * S];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;     // fragment row group, thread in group
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const long long bh = blockIdx.y;
  const auto* Q = static_cast<const __nv_bfloat16*>(p.q) + bh * p.SQ * D;
  const auto* K = static_cast<const __nv_bfloat16*>(p.k) + bh * p.SKV * D;
  const auto* V = static_cast<const __nv_bfloat16*>(p.v) + bh * p.SKV * D;
  auto* O = static_cast<__nv_bfloat16*>(p.o) + bh * p.SQ * D;

  // The Q tile passes through Ks once, then stays in registers as the A
  // operand: qa[kk] covers rows warp*16 + {g, g + 8}, columns kk*16 + ...
  load_tile<D, S>(Ks, Q, q0, p.SQ);
  __syncthreads();
  uint32_t qa[D / 16][4];
  {
    const __nv_bfloat16* r_lo = Ks + (warp * 16 + g) * S + t * 2;
    const __nv_bfloat16* r_hi = r_lo + 8 * S;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = ld32(r_lo + kk * 16);
      qa[kk][1] = ld32(r_hi + kk * 16);
      qa[kk][2] = ld32(r_lo + kk * 16 + 8);
      qa[kk][3] = ld32(r_hi + kk * 16 + 8);
    }
  }
  __syncthreads();

  const float scale2 = p.scale * kLog2e;     // scores kept in the log2 domain
  const int offset = p.SKV - p.SQ;
  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
  float m[2] = {kNegInf, kNegInf};           // running max of rows row_lo, row_hi
  float l[2] = {0.f, 0.f};                   // this thread's share of the denominators
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_tiles = kv_tiles<kBQ, kBK>(q0, p);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    load_tile<D, S>(Ks, K, k0, p.SKV);
    load_tile<D, S>(Vs, V, k0, p.SKV);
    __syncthreads();

    // S = Q K^T: 16 x 64 per warp, eight n8 tiles
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kp = Ks + (n * 8 + g) * S + t * 2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_bf16(s[n], qa[kk], ld32(kp + kk * 16), ld32(kp + kk * 16 + 8));
      }
    }

    // scale, mask, row max over the four threads that share a row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + t * 2 + (e & 1);
        const int row = e < 2 ? row_lo : row_hi;
        float x = s[n][e] * scale2;
        if (col >= p.SKV) x = -INFINITY;
        else if (p.causal && col > row + offset) x = kNegInf;   // exp2(-1e30 - m) = 0 too
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
    }
    const float alpha[2] = {exp2f(m[0] - mx[0]), exp2f(m[1] - mx[1])};
    m[0] = mx[0];
    m[1] = mx[1];

    // P = exp2(S - m), packed to bf16 as the A operand of P.V: the score
    // tiles 2c and 2c + 1 are exactly the k16 chunk c of that operand
    uint32_t pa[kBK / 16][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      const float p0 = exp2f(s[n][0] - m[0]), p1 = exp2f(s[n][1] - m[0]);
      const float p2 = exp2f(s[n][2] - m[1]), p3 = exp2f(s[n][3] - m[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pa[n / 2][(n & 1) * 2 + 0] = pack_f32(p0, p1);
      pa[n / 2][(n & 1) * 2 + 1] = pack_f32(p2, p3);
    }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];

    // acc = acc * alpha + P V: B operand element (k = kv row, n = d column)
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
      const __nv_bfloat16* vp = Vs + (t * 2) * S + nd * 8 + g;
#pragma unroll
      for (int c = 0; c < kBK / 16; ++c) {
        const __nv_bfloat16* v0 = vp + c * 16 * S;
        mma_bf16(acc[nd], pa[c], pack_bf16(v0[0], v0[S]),
                 pack_bf16(v0[8 * S], v0[9 * S]));
      }
    }
    __syncthreads();                         // the tile is read; the next may land
  }

  // denominators: the four threads of a row group hold a share each
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    l[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + t * 2;
    if (row_lo < p.SQ) {
      *reinterpret_cast<__nv_bfloat162*>(O + static_cast<long long>(row_lo) * D + col) =
          __floats2bfloat162_rn(acc[nd][0] * l[0], acc[nd][1] * l[0]);
    }
    if (row_hi < p.SQ) {
      *reinterpret_cast<__nv_bfloat162*>(O + static_cast<long long>(row_hi) * D + col) =
          __floats2bfloat162_rn(acc[nd][2] * l[1], acc[nd][3] * l[1]);
    }
  }
}

// --------------------------------------------------------------------------
// f32: plain FMA
// --------------------------------------------------------------------------

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
  if (check(BH, SQ, SKV) != cudaSuccess) return cudaErrorInvalidValue;
  const Params p{q, k, v, o, SQ, SKV, causal, scale};
  const dim3 grid((SQ + kBQ - 1) / kBQ, BH);
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: flash_fwd_bf16<32><<<grid, kThreads, 0, s>>>(p); break;
    case 64: flash_fwd_bf16<64><<<grid, kThreads, 0, s>>>(p); break;
    case 128: flash_fwd_bf16<128><<<grid, kThreads, 0, s>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
