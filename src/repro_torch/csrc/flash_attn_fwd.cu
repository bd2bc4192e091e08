// Flash-attention forward (prefill) for Hopper, sm_90a. Plain C entry
// point, loaded with ctypes by repro_torch/kernels/_build.py.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attn.py
// ::flash_attention_fwd (_fwd_kernel): online-softmax attention of
// q (B,H,Sq,D) against k/v (B,KV,Skv,D) with GQA (head h reads KV head
// h / (H/KV)), a causal band (top-left aligned: kpos <= qpos) and an
// optional sliding window, fully masked KV tiles skipped, the ragged Skv
// tail masked. Softmax and sums in f32, m starting at -1e30, masked
// scores giving p = 0 without taking their exp, the row sum divided as
// acc / max(l, 1e-30), output in the input type. D = 16, 32 or 64.
//
// What bounds it on the H100: the causal score and PV products,
// 2 * 2 * B*H * (Sq*Skv/2) * D operations, against 989 TFLOP/s of bf16
// tensor cores; at the served shapes (S <= 512) the bytes are smaller
// still, so in practice the longest block's walk over its KV tiles sets
// the time: every tile is read again from L2 by each q tile, and from
// shared memory by each warp.
//
// bf16 (the serving path): tensor cores. One block of eight warps per
// (64-row q tile, q head, batch), the q tiles scheduled in reverse so the
// causal tiles with the most KV tiles start first. The warps form two
// groups of four, each covering the 64 q rows (16 a warp); the band's KV
// tiles go to the groups in turn, which halves the longest walk, and at
// the end group 1 hands its (m, l, acc) to group 0 through shared memory,
// combined as the online softmax combines tiles. Q is loaded once and
// kept as mma A fragments (ldmatrix). K and V tiles of 64 keys stay bf16
// in shared memory (rows padded by 16 bytes so ldmatrix rows fall in
// distinct banks), in a cp.async ring of two rounds of two tiles, so the
// next round's copies overlap this round's math. S = Q K^T is mma.sync
// m16n8k16 (bf16 in, f32 accumulate); the online softmax runs on the
// accumulator fragments (row max and sum over the four lanes of a row by
// xor shuffles, in log2 units, 2^x on the SFU); P is rounded to bf16 in
// registers and used directly as the A operand of P V, with V's B
// fragments from ldmatrix.trans. Tiles outside the causal/window band are
// skipped by the loop bounds; only tiles that cross the diagonal, the
// window edge or the Skv tail run the masked variant of the tile code,
// compiled separately. Variants tried on the card and found slower: one
// group, four groups, a deeper ring, 32 q rows a warp (255 registers,
// fewer blocks per SM).
// Grouping the q heads of a KV head into one block was left out: at
// SmolLM's 15 heads it would cut 120 blocks to 40 on 132 SMs.
//
// f32 (the f32 logits checks and tests only): CUDA-core FMAs, exact in
// f32 (tensor cores would need three bf16 products per f32 product to
// hold 2e-5). One block of 256 threads per (64-row q tile, q head,
// batch); four threads share a query row, each scoring 16 of the 64 keys
// of a tile and owning D/4 output columns; K and V tiles staged in shared
// memory as f32, probabilities moved between the four threads by warp
// shuffles.
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per shared-memory tile
constexpr int THREADS = 256;   // four threads per query row

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int H, int KV, int Sq, int Skv, int causal, int window,
                 float scale) {
  using V16 = repro::Vec16<T>;
  constexpr int VEC = V16::N;
  constexpr int DJ = D / 4;            // output columns per thread
  constexpr int CJ = BK / 4;           // key columns per thread
  constexpr int CHUNKS = BK * D / VEC; // 16-byte loads per K (or V) tile
  static_assert(D % VEC == 0 && D % 4 == 0, "head_dim");
  static_assert(CHUNKS % THREADS == 0 || THREADS % CHUNKS == 0,
                "tile load split");

  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r = tid >> 2;              // query row within the tile
  const int c4 = tid & 3;              // column phase within the row
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q_start = blockIdx.x * BQ;
  const int qpos = q_start + r;

  const T* qp = q + ((size_t)b * H + h) * Sq * D;
  const T* kp = k + ((size_t)b * KV + kvh) * Skv * D;
  const T* vp = v + ((size_t)b * KV + kvh) * Skv * D;
  T* op = o + ((size_t)b * H + h) * Sq * D;

  float qr[D];
#pragma unroll
  for (int c = 0; c < D / VEC; ++c) {
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (qpos < Sq)
      raw = *reinterpret_cast<const uint4*>(qp + (size_t)qpos * D + c * VEC);
    V16::unpack(raw, qr + c * VEC);
  }

  // KV tiles in the band of this q tile.
  const int q_last = min(q_start + BQ, Sq) - 1;
  int kt_hi = (Skv + BK - 1) / BK;
  if (causal) kt_hi = min(kt_hi, q_last / BK + 1);
  int kt_lo = 0;
  if (window > 0) kt_lo = max(0, (q_start - window + 1) / BK);

  float m = repro::kNegBig, l = 0.f;
  float acc[DJ];
#pragma unroll
  for (int i = 0; i < DJ; ++i) acc[i] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k_start = kt * BK;
    __syncthreads();                   // previous tile fully consumed
#pragma unroll
    for (int it = 0; it < (CHUNKS + THREADS - 1) / THREADS; ++it) {
      const int chunk = tid + it * THREADS;
      if (chunk >= CHUNKS) break;
      const int row = chunk / (D / VEC);
      const int col = (chunk % (D / VEC)) * VEC;
      const int kpos = k_start + row;
      uint4 kraw = make_uint4(0u, 0u, 0u, 0u), vraw = kraw;
      if (kpos < Skv) {                // zero the ragged tail
        kraw = *reinterpret_cast<const uint4*>(kp + (size_t)kpos * D + col);
        vraw = *reinterpret_cast<const uint4*>(vp + (size_t)kpos * D + col);
      }
      float kf[VEC], vf[VEC];
      V16::unpack(kraw, kf);
      V16::unpack(vraw, vf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ks[row][col + e] = kf[e];
        vs[row][col + e] = vf[e];
      }
    }
    __syncthreads();

    // scores of this thread's 16 keys; masked keys are -inf
    float s[CJ];
    float mt = repro::kNegBig;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int c = c4 + 4 * j;
      const int kpos = k_start + c;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[c][d], dot);
      const bool ok = kpos < Skv && (!causal || kpos <= qpos) &&
                      (window <= 0 || kpos > qpos - window);
      s[j] = ok ? dot * scale : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);  // finite: m starts at -1e30
    const float alpha = expf(m - m_new);
    float lt = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      s[j] = (s[j] == -INFINITY) ? 0.f : expf(s[j] - m_new);
      lt += s[j];
    }
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    l = l * alpha + lt;
    m = m_new;
#pragma unroll
    for (int i = 0; i < DJ; ++i) acc[i] *= alpha;

    // acc[i] += sum_c p[c] * V[c][c4 + 4i]; p[c] lives in lane c % 4 of
    // this row's four lanes, register j = c / 4
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float p = __shfl_sync(0xffffffffu, s[j], (lane & ~3) | kk);
        const float* vrow = vs[4 * j + kk];
#pragma unroll
        for (int i = 0; i < DJ; ++i) acc[i] = fmaf(p, vrow[c4 + 4 * i], acc[i]);
      }
    }
  }

  if (qpos < Sq) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DJ; ++i)
      op[(size_t)qpos * D + c4 + 4 * i] = repro::from_f32<T>(acc[i] / denom);
  }
}

// ---- bf16: tensor cores ----------------------------------------------

constexpr int NGRP = 2;            // KV groups of four warps (16 q rows each)
constexpr int MMA_THREADS = 128 * NGRP;
constexpr int NRND = 2;            // rounds (NGRP K/V tiles each) in the ring
constexpr int NSLOT = NRND * NGRP;
using bf16 = __nv_bfloat16;

// 2^x on the SFU (MUFU.EX2, ~2 ulp; 0 for x = -inf or below -126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// dynamic shared memory of the bf16 kernel: Q and the ring of K/V tiles
constexpr int mma_smem(int D) { return (BQ + 2 * NSLOT * BK) * (D + 8) * 2; }

template <int D>
__global__ void __launch_bounds__(MMA_THREADS, 2)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                     int KV, int Sq, int Skv, int causal, int window,
                     float scale_log2) {
  constexpr int DP = D + 8;        // shared row in bf16, padded by 16 bytes
  constexpr int KS = D / 16;       // k-steps of Q K^T
  constexpr int NT = BK / 8;       // key n-tiles of a score tile
  constexpr int DT = D / 8;        // n-tiles of the output
  constexpr int RC = D / 8;        // 16-byte pieces of a row
  constexpr int XF = 4 + 4 * DT;   // floats a lane hands over in the merge
  static_assert((NGRP - 1) * XF * 128 * 4 <= 2 * NSLOT * BK * DP * 2,
                "merge buffer");
  extern __shared__ __align__(128) unsigned char smem_mma[];
  bf16* qs = reinterpret_cast<bf16*>(smem_mma);   // [BQ][DP]
  bf16* ks = qs + BQ * DP;                        // [NSLOT][BK][DP]
  bf16* vs = ks + NSLOT * BK * DP;                // [NSLOT][BK][DP]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp >> 2, wr = warp & 3;       // KV group, row block
  const int g = lane >> 2, c4 = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest first
  const bf16* qp = q + ((size_t)b * H + h) * Sq * D;
  const bf16* kp = k + ((size_t)b * KV + kvh) * Skv * D;
  const bf16* vp = v + ((size_t)b * KV + kvh) * Skv * D;
  bf16* op = o + ((size_t)b * H + h) * Sq * D;

  // 64 rows from row0 of src (n rows valid) into a padded shared tile;
  // rows past n are zero-filled. Each thread copies the same column of
  // rows lr, lr + RSTEP, ...
  constexpr int PIECES = 64 * RC, RSTEP = MMA_THREADS / RC;
  const int lr = tid / RC, lcol = (tid % RC) * 8;
  auto load_tile = [&](bf16* dst, const bf16* src, int row0, int n) {
#pragma unroll
    for (int i = 0; i < (PIECES + MMA_THREADS - 1) / MMA_THREADS; ++i) {
      const int r = lr + i * RSTEP;
      if (PIECES % MMA_THREADS == 0 || r < 64) {
        const bool ok = row0 + r < n;
        repro::cp_async16(dst + r * DP + lcol,
                          src + (ok ? (row0 + r) * D + lcol : 0), ok);
      }
    }
  };

  const int q_last = min(q_start + BQ, Sq) - 1;
  int kt_hi = (Skv + BK - 1) / BK;
  if (causal) kt_hi = min(kt_hi, q_last / BK + 1);
  int kt_lo = 0;
  if (window > 0) kt_lo = max(0, (q_start - window + 1) / BK);
  const int nrnd = (kt_hi - kt_lo + NGRP - 1) / NGRP;   // 0: empty band

  float oacc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
  float m[2] = {repro::kNegBig, repro::kNegBig};  // rows g and g + 8
  float l[2] = {0.f, 0.f};                        // this lane's part
  uint32_t qf[KS][4];
  const int r0 = q_start + wr * 16 + g, r1 = r0 + 8;

  // KV tiles go to the groups in turn, a round of NGRP tiles at a time
  // through a ring of NRND rounds: one commit group per round, empty past
  // the band
  auto load_round = [&](int j) {
    if (j < nrnd) {
#pragma unroll
      for (int e = 0; e < NGRP; ++e) {
        const int kt = kt_lo + NGRP * j + e, slot = NGRP * (j % NRND) + e;
        if (kt < kt_hi) {
          load_tile(ks + slot * BK * DP, kp, kt * BK, Skv);
          load_tile(vs + slot * BK * DP, vp, kt * BK, Skv);
        }
      }
    }
    repro::cp_async_commit();
  };

  // one KV tile: S = Q K^T, the online softmax in log2 units (masks only
  // on tiles that cross an edge: EDGE is a compile-time branch), O += P V
  auto tile = [&](const bf16* kb, const bf16* vb, int k_start, auto edge_t) {
    constexpr bool EDGE = decltype(edge_t)::value;
    float s[NT][4];
#pragma unroll
    for (int jj = 0; jj < NT; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jj][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t bb[NT / 2][4];          // this k-step's K fragments first
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        repro::ldmatrix_x4(bb[np], kb + (np * 16 + (lane & 7) +
                                         ((lane >> 4) << 3)) * DP +
                                       kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        repro::mma_bf16(s[2 * np], qf[kk], bb[np][0], bb[np][1]);
        repro::mma_bf16(s[2 * np + 1], qf[kk], bb[np][2], bb[np][3]);
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jj = 0; jj < NT; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[jj][e] * scale_log2;
        if (EDGE) {
          const int kpos = k_start + jj * 8 + 2 * c4 + (e & 1);
          const int qpos = e < 2 ? r0 : r1;
          const bool ok = kpos < Skv && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          x = ok ? x : -INFINITY;
        }
        s[jj][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);        // finite: m >= -1e30
      const float alpha = ex2(m[r] - mn);
      m[r] = mn;
      l[r] *= alpha;
#pragma unroll
      for (int jj = 0; jj < DT; ++jj) {
        oacc[jj][2 * r] *= alpha;
        oacc[jj][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int jj = 0; jj < NT; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[jj][e];
        s[jj][e] = (EDGE && x == -INFINITY) ? 0.f : ex2(x - m[e >> 1]);
        l[e >> 1] += s[jj][e];
      }
    }
    // O += P V: P's accumulators, rounded to bf16, are the A fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {
          repro::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          repro::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          repro::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          repro::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      uint32_t bv[DT / 2][4];          // this k-step's V fragments first
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp)
        repro::ldmatrix_x4_trans(bv[dp], vb + (kk * 16 + (lane & 15)) * DP +
                                             dp * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        repro::mma_bf16(oacc[2 * dp], a, bv[dp][0], bv[dp][1]);
        repro::mma_bf16(oacc[2 * dp + 1], a, bv[dp][2], bv[dp][3]);
      }
    }
  };

  if (nrnd > 0) load_tile(qs, qp, q_start, Sq);
#pragma unroll
  for (int i = 0; i < NRND - 1; ++i) load_round(i);
  for (int j = 0; j < nrnd; ++j) {
    load_round(j + NRND - 1);
    repro::cp_async_wait<NRND - 1>();    // round j (and Q) arrived
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        repro::ldmatrix_x4(qf[kk], qs + (wr * 16 + (lane & 15)) * DP +
                                       kk * 16 + (lane >> 4) * 8);
    }
    const int kt = kt_lo + NGRP * j + grp;
    if (kt < kt_hi) {
      const int slot = NGRP * (j % NRND) + grp;
      const int k_start = kt * BK;
      const bool edge = k_start + BK > Skv ||
                        (causal && k_start + BK - 1 > q_start) ||
                        (window > 0 && k_start + window <= q_start + BQ - 1);
      if (edge)
        tile(ks + slot * BK * DP, vs + slot * BK * DP, k_start,
             std::true_type{});
      else
        tile(ks + slot * BK * DP, vs + slot * BK * DP, k_start,
             std::false_type{});
    }
    __syncthreads();                 // round j read by every group
  }

  // the groups' partial results, merged by group 0 in group order (the
  // ring is free now) with the online-softmax combination
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* xb = reinterpret_cast<float*>(ks) + wr * 32 + lane;  // [XF][128]
  if (grp > 0) {
    float* x = xb + (grp - 1) * XF * 128;
    x[0] = m[0]; x[128] = m[1]; x[256] = l[0]; x[384] = l[1];
#pragma unroll
    for (int jj = 0; jj < DT; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[(4 + 4 * jj + e) * 128] = oacc[jj][e];
  }
  __syncthreads();
  if (grp > 0) return;
  for (int gi = 1; gi < NGRP; ++gi) {
    const float* x = xb + (gi - 1) * XF * 128;
    float fa[2], fo[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mo = x[r * 128], mn = fmaxf(m[r], mo);
      fa[r] = ex2(m[r] - mn);
      fo[r] = ex2(mo - mn);
      m[r] = mn;
      l[r] = l[r] * fa[r] + x[(2 + r) * 128] * fo[r];
    }
#pragma unroll
    for (int jj = 0; jj < DT; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        oacc[jj][e] = oacc[jj][e] * fa[e >> 1] +
                      x[(4 + 4 * jj + e) * 128] * fo[e >> 1];
  }
  const float d0 = fmaxf(l[0], 1e-30f), d1 = fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int jj = 0; jj < DT; ++jj) {
    const int col = jj * 8 + 2 * c4;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(op + (size_t)r0 * D + col) =
          repro::pack_bf16(oacc[jj][0] / d0, oacc[jj][1] / d0);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(op + (size_t)r1 * D + col) =
          repro::pack_bf16(oacc[jj][2] / d1, oacc[jj][3] / d1);
  }
}

template <int D>
void launch_mma(const void* q, const void* k, const void* v, void* o,
                const dim3& grid, int H, int KV, int Sq, int Skv, int causal,
                int window, float scale, cudaStream_t st) {
  const float log2e = 1.4426950408889634f;
  cudaFuncSetAttribute(flash_fwd_mma_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       mma_smem(D));
  flash_fwd_mma_kernel<D><<<grid, MMA_THREADS, mma_smem(D), st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, H, KV, Sq,
      Skv, causal, window, scale * log2e);
}

template <int D>
void launch_fma(const void* q, const void* k, const void* v, void* o,
                const dim3& grid, int H, int KV, int Sq, int Skv, int causal,
                int window, float scale, cudaStream_t st) {
  flash_fwd_kernel<float, D><<<grid, THREADS, 0, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, H, KV,
      Sq, Skv, causal, window, scale);
}

}  // namespace

// Returns the CUDA error of the launch (0 = launched). window <= 0 means
// no sliding window; dtype 0 = float32, 1 = bfloat16.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, int B, int H, int KV, int Sq, int Skv,
                              int D, int causal, int window, float scale,
                              int dtype, void* stream) {
  if (D != 16 && D != 32 && D != 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  auto go = dtype == 1
      ? (D == 16 ? launch_mma<16> : D == 32 ? launch_mma<32> : launch_mma<64>)
      : (D == 16 ? launch_fma<16> : D == 32 ? launch_fma<32> : launch_fma<64>);
  go(q, k, v, o, grid, H, KV, Sq, Skv, causal, window, scale, st);
  return (int)cudaGetLastError();
}
