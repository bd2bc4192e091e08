// xLSTM mLSTM chunkwise scan for Hopper, sm_90a. Plain C entry point,
// loaded with ctypes by repro_torch/kernels/_build.py.
//
// Replaces the Pallas TPU kernel repro/kernels/mlstm_scan.py
// ::mlstm_chunk_scan (_mlstm_kernel). Per (batch b, head h), with
// log f = -softplus(-f_pre), log i = i_pre, q scaled by 1/sqrt(P) and the
// sequence cut into chunks of L positions (the ragged tail padded with
// f = 1, i = -1e30 and zero q, k, v), within a chunk:
//   b_t   = sum_{s<=t} log f_s
//   D_ts  = b_t - b_s + log i_s                    (s <= t only)
//   m_t   = max(max_{s<=t} D_ts, b_t + m_prev)     (= the sequential m_t)
//   W_ts  = (q_t . k_s) exp(D_ts - m_t)            (s <= t, else 0)
//   h_t   = [sum_s W_ts v_s + exp(b_t + m_prev - m_t) q_t C_prev]
//           / max(|sum_s W_ts + exp(b_t + m_prev - m_t) q_t . n_prev|,
//                 exp(-m_t))
// and at the chunk's end, with m_new = m_{L-1} and B = b_{L-1}:
//   C = exp(B + m_prev - m_new) C + sum_s k_s^T v_s exp(B - b_s + log i_s - m_new)
//   n = the same with v_s replaced by 1.
// q, k, v (B,S,H,P) in f32 or bf16, i_pre and f_pre (B,S,H) f32; h in
// q's type, C (B,H,P,P), n (B,H,P) and m (B,H) f32. Sums in f32.
//
// What bounds it on the H100: at xLSTM-1.3B's prefill (H=4, P=1024,
// chunk L) a head does about 2 S L P (q k^T) + 4 S P^2 (q C_prev and
// the C update) + 2 S L P (W v) operations: ~9.1 GFLOP for the 4 heads
// at S=512, L=64, against ~34 MB moved (bf16 q, k, v and h; f32 C),
// ~270 FLOP per byte, just under the bf16 tensor-core line (~295). One
// head's C is 4 MB, more than a block's 227 KB of shared memory, so C is
// cut by value columns across blocks, and each block has to read all of
// the chunk's q and k (512 MB from L2 at S=512 with 16-column value
// tiles). In practice stage 3 below sets the time; neither a third step
// in flight nor sharing q and k across a cluster of two value tiles by
// TMA multicast made it faster on the card, so L2 bandwidth alone does
// not bound it (each warp also reloads the chunk's wk v fragments from
// shared memory at every step, for lack of registers to keep them).
//
// bf16 (the serving path; P <= 1024, a multiple of 8, and 16-byte aligned
// q, k, v, else the launch is refused): three launches behind one entry
// point, all products on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 accumulate), scratch from the caller.
//  1. mlstm_chunk_kernel, grid (chunk, head, batch): the chunk's gates
//     (b by a warp scan), the stabilizer chain up to it (the chain
//     depends on the gates alone: each block folds the earlier chunks'
//     (m_intra_{L-1}, b_tot) in order, so every block sees the same
//     m_prev), q.k^T once per chunk on the tensor cores, and W with its
//     row sums; W is written as stage 3's B fragments.
//  2. mlstm_norm_kernel, grid (64-key tile, head, batch): n walked once
//     per head (not once per value tile), writing per chunk the partial
//     q.n_prev of its keys; n is not folded into C as an extra column,
//     since with C held in registers (below) one extra row would double
//     stage 3's tile.
//  3. mlstm_value_kernel, grid (value tile of 16 columns, head, batch),
//     16 warps: C^T stays in registers for the whole sequence as the
//     accumulator of its own update (warp w: keys 64w..64w+63, 32 f32 a
//     thread), and the accumulators of two key tiles are directly the A
//     fragment of q C_prev. Each warp streams its own keys of q and k in
//     bf16 with cp.async, two 16-key steps in flight (a third measured no
//     faster: the block is bound by reading q and k from L2), and the
//     warps' partials of q C_prev are summed in a fixed order (run to run
//     identical).
// Precision: every product has one exact bf16 operand (q, k or v); the
// other (C, W, wk v) is f32, split into hi = bf16(x) and lo = bf16(x - hi)
// and run as two products into f32 (~2^-17 relative, inside the state's
// 1e-4; bf16 alone, 2^-9, would not be). q.k^T is exact products summed
// in f32, scaled by 1/sqrt(P) afterwards. Above the diagonal W is
// selected to 0 without taking the exp.
//
// f32 (the f32 logits checks and tests only): the first design,
// CUDA-core FMAs. Grid (value tile of VT=32 columns, head, batch); each
// block keeps its P x 32 slice of C (128 KB at P=1024) and all of n in
// ~203 KB of shared memory for the whole sequence, recomputing the
// chunk's q.k^T, stabilizers and q.n itself; q and k stream through in
// key tiles of 64 rows (f32, rows padded to KT+1 floats); one thread
// computes the cumulative log f. A P above ~1,200 does not fit and fails
// at launch.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int VT = 32;         // value columns of C per block (one per lane)
constexpr int KT = 64;         // rows of C per key tile
constexpr int KTP = KT + 1;    // padded row of the q and k tiles
constexpr int L_MAX = 64;      // chunk length the thread mapping covers
constexpr int WP = L_MAX + 1;  // padded row of W

__host__ __device__ inline size_t smem_floats(int P) {
  return (size_t)P * VT + P + 2 * (size_t)L_MAX * KTP + 2 * (size_t)L_MAX * VT
         + (size_t)L_MAX * WP + 5 * (size_t)L_MAX;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mlstm_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ i_pre,
             const float* __restrict__ f_pre, T* __restrict__ h,
             float* __restrict__ cout, float* __restrict__ nout,
             float* __restrict__ mout, int S, int H, int P, int L,
             float scale) {
  extern __shared__ float smem[];
  float* s_C = smem;                     // [P][VT]   this block's columns
  float* s_n = s_C + (size_t)P * VT;     // [P]
  float* s_q = s_n + P;                  // [L_MAX][KTP]  scaled q tile
  float* s_k = s_q + L_MAX * KTP;        // [L_MAX][KTP]
  float* s_v = s_k + L_MAX * KTP;        // [L_MAX][VT]
  float* s_vw = s_v + L_MAX * VT;        // [L_MAX][VT]   v * update weight
  float* s_W = s_vw + L_MAX * VT;        // [L_MAX][WP]
  float* s_b = s_W + L_MAX * WP;         // [L_MAX] cumulative log f
  float* s_li = s_b + L_MAX;             // [L_MAX] log i (-1e30 padded)
  float* s_m = s_li + L_MAX;             // [L_MAX] row stabilizers
  float* s_inter = s_m + L_MAX;          // [L_MAX] exp(b + m_prev - m)
  float* s_wk = s_inter + L_MAX;         // [L_MAX] update weights

  const int v0 = blockIdx.x * VT, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;        // q.k^T register tile
  const size_t rs = (size_t)H * P;               // stride of one position
  const T* qb = q + (size_t)bb * S * rs + (size_t)hh * P;
  const T* kb = k + (size_t)bb * S * rs + (size_t)hh * P;
  const T* vb = v + (size_t)bb * S * rs + (size_t)hh * P;
  T* hb = h + (size_t)bb * S * rs + (size_t)hh * P;
  const float* ib = i_pre + (size_t)bb * S * H + hh;
  const float* fb = f_pre + (size_t)bb * S * H + hh;
  const bool vok = v0 + lane < P;

  for (int i = tid; i < P * VT; i += THREADS) s_C[i] = 0.f;
  for (int i = tid; i < P; i += THREADS) s_n[i] = 0.f;
  float m_prev = repro::kNegBig;         // the same in every thread

  const int n_chunks = (S + L - 1) / L;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * L;
    // 1. gates of the chunk, and its v tile (rows past L or S are zero)
    if (tid < L_MAX) {
      const bool ok = tid < L && t0 + tid < S;
      const float f = ok ? fb[(size_t)(t0 + tid) * H] : 0.f;
      // log sigmoid(f) = -softplus(-f), in the stable form
      s_b[tid] = ok ? fminf(f, 0.f) - log1pf(expf(-fabsf(f))) : 0.f;
      s_li[tid] = ok ? ib[(size_t)(t0 + tid) * H] : repro::kNegBig;
    }
    for (int i = tid; i < L_MAX * VT; i += THREADS) {
      const int t = i / VT, c = i - t * VT;
      const bool ok = t < L && t0 + t < S && v0 + c < P;
      s_v[i] = ok ? repro::to_f32(vb[(size_t)(t0 + t) * rs + v0 + c]) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float cum = 0.f;
      for (int t = 0; t < L; ++t) {
        cum += s_b[t];
        s_b[t] = cum;
      }
    }
    __syncthreads();
    if (tid < L) {
      const float bt = s_b[tid];
      float mx = bt + m_prev;
      for (int s = 0; s <= tid; ++s) mx = fmaxf(mx, bt - s_b[s] + s_li[s]);
      s_m[tid] = mx;
      s_inter[tid] = expf(bt + m_prev - mx);
    }
    __syncthreads();
    const float btot = s_b[L - 1], m_new = s_m[L - 1];
    const float decay = expf(btot + m_prev - m_new);
    if (tid < L_MAX)
      s_wk[tid] = tid < L ? expf(btot - s_b[tid] + s_li[tid] - m_new) : 0.f;
    __syncthreads();
    for (int i = tid; i < L_MAX * VT; i += THREADS) s_vw[i] = s_v[i] * s_wk[i / VT];

    // 2. q.k^T, q C_prev and q.n_prev over the key tiles, then the
    //    tile's rows of C and n updated in place
    float sacc[4][4], qc[L_MAX / NWARP], qn = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
#pragma unroll
    for (int i = 0; i < L_MAX / NWARP; ++i) qc[i] = 0.f;

    for (int p0 = 0; p0 < P; p0 += KT) {
      const int pn = min(KT, P - p0);
      __syncthreads();                   // previous tile consumed
      for (int i = tid; i < L_MAX * KT; i += THREADS) {
        const int t = i / KT, c = i - t * KT;
        const bool ok = t < L && t0 + t < S && c < pn;
        const size_t g = (size_t)(t0 + t) * rs + p0 + c;
        s_q[t * KTP + c] = ok ? repro::to_f32(qb[g]) * scale : 0.f;
        s_k[t * KTP + c] = ok ? repro::to_f32(kb[g]) : 0.f;
      }
      __syncthreads();
      for (int c = 0; c < pn; ++c) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = s_q[(ty + 16 * i) * KTP + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = s_k[(tx + 16 * j) * KTP + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
        const float cv = s_C[(size_t)(p0 + c) * VT + lane];
#pragma unroll
        for (int i = 0; i < L_MAX / NWARP; ++i)
          qc[i] = fmaf(s_q[(warp + NWARP * i) * KTP + c], cv, qc[i]);
      }
      if (tid < L_MAX)
        for (int c = 0; c < pn; ++c) qn = fmaf(s_q[tid * KTP + c], s_n[p0 + c], qn);
      __syncthreads();                   // C_prev, n_prev of the tile read
      {
        float acc[KT / NWARP];
#pragma unroll
        for (int i = 0; i < KT / NWARP; ++i) acc[i] = 0.f;
        for (int s = 0; s < L; ++s) {
          const float vw = s_vw[s * VT + lane];
#pragma unroll
          for (int i = 0; i < KT / NWARP; ++i)
            acc[i] = fmaf(s_k[s * KTP + warp + NWARP * i], vw, acc[i]);
        }
#pragma unroll
        for (int i = 0; i < KT / NWARP; ++i) {
          const int pl = warp + NWARP * i;
          if (pl < pn) {
            float* cp = s_C + (size_t)(p0 + pl) * VT + lane;
            *cp = fmaf(decay, *cp, acc[i]);
          }
        }
      }
      if (tid < pn) {
        float acc = 0.f;
        for (int s = 0; s < L; ++s) acc = fmaf(s_k[s * KTP + tid], s_wk[s], acc);
        s_n[p0 + tid] = fmaf(decay, s_n[p0 + tid], acc);
      }
    }

    // 3. W_ts = (q_t . k_s) exp(D_ts - m_t) for s <= t < L, else 0
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = tx + 16 * j;
        s_W[t * WP + s] = (s <= t && t < L)
            ? sacc[i][j] * expf(s_b[t] - s_b[s] + s_li[s] - s_m[t]) : 0.f;
      }
    }
    float* s_qn = s_wk;                  // the weights are used up
    __syncthreads();
    if (tid < L_MAX) s_qn[tid] = qn;
    __syncthreads();

    // 4. h_t = (W v + inter q C_prev) / max(|W 1 + inter q.n_prev|, exp(-m))
#pragma unroll
    for (int i = 0; i < L_MAX / NWARP; ++i) {
      const int t = warp + NWARP * i;
      if (t >= L) continue;
      float num = 0.f, den = 0.f;
      for (int s = 0; s <= t; ++s) {
        const float w = s_W[t * WP + s];
        num = fmaf(w, s_v[s * VT + lane], num);
        den += w;
      }
      if (t0 + t < S && vok) {
        const float it = s_inter[t];
        den = fmaxf(fabsf(fmaf(it, s_qn[t], den)), expf(-s_m[t]));
        hb[(size_t)(t0 + t) * rs + v0 + lane] =
            repro::from_f32<T>(fmaf(it, qc[i], num) / den);
      }
    }
    m_prev = m_new;
    __syncthreads();                     // gates and W consumed
  }

  float* cb = cout + ((size_t)bb * H + hh) * P * P;
  for (int i = tid; i < P * VT; i += THREADS) {
    const int p = i / VT, c = i - p * VT;
    if (v0 + c < P) cb[(size_t)p * P + v0 + c] = s_C[i];
  }
  if (blockIdx.x == 0) {
    float* nb = nout + ((size_t)bb * H + hh) * P;
    for (int p = tid; p < P; p += THREADS) nb[p] = s_n[p];
    if (tid == 0) mout[(size_t)bb * H + hh] = m_prev;
  }
}


template <typename T>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                   const float* ip, const float* fp, void* h, float* c,
                   float* n, float* m, int B, int S, int H, int P, int L,
                   float scale, cudaStream_t st) {
  const size_t bytes = smem_floats(P) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_fma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + VT - 1) / VT, H, B);
  mlstm_fma_kernel<T><<<grid, THREADS, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, ip, fp, (T*)h, c, n, m, S, H, P,
      L, scale);
  return cudaGetLastError();
}

// ---- bf16: tensor cores, three stages ---------------------------------

using bf16 = __nv_bfloat16;
constexpr unsigned FULL = 0xffffffffu;
constexpr int P_TC = 1024;          // widest head of the tensor-core path
constexpr int KB = 64;              // keys of a stage-2 block, a stage-3 warp
constexpr int NPART = P_TC / KB;    // partial sums of q.n per position
constexpr int VT3 = 16;             // value columns per block of stage 3
constexpr int WARPS3 = P_TC / KB;   // stage 3: 16 warps cover 1024 keys
constexpr int THREADS3 = 32 * WARPS3;
constexpr int SP1 = KB + 8;         // stage 1's shared row, padded by 16 bytes
constexpr int NRING = 4;            // stages 1 and 2: tiles in shared memory
constexpr size_t SMEM1 = 2 * NRING * L_MAX * SP1 * 2;
constexpr size_t SMEM2 = 2 * NRING * L_MAX * KB * 2;
// Scratch: one record per (batch, head, chunk), in 32-bit words
// (SCRATCH_WORDS in kernels/mlstm_scan.py).
constexpr int OFF_WF = 0;                         // W^T B fragments, hi/lo
constexpr int OFF_INTER = OFF_WF + 8 * 4 * 32 * 4;  // exp(b + m_prev - m)
constexpr int OFF_M = OFF_INTER + L_MAX;          // row stabilizers m_t
constexpr int OFF_RS = OFF_M + L_MAX;             // row sums of W
constexpr int OFF_WK = OFF_RS + L_MAX;            // update weights
constexpr int OFF_MISC = OFF_WK + L_MAX;          // decay, m_new
constexpr int OFF_QN = OFF_MISC + L_MAX;          // [NPART][L_MAX] q.n_prev
constexpr int REC = OFF_QN + NPART * L_MAX;       // 5440
// stage 3's dynamic shared memory
constexpr int STAGE3 = 2 * L_MAX * VT3;           // bf16: one q and one k step
constexpr size_t SMEM3 =
    (size_t)WARPS3 * 2 * STAGE3 * 2               // two steps per warp
    + (size_t)WARPS3 * 8 * 32 * 16                // partials of q C_prev
    + 8 * 32 * 16                                 // W v
    + 4 * 32 * 16 + 4 * 2 * 32 * 16               // v^T, (wk v)^T hi/lo
    + L_MAX * VT3 * 2                             // the v tile
    + 3 * L_MAX * 4 + 16;                         // inter, den, wk, decay

// The gates of one chunk by one warp, lane l holding positions 2l and
// 2l+1: b_t = sum_{s<=t} log f_s (a warp scan), log i_t, and
// pm_t = max_{s<=t} (log i_s - b_s), so that max_{s<=t} D_ts = b_t + pm_t.
// Positions at or past L, or past S, are padded with f = 1, i = -1e30.
struct Gates {
  float b[2], li[2], pm[2];
};

__device__ __forceinline__ Gates chunk_gates(const float* fb, const float* ib,
                                             int H, int S, int t0, int L,
                                             int lane) {
  Gates gt;
  float lf[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = 2 * lane + e;
    const bool ok = t < L && t0 + t < S;
    const float f = ok ? fb[(size_t)(t0 + t) * H] : 0.f;
    lf[e] = ok ? fminf(f, 0.f) - log1pf(expf(-fabsf(f))) : 0.f;
    gt.li[e] = ok ? ib[(size_t)(t0 + t) * H] : repro::kNegBig;
  }
  float x = lf[0] + lf[1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  float ex = __shfl_up_sync(FULL, x, 1);
  if (lane == 0) ex = 0.f;
  gt.b[0] = ex + lf[0];
  gt.b[1] = gt.b[0] + lf[1];
  const float d0 = gt.li[0] - gt.b[0];
  const float d1 = fmaxf(d0, gt.li[1] - gt.b[1]);
  float mx = d1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(FULL, mx, o);
    if (lane >= o) mx = fmaxf(mx, y);
  }
  float pm = __shfl_up_sync(FULL, mx, 1);
  if (lane == 0) pm = -INFINITY;
  gt.pm[0] = fmaxf(pm, d0);
  gt.pm[1] = fmaxf(pm, d1);
  return gt;
}

// Stage 1, grid (chunk, head, batch), 8 warps: the chunk's gates, the
// stabilizer chain up to it, S = q k^T on the tensor cores (warps w and
// w + 4: rows 16w..16w+15 over the even and the odd 64-key slices, key
// tiles up to the diagonal, summed at the end), W = S exp(D - m) below
// the diagonal, written as stage 3's B fragments (hi/lo), and the
// per-position scalars of the chunk.
constexpr int THREADS1 = 256;
__global__ void __launch_bounds__(THREADS1)
mlstm_chunk_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const float* __restrict__ i_pre,
                   const float* __restrict__ f_pre, float* __restrict__ scratch,
                   float* __restrict__ mout, int S, int H, int P, int L,
                   float scale) {
  extern __shared__ __align__(128) unsigned char smem1[];
  bf16* qs = reinterpret_cast<bf16*>(smem1);       // [NRING][L_MAX][SP1]
  bf16* ks = qs + NRING * L_MAX * SP1;             // [NRING][L_MAX][SP1]
  __shared__ float s_b[L_MAX], s_li[L_MAX], s_m[L_MAX];
  __shared__ float s_sum[8][2];
  __shared__ float s_mprev;

  const int ci = blockIdx.x, nc = gridDim.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp >> 2, wr = warp & 3;       // slice group, row block
  const int g = lane >> 2, c4 = lane & 3;
  const int t0 = ci * L;
  const size_t rs = (size_t)H * P;
  const bf16* qb = q + (size_t)bb * S * rs + (size_t)hh * P;
  const bf16* kb = k + (size_t)bb * S * rs + (size_t)hh * P;
  const float* ib = i_pre + (size_t)bb * S * H + hh;
  const float* fb = f_pre + (size_t)bb * S * H + hh;
  float* rec = scratch + (((size_t)bb * H + hh) * nc + ci) * REC;

  // q and k of the chunk, 64 keys a slice, two slices (one per group) at
  // a time through a ring of NRING slices (rows past L or S and keys past
  // P zero-filled; one commit group per pair, empty past the last)
  const int ns = (P + KB - 1) / KB, npairs = (ns + 1) / 2;
  auto load_pair = [&](int j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int sl = 2 * j + e;
      if (sl < ns) {
        const int p0 = sl * KB;
        bf16* qd = qs + (sl % NRING) * L_MAX * SP1;
        bf16* kd = ks + (sl % NRING) * L_MAX * SP1;
        for (int i = tid; i < L_MAX * 8; i += THREADS1) {
          const int t = i >> 3, col = (i & 7) * 8;
          const bool ok = t < L && t0 + t < S && p0 + col < P;
          const size_t go = ok ? (size_t)(t0 + t) * rs + p0 + col : 0;
          repro::cp_async16(qd + t * SP1 + col, qb + go, ok);
          repro::cp_async16(kd + t * SP1 + col, kb + go, ok);
        }
      }
    }
    repro::cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < NRING / 2 - 1; ++i) load_pair(i);

  // m_prev: m_end(c) = max(m_intra_{L-1}(c), b_tot(c) + m_end(c-1)) over
  // the earlier chunks, eight at a time, one per warp, folded in order
  float m_run = repro::kNegBig;          // kept by thread 0
  const int ll = (L - 1) >> 1, le = (L - 1) & 1;
  for (int r = 0; r < ci; r += 8) {
    if (r + warp < ci) {
      const Gates gt = chunk_gates(fb, ib, H, S, (r + warp) * L, L, lane);
      const float bt = __shfl_sync(FULL, le ? gt.b[1] : gt.b[0], ll);
      const float pm = __shfl_sync(FULL, le ? gt.pm[1] : gt.pm[0], ll);
      if (lane == 0) {
        s_sum[warp][0] = bt + pm;
        s_sum[warp][1] = bt;
      }
    }
    __syncthreads();
    if (tid == 0)
      for (int w = 0; w < 8 && r + w < ci; ++w)
        m_run = fmaxf(s_sum[w][0], s_sum[w][1] + m_run);
    __syncthreads();
  }
  if (warp == 0) {
    const Gates gt = chunk_gates(fb, ib, H, S, t0, L, lane);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s_b[2 * lane + e] = gt.b[e];
      s_li[2 * lane + e] = gt.li[e];
      s_m[2 * lane + e] = gt.pm[e];
    }
  }
  if (tid == 0) s_mprev = m_run;
  __syncthreads();
  const float m_prev = s_mprev;
  if (tid < L_MAX)                       // m_t = max(b_t + pm_t, b_t + m_prev)
    s_m[tid] = fmaxf(s_b[tid] + s_m[tid], s_b[tid] + m_prev);

  // S = q k^T, f32 accumulators (synced with s_m by the loop's barrier)
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int j = 0; j < npairs; ++j) {
    load_pair(j + NRING / 2 - 1);
    repro::cp_async_wait<NRING / 2 - 1>();   // pair j arrived
    __syncthreads();
    const int sl = 2 * j + grp;
    if (sl < ns) {
      const bf16* qsl = qs + (sl % NRING) * L_MAX * SP1;
      const bf16* ksl = ks + (sl % NRING) * L_MAX * SP1;
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk) {
        uint32_t a[4];
        repro::ldmatrix_x4(a, qsl + (wr * 16 + (lane & 15)) * SP1 +
                                  kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np <= wr) {                // key tiles at or below the diagonal
            uint32_t bk[4];
            repro::ldmatrix_x4(bk, ksl + (np * 16 + (lane & 7) +
                                          ((lane >> 4) << 3)) * SP1 +
                                       kk * 16 + ((lane >> 3) & 1) * 8);
            repro::mma_bf16(acc[2 * np], a, bk[0], bk[1]);
            repro::mma_bf16(acc[2 * np + 1], a, bk[2], bk[3]);
          }
        }
      }
    }
    __syncthreads();
  }
  // the odd slices' sums join the even ones' (the ring is free now)
  float* xb = reinterpret_cast<float*>(smem1) + wr * 32 + lane;  // [32][128]
  if (grp == 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) xb[(4 * j + e) * 128] = acc[j][e];
  }
  __syncthreads();
  if (grp == 1) return;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += xb[(4 * j + e) * 128];

  // W_ts = (scale q_t . k_s) exp(D_ts - m_t) for s <= t < L, else 0 (the
  // exp is never taken above the diagonal); its row sums
  const int ta = wr * 16 + g, tb = ta + 8;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = e < 2 ? ta : tb, s = 8 * j + 2 * c4 + (e & 1);
      acc[j][e] = (s <= t && t < L)
          ? acc[j][e] * scale * expf(s_b[t] - s_b[s] + s_li[s] - s_m[t])
          : 0.f;
    }
    rs0 += acc[j][0] + acc[j][1];
    rs1 += acc[j][2] + acc[j][3];
  }
  rs0 += __shfl_xor_sync(FULL, rs0, 1);
  rs0 += __shfl_xor_sync(FULL, rs0, 2);
  rs1 += __shfl_xor_sync(FULL, rs1, 1);
  rs1 += __shfl_xor_sync(FULL, rs1, 2);
  if (c4 == 0) {
    rec[OFF_RS + ta] = rs0;
    rec[OFF_RS + tb] = rs1;
  }
  // stage 3 reads W^T as B[s][t]: for its t n-tile 2wr (rows ta) and
  // k-step sk, b0 = this lane's (c0, c1) of key tile 2sk and b1 those of
  // 2sk+1; n-tile 2wr+1 (rows tb) takes (c2, c3)
  uint4* wf = reinterpret_cast<uint4*>(rec + OFF_WF);
#pragma unroll
  for (int sk = 0; sk < 4; ++sk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int e = 2 * half;
      uint32_t h0, l0, h1, l1;
      repro::split_bf16(acc[2 * sk][e], acc[2 * sk][e + 1], h0, l0);
      repro::split_bf16(acc[2 * sk + 1][e], acc[2 * sk + 1][e + 1], h1, l1);
      wf[((2 * wr + half) * 4 + sk) * 32 + lane] = make_uint4(h0, h1, l0, l1);
    }
  }
  const float btot = s_b[L - 1], m_new = s_m[L - 1];
  if (tid < L_MAX) {
    const int t = tid;
    rec[OFF_INTER + t] = t < L ? expf(s_b[t] + m_prev - s_m[t]) : 0.f;
    rec[OFF_M + t] = s_m[t];
    rec[OFF_WK + t] = t < L ? expf(btot - s_b[t] + s_li[t] - m_new) : 0.f;
  }
  if (tid == 0) {
    rec[OFF_MISC] = expf(btot + m_prev - m_new);   // decay of C and n
    rec[OFF_MISC + 1] = m_new;
    if (ci == nc - 1) mout[(size_t)bb * H + hh] = m_new;
  }
}

// Stage 2, grid (64-key tile, head, batch), 4 warps: the normalizer n,
// walked over the chunks once per head. Per chunk: the partial q_t . n_prev
// over this tile's keys (stage 3 sums the tiles in order), then
// n = decay n + sum_s wk_s k_s. q and k tiles double-buffered with cp.async.
__global__ void __launch_bounds__(128)
mlstm_norm_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  float* __restrict__ scratch, float* __restrict__ nout, int S,
                  int H, int P, int L) {
  extern __shared__ __align__(128) unsigned char smem2[];
  bf16* qs = reinterpret_cast<bf16*>(smem2);       // [NRING][L_MAX][KB]
  bf16* ks = qs + NRING * L_MAX * KB;              // [NRING][L_MAX][KB]
  __shared__ __align__(16) float s_n[KB];
  __shared__ float s_wk[L_MAX];

  const int pt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x;
  const int p0 = pt * KB, nc = (S + L - 1) / L;
  const size_t rs = (size_t)H * P;
  const bf16* qb = q + (size_t)bb * S * rs + (size_t)hh * P;
  const bf16* kb = k + (size_t)bb * S * rs + (size_t)hh * P;
  float* rec0 = scratch + ((size_t)bb * H + hh) * nc * REC;

  // the tiles of chunk c, in a ring of NRING chunks
  auto load = [&](int c) {
    if (c < nc) {
      const int t0 = c * L;
      bf16* qd = qs + (c % NRING) * L_MAX * KB;
      bf16* kd = ks + (c % NRING) * L_MAX * KB;
      for (int i = tid; i < L_MAX * 8; i += 128) {
        const int t = i >> 3, col = (i & 7) * 8;
        const bool ok = t < L && t0 + t < S && p0 + col < P;
        const size_t go = ok ? (size_t)(t0 + t) * rs + p0 + col : 0;
        repro::cp_async16(qd + t * KB + col, qb + go, ok);
        repro::cp_async16(kd + t * KB + col, kb + go, ok);
      }
    }
    repro::cp_async_commit();
  };
  // threads 0-63: q_t . n_prev for position t; threads 64-127: the n
  // update of key p0 + tid - 64, kept in a register and published to s_n
  // after every q_t . n_prev of the chunk has been read
  float nv = 0.f;
  if (tid < KB) s_n[tid] = 0.f;
#pragma unroll
  for (int i = 0; i < NRING - 1; ++i) load(i);
  for (int c = 0; c < nc; ++c) {
    float* rec = rec0 + (size_t)c * REC;
    load(c + NRING - 1);
    if (tid < L_MAX) s_wk[tid] = rec[OFF_WK + tid];
    repro::cp_async_wait<NRING - 1>();   // chunk c arrived
    __syncthreads();                     // and n_prev published
    const bf16* qc = qs + (c % NRING) * L_MAX * KB;
    const bf16* kc = ks + (c % NRING) * L_MAX * KB;
    float a = 0.f;
    if (tid < L_MAX) {
      // pairs of keys in an order rotated by t: the 32 lanes of a warp
      // read 32 different banks of their rows
#pragma unroll 8
      for (int j = 0; j < KB / 2; ++j) {
        const int pp = (j + tid) & (KB / 2 - 1);
        const __nv_bfloat162 qq =
            *reinterpret_cast<const __nv_bfloat162*>(qc + tid * KB + 2 * pp);
        const float2 nn = *reinterpret_cast<const float2*>(s_n + 2 * pp);
        a = fmaf(__low2float(qq), nn.x, a);
        a = fmaf(__high2float(qq), nn.y, a);
      }
      rec[OFF_QN + pt * L_MAX + tid] = a;
    } else {
      for (int s = 0; s < L; ++s)
        a = fmaf(__bfloat162float(kc[s * KB + tid - L_MAX]), s_wk[s], a);
    }
    __syncthreads();                     // n_prev read, chunk c's tiles used
    if (tid >= L_MAX) {
      nv = fmaf(rec[OFF_MISC], nv, a);
      s_n[tid - L_MAX] = nv;
    }
  }
  if (tid >= L_MAX && p0 + tid - L_MAX < P)
    nout[((size_t)bb * H + hh) * P + p0 + tid - L_MAX] = nv;
}

// A step of stage 3 is a [64][16] bf16 tile; its two 16-byte halves are
// swapped on rows 4-7 of every 8 so ldmatrix's 8 rows hit distinct banks.
__device__ __forceinline__ int swz(int row, int half) {
  return row * 16 + ((half ^ ((row >> 2) & 1)) << 3);
}

// Stage 3, grid (value tile of 16 columns, head, batch), 16 warps: the
// walk over chunks. C^T (16 values x P keys) lives in registers as the
// accumulator of its own update: warp w holds keys 64w..64w+63. Per chunk,
// warp w streams its keys of q and k in steps of 16 (cp.async, two steps
// in flight, synchronised within the warp only) and computes
//   (a) (q C_prev)^T += C_prev^T q^T, C split hi/lo from its accumulators;
//   (c) C^T = decay C^T + (wk v)^T k, wk v split hi/lo;
// then its partial of (a) goes to shared memory, warps 0-7 compute
// (W v)^T for one 8-position tile each (W^T hi/lo from stage 1, v exact),
// and the block sums the 16 partials in order and writes
//   h_t = (W v + inter_t scale q_t C_prev) / den_t.
__global__ void __launch_bounds__(THREADS3, 1)
mlstm_value_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ scratch,
                   bf16* __restrict__ h, float* __restrict__ cout, int S, int H,
                   int P, int L, float scale) {
  extern __shared__ __align__(128) unsigned char smem3[];
  bf16* stages = reinterpret_cast<bf16*>(smem3);              // [warp][2][q|k]
  float4* part = reinterpret_cast<float4*>(stages + WARPS3 * 2 * STAGE3);
  float4* wv = part + WARPS3 * 8 * 32;                         // [8][32]
  uint4* vtf = reinterpret_cast<uint4*>(wv + 8 * 32);          // [4][32]
  uint4* vwf = vtf + 4 * 32;                                   // [4][2][32]
  bf16* s_v = reinterpret_cast<bf16*>(vwf + 4 * 2 * 32);       // [64][16]
  float* s_iq = reinterpret_cast<float*>(s_v + L_MAX * VT3);   // inter scale
  float* s_den = s_iq + L_MAX;
  float* s_wk = s_den + L_MAX;
  float* s_decay = s_wk + L_MAX;

  const int v0 = blockIdx.x * VT3, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c4 = lane & 3;
  const int nc = (S + L - 1) / L, npart = (P + KB - 1) / KB;
  const size_t rs = (size_t)H * P;
  const bf16* qb = q + (size_t)bb * S * rs + (size_t)hh * P;
  const bf16* kb = k + (size_t)bb * S * rs + (size_t)hh * P;
  const bf16* vb = v + (size_t)bb * S * rs + (size_t)hh * P;
  bf16* hb = h + (size_t)bb * S * rs + (size_t)hh * P;
  const float* rec0 = scratch + ((size_t)bb * H + hh) * nc * REC;
  const int kbase = warp * KB;                    // this warp's keys
  const int nkk = max(0, min(KB / 16, (P - kbase + 15) / 16));
  const int total = nc * nkk;                     // this warp's steps
  bf16* wst = stages + warp * 2 * STAGE3;

  // The step of chunk c and keys kbase + 16 kk into buffer i & 1 (i =
  // c nkk + kk): lane l copies half l & 1 of rows l / 2 + 16 j, j < 4, of
  // q and of k, so its offsets are fixed but for the step's base.
  const int lhalf = lane & 1, lrow = lane >> 1;
  const int lane_go = lrow * H * P + lhalf * 8;   // S H P < 2^31 (wrapper)
  const int lane_so = swz(lrow, lhalf);           // + 256 j for row + 16 j
  auto issue = [&](int i, int c, int kk) {
    const int t0 = c * L, pk = kbase + kk * 16;
    const int rows = min(L, S - t0);               // rows of the chunk
    const bool key_ok = pk + lhalf * 8 < P;
    const int go = t0 * H * P + pk + lane_go;
    bf16* qst = wst + (i & 1) * STAGE3 + lane_so;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = key_ok && lrow + 16 * j < rows;
      const int gj = ok ? go + 16 * j * H * P : 0;
      repro::cp_async16(qst + 256 * j, qb + gj, ok);
      repro::cp_async16(qst + L_MAX * VT3 + 256 * j, kb + gj, ok);
    }
  };
  if (nkk > 0) {
    issue(0, 0, 0);
    repro::cp_async_commit();
  }

  float C[8][4];                                  // C^T: (values, keys)
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) C[j][e] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L;
    const float* rec = rec0 + (size_t)c * REC;
    __syncthreads();                              // last chunk's sums read
    if (tid < 128) {                              // the v tile, zero-padded
      const int row = tid >> 1, half = tid & 1;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (row < L && t0 + row < S && v0 + half * 8 < P)
        raw = *reinterpret_cast<const uint4*>(vb + (size_t)(t0 + row) * rs +
                                              v0 + half * 8);
      *reinterpret_cast<uint4*>(s_v + row * VT3 + half * 8) = raw;
    } else if (tid < 128 + L_MAX) {               // per-position scalars
      const int t = tid - 128;
      float iq = 0.f, den = 1.f, wk = 0.f;
      if (t < L) {
        float qn = 0.f;
        for (int p = 0; p < npart; ++p) qn += rec[OFF_QN + p * L_MAX + t];
        iq = rec[OFF_INTER + t] * scale;
        den = fmaxf(fabsf(rec[OFF_RS + t] + iq * qn), expf(-rec[OFF_M + t]));
        wk = rec[OFF_WK + t];
      }
      s_iq[t] = iq;
      s_den[t] = den;
      s_wk[t] = wk;
    } else if (tid == 128 + L_MAX) {
      *s_decay = rec[OFF_MISC];
    }
    __syncthreads();
    if (tid < 128) {                  // A fragments of v^T and (wk v)^T
      const int sk = tid >> 5, s0 = 16 * sk + 2 * c4;
      uint32_t a[4], hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int vr = g + 8 * (r & 1), s = s0 + 8 * (r >> 1);
        const bf16 x0 = s_v[s * VT3 + vr], x1 = s_v[(s + 1) * VT3 + vr];
        a[r] = (uint32_t)__bfloat16_as_ushort(x0) |
               ((uint32_t)__bfloat16_as_ushort(x1) << 16);
        repro::split_bf16(__bfloat162float(x0) * s_wk[s],
                          __bfloat162float(x1) * s_wk[s + 1], hi[r], lo[r]);
      }
      vtf[sk * 32 + lane] = make_uint4(a[0], a[1], a[2], a[3]);
      vwf[(2 * sk) * 32 + lane] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      vwf[(2 * sk + 1) * 32 + lane] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    __syncthreads();

    const float decay = *s_decay;
    float acc[8][4];                              // (q C_prev)^T: (values, t)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk) {
      if (kk < nkk) {
        const int i = c * nkk + kk;
        if (i + 1 < total) {                      // the next step's copy
          if (kk + 1 < nkk)
            issue(i + 1, c, kk + 1);
          else
            issue(i + 1, c + 1, 0);
          repro::cp_async_commit();
          repro::cp_async_wait<1>();
        } else {
          repro::cp_async_wait<0>();
        }
        __syncwarp();
        const bf16* qst = wst + (i & 1) * STAGE3;
        const bf16* kst = qst + L_MAX * VT3;
        // (a) with C_prev of keys 16kk..16kk+15 as A, hi and lo
        uint32_t ah[4], al[4];
        repro::split_bf16(C[2 * kk][0], C[2 * kk][1], ah[0], al[0]);
        repro::split_bf16(C[2 * kk][2], C[2 * kk][3], ah[1], al[1]);
        repro::split_bf16(C[2 * kk + 1][0], C[2 * kk + 1][1], ah[2], al[2]);
        repro::split_bf16(C[2 * kk + 1][2], C[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bq[4];
          repro::ldmatrix_x4(bq, qst + swz(np * 16 + (lane & 7) +
                                               ((lane >> 4) << 3),
                                           (lane >> 3) & 1));
          repro::mma_bf16(acc[2 * np], ah, bq[0], bq[1]);
          repro::mma_bf16(acc[2 * np], al, bq[0], bq[1]);
          repro::mma_bf16(acc[2 * np + 1], ah, bq[2], bq[3]);
          repro::mma_bf16(acc[2 * np + 1], al, bq[2], bq[3]);
        }
        // (c) the update of the same keys
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          C[2 * kk][e] *= decay;
          C[2 * kk + 1][e] *= decay;
        }
#pragma unroll
        for (int sk = 0; sk < 4; ++sk) {
          uint32_t bk[4];
          repro::ldmatrix_x4_trans(bk, kst + swz(sk * 16 + (lane & 15),
                                                 lane >> 4));
          const uint4 h4 = vwf[(2 * sk) * 32 + lane];
          const uint4 l4 = vwf[(2 * sk + 1) * 32 + lane];
          const uint32_t hv[4] = {h4.x, h4.y, h4.z, h4.w};
          const uint32_t lv[4] = {l4.x, l4.y, l4.z, l4.w};
          repro::mma_bf16(C[2 * kk], hv, bk[0], bk[1]);
          repro::mma_bf16(C[2 * kk], lv, bk[0], bk[1]);
          repro::mma_bf16(C[2 * kk + 1], hv, bk[2], bk[3]);
          repro::mma_bf16(C[2 * kk + 1], lv, bk[2], bk[3]);
        }
        __syncwarp();                             // buffer i & 1 read
      }
    }

    float4* pw = part + warp * 8 * 32;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      pw[j * 32 + lane] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    if (warp < 8) {                               // (W v)^T, positions 8w..
      const uint4* wf = reinterpret_cast<const uint4*>(rec + OFF_WF) +
                        warp * 4 * 32;
      float o4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int sk = 0; sk < 4; ++sk) {
        const uint4 b = wf[sk * 32 + lane];
        const uint4 a4 = vtf[sk * 32 + lane];
        const uint32_t a[4] = {a4.x, a4.y, a4.z, a4.w};
        repro::mma_bf16(o4, a, b.x, b.y);
        repro::mma_bf16(o4, a, b.z, b.w);
      }
      wv[warp * 32 + lane] = make_float4(o4[0], o4[1], o4[2], o4[3]);
    }
    __syncthreads();
    if (tid < 256) {                  // position tile tid / 32, in order
      const int nt = tid >> 5;
      float r[4] = {0.f, 0.f, 0.f, 0.f};
      for (int w = 0; w < WARPS3; ++w) {
        const float4 x = part[(w * 8 + nt) * 32 + lane];
        r[0] += x.x; r[1] += x.y; r[2] += x.z; r[3] += x.w;
      }
      const float4 wv4 = wv[nt * 32 + lane];
      const float wvv[4] = {wv4.x, wv4.y, wv4.z, wv4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int vr = g + 8 * (e >> 1), t = nt * 8 + 2 * c4 + (e & 1);
        if (t < L && t0 + t < S && v0 + vr < P)
          hb[(size_t)(t0 + t) * rs + v0 + vr] =
              __float2bfloat16((wvv[e] + s_iq[t] * r[e]) / s_den[t]);
      }
    }
  }

  float* cb = cout + ((size_t)bb * H + hh) * P * P;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = kbase + 8 * j + 2 * c4 + (e & 1), vr = v0 + g + 8 * (e >> 1);
      if (p < P && vr < P) cb[(size_t)p * P + vr] = C[j][e];
    }
}

cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const float* ip, const float* fp, void* h, float* c,
                      float* n, float* m, float* scratch, int B, int S, int H,
                      int P, int L, float scale, cudaStream_t st) {
  const int nc = (S + L - 1) / L;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM1);
  if (err != cudaSuccess) return err;
  mlstm_chunk_kernel<<<dim3(nc, H, B), THREADS1, SMEM1, st>>>(
      (const bf16*)q, (const bf16*)k, ip, fp, scratch, m, S, H, P, L, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mlstm_norm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM2);
  if (err != cudaSuccess) return err;
  mlstm_norm_kernel<<<dim3((P + KB - 1) / KB, H, B), 128, SMEM2, st>>>(
      (const bf16*)q, (const bf16*)k, scratch, n, S, H, P, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mlstm_value_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM3);
  if (err != cudaSuccess) return err;
  mlstm_value_kernel<<<dim3((P + VT3 - 1) / VT3, H, B), THREADS3, SMEM3, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, scratch, (bf16*)h, c, S,
      H, P, L, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 = launched). All arrays are
// contiguous on one device; dtype 0 = float32, 1 = bfloat16 for q, k, v
// and h. L (the chunk length, <= S) must be in [1, 64]; n is written as
// (B, H, P). scale is q's factor, 1/sqrt(P). scratch holds
// B * H * ceil(S / L) records of REC floats (the tensor-core path only).
extern "C" int mlstm_scan(const void* q, const void* k, const void* v,
                          const void* i_pre, const void* f_pre, void* h,
                          void* c, void* n, void* m, void* scratch, int B,
                          int S, int H, int P, int L, float scale, int dtype,
                          void* stream) {
  if (L < 1 || L > L_MAX || L > S || P < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ip = static_cast<const float*>(i_pre);
  const float* fp = static_cast<const float*>(f_pre);
  float* cf = static_cast<float*>(c);
  float* nf = static_cast<float*>(n);
  float* mf = static_cast<float*>(m);
  if (dtype == 1) {
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
          reinterpret_cast<uintptr_t>(v)) & 15) == 0;
    if (P > P_TC || P % 8 || !aligned) return (int)cudaErrorInvalidValue;
    return (int)launch_tc(q, k, v, ip, fp, h, cf, nf, mf,
                          static_cast<float*>(scratch), B, S, H, P, L, scale,
                          st);
  }
  return (int)launch_fma<float>(q, k, v, ip, fp, h, cf, nf, mf, B, S, H, P,
                                L, scale, st);
}
