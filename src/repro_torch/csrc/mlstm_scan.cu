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
// q's type, C (B,H,P,P), n (B,H,P) and m (B,H) f32. Math in f32.
//
// What bounds it on the H100: at xLSTM-1.3B's prefill (H=4, P=1024,
// chunk L) a head does about 2 S L P (q k^T) + 4 S P^2 (q C_prev and
// the C update) + 2 S L P (W v) operations: ~9.1 GFLOP for the 4 heads
// at S=512, L=64, against ~34 MB moved (bf16 q, k, v and h; f32 C),
// ~270 FLOP per byte, just under the bf16 tensor-core line (~295).
// This kernel runs f32 FMAs on the CUDA cores, fed from shared memory,
// far from that bound.
//
// Design. The TPU walks the chunks of one (b, h) in order on one core
// with all of C in VMEM; one head's C is 4 MB here, more than a block's
// 227 KB of shared memory. The value columns of C are independent
// (column v of h needs only column v of C and of v, plus the
// head-wide q.k^T, stabilizers and denominator), so the grid is
// (value tile of VT=32 columns, head, batch): 128 blocks for one
// full-width prompt. Each block keeps its 1024 x 32 f32 slice of C
// (128 KB) and all of n in shared memory for the whole sequence and
// walks the chunks in a loop. The price: every value tile computes the
// chunk's q.k^T, stabilizers and q.n itself (the q.k^T product is about
// half of a block's FMAs at L=64). Per chunk, with 256 threads:
//   1. gates: log f, log i (padded tail), the cumulative b by one thread,
//      then m_t, the inter-chunk scale and the update weights;
//   2. over key tiles of KT=64 rows of C: load the q and k tile (L x KT,
//      f32, rows padded to KT+1 floats so column reads fall in distinct
//      banks), accumulate q.k^T (4x4 register tile per thread), q C_prev
//      (8 rows per thread, a lane per value column) and q.n_prev, then
//      update this tile's rows of C and n in place;
//   3. W from the q.k^T registers: entries with s > t are selected to 0
//      and their exp is never taken;
//   4. h = (W v + inter q C_prev) / max(|den|, exp(-m)).
// C and n start at zero (the first chunk's decay is exp(-1e30) = 0, and
// 0 times uninitialised memory could be NaN). Shared memory at P=1024:
// C 128 KB, n 4 KB, q and k tiles 33 KB, v twice 16 KB, W 16.6 KB:
// ~203 KB, dynamic, one block per SM. Tensor-core products (mma.sync,
// then wgmma) and one q.k^T shared by the value tiles are later work.
#include "common.cuh"

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
mlstm_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ip, const float* fp, void* h, float* c,
                   float* n, float* m, int B, int S, int H, int P, int L,
                   float scale, cudaStream_t st) {
  const size_t bytes = smem_floats(P) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + VT - 1) / VT, H, B);
  mlstm_kernel<T><<<grid, THREADS, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, ip, fp, (T*)h, c, n, m, S, H, P,
      L, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 = launched). All arrays are
// contiguous on one device; dtype 0 = float32, 1 = bfloat16 for q, k, v
// and h. L (the chunk length, <= S) must be in [1, 64]; n is written as
// (B, H, P). scale is q's factor, 1/sqrt(P).
extern "C" int mlstm_scan(const void* q, const void* k, const void* v,
                          const void* i_pre, const void* f_pre, void* h,
                          void* c, void* n, void* m, int B, int S, int H,
                          int P, int L, float scale, int dtype, void* stream) {
  if (L < 1 || L > L_MAX || L > S || P < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ip = static_cast<const float*>(i_pre);
  const float* fp = static_cast<const float*>(f_pre);
  float* cf = static_cast<float*>(c);
  float* nf = static_cast<float*>(n);
  float* mf = static_cast<float*>(m);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, ip, fp, h, cf, nf, mf, B, S, H,
                                      P, L, scale, st);
  return (int)launch<float>(q, k, v, ip, fp, h, cf, nf, mf, B, S, H, P, L,
                            scale, st);
}
