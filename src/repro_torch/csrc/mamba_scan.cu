// Mamba-2 SSD chunked scan for Hopper, sm_90a. Plain C entry point,
// loaded with ctypes by repro_torch/kernels/_build.py.
//
// Replaces the Pallas TPU kernel repro/kernels/mamba_scan.py
// ::mamba_chunk_scan (_ssd_kernel). Per (batch b, head h), with
// a = -exp(a_log[h]) and the sequence cut into chunks of L positions
// (the ragged last chunk masked as zero dt and zero data):
//   cum_t = sum_{s<=t} a*dt_s                         (within the chunk)
//   y_t   = sum_{s<=t} exp(cum_t - cum_s) (c_t . b_s) dt_s x_s
//         + exp(cum_t) c_t . h_prev^T
//   h     = exp(cum_L) h_prev + sum_s x_s^T (b_s dt_s exp(cum_L - cum_s))
// x (B,S,H,P) and b, c (B,S,N) in f32 or bf16, dt (B,S,H) and a_log (H,)
// in f32; y (B,S,H,P) in x's type, h_final (B,H,P,N) in f32. Sums in f32.
//
// What bounds it on the H100: its bytes. At Zamba2-1.2B's prefill (H=64,
// P=N=64, L=128, S=512, bf16) x, b, c, dt and y with the f32 final state
// are 9.70 MB, 2.90 us at 3.35 TB/s, against 1.61 GFLOP, 1.6 us at the
// bf16 tensor-core peak (and 24 us on f32 CUDA cores).
//
// bf16 (the serving path; N <= 128, else the launch is refused): the SSD
// state-passing form in three launches behind one entry point, every
// product on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate), scratch from the caller. No block walks the chunks of a
// prompt: chunks run in parallel, and only the state pass, elementwise,
// is sequential over them. Stages 2 and 3 are launched as programmatic
// dependents (griddepcontrol): each starts while the one before runs and
// loads its own inputs before it waits for that one's results.
//  1. ssd_chunk_kernel, grid (chunk, role, batch): role H * npt computes
//     G = c b^T of the chunk once for all heads (rows t of warp w =
//     16w.., column tiles up to the diagonal); the other roles, one per
//     (head, 64-row tile of p), the chunk's contribution to the state
//     U = x^T (b w), w_s = dt_s exp(cum_L - cum_s), and its decay
//     exp(cum_L). Each block forms its head's cum by a warp scan, in log2
//     units, so that every decay is one MUFU.EX2.
//  2. ssd_state_kernel, grid (P*N / 1024, head, batch): a thread per four
//     state elements walks the chunks, h = exp(cum_L) h + U, storing the
//     state entering each chunk in place of U, and writes h_final.
//  3. ssd_out_kernel, grid (chunk x p-tile, head, batch): warp w computes
//     c h_in^T for rows t = 16w..16w+15 (k over n), scaled by exp(cum_t)
//     in the accumulators, then M x with M_ts = exp(cum_t - cum_s) G_ts
//     dt_s built from G (read from L2 in the A-fragment pattern) for the
//     column tiles up to the diagonal; above it M is selected to 0 and its
//     exp never taken. Strip w has w + 1 such tiles, so the tiles of the
//     long strips past the midpoint go to the warps of the short ones and
//     their sums meet in shared memory (at most 5 tiles a warp, not 8).
// Precision: c, b and x are exact bf16, so G is exact products summed in
// f32; the f32 operands (M, b w, h_in) are split into hi = bf16(v) and
// lo = bf16(v - hi) and run as two products into f32 (~2^-17 relative),
// as in mlstm_scan.cu. Tiles are zero-padded in shared memory: L to a
// multiple of 16 rows, N to 16 columns, p to 64; shared rows are padded
// by 16 bytes so that ldmatrix's eight rows hit distinct banks.
// Measured on the card (PERF.md): the hi/lo pairs double the
// mma.sync work, and the products of stage 3 run at about the mma.sync
// issue rate; the rest is the load latency of each stage's prologue.
//
// f32 (the f32 logits checks and tests only): the first design, CUDA-core
// FMAs. The grid is (P-tile of PT=32 rows, head, batch) and one block
// walks the chunks of its (b, h) in order, keeping its slice of h in
// shared memory. Per chunk, with 256 threads:
//   1. load b, c (L x N), the x tile (L x PT) and dt into shared f32,
//      zeroing positions past S;
//   2. one thread forms the cumulative log-decays in order;
//   3. the L x L decay-masked matrix M, 8x8 entries per thread from a
//      register tile over n; entries with s > t are selected to 0 and
//      their exp is never taken (exp(cum_t - cum_s) overflows there);
//   4. y = M x + exp(cum) (c h^T), one warp per 16 rows t, a lane per p;
//   5. b is scaled by dt exp(cum_L - cum) in place, then h is updated.
// Shared memory at L=128, N=64: b and c 2 x 33 KB, M 74 KB, x 16 KB,
// h 8 KB: ~167 KB, dynamic, one block per SM; a larger N does not fit and
// the launch fails. Rows of b, c and h are padded to N+1 floats and rows
// of M to 16 mod 32 so that the strided reads of each step fall in
// distinct banks.
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int PT = 32;        // state rows (p) per block
constexpr int L_MAX = 128;    // chunk length the thread mapping covers
constexpr int MT = 8;         // M register tile: MT x MT per thread

__host__ __device__ inline int m_stride(int L) { return ((L + 31) / 32) * 32 + 16; }

__host__ __device__ inline size_t smem_floats(int L, int N) {
  const int NP = N + 1;
  return (size_t)2 * L * NP + (size_t)L * m_stride(L) + (size_t)L * PT
         + (size_t)PT * NP + 4 * (size_t)L;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a_log, const T* __restrict__ bm,
           const T* __restrict__ cm, T* __restrict__ y,
           float* __restrict__ hout, int S, int H, int P, int N, int L) {
  extern __shared__ float smem[];
  const int NP = N + 1, MS = m_stride(L);
  float* s_b = smem;                    // [L][NP]
  float* s_c = s_b + L * NP;            // [L][NP]
  float* s_M = s_c + L * NP;            // [L][MS]
  float* s_x = s_M + L * MS;            // [L][PT]
  float* s_h = s_x + L * PT;            // [PT][NP]
  float* s_dt = s_h + PT * NP;          // [L]
  float* s_cum = s_dt + L;
  float* s_ecum = s_cum + L;
  float* s_w = s_ecum + L;

  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float a = -expf(a_log[h]);
  for (int i = tid; i < PT * NP; i += THREADS) s_h[i] = 0.f;

  const int n_chunks = (S + L - 1) / L;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * L;
    // 1. loads, zero past the end of the sequence (and past P)
    for (int i = tid; i < L * N; i += THREADS) {
      const int t = i / N, n = i - t * N;
      const bool ok = t0 + t < S;
      const size_t g = ((size_t)b * S + t0 + t) * N + n;
      s_b[t * NP + n] = ok ? repro::to_f32(bm[g]) : 0.f;
      s_c[t * NP + n] = ok ? repro::to_f32(cm[g]) : 0.f;
    }
    for (int i = tid; i < L * PT; i += THREADS) {
      const int t = i / PT, p = i - t * PT;
      const bool ok = t0 + t < S && p0 + p < P;
      s_x[i] = ok ? repro::to_f32(x[(((size_t)b * S + t0 + t) * H + h) * P + p0 + p])
                  : 0.f;
    }
    for (int t = tid; t < L; t += THREADS)
      s_dt[t] = t0 + t < S ? dt[((size_t)b * S + t0 + t) * H + h] : 0.f;
    __syncthreads();

    // 2. cumulative log-decays, in sequence order
    if (tid == 0) {
      float cum = 0.f;
      for (int t = 0; t < L; ++t) {
        cum += a * s_dt[t];
        s_cum[t] = cum;
      }
    }
    __syncthreads();
    const float total = s_cum[L - 1];
    for (int t = tid; t < L; t += THREADS) {
      s_ecum[t] = expf(s_cum[t]);
      s_w[t] = expf(total - s_cum[t]) * s_dt[t];
    }

    // 3. M[t][s] = exp(cum_t - cum_s) (c_t . b_s) dt_s for s <= t, else 0
    {
      const int ty = tid / 16, tx = tid % 16;
      float acc[MT][MT];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < MT; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[MT], bv[MT];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int t = ty + 16 * i;
          cv[i] = t < L ? s_c[t * NP + n] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          const int s = tx + 16 * j;
          bv[j] = s < L ? s_b[s * NP + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < MT; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int t = ty + 16 * i;
        if (t >= L) continue;
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          const int s = tx + 16 * j;
          if (s >= L) continue;
          s_M[t * MS + s] =
              s <= t ? expf(s_cum[t] - s_cum[s]) * acc[i][j] * s_dt[s] : 0.f;
        }
      }
    }
    __syncthreads();

    // 4. y = M x + exp(cum) (c . h_prev^T); warp w owns rows t = w + 8 i
    {
      constexpr int RT = L_MAX / NWARP;
      const int p = lane;
      float acc[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) acc[i] = 0.f;
      for (int s = 0; s < L; ++s) {
        const float xv = s_x[s * PT + p];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const int t = warp + NWARP * i;
          if (t < L) acc[i] = fmaf(s_M[t * MS + s], xv, acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int t = warp + NWARP * i;
        if (t >= L) continue;
        float d = 0.f;
        for (int n = 0; n < N; ++n) d = fmaf(s_c[t * NP + n], s_h[p * NP + n], d);
        if (t0 + t < S && p0 + p < P)
          y[(((size_t)b * S + t0 + t) * H + h) * P + p0 + p] =
              repro::from_f32<T>(acc[i] + s_ecum[t] * d);
      }
    }
    __syncthreads();

    // 5. h = exp(cum_L) h + x^T (b * dt * exp(cum_L - cum))
    for (int i = tid; i < L * N; i += THREADS) {
      const int t = i / N;
      s_b[t * NP + (i - t * N)] *= s_w[t];
    }
    __syncthreads();
    const float etot = expf(total);
    for (int i = tid; i < PT * N; i += THREADS) {
      const int p = i / N, n = i - p * N;
      float acc = 0.f;
      for (int s = 0; s < L; ++s) acc = fmaf(s_x[s * PT + p], s_b[s * NP + n], acc);
      s_h[p * NP + n] = etot * s_h[p * NP + n] + acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < PT * N; i += THREADS) {
    const int p = i / N, n = i - p * N;
    if (p0 + p < P) hout[(((size_t)b * H + h) * P + p0 + p) * N + n] = s_h[p * NP + n];
  }
}

template <typename T>
cudaError_t launch_fma(const void* x, const float* dt, const float* a_log,
                       const void* bm, const void* cm, void* y, float* h,
                       int B, int S, int H, int P, int N, int L,
                       cudaStream_t st) {
  const size_t bytes = smem_floats(L, N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + PT - 1) / PT, H, B);
  ssd_kernel<T><<<grid, THREADS, bytes, st>>>(
      (const T*)x, dt, a_log, (const T*)bm, (const T*)cm, (T*)y, h, S, H, P, N, L);
  return cudaGetLastError();
}

// ---- bf16: tensor cores, three stages ---------------------------------

using bf16 = __nv_bfloat16;
constexpr unsigned FULL = 0xffffffffu;
constexpr int PT_TC = 64;     // state rows p per block of stages 1 and 3
constexpr int N_TC = 128;     // widest state the tensor-core path takes
constexpr int SPAD = 8;       // bf16 padding of a shared row (16 bytes)
constexpr int XS = PT_TC + SPAD;

__host__ __device__ inline int pad16(int v) { return (v + 15) & ~15; }

// Programmatic dependent launch (sm_90): the next kernel of the stream may
// start once every block of this one has signalled, and waits for this
// one's completion and memory where it needs its results.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_prerequisite() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Warp 0 of a block: dt of the chunk's positions t0.. for one head (0 at
// or past L or S) into s_dt[128] and cum_t = sum_{s<=t} a dt_s into
// s_cum[128], four positions a lane and a warp scan of the lane sums.
// Called with a = -exp(a_log) log2(e), so that s_cum holds cum / ln 2 and
// every decay is one MUFU.EX2.
__device__ __forceinline__ void chunk_decays(const float* dtb, int H, float a,
                                             int t0, int L, int S, int lane,
                                             float* s_dt, float* s_cum) {
  float d[4], run = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = 4 * lane + e;
    d[e] = (t < L && t0 + t < S) ? dtb[(size_t)(t0 + t) * H] : 0.f;
    run += a * d[e];
  }
  float x = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += v;
  }
  float cum = __shfl_up_sync(FULL, x, 1);
  if (lane == 0) cum = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    cum += a * d[e];
    s_cum[4 * lane + e] = cum;
    s_dt[4 * lane + e] = d[e];
  }
}

// Rows [0, LP) x columns [0, CP) of a bf16 tile into shared memory (row
// stride ds) from global rows t0 + r (stride gs), zero at or past L or S
// and at or past `cols`. vec: 16-byte cp.async (cols, gs and the base a
// multiple of 8 elements); otherwise element by element. The caller
// commits and waits.
__device__ __forceinline__ void load_tile(bf16* dst, int ds, const bf16* src,
                                          size_t gs, int t0, int L, int S,
                                          int LP, int cols, int CP, bool vec,
                                          int tid) {
  if (vec) {
    const int cw = CP / 8;
    for (int i = tid; i < LP * cw; i += THREADS) {
      const int r = i / cw, c = (i - r * cw) * 8;
      const bool ok = r < L && t0 + r < S && c < cols;
      repro::cp_async16(dst + r * ds + c,
                        ok ? src + (size_t)(t0 + r) * gs + c : src, ok);
    }
  } else {
    for (int i = tid; i < LP * CP; i += THREADS) {
      const int r = i / CP, c = i - r * CP;
      const bool ok = r < L && t0 + r < S && c < cols;
      dst[r * ds + c] = ok ? src[(size_t)(t0 + r) * gs + c] : __float2bfloat16(0.f);
    }
  }
}

// Stage 1, grid (chunk, role, batch), 8 warps. Role H * npt: G = c b^T of
// the chunk, written [t][s] f32 for the 16 x 16 tiles at or below the
// diagonal. Other roles (head role / npt, rows p0 = 64 (role % npt)..):
// U[p][n] = sum_s x[s][p] (b[s][n] w_s) with x^T as the A operand and b w
// split hi/lo as B (warp w: rows p 16 (w & 3).., column pairs w >> 2, +2,
// ...), written to ubuf, and the chunk's decay exp(cum_L) to dbuf.
__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a_log, const bf16* __restrict__ bm,
                 const bf16* __restrict__ cm, float* __restrict__ gbuf,
                 float* __restrict__ ubuf, float* __restrict__ dbuf, int S,
                 int H, int P, int N, int L, int npt, int vx, int vbc) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  __shared__ float s_dt[128], s_cum[128], s_w[128];
  launch_dependents();
  const int ci = blockIdx.x, nc = gridDim.x, role = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c4 = lane & 3;
  const int LP = pad16(L), NP = pad16(N), NS = NP + SPAD;
  const int t0 = ci * L;

  if (role == H * npt) {
    bf16* s_c = reinterpret_cast<bf16*>(smem_tc);   // [LP][NS]
    bf16* s_b = s_c + LP * NS;                      // [LP][NS]
    load_tile(s_c, NS, cm + (size_t)bb * S * N, N, t0, L, S, LP, N, NP, vbc, tid);
    load_tile(s_b, NS, bm + (size_t)bb * S * N, N, t0, L, S, LP, N, NP, vbc, tid);
    repro::cp_async_commit();
    repro::cp_async_wait<0>();
    __syncthreads();
    if (warp * 16 >= LP) return;
    float acc[16][4];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int kk = 0; kk < NP / 16; ++kk) {
      uint32_t a[4];
      repro::ldmatrix_x4(a, s_c + (warp * 16 + (lane & 15)) * NS + kk * 16 +
                                (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        if (np <= warp) {              // column tiles up to the diagonal
          uint32_t bk[4];
          repro::ldmatrix_x4(bk, s_b + (np * 16 + (lane & 7) +
                                        ((lane >> 4) << 3)) * NS +
                                     kk * 16 + ((lane >> 3) & 1) * 8);
          repro::mma_bf16(acc[2 * np], a, bk[0], bk[1]);
          repro::mma_bf16(acc[2 * np + 1], a, bk[2], bk[3]);
        }
      }
    }
    float* gb = gbuf + ((size_t)bb * nc + ci) * LP * LP;
    const int ta = warp * 16 + g;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j / 2 <= warp) {
        const int s = j * 8 + 2 * c4;
        *reinterpret_cast<float2*>(gb + ta * LP + s) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(gb + (ta + 8) * LP + s) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }
    return;
  }

  const int hh = role / npt, p0 = (role % npt) * PT_TC;
  const int pw = min(PT_TC, P - p0);
  bf16* s_x = reinterpret_cast<bf16*>(smem_tc);     // [LP][XS]
  bf16* s_hi = s_x + LP * XS;                       // [LP][NS]  b, then (b w) hi
  bf16* s_lo = s_hi + LP * NS;                      // [LP][NS]  (b w) lo
  load_tile(s_x, XS, x + (size_t)bb * S * H * P + (size_t)hh * P + p0,
            (size_t)H * P, t0, L, S, LP, pw, PT_TC, vx, tid);
  load_tile(s_hi, NS, bm + (size_t)bb * S * N, N, t0, L, S, LP, N, NP, vbc, tid);
  repro::cp_async_commit();
  if (warp == 0)
    chunk_decays(dt + (size_t)bb * S * H + hh, H, -expf(a_log[hh]) * repro::kLog2e,
                 t0, L, S, lane, s_dt, s_cum);
  __syncthreads();
  const float cl = s_cum[LP - 1];
  if (tid < LP) s_w[tid] = s_dt[tid] * repro::ex2(cl - s_cum[tid]);
  repro::cp_async_wait<0>();
  __syncthreads();
  for (int s = warp; s < LP; s += NWARP) {  // b w, split: rows by warp
    const float w = s_w[s];
    for (int n = 2 * lane; n < NP; n += 64) {
      const __nv_bfloat162 bv =
          *reinterpret_cast<const __nv_bfloat162*>(s_hi + s * NS + n);
      uint32_t hi, lo;
      repro::split_bf16(__low2float(bv) * w, __high2float(bv) * w, hi, lo);
      *reinterpret_cast<uint32_t*>(s_hi + s * NS + n) = hi;
      *reinterpret_cast<uint32_t*>(s_lo + s * NS + n) = lo;
    }
  }
  __syncthreads();

  const int mt = warp & 3;
  if (mt * 16 < pw) {
    float acc[4][2][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int kk = 0; kk < LP / 16; ++kk) {
      uint32_t a[4];                   // x^T: A from [s][p], transposed
      repro::ldmatrix_x4_trans(a, s_x + (kk * 16 + (lane & 7) +
                                         ((lane >> 4) << 3)) * XS +
                                      mt * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int np = (warp >> 2) + 2 * i;
        if (np * 16 < NP) {            // b w: B from [s][n], transposed
          const int off = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * NS +
                          np * 16 + (lane >> 4) * 8;
          uint32_t bh[4], bl[4];
          repro::ldmatrix_x4_trans(bh, s_hi + off);
          repro::ldmatrix_x4_trans(bl, s_lo + off);
          repro::mma_bf16(acc[i][0], a, bh[0], bh[1]);
          repro::mma_bf16(acc[i][0], a, bl[0], bl[1]);
          repro::mma_bf16(acc[i][1], a, bh[2], bh[3]);
          repro::mma_bf16(acc[i][1], a, bl[2], bl[3]);
        }
      }
    }
    float* ub = ubuf + (((size_t)bb * nc + ci) * H + hh) * P * N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int np = (warp >> 2) + 2 * i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = np * 16 + j * 8 + 2 * c4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = mt * 16 + g + (e >> 1) * 8, nn = n + (e & 1);
          if (np * 16 < NP && p < pw && nn < N)
            ub[(size_t)(p0 + p) * N + nn] = acc[i][j][e];
        }
      }
    }
  }
  if (tid == 0 && p0 == 0) dbuf[((size_t)bb * nc + ci) * H + hh] = repro::ex2(cl);
}

// Stage 2, grid (P*N / (256 V), head, batch): the state pass. A thread
// per V state elements walks the chunks (eight loads ahead), storing the
// state entering each chunk in place of its contribution, and writes
// h_final. V = 4 (16-byte loads) when P*N is a multiple of 4.
template <int V>
__global__ void __launch_bounds__(THREADS)
ssd_state_kernel(float* __restrict__ ubuf, const float* __restrict__ dbuf,
                 float* __restrict__ hout, int nc, int H, int PN) {
  using VT = typename std::conditional<V == 4, float4, float>::type;
  launch_dependents();
  const int e = (blockIdx.x * THREADS + threadIdx.x) * V, hh = blockIdx.y;
  const int bb = blockIdx.z;
  wait_prerequisite();                 // stage 1's contributions and decays
  if (e >= PN) return;
  float h[V] = {};
  for (int c0 = 0; c0 < nc; c0 += 8) {
    VT u[8];
    float d[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const size_t r = ((size_t)bb * nc + c0 + j) * H + hh;
      if (c0 + j < nc) {
        u[j] = *reinterpret_cast<const VT*>(ubuf + r * PN + e);
        d[j] = dbuf[r];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (c0 + j < nc) {
        float* dst = ubuf + (((size_t)bb * nc + c0 + j) * H + hh) * PN + e;
        const float* uj = reinterpret_cast<const float*>(&u[j]);
        VT hv;
        float* hs = reinterpret_cast<float*>(&hv);
#pragma unroll
        for (int q = 0; q < V; ++q) {
          hs[q] = h[q];
          h[q] = fmaf(d[j], h[q], uj[q]);
        }
        *reinterpret_cast<VT*>(dst) = hv;
      }
    }
  }
  VT hv;
#pragma unroll
  for (int q = 0; q < V; ++q) reinterpret_cast<float*>(&hv)[q] = h[q];
  *reinterpret_cast<VT*>(hout + ((size_t)bb * H + hh) * PN + e) = hv;
}

// M_ts = exp(cum_t - cum_s) G_ts dt_s for s <= t, else 0 (selected: the
// exp is never taken above the diagonal, where it would overflow); cum in
// log2 units.
__device__ __forceinline__ float mval(const float* s_cum, const float* s_dt,
                                      int t, float ct, int s, float gv) {
  return s <= t ? repro::ex2(ct - s_cum[s]) * gv * s_dt[s] : 0.f;
}

// G's A-fragment pattern for column tile kk of rows ta, tb = ta + 8:
// (ta, s0..s0+1), (tb, s0..), (ta, s0+8..), (tb, s0+8..), s0 = 16 kk + 2 c4.
__device__ __forceinline__ void load_g(float2 (&gq)[4], const float* gb, int LP,
                                       int ta, int kk, int c4) {
  const float* r0 = gb + ta * LP + kk * 16 + 2 * c4;
  const float* r1 = r0 + 8 * LP;
  gq[0] = *reinterpret_cast<const float2*>(r0);
  gq[1] = *reinterpret_cast<const float2*>(r1);
  gq[2] = *reinterpret_cast<const float2*>(r0 + 8);
  gq[3] = *reinterpret_cast<const float2*>(r1 + 8);
}

// acc += M x over the column tiles kk0..kk1 of the 16 rows of strip r
// (ta = 16 r + g, tb = ta + 8); gq holds G of tile kk0, and G of the next
// tile is loaded before this one's products. M is split hi/lo into A
// fragments; x is B from [s][p], transposed.
__device__ __forceinline__ void mx_tiles(float (&acc)[4][2][4], float2 (&gq)[4],
                                         const float* gb, int LP,
                                         const float* s_cum, const float* s_dt,
                                         const bf16* s_x, int r, int kk0,
                                         int kk1, int npair, int lane) {
  const int g = lane >> 2, c4 = lane & 3;
  const int ta = 16 * r + g, tb = ta + 8;
  const float cta = s_cum[ta], ctb = s_cum[tb];
  for (int kk = kk0; kk <= kk1; ++kk) {
    const int s0 = kk * 16 + 2 * c4, s1 = s0 + 8;
    float2 gn[4] = {gq[0], gq[1], gq[2], gq[3]};
    if (kk < kk1) load_g(gn, gb, LP, ta, kk + 1, c4);
    uint32_t ah[4], al[4];
    repro::split_bf16(mval(s_cum, s_dt, ta, cta, s0, gq[0].x),
                      mval(s_cum, s_dt, ta, cta, s0 + 1, gq[0].y), ah[0], al[0]);
    repro::split_bf16(mval(s_cum, s_dt, tb, ctb, s0, gq[1].x),
                      mval(s_cum, s_dt, tb, ctb, s0 + 1, gq[1].y), ah[1], al[1]);
    repro::split_bf16(mval(s_cum, s_dt, ta, cta, s1, gq[2].x),
                      mval(s_cum, s_dt, ta, cta, s1 + 1, gq[2].y), ah[2], al[2]);
    repro::split_bf16(mval(s_cum, s_dt, tb, ctb, s1, gq[3].x),
                      mval(s_cum, s_dt, tb, ctb, s1 + 1, gq[3].y), ah[3], al[3]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < npair) {
        const int off = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * XS +
                        i * 16 + (lane >> 4) * 8;
        uint32_t bx[4];
        repro::ldmatrix_x4_trans(bx, s_x + off);
        repro::mma_bf16(acc[i][0], ah, bx[0], bx[1]);
        repro::mma_bf16(acc[i][0], al, bx[0], bx[1]);
        repro::mma_bf16(acc[i][1], ah, bx[2], bx[3]);
        repro::mma_bf16(acc[i][1], al, bx[2], bx[3]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) gq[e] = gn[e];
  }
}

// Stage 3, grid (chunk * npt + p-tile, head, batch), 8 warps; warp w owns
// rows t = 16w..16w+15 of the chunk and the tile's 64 columns p:
//   y = exp(cum_t) (c h_in^T) + M x,  M_ts = exp(cum_t - cum_s) G_ts dt_s.
// c is A from [t][n]; h_in^T is B from [p][n] (hi and lo); x is B from
// [s][p], transposed; M's A fragments are built from G in registers.
__global__ void __launch_bounds__(THREADS)
ssd_out_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a_log, const bf16* __restrict__ cm,
               const float* __restrict__ gbuf, const float* __restrict__ ubuf,
               bf16* __restrict__ y, int S, int H, int P, int N, int L,
               int npt, int vx, int vbc) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  __shared__ float s_dt[128], s_cum[128];
  const int ci = blockIdx.x / npt, p0 = (blockIdx.x % npt) * PT_TC;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c4 = lane & 3;
  const int LP = pad16(L), NP = pad16(N), NS = NP + SPAD;
  const int nc = (S + L - 1) / L, t0 = ci * L;
  const int pw = min(PT_TC, P - p0);
  bf16* s_x = reinterpret_cast<bf16*>(smem_tc);     // [LP][XS]
  bf16* s_c = s_x + LP * XS;                        // [LP][NS]
  bf16* s_hh = s_c + LP * NS;                       // [PT_TC][NS]  h_in hi
  bf16* s_hl = s_hh + PT_TC * NS;                   // [PT_TC][NS]  h_in lo
  load_tile(s_x, XS, x + (size_t)bb * S * H * P + (size_t)hh * P + p0,
            (size_t)H * P, t0, L, S, LP, pw, PT_TC, vx, tid);
  load_tile(s_c, NS, cm + (size_t)bb * S * N, N, t0, L, S, LP, N, NP, vbc, tid);
  repro::cp_async_commit();
  if (warp == 0)
    chunk_decays(dt + (size_t)bb * S * H + hh, H, -expf(a_log[hh]) * repro::kLog2e,
                 t0, L, S, lane, s_dt, s_cum);
  wait_prerequisite();                 // G (stage 1) and h_in (stage 2)
  if (ci > 0) {                        // the state entering the chunk:
    const float* hin = ubuf + (((size_t)bb * nc + ci) * H + hh) * P * N;
    for (int n0 = 0; n0 < NP; n0 += 64) {   // rows p = warp + 8 r, lane pairs
      const int n = n0 + 2 * lane;
      float v[PT_TC / NWARP][2];          // loads all in flight
#pragma unroll
      for (int r = 0; r < PT_TC / NWARP; ++r) {
        const int p = warp + NWARP * r;
        const float* src = hin + (size_t)(p0 + p) * N + n;
        v[r][0] = p < pw && n < N ? src[0] : 0.f;
        v[r][1] = p < pw && n + 1 < N ? src[1] : 0.f;
      }
      if (n < NP) {
#pragma unroll
        for (int r = 0; r < PT_TC / NWARP; ++r) {
          const int p = warp + NWARP * r;
          uint32_t hi, lo;
          repro::split_bf16(v[r][0], v[r][1], hi, lo);
          *reinterpret_cast<uint32_t*>(s_hh + p * NS + n) = hi;
          *reinterpret_cast<uint32_t*>(s_hl + p * NS + n) = lo;
        }
      }
    }
  }
  repro::cp_async_wait<0>();
  __syncthreads();

  // Strip r (rows 16r..16r+15) has M x tiles kk = 0..r. Warp r takes those
  // below the midpoint T = ceil(nst / 2); the strips r >= T hand their
  // tiles kk >= T to warp nst - 1 - r (< nst - T), whose partial sums go
  // through shared memory: at most 5 tiles a warp at LP = 128, not 8.
  const int nst = LP / 16, T = (nst + 1) / 2;
  const bool own = warp < nst, extra = warp < nst - T;
  const int ta = warp * 16 + g, tb = ta + 8, r2 = nst - 1 - warp;
  const int npair = (pw + 15) / 16;
  float acc[4][2][4], acc2[4][2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = acc2[i][j][e] = 0.f;

  // G of each walk's first tile, in flight during step 1
  const float* gb = gbuf + ((size_t)bb * nc + ci) * LP * LP;
  float2 gq[4], gq2[4];
  if (own) load_g(gq, gb, LP, ta, 0, c4);
  if (extra) load_g(gq2, gb, LP, 16 * r2 + g, T, c4);

  // 1. c h_in^T, then the rows scaled by exp(cum_t)
  if (own && ci > 0) {
    for (int kk = 0; kk < NP / 16; ++kk) {
      uint32_t a[4];
      repro::ldmatrix_x4(a, s_c + (warp * 16 + (lane & 15)) * NS + kk * 16 +
                                (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < npair) {
          const int off = (i * 16 + (lane & 7) + ((lane >> 4) << 3)) * NS +
                          kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t bh[4], bl[4];
          repro::ldmatrix_x4(bh, s_hh + off);
          repro::ldmatrix_x4(bl, s_hl + off);
          repro::mma_bf16(acc[i][0], a, bh[0], bh[1]);
          repro::mma_bf16(acc[i][0], a, bl[0], bl[1]);
          repro::mma_bf16(acc[i][1], a, bh[2], bh[3]);
          repro::mma_bf16(acc[i][1], a, bl[2], bl[3]);
        }
      }
    }
    const float ea = repro::ex2(s_cum[ta]), eb = repro::ex2(s_cum[tb]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        acc[i][j][0] *= ea;
        acc[i][j][1] *= ea;
        acc[i][j][2] *= eb;
        acc[i][j][3] *= eb;
      }
  }

  // 2. M x: this warp's tiles of its strip, then those it takes over
  if (own)
    mx_tiles(acc, gq, gb, LP, s_cum, s_dt, s_x, warp, 0, min(warp, T - 1),
             npair, lane);
  if (extra)
    mx_tiles(acc2, gq2, gb, LP, s_cum, s_dt, s_x, r2, T, r2, npair, lane);
  __syncthreads();                     // h_in is read: its room takes the sums
  float* part = reinterpret_cast<float*>(s_hh);     // [nst - T][32][32 lanes]
  if (extra)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[(warp * 32 + i * 8 + j * 4 + e) * 32 + lane] = acc2[i][j][e];
  __syncthreads();
  if (!own) return;
  if (warp >= T)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] += part[(r2 * 32 + i * 8 + j * 4 + e) * 32 + lane];

  // 3. y rows ta, tb (inside the chunk and the sequence)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = half ? tb : ta;
    if (t >= L || t0 + t >= S) continue;
    bf16* yr = y + ((size_t)(bb * S + t0 + t) * H + hh) * P + p0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int p = i * 16 + j * 8 + 2 * c4;
        const float v0 = acc[i][j][2 * half], v1 = acc[i][j][2 * half + 1];
        if (i < npair && p + 1 < pw && (P & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(yr + p) = __floats2bfloat162_rn(v0, v1);
        } else if (i < npair) {
          if (p < pw) yr[p] = __float2bfloat16(v0);
          if (p + 1 < pw) yr[p + 1] = __float2bfloat16(v1);
        }
      }
  }
}

cudaError_t launch_tc(const void* x, const float* dt, const float* a_log,
                      const void* bm, const void* cm, void* y, float* h,
                      float* scratch, int B, int S, int H, int P, int N, int L,
                      cudaStream_t st) {
  if (N > N_TC) return cudaErrorInvalidValue;
  const int nc = (S + L - 1) / L, LP = pad16(L), NS = pad16(N) + SPAD;
  const int npt = (P + PT_TC - 1) / PT_TC;
  float* gbuf = scratch;                                 // [B][nc][LP][LP]
  float* ubuf = gbuf + (size_t)B * nc * LP * LP;         // [B][nc][H][P][N]
  float* dbuf = ubuf + (size_t)B * nc * H * P * N;       // [B][nc][H]
  const uintptr_t ax = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ab = reinterpret_cast<uintptr_t>(bm) | reinterpret_cast<uintptr_t>(cm);
  const int vx = P % 8 == 0 && ax % 16 == 0;
  const int vbc = N % 8 == 0 && ab % 16 == 0;
  const size_t smem1 = (size_t)(LP * XS + 2 * LP * NS) * sizeof(bf16);
  const size_t hroom = (size_t)2 * PT_TC * NS * sizeof(bf16);   // h_in, then
  const size_t sums = (size_t)4 * 32 * 32 * sizeof(float);      // partial sums
  const size_t smem3 =
      (size_t)(LP * XS + LP * NS) * sizeof(bf16) + (hroom > sums ? hroom : sums);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      ssd_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (err != cudaSuccess) return err;
  ssd_chunk_kernel<<<dim3(nc, H * npt + 1, B), THREADS, smem1, st>>>(
      (const bf16*)x, dt, a_log, (const bf16*)bm, (const bf16*)cm, gbuf, ubuf,
      dbuf, S, H, P, N, L, npt, vx, vbc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.stream = st;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  const int PN = P * N, v4 = PN % 4 == 0 ? 4 : 1;
  cfg.gridDim = dim3((PN / v4 + THREADS - 1) / THREADS, H, B);
  err = v4 == 4 ? cudaLaunchKernelEx(&cfg, ssd_state_kernel<4>, ubuf,
                                     (const float*)dbuf, h, nc, H, PN)
                : cudaLaunchKernelEx(&cfg, ssd_state_kernel<1>, ubuf,
                                     (const float*)dbuf, h, nc, H, PN);
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3(nc * npt, H, B);
  cfg.dynamicSmemBytes = smem3;
  return cudaLaunchKernelEx(&cfg, ssd_out_kernel, (const bf16*)x, dt, a_log,
                            (const bf16*)cm, (const float*)gbuf,
                            (const float*)ubuf, (bf16*)y, S, H, P, N, L, npt,
                            vx, vbc);
}

}  // namespace

// Returns the CUDA error of the launch (0 = launched). All arrays are
// contiguous on one device; dtype 0 = float32, 1 = bfloat16 for x, b, c
// and y. L (the chunk length, <= S) must be in [1, 128]. bf16 needs N <=
// 128 and float scratch of B * nc * (LP^2 + H*P*N + H) words (nc = the
// number of chunks, LP = L rounded up to 16; kernels/mamba_scan.py
// ::scratch_words); f32 ignores scratch.
extern "C" int mamba_scan(const void* x, const void* dt, const void* a_log,
                          const void* b, const void* c, void* y, void* h,
                          void* scratch, int B, int S, int H, int P, int N,
                          int L, int dtype, void* stream) {
  if (L < 1 || L > L_MAX || S < 1 || N < 1 || P < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* al = static_cast<const float*>(a_log);
  float* hf = static_cast<float*>(h);
  if (dtype == 1)
    return (int)launch_tc(x, dtf, al, b, c, y, hf, static_cast<float*>(scratch),
                          B, S, H, P, N, L, st);
  return (int)launch_fma<float>(x, dtf, al, b, c, y, hf, B, S, H, P, N, L, st);
}
