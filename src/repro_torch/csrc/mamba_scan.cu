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
// in f32; y (B,S,H,P) in x's type, h_final (B,H,P,N) in f32. Math in f32.
//
// What bounds it on the H100: at Zamba2-1.2B's prefill (H=64, P=N=64,
// L=128) about 6.3 MFLOP per (head, chunk) against 9.6 MB moved at
// S=512, i.e. ~170 FLOP per byte: below the bf16 tensor-core line (~295)
// so the bytes bound it there, but far above the f32 CUDA-core line
// (~20), which is what this kernel uses. As written, its f32 FMAs wait
// on shared-memory loads that 8 warps per SM cannot hide.
//
// Design. The TPU walks the chunks of one (b, h) in order on one core
// with h in VMEM scratch; here one block walks them in a loop and keeps
// its slice of h in shared memory. Rows of the state are independent
// (y[:, p] needs only x[:, p] and h[p, :]), so the grid is
// (P-tile of PT=32 rows, head, batch): 128 blocks for one full-width
// prompt instead of 64, close to the 132 SMs. The price is that the
// head-independent c.b^T product of a chunk is computed once per P-tile.
// Per chunk, with 256 threads:
//   1. load b, c (L x N), the x tile (L x PT) and dt into shared f32,
//      zeroing positions past S;
//   2. one thread forms the cumulative log-decays in order;
//   3. the L x L decay-masked matrix M, 8x8 entries per thread from a
//      register tile over n; entries with s > t are selected to 0 and
//      their exp is never taken (exp(cum_t - cum_s) overflows there);
//   4. y = M x + exp(cum) (c h^T), one warp per 16 rows t, a lane per p;
//   5. b is scaled by dt exp(cum_L - cum) in place, then h is updated.
// Shared memory at L=128, N=64: b and c 2 x 33 KB, M 74 KB, x 16 KB,
// h 8 KB: ~167 KB, dynamic, one block per SM. Rows of b, c and h are
// padded to N+1 floats and rows of M to 16 mod 32 so that the strided
// reads of each step fall in distinct banks. Plain f32 FMAs; tensor-core
// products (mma.sync, then wgmma) and sharing c.b^T across heads are
// later work.
#include "common.cuh"

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
cudaError_t launch(const void* x, const float* dt, const float* a_log,
                   const void* bm, const void* cm, void* y, float* h, int B,
                   int S, int H, int P, int N, int L, cudaStream_t st) {
  const size_t bytes = smem_floats(L, N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + PT - 1) / PT, H, B);
  ssd_kernel<T><<<grid, THREADS, bytes, st>>>(
      (const T*)x, dt, a_log, (const T*)bm, (const T*)cm, (T*)y, h, S, H, P, N, L);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 = launched). All arrays are
// contiguous on one device; dtype 0 = float32, 1 = bfloat16 for x, b, c
// and y. L (the chunk length, <= S) must be in [1, 128].
extern "C" int mamba_scan(const void* x, const void* dt, const void* a_log,
                          const void* b, const void* c, void* y, void* h,
                          int B, int S, int H, int P, int N, int L, int dtype,
                          void* stream) {
  if (L < 1 || L > L_MAX || S < 1 || N < 1 || P < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* al = static_cast<const float*>(a_log);
  float* hf = static_cast<float*>(h);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dtf, al, b, c, y, hf, B, S, H, P, N, L, st);
  return (int)launch<float>(x, dtf, al, b, c, y, hf, B, S, H, P, N, L, st);
}
