// Flash-attention forward (prefill) for Hopper, sm_90a. Plain C entry
// point, loaded with ctypes by repro_torch/kernels/_build.py.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attn.py
// ::flash_attention_fwd (_fwd_kernel): online-softmax attention of
// q (B,H,Sq,D) against k/v (B,KV,Skv,D) with GQA (head h reads KV head
// h / (H/KV)), a causal band and an optional sliding window, fully
// masked KV tiles skipped, the ragged Skv tail masked. Inputs bf16 or
// f32, all math in f32, the row sum divided as acc / max(l, 1e-30),
// output in the input type.
//
// What bounds it on the H100: the causal score and PV products,
// 2 * 2 * B*H * (Sq*Skv/2) * D operations, against 989 TFLOP/s of bf16
// tensor cores. This first kernel does not reach that bound: it runs the
// products as f32 FMAs on the CUDA cores (67 TFLOP/s peak), which keeps
// it simple and exact in f32; wgmma and TMA are later work.
//
// Design: one block of 256 threads per (64-row q tile, q head, batch).
// Four threads share a query row: the row's q lives in each one's
// registers, each thread scores 16 of the 64 keys of a tile and owns D/4
// of the D output columns (D = 16, 32 or 64; at D = 16 a row of q is 32
// bytes of bf16, two 16-byte loads, and a tile of K is 128 such loads,
// so half of the threads load one). K and V tiles of 64 rows are staged in shared
// memory as f32 (K padded by one column so the four threads of a row
// hit four banks); probabilities move between the four threads by warp
// shuffles instead of shared memory. Each KV tile is read once per q
// tile of each q head; tiles outside the causal/window band are skipped
// by the loop bounds, not by masks.
#include "common.cuh"

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
  // bf16 at D = 16: 128 loads per tile, so half the threads load one
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

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int Sq, int Skv, int D, int causal,
                   int window, float scale, cudaStream_t st) {
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  switch (D) {
    case 16:
      flash_fwd_kernel<T, 16><<<grid, THREADS, 0, st>>>(
          (const T*)q, (const T*)k, (const T*)v, (T*)o, H, KV, Sq, Skv,
          causal, window, scale);
      break;
    case 32:
      flash_fwd_kernel<T, 32><<<grid, THREADS, 0, st>>>(
          (const T*)q, (const T*)k, (const T*)v, (T*)o, H, KV, Sq, Skv,
          causal, window, scale);
      break;
    case 64:
      flash_fwd_kernel<T, 64><<<grid, THREADS, 0, st>>>(
          (const T*)q, (const T*)k, (const T*)v, (T*)o, H, KV, Sq, Skv,
          causal, window, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 = launched). window <= 0 means
// no sliding window; dtype 0 = float32, 1 = bfloat16.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, int B, int H, int KV, int Sq, int Skv,
                              int D, int causal, int window, float scale,
                              int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Skv, D,
                                      causal, window, scale, st);
  return (int)launch<float>(q, k, v, o, B, H, KV, Sq, Skv, D, causal, window,
                            scale, st);
}
