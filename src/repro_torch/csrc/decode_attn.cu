// Flash-decode attention for Hopper, sm_90a. Plain C entry point, loaded
// with ctypes by repro_torch/kernels/_build.py.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attn.py
// ::decode_attention (_decode_kernel): one new query token per batch row,
// q (B,H,1,D), against the KV cache k/v (B,KV,S,D) of which the first
// lengths[b] rows are valid, with GQA. Inputs bf16 or f32, math in f32,
// output in the input type.
//
// What bounds it on the H100: reading the valid K and V rows once,
// sum_b lengths[b] * KV * D * 2 * sizeof(T) bytes, at 3.35 TB/s; the
// arithmetic is about one FMA per byte.
//
// Design: one block of 256 threads per (KV head, batch row). The block
// serves all H/KV query heads that share its KV head, so each cache row
// is read from device memory once per KV head (the Pallas grid streams
// it once per query head). A cache row is read by D*sizeof(T)/16 lanes
// with one 16-byte load each, so a warp reads several whole rows in one
// coalesced request (at D = 16, two lanes a bf16 row and four an f32
// one); each lane keeps an online-softmax state (m, l and
// its slice of acc) for every query head of the group. Loads of UNROLL
// rows are started before any is used, to keep more bytes in flight.
// Rows at or past lengths[b] are never read. The per-lane states are
// merged by warp shuffles, then across warps through shared memory.
// Splitting S across blocks (flash-decoding) is later work: with B*KV
// blocks the card is not filled at small batch.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int MAXG = 8;        // query heads per KV head
constexpr int UNROLL = 4;      // cache rows in flight per lane

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ o, int H, int KV, int S, float scale) {
  using V16 = repro::Vec16<T>;
  constexpr int VEC = V16::N;
  constexpr int LPK = D / VEC;         // lanes per cache row
  constexpr int KPW = 32 / LPK;        // rows per warp per load
  static_assert(D % VEC == 0 && LPK <= 32 && 32 % LPK == 0, "head_dim");

  __shared__ float sm_m[NW][MAXG];
  __shared__ float sm_l[NW][MAXG];
  __shared__ float sm_acc[NW][MAXG][D];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int group = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane % LPK;          // which 16 bytes of the row
  const int kslot = lane / LPK;        // which row of the warp's KPW
  const int len = min(max(lengths[b], 0), S);

  const T* kbase = k + ((size_t)b * KV + kvh) * S * D + sub * VEC;
  const T* vbase = v + ((size_t)b * KV + kvh) * S * D + sub * VEC;
  const T* qbase = q + ((size_t)b * H + (size_t)kvh * group) * D + sub * VEC;

  float qv[MAXG][VEC];
  float m[MAXG], l[MAXG], acc[MAXG][VEC];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (g < group) raw = *reinterpret_cast<const uint4*>(qbase + (size_t)g * D);
    V16::unpack(raw, qv[g]);
    m[g] = repro::kNegBig;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  constexpr int WARP_ROWS = KPW * UNROLL;
  for (int j0 = warp * WARP_ROWS; j0 < len; j0 += NW * WARP_ROWS) {
    uint4 kr[UNROLL], vr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * KPW + kslot;
      kr[u] = make_uint4(0u, 0u, 0u, 0u);
      vr[u] = kr[u];
      if (j < len) {
        kr[u] = *reinterpret_cast<const uint4*>(kbase + (size_t)j * D);
        vr[u] = *reinterpret_cast<const uint4*>(vbase + (size_t)j * D);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool valid = j0 + u * KPW + kslot < len;
      float kf[VEC], vf[VEC];
      V16::unpack(kr[u], kf);
      V16::unpack(vr[u], vf);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= group) break;         // uniform across the block
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qv[g][e], kf[e], dot);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (valid) {
          const float s = dot * scale;
          const float m_new = fmaxf(m[g], s);
          const float alpha = expf(m[g] - m_new);
          const float p = expf(s - m_new);
          l[g] = l[g] * alpha + p;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e] * alpha);
          m[g] = m_new;
        }
      }
    }
  }

  // merge the KPW row slots of each warp (lanes sub, sub+LPK, ...)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= group) break;
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = expf(m[g] - mn), c = expf(mo - mn);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + ao * c;
      }
      m[g] = mn;
    }
  }
  if (kslot == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= group) break;
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[warp][g][sub * VEC + e] = acc[g][e];
      if (sub == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps; one output element per thread per pass
  for (int idx = tid; idx < group * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    float mx = repro::kNegBig;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * f;
      a += sm_acc[w][g][d] * f;
    }
    o[((size_t)b * H + (size_t)kvh * group + g) * D + d] =
        repro::from_f32<T>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* o, int B, int H, int KV, int S,
                   int D, float scale, cudaStream_t st) {
  const dim3 grid(KV, B);
  switch (D) {
    case 16:
      decode_kernel<T, 16><<<grid, THREADS, 0, st>>>(
          (const T*)q, (const T*)k, (const T*)v, lengths, (T*)o, H, KV, S, scale);
      break;
    case 32:
      decode_kernel<T, 32><<<grid, THREADS, 0, st>>>(
          (const T*)q, (const T*)k, (const T*)v, lengths, (T*)o, H, KV, S, scale);
      break;
    case 64:
      decode_kernel<T, 64><<<grid, THREADS, 0, st>>>(
          (const T*)q, (const T*)k, (const T*)v, lengths, (T*)o, H, KV, S, scale);
      break;
    case 128:
      decode_kernel<T, 128><<<grid, THREADS, 0, st>>>(
          (const T*)q, (const T*)k, (const T*)v, lengths, (T*)o, H, KV, S, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 = launched). lengths is an
// int32 device array of B entries; dtype 0 = float32, 1 = bfloat16.
extern "C" int decode_attn(const void* q, const void* k, const void* v,
                           const void* lengths, void* o, int B, int H, int KV,
                           int S, int D, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, len, o, B, H, KV, S, D, scale, st);
  return (int)launch<float>(q, k, v, len, o, B, H, KV, S, D, scale, st);
}
