// Per-row symmetric int8 quantization of the split-learning boundary for
// Hopper, sm_90a, with the straight-through estimator's dequantize fused
// in. Plain C entry point, loaded with ctypes by
// repro_torch/kernels/_build.py.
//
// Replaces the Pallas TPU kernel repro/kernels/split_quant.py
// ::quantize_rows (_quant_kernel): rows of x in f32 or bf16 ->
//   absmax = max_j |x[r, j]|,  scale[r] = max(absmax, 1e-30) / 127,
//   q[r, j] = clip(round_half_even(x[r, j] / scale[r]), -127, 127)  (int8),
// and, fused, the STE's forward output xhat[r, j] = q[r, j] * scale[r]
// rounded to x's type (round to nearest even for bf16, as torch's .to()).
// Bit-exact with the reference: the scale and every quotient use IEEE
// division (no reciprocal, no fast math), rounding is rintf (half to
// even), the abs-max is order-independent, and xhat is the product of
// the integer code and the scale, as the plain version computes it.
//
// The boundary is taken in the layout it arrives in. Element (n, p, c)
// of the (N, P, C) view (image n, pixel p, channel c; row r = n P + p)
// lies at n ns + p ps + c cs. Each output is optional (a null pointer):
// q is written (rows, C) row-major, as the reference returns it, the
// scales as (rows,), and xhat at x's own offsets, so the caller gets the
// boundary back in the layout it handed over.
//
// What bounds it on the H100: the bytes, x read once plus what is
// written (xhat in x's type, or q and the f32 scales), at 3.35 TB/s.
// About six f32 operations per element are far below the compute line.
//
// Design, by layout:
// - Row-major rows (cs = 1): one warp per row, 8 rows per block of 256
//   threads. Where C is a multiple of the 16-byte vector (4 f32 or 8
//   bf16) and every row starts 16-byte aligned, each lane loads whole
//   16-byte vectors, a xor-shuffle max gives the row's abs-max to every
//   lane, and each lane then divides, rounds and writes its 4 (or 8)
//   codes in one 32-bit (or 64-bit) store and its xhat values in one
//   16-byte store. The second sweep re-reads the row from L1, where the
//   first sweep left it. Other C take a scalar path with the same
//   arithmetic, one element per lane per step.
// - Channel-major rows (ps = 1, e.g. an NHWC view of NCHW memory): a
//   row's C values lie cs elements apart, so a warp per row would read
//   32 scattered words per load. Instead each lane owns one pixel, 32
//   neighbouring pixels per block, and the block's W = min(16, C) warps
//   split the channels (warp w takes c = w, w + W, ...): every load of a
//   warp is one coalesced line of 32 pixels of one channel. Each thread
//   keeps its K <= 16 values in registers (all K loads in flight at
//   once) and its own partial abs-max; the W partial maxima meet in
//   shared memory. The second sweep reads the registers, and xhat is
//   written in x's layout, again one coalesced line per channel. q is
//   transposed through shared memory (32 rows of C codes, padded against
//   bank conflicts) and written as one contiguous run of 32 C bytes.
//   Tiles may straddle two images: each lane derives its own (n, p).
//   At ResNet-18's l2 boundary 16 warps beat 8 and 32, and a thread per
//   pixel holding all 128 channels (16 codes per 16-byte store of q)
//   was several times slower (PERF.md, Findings).
// - Zeros skip the division (see code()): a warp takes the IEEE
//   division's slow path for all its lanes if one lane needs it, and an
//   all-zero row among 32 pixels did so for every channel.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CM_WARPS = 16;                   // channel-major: warps per block
constexpr int CM_MAX_C = 256;                  // and C <= 256 (K <= 16)

// The code of x under scale s, an integer in [-127, 127]. A zero x (an
// all-zero row, a ReLU output) has code 0 under every scale; it divides
// s / s instead, which keeps it off the IEEE division's slow path.
__device__ __forceinline__ int code(float x, float s) {
  const float r = rintf((x == 0.0f ? s : x) / s);
  return x == 0.0f ? 0 : (int)fminf(fmaxf(r, -127.0f), 127.0f);
}

__device__ __forceinline__ uint32_t byte(int c) {
  return (uint32_t)(uint8_t)(int8_t)c;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
quant_kernel(const T* __restrict__ x, T* __restrict__ xhat,
             int8_t* __restrict__ q, float* __restrict__ scale, int rows,
             int P, int d, long long ns, long long ps) {
  using V16 = repro::Vec16<T>;
  constexpr int N = V16::N;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;                      // whole warp: row is warp-uniform
  const int n = row / P;
  const long long off = n * ns + (long long)(row - n * P) * ps;
  const T* xr = x + off;
  T* yr = xhat ? xhat + off : nullptr;
  int8_t* qr = q ? q + (long long)row * d : nullptr;

  float m = 0.0f;
  if constexpr (VEC) {
    for (int c = lane * N; c < d; c += 32 * N) {
      float f[N];
      V16::unpack(*reinterpret_cast<const uint4*>(xr + c), f);
#pragma unroll
      for (int i = 0; i < N; ++i) m = fmaxf(m, fabsf(f[i]));
    }
  } else {
    for (int c = lane; c < d; c += 32) m = fmaxf(m, fabsf(repro::to_f32(xr[c])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float s = fmaxf(m, 1e-30f) / 127.0f;
  if (scale && lane == 0) scale[row] = s;

  if constexpr (VEC) {
    for (int c = lane * N; c < d; c += 32 * N) {
      float f[N];
      int k[N];
      V16::unpack(*reinterpret_cast<const uint4*>(xr + c), f);
#pragma unroll
      for (int i = 0; i < N; ++i) k[i] = code(f[i], s);
      if (yr) {
#pragma unroll
        for (int i = 0; i < N; ++i) f[i] = (float)k[i] * s;
        *reinterpret_cast<uint4*>(yr + c) = V16::pack(f);
      }
      if (qr) {
        uint32_t w[N / 4];
#pragma unroll
        for (int i = 0; i < N / 4; ++i)
          w[i] = byte(k[4 * i]) | byte(k[4 * i + 1]) << 8
               | byte(k[4 * i + 2]) << 16 | byte(k[4 * i + 3]) << 24;
        if constexpr (N == 4) {
          *reinterpret_cast<uint32_t*>(qr + c) = w[0];
        } else {
          *reinterpret_cast<uint2*>(qr + c) = make_uint2(w[0], w[1]);
        }
      }
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const int k = code(repro::to_f32(xr[c]), s);
      if (yr) yr[c] = repro::from_f32<T>((float)k * s);
      if (qr) qr[c] = (int8_t)k;
    }
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(32 * CM_WARPS)
quant_cm_kernel(const T* __restrict__ x, T* __restrict__ xhat,
                int8_t* __restrict__ q, float* __restrict__ scale, int rows,
                int P, int C, long long ns, long long cs) {
  __shared__ float part[CM_WARPS][32];
  // the block's 32 rows of codes; a row of ceil(C / 4) + 1 words, so the
  // lanes of one channel fall into distinct banks (for C a multiple of 8)
  constexpr int QS_MAX = 32 * ((CM_MAX_C + 3) / 4 + 1) * 4;
  __shared__ __align__(16) uint8_t qs[QS_MAX];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int r0 = blockIdx.x * 32, row = r0 + lane;
  const bool valid = row < rows;
  const int n = valid ? row / P : 0;
  const long long off = n * ns + (valid ? row - n * P : 0);

  // All K loads first, unconditionally (lanes past the last row read
  // row 0, channels past C re-read channel C - 1), so that none waits on
  // another; the masks apply to the values.
  float v[K];
#pragma unroll
  for (int i = 0; i < K; ++i)
    v[i] = repro::to_f32(x[off + min(w + i * W, C - 1) * cs]);
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < K; ++i)
    if (valid && w + i * W < C) m = fmaxf(m, fabsf(v[i]));
  part[w][lane] = m;
  __syncthreads();
  m = part[0][lane];
  for (int j = 1; j < W; ++j) m = fmaxf(m, part[j][lane]);
  const float s = fmaxf(m, 1e-30f) / 127.0f;
  if (scale && w == 0 && valid) scale[row] = s;

  const int qstride = ((C + 3) / 4 + 1) * 4;    // bytes per row of qs
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int c = w + i * W;
    if (valid && c < C) {
      const int k = code(v[i], s);
      if (xhat) xhat[off + c * cs] = repro::from_f32<T>((float)k * s);
      if (q) qs[lane * qstride + c] = (uint8_t)byte(k);
    }
  }
  if (!q) return;
  __syncthreads();
  const int nr = min(32, rows - r0);             // rows of this tile
  int8_t* qt = q + (long long)r0 * C;            // the tile's codes, contiguous
  if ((C & 3) == 0) {                            // 4-byte words, coalesced
    const int wpr = C >> 2;
    for (int k = threadIdx.x; k < nr * wpr; k += blockDim.x) {
      const int rr = k / wpr, cw = k - rr * wpr;
      reinterpret_cast<uint32_t*>(qt)[k] =
          *reinterpret_cast<const uint32_t*>(qs + rr * qstride + 4 * cw);
    }
  } else {
    for (int k = threadIdx.x; k < nr * C; k += blockDim.x) {
      const int rr = k / C;
      qt[k] = (int8_t)qs[rr * qstride + k - rr * C];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* xhat, void* q, void* scale, int N,
                   int P, int C, long long ns, long long ps, long long cs,
                   int vec, cudaStream_t st) {
  const int rows = N * P;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(xhat);
  int8_t* qt = static_cast<int8_t*>(q);
  float* sc = static_cast<float*>(scale);
  if (cs == 1 || C == 1) {                       // row-major rows
    const int grid = (rows + WARPS - 1) / WARPS;
    if (vec)
      quant_kernel<T, true><<<grid, THREADS, 0, st>>>(xt, yt, qt, sc, rows,
                                                      P, C, ns, ps);
    else
      quant_kernel<T, false><<<grid, THREADS, 0, st>>>(xt, yt, qt, sc, rows,
                                                       P, C, ns, ps);
    return cudaGetLastError();
  }
  if (ps != 1 || C > CM_MAX_C) return cudaErrorInvalidValue;
  const int W = C < CM_WARPS ? C : CM_WARPS;     // channel-major rows
  const int per = (C + W - 1) / W;               // channels per thread
  const dim3 grid((rows + 31) / 32), block(32 * W);
#define REPRO_CM(K) \
  quant_cm_kernel<T, K><<<grid, block, 0, st>>>(xt, yt, qt, sc, rows, P, C, ns, cs)
  if (per <= 1) REPRO_CM(1);
  else if (per <= 2) REPRO_CM(2);
  else if (per <= 4) REPRO_CM(4);
  else if (per <= 8) REPRO_CM(8);
  else REPRO_CM(16);
#undef REPRO_CM
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 = launched). x is read as the
// (N, P, C) view with element strides (ns, ps, cs): cs = 1 takes the
// row-major path, else ps must be 1 and C <= 256 (channel-major). xhat
// (x's type, x's offsets), q int8 (N P, C) contiguous and scale f32
// (N P,) may each be null. dtype 0 = float32, 1 = bfloat16. vec = 1 only
// on the row-major path with C, ns and ps multiples of 16 / sizeof(T)
// and x 16-byte aligned (the wrapper checks; xhat and q are fresh
// allocations).
extern "C" int split_quant(const void* x, void* xhat, void* q, void* scale,
                           int N, int P, int C, long long ns, long long ps,
                           long long cs, int dtype, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0 || P <= 0 || C <= 0) return 0;
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, xhat, q, scale, N, P, C, ns, ps, cs,
                                      vec, st);
  return (int)launch<float>(x, xhat, q, scale, N, P, C, ns, ps, cs, vec, st);
}
