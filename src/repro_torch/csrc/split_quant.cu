// Per-row symmetric int8 quantization of the split-learning boundary for
// Hopper, sm_90a. Plain C entry point, loaded with ctypes by
// repro_torch/kernels/_build.py.
//
// Replaces the Pallas TPU kernel repro/kernels/split_quant.py
// ::quantize_rows (_quant_kernel): x (rows, d) in f32 or bf16 ->
//   absmax = max_j |x[r, j]|,  scale[r] = max(absmax, 1e-30) / 127,
//   q[r, j] = clip(round_half_even(x[r, j] / scale[r]), -127, 127)  (int8).
// Bit-exact with the reference: the scale and every quotient use IEEE
// division (no reciprocal, no fast math), rounding is rintf (half to
// even), and the abs-max is order-independent.
//
// What bounds it on the H100: the bytes, rows*d*sizeof(T) read plus
// rows*d int8 and rows*4 scale bytes written, at 3.35 TB/s (a handful of
// f32 operations per element is far below the compute line).
//
// Design: one warp per row, 8 rows per block of 256 threads, so a block
// reads 8 contiguous rows. Where d is a multiple of the 16-byte vector
// (4 f32 or 8 bf16) and x is 16-byte aligned, each lane loads whole
// 16-byte vectors, a xor-shuffle max gives the row's abs-max to every
// lane, and each lane then divides, rounds and packs its 4 (or 8) codes
// into one 32-bit (or 64-bit) store. The second sweep over the row reads
// it again from L1, where the first sweep left it, so device memory is
// read once. Other d (the autoencoder's 3-channel latent, d = 130) take
// a scalar path with the same arithmetic, one element per lane per
// step. Rows past the end of the last block are skipped by whole warps.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

__device__ __forceinline__ uint32_t code(float x, float scale) {
  const float r = fminf(fmaxf(rintf(x / scale), -127.0f), 127.0f);
  return (uint32_t)(uint8_t)(int8_t)(int)r;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
             float* __restrict__ scale, int rows, int d) {
  using V16 = repro::Vec16<T>;
  constexpr int N = V16::N;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;                      // whole warp: row is warp-uniform
  const T* xr = x + row * d;
  int8_t* qr = q + row * d;

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
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float s = fmaxf(m, 1e-30f) / 127.0f;
  if (lane == 0) scale[row] = s;

  if constexpr (VEC) {
    for (int c = lane * N; c < d; c += 32 * N) {
      float f[N];
      V16::unpack(*reinterpret_cast<const uint4*>(xr + c), f);
      uint32_t w[N / 4];
#pragma unroll
      for (int i = 0; i < N / 4; ++i)
        w[i] = code(f[4 * i], s) | code(f[4 * i + 1], s) << 8
             | code(f[4 * i + 2], s) << 16 | code(f[4 * i + 3], s) << 24;
      if constexpr (N == 4) {
        *reinterpret_cast<uint32_t*>(qr + c) = w[0];
      } else {
        *reinterpret_cast<uint2*>(qr + c) = make_uint2(w[0], w[1]);
      }
    }
  } else {
    for (int c = lane; c < d; c += 32)
      qr[c] = (int8_t)code(repro::to_f32(xr[c]), s);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* q, void* scale, int rows, int d,
                   int vec, cudaStream_t st) {
  const int grid = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  if (vec)
    quant_kernel<T, true><<<grid, THREADS, 0, st>>>(
        (const T*)x, (int8_t*)q, (float*)scale, rows, d);
  else
    quant_kernel<T, false><<<grid, THREADS, 0, st>>>(
        (const T*)x, (int8_t*)q, (float*)scale, rows, d);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 = launched). x is (rows, d)
// contiguous; q int8 (rows, d); scale f32 (rows,). dtype 0 = float32,
// 1 = bfloat16. vec = 1 only if d is a multiple of 16 / sizeof(T), x is
// 16-byte aligned and q is aligned to 16 / sizeof(T) bytes (the wrapper
// checks).
extern "C" int split_quant(const void* x, void* q, void* scale, int rows,
                           int d, int dtype, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0) return 0;
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, q, scale, rows, d, vec, st);
  return (int)launch<float>(x, q, scale, rows, d, vec, st);
}
