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
// sum_b lengths[b] * KV * D * 2 * sizeof(T) bytes, at 3.35 TB/s (8.3 MB,
// 2.5 us, at SmolLM-360M's decode shape); the arithmetic is about one
// FMA per byte.
//
// Design: split-KV flash-decoding in one kernel, decode_split_kernel,
// a 1-D grid of B * KV * ceil(S / split) blocks of 256 threads.
//  1. Block i finds its (batch row, KV head, split of `split` cache
//     rows) by a warp scan over the rows' lengths: the blocks with rows
//     come first in the grid, so they are dispatched first, and the rest
//     return at once. A block serves all H/KV query heads that share its
//     KV head, so each cache row is read from device memory once per KV
//     head (the Pallas grid streams it once per query head). A cache row
//     is read by D*sizeof(T)/16 lanes with one 16-byte load each, so a
//     warp reads several whole rows in one coalesced request; each lane
//     keeps an online-softmax state (m, l and its slice of acc) for every
//     query head of the group. UNROLL rows are loaded before any is used;
//     scores are kept in log2 units so that each exp is one MUFU.EX2.
//     The wrapper's split is 256 rows, or 32 KB of K (and of V) if less,
//     at most two passes of the block's 256 x UNROLL 16-byte loads: at
//     SmolLM's shape (bf16, D=64) 256 rows, so its 40 (KV head, batch)
//     pairs and 6,500 valid rows give 150 blocks with rows, more than the
//     132 SMs, all resident at once (16 KB splits, 275 blocks, measured
//     slower; at D=16 a 32 KB split of 1,024 rows left 40 blocks). The
//     lanes' states are merged by warp shuffles, the warps' through
//     shared memory, and the block writes its unnormalized record (m, l,
//     acc) per query head to scratch.
//  2. The merge, in the same kernel: each block counts itself done on an
//     atomic counter of its (KV head, batch row), zeroed by a memset
//     before the launch, and the last one merges the records in split
//     order, out = acc / l. The order of the sums is fixed whichever block
//     merges (no float atomics), so two runs give bit-identical outputs.
// Instantiated per group bucket (1, 2, 4, 8 query heads), so a lane holds
// q and acc for no more heads than it serves.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int UNROLL = 4;      // cache rows in flight per lane

template <typename T, int D, int MAXG>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ o, float* part_ml, float* part_acc,
                    int* counts, int B, int H, int KV, int S, int split,
                    int nsplit, float scale2) {
  using V16 = repro::Vec16<T>;
  constexpr int VEC = V16::N;
  constexpr int LPK = D / VEC;         // lanes per cache row
  constexpr int KPW = 32 / LPK;        // rows per warp per load
  static_assert(D % VEC == 0 && LPK <= 32 && 32 % LPK == 0, "head_dim");

  __shared__ float sm_m[NW][MAXG];
  __shared__ float sm_l[NW][MAXG];
  __shared__ float sm_acc[NW][MAXG][D];
  __shared__ int s_last;

  // Blocks with rows first: block i finds its batch row by a warp scan of
  // the rows' block counts, KV x max(1, ceil(len / split)) each (one per
  // KV head for an empty row, which writes 0); the blocks past them
  // return at once.
  __shared__ int s_map[4];             // b (-1: past the last), len, nv, i
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp == 0) {
    int i = blockIdx.x, found = -1;
    for (int b0 = 0; b0 < B && found < 0; b0 += 32) {
      const int bl = b0 + lane;
      const int ln = bl < B ? min(max(lengths[bl], 0), S) : 0;
      const int nb = bl < B ? KV * max(1, (ln + split - 1) / split) : 0;
      int inc = nb;                    // inclusive scan of the block counts
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += y;
      }
      const unsigned hit = __ballot_sync(0xffffffffu, i < inc);
      if (hit) {
        found = __ffs(hit) - 1;
        if (lane == found) {
          s_map[0] = bl;
          s_map[1] = ln;
          s_map[2] = nb / KV;
          s_map[3] = i - (inc - nb);
        }
      } else {
        i -= __shfl_sync(0xffffffffu, inc, 31);
      }
    }
    if (found < 0 && lane == 0) s_map[0] = -1;
  }
  __syncthreads();
  const int b = s_map[0];
  if (b < 0) return;
  const int len = s_map[1], nv = s_map[2];
  const int kvh = s_map[3] / nv, sp = s_map[3] - kvh * nv;
  const int group = H / KV;
  T* ob = o + ((size_t)b * H + (size_t)kvh * group) * D;
  if (len == 0) {                      // no valid row: 0, as the reference
    for (int e = tid; e < group * D; e += THREADS) ob[e] = repro::from_f32<T>(0.f);
    return;
  }
  const int r0 = sp * split, r1 = min(len, r0 + split);
  const int sub = lane % LPK;          // which 16 bytes of the row
  const int kslot = lane / LPK;        // which row of the warp's KPW

  const T* kbase = k + ((size_t)b * KV + kvh) * S * D + sub * VEC;
  const T* vbase = v + ((size_t)b * KV + kvh) * S * D + sub * VEC;
  const T* qbase = q + ((size_t)b * H + (size_t)kvh * group) * D + sub * VEC;

  // scores in log2 units (q . k scale log2 e), so every exp is one ex2
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
  for (int j0 = r0 + warp * WARP_ROWS; j0 < r1; j0 += NW * WARP_ROWS) {
    uint4 kr[UNROLL], vr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * KPW + kslot;
      kr[u] = make_uint4(0u, 0u, 0u, 0u);
      vr[u] = kr[u];
      if (j < r1) {
        kr[u] = *reinterpret_cast<const uint4*>(kbase + (size_t)j * D);
        vr[u] = *reinterpret_cast<const uint4*>(vbase + (size_t)j * D);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool valid = j0 + u * KPW + kslot < r1;
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
          const float sc = dot * scale2;
          const float m_new = fmaxf(m[g], sc);
          const float alpha = repro::ex2(m[g] - m_new);
          const float p = repro::ex2(sc - m_new);
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
      const float a = repro::ex2(m[g] - mn), c = repro::ex2(mo - mn);
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

  // merge the warps in order; the split's record per query head
  const size_t rec0 = (((size_t)b * KV + kvh) * nsplit + sp) * group;
  for (int idx = tid; idx < group * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    float mx = repro::kNegBig;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = repro::ex2(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * f;
      a += sm_acc[w][g][d] * f;
    }
    part_acc[(rec0 + g) * D + d] = a;
    if (d == 0) {
      part_ml[2 * (rec0 + g)] = mx;
      part_ml[2 * (rec0 + g) + 1] = lsum;
    }
  }

  // The last block of this (KV head, batch row) to finish merges the
  // records of its splits in split order, a warp per query head, 16
  // splits at a time: lane j holds split j's (m, l), every lane loads the
  // 16 acc rows at its output columns d = lane + 32 c in the same round,
  // and the weights f_j = 2^(m_j - m) come from a butterfly max (l summed
  // by a fixed butterfly too). Which block merges varies; what it
  // computes does not.
  __threadfence();                     // this block's record, then the count
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(counts + (size_t)b * KV + kvh, 1) == nv - 1;
  __syncthreads();
  if (!s_last || warp >= group) return;
  __threadfence();
  const size_t mrec = ((size_t)b * KV + kvh) * nsplit * group + warp;
  constexpr int DC = (D + 31) / 32;    // output columns per lane
  float gm = repro::kNegBig, gl = 0.f, ga[DC] = {};
  for (int j0 = 0; j0 < nv; j0 += 16) {
    // 16 splits' (m, l) (lane j) and acc rows (all lanes) loaded together
    const int nj = min(16, nv - j0);
    float2 ml = make_float2(repro::kNegBig, 0.f);
    if (lane < nj)
      ml = __ldcg(reinterpret_cast<const float2*>(part_ml) + mrec +
                  (size_t)(j0 + lane) * group);
    float ar[16][DC];
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
#pragma unroll
      for (int c = 0; c < DC; ++c)
        ar[jj][c] = jj < nj && lane + 32 * c < D
            ? __ldcg(part_acc + (mrec + (size_t)(j0 + jj) * group) * D + lane + 32 * c)
            : 0.f;
    float mx = ml.x;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float mn = fmaxf(gm, mx), alpha = repro::ex2(gm - mn);
    const float f = lane < nj ? repro::ex2(ml.x - mn) : 0.f;
    float ls = ml.y * f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ls += __shfl_xor_sync(0xffffffffu, ls, off);
    gl = gl * alpha + ls;
#pragma unroll
    for (int c = 0; c < DC; ++c) ga[c] *= alpha;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const float fj = __shfl_sync(0xffffffffu, f, jj);
#pragma unroll
      for (int c = 0; c < DC; ++c) ga[c] = fmaf(ar[jj][c], fj, ga[c]);
    }
    gm = mn;
  }
#pragma unroll
  for (int c = 0; c < DC; ++c)
    if (lane + 32 * c < D)
      ob[(size_t)warp * D + lane + 32 * c] =
          repro::from_f32<T>(ga[c] / fmaxf(gl, 1e-30f));
}

struct Args {
  const void *q, *k, *v;
  const int* lengths;
  void* o;
  float *part_ml, *part_acc;
  int* counts;
  int B, H, KV, S, D, split, nsplit;
  float scale2;
  cudaStream_t st;
};

template <typename T, int D, int MAXG>
void launch_split(const Args& a) {
  decode_split_kernel<T, D, MAXG><<<a.B * a.KV * a.nsplit, THREADS, 0, a.st>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.lengths, (T*)a.o,
      a.part_ml, a.part_acc, a.counts, a.B, a.H, a.KV, a.S, a.split, a.nsplit,
      a.scale2);
}

template <typename T, int D>
void launch_group(const Args& a) {
  const int group = a.H / a.KV;
  if (group <= 1) launch_split<T, D, 1>(a);
  else if (group <= 2) launch_split<T, D, 2>(a);
  else if (group <= 4) launch_split<T, D, 4>(a);
  else launch_split<T, D, 8>(a);
}

template <typename T>
cudaError_t launch(const Args& a) {
  cudaError_t err = cudaMemsetAsync(a.counts, 0, sizeof(int) * a.B * a.KV, a.st);
  if (err != cudaSuccess) return err;
  switch (a.D) {
    case 16: launch_group<T, 16>(a); break;
    case 32: launch_group<T, 32>(a); break;
    case 64: launch_group<T, 64>(a); break;
    case 128: launch_group<T, 128>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 = launched). lengths is an
// int32 device array of B entries; dtype 0 = float32, 1 = bfloat16.
// split (>= 1) is the number of cache rows per block; scratch holds
// B * KV * ceil(S / split) * (H / KV) * (D + 2) floats and B * KV ints
// (kernels/decode_attn.py::scratch_words).
extern "C" int decode_attn(const void* q, const void* k, const void* v,
                           const void* lengths, void* o, void* scratch, int B,
                           int H, int KV, int S, int D, int split, float scale,
                           int dtype, void* stream) {
  if (split < 1 || S < 1 || KV < 1 || H % KV) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.lengths = static_cast<const int*>(lengths);
  a.o = o;
  a.nsplit = (S + split - 1) / split;
  a.part_ml = static_cast<float*>(scratch);
  a.part_acc = a.part_ml + 2 * (size_t)B * KV * a.nsplit * (H / KV);
  a.counts = reinterpret_cast<int*>(
      a.part_acc + (size_t)B * KV * a.nsplit * (H / KV) * D);
  a.B = B;
  a.H = H;
  a.KV = KV;
  a.S = S;
  a.D = D;
  a.split = split;
  a.scale2 = scale * repro::kLog2e;
  a.st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a);
  return (int)launch<float>(a);
}
