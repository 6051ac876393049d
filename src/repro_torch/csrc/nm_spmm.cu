// 2:4 compressed matmul for Hopper: out (M, N) = x (M, K) @ W (K, N), with W
// pruned 2:4 along K and given compressed as vals (K/2, N) plus in-group
// positions, either packed 4-per-byte (K/8, N) uint8 or int8 (K/2, N); and
// its expert-banked form, out (E, M, N) = x (E, M, K) @ W (E, K, N), one such
// product per expert of an MoE bank.
//
// Replaces the TPU kernels src/repro/kernels/nm_spmm.py::nm_matmul
// (_nm_matmul_kernel) and ::nm_matmul_expert (_nm_matmul_expert_kernel).  On
// the TPU the compressed tile was expanded to dense with a masked select,
// because the VPU has no gather, and fed to the MXU; the expert variant grew
// the grid a leading expert dimension.  Here nothing is expanded: each thread
// owns two adjacent output columns and walks the 2:4 groups along K, reading
// its two bf16 values per group and the group's index bits, and gathers the
// matching x entries from shared memory.  Sums are kept in f32 registers.
// The expert axis is folded into the grid's z dimension with the row tiles
// (z = expert * row_tiles + row_tile); each block offsets x, vals, idx, out
// and the split-K workspace by its expert's stride.  The 2-D product is the
// one-expert case of the same kernel, instantiated without those offsets
// (kExperts = false): with them it ran ~7% slower at llama's decode shapes
// on an H100.
//
// What bounds it: at decode (M = serving slots, or the MoE capacity C, a
// handful) the work is ~M flops per weight byte, far under the ~295
// flops/byte at which the H100's data-sheet bf16 rate and HBM rate balance,
// so the bound is the bytes of the compressed weight (1.125 B per weight
// with the packed index plane): one Mixtral-8x22B expert bank, 8 x 6144 x
// 16384 weights, is 0.906 GB, 0.27 ms at 3.35 TB/s.  The design keeps those
// reads coalesced along N (32 lanes x 2 columns = 128 contiguous bytes of
// bf16 values per row) and splits K over the 8 warps of a block and, when
// the expert x N x M grid is too small to fill the card, over blocks
// (deterministic second pass, no atomics).  Prefill-sized M re-reads the
// weight once per 16-row tile of x; tensor cores (mma.sp / wgmma) are not
// used yet.
//
// Plain C interface for ctypes: the caller allocates the output and the
// split-K workspace, the launch goes on the caller's stream, and the
// function returns cudaGetLastError() without synchronising.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 64;                // columns per block: 32 lanes x 2
constexpr int kWarps = 8;              // warps splitting the block's K range
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxBM = 16;             // rows of x per block, at most
constexpr int kKC = 256;               // dense K rows of x staged per chunk
constexpr int kSmemFloats = kWarps * kMaxBM * kBN;  // 32 KB; >= kMaxBM * kKC

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<__nv_bfloat16> { using type = __nv_bfloat162; };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float2 to_float2(float2 v) { return v; }
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// grid: (ceil(N / kBN), ksplit, E * ceil(M / BM)).  Block (bx, s, z) with
// z = e * ceil(M / BM) + bz computes, for expert e, columns
// [bx*kBN, bx*kBN + kBN) of rows [bz*BM, bz*BM + BM) over the s-th
// contiguous range of 2:4 groups.  With ksplit == 1 it writes `out`;
// otherwise f32 partial sums go to ws[s][e] and splitk_reduce adds them.
// kExperts = false is the E = 1 case: z is the row tile, no offsets.
template <typename TIn, typename TOut, bool kPacked, int BM, bool kExperts>
__global__ void __launch_bounds__(kThreads)
nm_matmul_kernel(const TIn* __restrict__ x, const TIn* __restrict__ vals,
                 const uint8_t* __restrict__ idx, TOut* __restrict__ out,
                 float* __restrict__ ws, int E, int M, int K, int N,
                 int ksplit) {
  __shared__ float smem[kSmemFloats];
  using P = typename Pair<TIn>::type;

  const size_t mn = (size_t)M * N;
  int e = 0;
  if (kExperts) {
    // this expert's operands: x (M, K), vals (K/2, N), idx (K/8 | K/2, N),
    // out and each split's workspace slice (M, N)
    e = blockIdx.z / ((M + BM - 1) / BM);
    x += (size_t)e * M * K;
    vals += (size_t)e * (K / 2) * N;
    idx += (size_t)e * (kPacked ? K / 8 : K / 2) * N;
    out += (size_t)e * mn;
  }
  if (ws != nullptr) ws += ((size_t)blockIdx.y * E + e) * mn;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kBN + 2 * lane;  // N is even: n0 + 1 < N too
  const int m0 = (blockIdx.z - e * ((M + BM - 1) / BM)) * BM;
  const int mt = min(BM, M - m0);
  const int groups = K / 4;
  const int per_split = (groups + ksplit - 1) / ksplit;
  const int g_lo = blockIdx.y * per_split;
  const int g_hi = min(groups, g_lo + per_split);

  float acc[BM][2];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m][0] = acc[m][1] = 0.f;

  for (int c0 = g_lo; c0 < g_hi; c0 += kKC / 4) {
    const int c1 = min(g_hi, c0 + kKC / 4);
    const int rows = (c1 - c0) * 4;
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < BM * rows; i += kThreads) {
      const int m = i / rows, k = i - m * rows;
      smem[m * kKC + k] =
          m < mt ? to_float(x[(size_t)(m0 + m) * K + 4 * c0 + k]) : 0.f;
    }
    __syncthreads();
    if (n0 < N) {
      for (int g = c0 + warp; g < c1; g += kWarps) {
        const float2 v0 = to_float2(
            *reinterpret_cast<const P*>(vals + (size_t)(2 * g) * N + n0));
        const float2 v1 = to_float2(
            *reinterpret_cast<const P*>(vals + (size_t)(2 * g + 1) * N + n0));
        int pa0, pa1, pb0, pb1;  // column n0 (a) and n0 + 1 (b)
        if (kPacked) {
          // byte row g/2 holds compressed rows 2g, 2g+1 in bits 4(g&1)..+3
          const uint16_t two = *reinterpret_cast<const uint16_t*>(
              idx + (size_t)(g >> 1) * N + n0);
          const int sh = 4 * (g & 1);
          const int a = (two & 0xff) >> sh, b = (two >> 8) >> sh;
          pa0 = a & 3; pa1 = (a >> 2) & 3;
          pb0 = b & 3; pb1 = (b >> 2) & 3;
        } else {
          const char2 i0 = *reinterpret_cast<const char2*>(
              idx + (size_t)(2 * g) * N + n0);
          const char2 i1 = *reinterpret_cast<const char2*>(
              idx + (size_t)(2 * g + 1) * N + n0);
          pa0 = i0.x; pb0 = i0.y; pa1 = i1.x; pb1 = i1.y;
        }
        const float* xg = smem + 4 * (g - c0);
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const float* xr = xg + m * kKC;
          acc[m][0] = fmaf(xr[pa1], v1.x, fmaf(xr[pa0], v0.x, acc[m][0]));
          acc[m][1] = fmaf(xr[pb1], v1.y, fmaf(xr[pb0], v0.y, acc[m][1]));
        }
      }
    }
  }

  // reduce the warps' K slices through shared memory, in warp order
  __syncthreads();
#pragma unroll
  for (int m = 0; m < BM; ++m) {
    smem[(warp * BM + m) * kBN + 2 * lane] = acc[m][0];
    smem[(warp * BM + m) * kBN + 2 * lane + 1] = acc[m][1];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < mt * kBN; i += kThreads) {
    const int m = i / kBN, c = i - m * kBN;
    const int n = blockIdx.x * kBN + c;
    if (n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += smem[(w * BM + m) * kBN + c];
    const size_t o = (size_t)(m0 + m) * N + n;
    if (ksplit == 1) {
      out[o] = from_float<TOut>(s);
    } else {
      ws[o] = s;
    }
  }
}

template <typename TOut>
__global__ void splitk_reduce(const float* __restrict__ ws,
                              TOut* __restrict__ out, int ksplit, size_t mn) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int k = 0; k < ksplit; ++k) s += ws[k * mn + i];
  out[i] = from_float<TOut>(s);
}

struct Args {
  const void* x;
  const void* vals;
  const void* idx;
  void* out;
  void* ws;
  int E, M, K, N, ksplit;
};

template <typename TIn, typename TOut, bool kPacked, int BM>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long z = (long long)a.E * ((a.M + BM - 1) / BM);
  if (z > 65535 || a.ksplit > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((a.N + kBN - 1) / kBN, a.ksplit, (unsigned)z);
  auto kernel = a.E > 1 ? nm_matmul_kernel<TIn, TOut, kPacked, BM, true>
                        : nm_matmul_kernel<TIn, TOut, kPacked, BM, false>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(a.x), static_cast<const TIn*>(a.vals),
      static_cast<const uint8_t*>(a.idx), static_cast<TOut*>(a.out),
      static_cast<float*>(a.ksplit > 1 ? a.ws : nullptr), a.E, a.M, a.K, a.N,
      a.ksplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.ksplit == 1) return err;
  const size_t emn = (size_t)a.E * a.M * a.N;
  splitk_reduce<TOut><<<(unsigned)((emn + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(a.ws), static_cast<TOut*>(a.out), a.ksplit,
      emn);
  return cudaGetLastError();
}

template <typename TIn, typename TOut, bool kPacked>
cudaError_t launch_bm(const Args& a, cudaStream_t s) {
  if (a.M <= 1) return launch<TIn, TOut, kPacked, 1>(a, s);
  if (a.M <= 2) return launch<TIn, TOut, kPacked, 2>(a, s);
  if (a.M <= 4) return launch<TIn, TOut, kPacked, 4>(a, s);
  if (a.M <= 8) return launch<TIn, TOut, kPacked, 8>(a, s);
  return launch<TIn, TOut, kPacked, kMaxBM>(a, s);
}

template <typename TIn, typename TOut>
cudaError_t launch_layout(const Args& a, int packed, cudaStream_t s) {
  return packed ? launch_bm<TIn, TOut, true>(a, s)
                : launch_bm<TIn, TOut, false>(a, s);
}

}  // namespace

// out (E, M, N) = x (E, M, K) @ W (E, K, N), per expert, W given as vals
// (E, K/2, N) and idx (E, K/8, N) packed or (E, K/2, N) int8; the 2-D
// product is E = 1.  in_bf16: x and vals are bf16 (else f32); out_bf16: out
// is bf16 (else f32; bf16 out needs bf16 in).  packed: the packed plane
// (K % 8 == 0), else the int8 plane.  ws: ksplit x E x M x N f32 scratch
// when ksplit > 1.  Requires N even, K % 4 == 0, every operand contiguous.
extern "C" int repro_nm_matmul_expert(const void* x, const void* vals,
                                      const void* idx, void* out, void* ws,
                                      int E, int M, int K, int N,
                                      int in_bf16, int out_bf16, int packed,
                                      int ksplit, void* stream) {
  const Args a{x, vals, idx, out, ws, E, M, K, N, ksplit};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16 && out_bf16)
    return (int)launch_layout<__nv_bfloat16, __nv_bfloat16>(a, packed, s);
  if (in_bf16) return (int)launch_layout<__nv_bfloat16, float>(a, packed, s);
  if (!out_bf16) return (int)launch_layout<float, float>(a, packed, s);
  return (int)cudaErrorInvalidValue;
}
