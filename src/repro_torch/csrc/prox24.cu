// R_{2:4} proximal operator for Hopper: for every contiguous group of 4 rows
// along K of a weight array w (R, N), the damped Jacobi fixed point
//     u_i <- damping * max(0, |w_i| - lam * e2(u_others)) + (1 - damping) u_i
// from u = |w|, `iters` times, then the signs restored: out_i = sign(w_i) u_i
// (copysign, which is the same for u >= 0, signed zeros included).
//
// Replaces the TPU kernel src/repro/kernels/nm_prox.py::prox24
// (_prox_kernel), which computes core/prox.py::prox_nm24, the operator the
// N:M search applies to every prunable leaf each step.  The pair sums follow
// _pairsum_others's term order and every product, sum and damping term is
// rounded to f32 on its own (this file builds with -fmad=false, so nothing
// fuses into a multiply-add), so the output is bit-identical to the plain
// PyTorch version, prox_nm24, which rounds each op the same way.
//
// What bounds it: bytes, barely.  Each weight is read once and written once
// (8 B per element in f32) against 11 f32 operations per element per
// iteration (132 for 12 iterations): 16.5 operations per byte, under the
// card's 67 TFLOP/s / 3.35 TB/s = 20.  That peak counts a multiply-add as
// two operations; with every op rounded on its own each takes an
// instruction, so the instruction throughput may bind first.
// One thread per (group, column): its 4 reads are strided by N and coalesced
// across the warp's consecutive columns, the 12 iterations stay in
// registers, and its 4 writes coalesce the same way.
//
// In place is allowed (out == w): each thread reads its 4 entries before it
// writes them, and no other thread touches them.  The search overwrites W.
//
// Plain C interface for ctypes: the caller allocates the output, the launch
// goes on the caller's stream, and the function returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// no __restrict__: w and out may be the same array
template <typename T>
__global__ void prox24_kernel(const T* w, T* out, long long cells, int N,
                              float lam, float damping, float keep,
                              int iters) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= cells) return;  // cells = (R / 4) * N
  const long long g = i / N;
  const int n = (int)(i - g * N);
  const size_t base = (size_t)(4 * g) * N + n;
  const float w0 = to_float(w[base]);
  const float w1 = to_float(w[base + N]);
  const float w2 = to_float(w[base + 2 * (size_t)N]);
  const float w3 = to_float(w[base + 3 * (size_t)N]);
  const float a0 = fabsf(w0), a1 = fabsf(w1), a2 = fabsf(w2), a3 = fabsf(w3);
  float u0 = a0, u1 = a1, u2 = a2, u3 = a3;
  for (int it = 0; it < iters; ++it) {
    // _pairsum_others: the pairs of the other three, left to right
    const float e0 = u1 * u2 + u2 * u3 + u3 * u1;
    const float e1 = u0 * u2 + u2 * u3 + u3 * u0;
    const float e2 = u0 * u1 + u1 * u3 + u3 * u0;
    const float e3 = u0 * u1 + u1 * u2 + u2 * u0;
    const float n0 = damping * fmaxf(a0 - lam * e0, 0.0f) + keep * u0;
    const float n1 = damping * fmaxf(a1 - lam * e1, 0.0f) + keep * u1;
    const float n2 = damping * fmaxf(a2 - lam * e2, 0.0f) + keep * u2;
    const float n3 = damping * fmaxf(a3 - lam * e3, 0.0f) + keep * u3;
    u0 = n0;
    u1 = n1;
    u2 = n2;
    u3 = n3;
  }
  out[base] = from_float<T>(copysignf(u0, w0));
  out[base + N] = from_float<T>(copysignf(u1, w1));
  out[base + 2 * (size_t)N] = from_float<T>(copysignf(u2, w2));
  out[base + 3 * (size_t)N] = from_float<T>(copysignf(u3, w3));
}

template <typename T>
void launch(const void* w, void* out, long long cells, int N, float lam,
            float damping, float keep, int iters, cudaStream_t st) {
  const unsigned blocks = (unsigned)((cells + 255) / 256);
  prox24_kernel<T><<<blocks, 256, 0, st>>>(static_cast<const T*>(w),
                                            static_cast<T*>(out), cells, N,
                                            lam, damping, keep, iters);
}


// The shared memory of one instantiation: *static_bytes as
// cudaFuncGetAttributes reports it, *dynamic_bytes what its launch passes
// (the static analysis, analysis/memplan.py, is held against these).
template <typename Kern>
int smem_of(Kern kern, int dynamic, int* static_bytes, int* dynamic_bytes) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, kern);
  if (err != cudaSuccess) return (int)err;
  *static_bytes = (int)fa.sharedSizeBytes;
  *dynamic_bytes = dynamic;
  return 0;
}

}  // namespace

// The shared memory of the dtype's instantiation (smem_of).
extern "C" int repro_prox24_smem(int dtype, int* static_bytes,
                                 int* dynamic_bytes) {
  switch (dtype) {
    case 0:
      return smem_of(prox24_kernel<float>, 0, static_bytes, dynamic_bytes);
    case 1:
      return smem_of(prox24_kernel<__nv_bfloat16>, 0, static_bytes,
                     dynamic_bytes);
    case 2:
      return smem_of(prox24_kernel<__half>, 0, static_bytes, dynamic_bytes);
  }
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = f32, 1 = bf16, 2 = f16 (w and out alike).  w and out are
// contiguous (R, N) arrays with R % 4 == 0; out may be w.  keep is
// (1 - damping) as the caller rounds it.
extern "C" int repro_prox24(const void* w, void* out, long long R, int N,
                            int dtype, float lam, float damping, float keep,
                            int iters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long cells = (R / 4) * N;
  switch (dtype) {
    case 0:
      launch<float>(w, out, cells, N, lam, damping, keep, iters, st);
      break;
    case 1:
      launch<__nv_bfloat16>(w, out, cells, N, lam, damping, keep, iters, st);
      break;
    case 2:
      launch<__half>(w, out, cells, N, lam, damping, keep, iters, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
