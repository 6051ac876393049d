// 2:4 keep-mask for Hopper: for every contiguous group of 4 rows along K of
// a score array s (R, N), keep the 2 entries of largest |s|; ties go to the
// lower position.  Output is a bool (R, N) array.
//
// Replaces the TPU kernel src/repro/kernels/nm_prox.py::nm_mask24
// (_mask_kernel), and computes the same integer function as
// core/masks.py::nm_masks: the rank of entry i is the number of entries j
// of its group that beat it (|s_j| > |s_i|, or |s_j| == |s_i| with j < i),
// and i is kept when its rank is under 2.  The comparisons are the
// reference's, so the masks are bit-identical.
//
// What bounds it: bytes.  Each score is read once and each mask byte
// written once (5 B per element for f32 scores), against ~4 compares per
// element.  One thread per (group, column): its 4 reads are strided by N
// and coalesced across the warp's consecutive columns, as are its 4 writes.
//
// Plain C interface for ctypes: the caller allocates the output, the launch
// goes on the caller's stream, and the function returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T>
__global__ void nm_mask24_kernel(const T* __restrict__ s,
                                 uint8_t* __restrict__ keep, long long cells,
                                 int N) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= cells) return;  // cells = (R / 4) * N
  const long long g = i / N;
  const int n = (int)(i - g * N);
  const size_t base = (size_t)(4 * g) * N + n;
  const float a0 = fabsf(to_float(s[base]));
  const float a1 = fabsf(to_float(s[base + N]));
  const float a2 = fabsf(to_float(s[base + 2 * (size_t)N]));
  const float a3 = fabsf(to_float(s[base + 3 * (size_t)N]));
  // an earlier position beats on >=, a later one only on >
  const int r0 = (a1 > a0) + (a2 > a0) + (a3 > a0);
  const int r1 = (a0 >= a1) + (a2 > a1) + (a3 > a1);
  const int r2 = (a0 >= a2) + (a1 >= a2) + (a3 > a2);
  const int r3 = (a0 >= a3) + (a1 >= a3) + (a2 >= a3);
  keep[base] = r0 < 2;
  keep[base + N] = r1 < 2;
  keep[base + 2 * (size_t)N] = r2 < 2;
  keep[base + 3 * (size_t)N] = r3 < 2;
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
extern "C" int repro_nm_mask24_smem(int dtype, int* static_bytes,
                                    int* dynamic_bytes) {
  switch (dtype) {
    case 0:
      return smem_of(nm_mask24_kernel<float>, 0, static_bytes, dynamic_bytes);
    case 1:
      return smem_of(nm_mask24_kernel<__nv_bfloat16>, 0, static_bytes,
                     dynamic_bytes);
    case 2:
      return smem_of(nm_mask24_kernel<__half>, 0, static_bytes,
                     dynamic_bytes);
  }
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = f32, 1 = bf16, 2 = f16.  s and keep are contiguous (R, N)
// arrays with R % 4 == 0; keep is a torch.bool (one byte per entry).
extern "C" int repro_nm_mask24(const void* s, void* keep, long long R, int N,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long cells = (R / 4) * N;
  const unsigned blocks = (unsigned)((cells + 255) / 256);
  uint8_t* out = static_cast<uint8_t*>(keep);
  switch (dtype) {
    case 0:
      nm_mask24_kernel<float><<<blocks, 256, 0, st>>>(
          static_cast<const float*>(s), out, cells, N);
      break;
    case 1:
      nm_mask24_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
          static_cast<const __nv_bfloat16*>(s), out, cells, N);
      break;
    case 2:
      nm_mask24_kernel<__half><<<blocks, 256, 0, st>>>(
          static_cast<const __half*>(s), out, cells, N);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
