// Fused UniPruning inner loop for Hopper: local metric + dual update + Gamma
// prox in one elementwise pass over a weight array w (R, N):
//
//   wanda:      S = |w| * a[r]
//   magnitude:  S = |w|
//   ria:        S = (|w| / (rowsum[r] + 1e-12) + |w| / (colsum[l, n] + 1e-12))
//                   * sqrt(max(a[r], 1e-12))          (stochria: the same,
//                   with the subsampled sums computed outside)
//   S = S / s_div                                     (when s_div is given)
//   V' = V - v_lr * (Gamma - S);   Gamma' = sign(V') * max(|V'| - lam, 0)
//
// Replaces the TPU kernel src/repro/kernels/saliency_fuse.py::
// saliency_fused_step (_fuse_kernel), with the constants in its order.  The
// one addition is s_div, a device scalar (med + 1e-12 of the search's
// median score normalisation) read by every thread and never synced to the
// host; without it the kernel computes the Pallas kernel's function.  A
// stacked (L, K, N) leaf runs as its (L*K, N) view: row r is input feature
// r of layer l = r / K, so a and rowsum are (L*K,) and colsum is (L, N).
//
// This file builds with -fmad=false and keeps IEEE division and sqrtf, so
// each op rounds on its own, as the plain PyTorch version's separate
// elementwise ops do: the outputs are bit-identical to it.
//
// What bounds it: bytes.  w, Gamma and V are read once and V', Gamma'
// written once (20 B per element with f32 w) against 10 f32 operations
// per element (wanda with s_div), 15 for ria.  One thread per element:
// consecutive threads take consecutive columns, so every load and store
// coalesces; a, rowsum and colsum are small and stay in L2.
//
// In place is allowed (v_out == v, g_out == gamma): each thread reads its
// element before it writes it.  The search overwrites V and Gamma.
//
// Plain C interface for ctypes: the caller allocates the outputs, the launch
// goes on the caller's stream, and the function returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

enum Metric { kWanda = 0, kMagnitude = 1, kRia = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// no __restrict__ on gamma/v and their outputs: they may be the same arrays
template <typename T, int M, bool kDiv>
__global__ void saliency_fuse_kernel(
    const T* __restrict__ w, const float* __restrict__ a,
    const float* __restrict__ rowsum, const float* __restrict__ colsum,
    const float* __restrict__ s_div, const float* gamma, const float* v,
    float* v_out, float* g_out, long long total, int K, int N, float v_lr,
    float lam) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long r = i / N;
  const float wf = fabsf(to_float(w[i]));
  float s;
  if (M == kWanda) {
    s = wf * a[r];
  } else if (M == kMagnitude) {
    s = wf;
  } else {
    const long long col = (r / K) * N + (i - r * N);
    s = (wf / (rowsum[r] + 1e-12f) + wf / (colsum[col] + 1e-12f)) *
        sqrtf(fmaxf(a[r], 1e-12f));
  }
  if (kDiv) s = s / *s_div;
  const float vn = v[i] - v_lr * (gamma[i] - s);
  v_out[i] = vn;
  g_out[i] = copysignf(fmaxf(fabsf(vn) - lam, 0.0f), vn);
}

template <typename T, int M>
void launch(const void* w, const float* a, const float* rowsum,
            const float* colsum, const float* s_div, const float* gamma,
            const float* v, float* v_out, float* g_out, long long total,
            int K, int N, float v_lr, float lam, cudaStream_t st) {
  const unsigned blocks = (unsigned)((total + 255) / 256);
  const T* wt = static_cast<const T*>(w);
  if (s_div != nullptr) {
    saliency_fuse_kernel<T, M, true><<<blocks, 256, 0, st>>>(
        wt, a, rowsum, colsum, s_div, gamma, v, v_out, g_out, total, K, N,
        v_lr, lam);
  } else {
    saliency_fuse_kernel<T, M, false><<<blocks, 256, 0, st>>>(
        wt, a, rowsum, colsum, s_div, gamma, v, v_out, g_out, total, K, N,
        v_lr, lam);
  }
}

template <typename T>
int dispatch_metric(int metric, const void* w, const float* a,
                    const float* rowsum, const float* colsum,
                    const float* s_div, const float* gamma, const float* v,
                    float* v_out, float* g_out, long long total, int K, int N,
                    float v_lr, float lam, cudaStream_t st) {
  switch (metric) {
    case kWanda:
      launch<T, kWanda>(w, a, rowsum, colsum, s_div, gamma, v, v_out, g_out,
                        total, K, N, v_lr, lam, st);
      return 0;
    case kMagnitude:
      launch<T, kMagnitude>(w, a, rowsum, colsum, s_div, gamma, v, v_out,
                            g_out, total, K, N, v_lr, lam, st);
      return 0;
    case kRia:
      launch<T, kRia>(w, a, rowsum, colsum, s_div, gamma, v, v_out, g_out,
                      total, K, N, v_lr, lam, st);
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
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

template <typename T, int M>
int metric_smem(bool div, int* static_bytes, int* dynamic_bytes) {
  return div ? smem_of(saliency_fuse_kernel<T, M, true>, 0, static_bytes,
                       dynamic_bytes)
             : smem_of(saliency_fuse_kernel<T, M, false>, 0, static_bytes,
                       dynamic_bytes);
}

template <typename T>
int dtype_smem(int metric, bool div, int* static_bytes, int* dynamic_bytes) {
  switch (metric) {
    case kWanda: return metric_smem<T, kWanda>(div, static_bytes,
                                               dynamic_bytes);
    case kMagnitude: return metric_smem<T, kMagnitude>(div, static_bytes,
                                                       dynamic_bytes);
    case kRia: return metric_smem<T, kRia>(div, static_bytes, dynamic_bytes);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The shared memory of the (dtype, metric, s_div given) instantiation
// (smem_of).
extern "C" int repro_saliency_fused_step_smem(int dtype, int metric, int div,
                                              int* static_bytes,
                                              int* dynamic_bytes) {
  switch (dtype) {
    case 0: return dtype_smem<float>(metric, div != 0, static_bytes,
                                     dynamic_bytes);
    case 1: return dtype_smem<__nv_bfloat16>(metric, div != 0, static_bytes,
                                             dynamic_bytes);
    case 2: return dtype_smem<__half>(metric, div != 0, static_bytes,
                                      dynamic_bytes);
  }
  return (int)cudaErrorInvalidValue;
}

// w: contiguous (R, N), dtype 0 = f32, 1 = bf16, 2 = f16; everything else
// f32 and contiguous: a, rowsum (R,) (a unused for magnitude, rowsum and
// colsum only for ria), colsum (R / K, N), s_div one scalar or null, gamma,
// v, v_out, g_out (R, N).  metric: 0 = wanda, 1 = magnitude, 2 = ria.
extern "C" int repro_saliency_fused_step(
    const void* w, const void* a, const void* rowsum, const void* colsum,
    const void* s_div, const void* gamma, const void* v, void* v_out,
    void* g_out, long long R, int K, int N, int dtype, int metric,
    float v_lr, float lam, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = R * N;
  const float* af = static_cast<const float*>(a);
  const float* rs = static_cast<const float*>(rowsum);
  const float* cs = static_cast<const float*>(colsum);
  const float* sd = static_cast<const float*>(s_div);
  const float* g = static_cast<const float*>(gamma);
  const float* vv = static_cast<const float*>(v);
  float* vo = static_cast<float*>(v_out);
  float* go = static_cast<float*>(g_out);
  int err;
  switch (dtype) {
    case 0:
      err = dispatch_metric<float>(metric, w, af, rs, cs, sd, g, vv, vo, go,
                                   total, K, N, v_lr, lam, st);
      break;
    case 1:
      err = dispatch_metric<__nv_bfloat16>(metric, w, af, rs, cs, sd, g, vv,
                                           vo, go, total, K, N, v_lr, lam,
                                           st);
      break;
    case 2:
      err = dispatch_metric<__half>(metric, w, af, rs, cs, sd, g, vv, vo, go,
                                    total, K, N, v_lr, lam, st);
      break;
    default:
      err = (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}
