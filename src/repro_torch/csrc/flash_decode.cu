// Split-KV decode attention for Hopper: one query token per (row b, kv head
// h) for all G query heads of its group, against the KV cache, online
// softmax in f32.
//
// Replaces the TPU kernels src/repro/kernels/flash_decode.py::flash_decode
// (_decode_kernel: the normalised output) and ::flash_decode_partial
// (_decode_partial_kernel: the raw f32 (acc, m, l) of one capacity shard),
// and, as a second kernel here, the cross-shard combine that
// src/repro/kernels/shard.py:327-330 runs as one pmax and one psum over
// the mesh's "model" axis.  On one card the capacity shards are a grid
// axis instead of devices: flash-decoding's split-KV form.
//
// Arithmetic, in the TPU kernel's order: s = (q . k) * scale + bias,
// m_new = max(m_prev, s), p = exp(s - m_new), corr = exp(m_prev - m_new),
// l = l * corr + p, acc = acc * corr + p v, m starting at -1e30; the
// flush is acc / max(l, 1e-30).  expf, not __expf.  Masked slots carry
// bias = -1e30 and are not skipped: s rounds to exactly -1e30, so an
// all-masked shard flushes m = -1e30, l = its slot count and acc = sum v,
// as flash_decode_partial_ref does, and the combine's exp(-1e30 - mg) = 0
// removes it against any shard with a valid slot.
//
// What bounds it: bytes.  Each K and V row is read once (128 or 256 B of
// bf16 per head at D = 64 or 128) for about 4 G flops, about G flops per
// byte against the card's ~20 f32 flops per byte of HBM.  All G query
// heads of the group share each row as it is read: the point of GQA at
// decode.
//
// Grid (S, K, B): one block per (shard, kv head, row), 4 warps.  A lane
// reads 16 contiguous bytes of a key row (the cache is read in its
// (B, C, K, D) layout, no transposed copy), D / VEC lanes hold one row, so
// a warp takes 32 / (D / VEC) rows at a time; each sub-warp keeps its own
// (m, l, acc[G][VEC]) over the slots it takes, and the block merges the
// sub-warp states (shuffles) and then the warps' states (shared memory)
// with the same rescaling rule.  The loop over a shard's slots replaces
// the TPU's sequential grid axis (Hopper blocks run in no order) and
// needs no multiple of any chunk.  With S = 1, llama's 4 slots x 8 kv
// heads give 32 blocks, 32 of the 132 SMs; a grid over S capacity shards
// gives 32 S blocks, which is what lets a long cache stream at the card's
// rate.
//
// Plain C interface for ctypes: the caller allocates every output, the
// launch goes on the caller's stream, and each function returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load16(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&o)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// q (B,K,G,D), k/v (B,C,K,D), bias (B,C) f32.  Shard s of S covers slots
// [s * n, (s + 1) * n) with n = C / S.  kPartial: acc (S,B,K,G,D), m and l
// (S,B,K,G) f32; else out (B,K,G,D) in T (S = 1).
template <typename T, int D, int G, bool kPartial>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    int C, int n, float scale, T* __restrict__ out,
                    float* __restrict__ acc_o, float* __restrict__ m_o,
                    float* __restrict__ l_o) {
  constexpr int VEC = 16 / sizeof(T);  // elements of a row per lane
  constexpr int LPR = D / VEC;         // lanes per row
  constexpr int RPW = 32 / LPR;        // rows per warp at a time
  constexpr int STEP = kWarps * RPW;   // rows per block at a time
  constexpr int U = 2;                 // row loads in flight per lane
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "head dim");

  __shared__ float sm_acc[kWarps][G][D];
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];

  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int S = gridDim.x, K = gridDim.y, B = gridDim.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / LPR, part = lane % LPR;

  float qr[G][VEC];
  const T* qb = q + (size_t)(b * K + h) * G * D + part * VEC;
#pragma unroll
  for (int g = 0; g < G; ++g) load16(qb + g * D, qr[g]);

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.0f;
  }

  const size_t row = (size_t)K * D;  // elements between slots c and c + 1
  const size_t off = ((size_t)b * C * K + h) * D + part * VEC;
  const T* kb = k + off;
  const T* vb = v + off;
  const float* bb = bias + (size_t)b * C;
  const int c0 = s * n, c1 = c0 + n;

  // every lane of a warp runs the same trips (the shuffles need all 32);
  // a lane whose slot lies past the shard loads nothing and keeps its state
  for (int cw = c0 + warp * RPW; cw < c1; cw += U * STEP) {
    float kf[U][VEC], vf[U][VEC], bv[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = cw + u * STEP + sub;
      ok[u] = c < c1;
      if (ok[u]) {
        load16(kb + c * row, kf[u]);
        load16(vb + c * row, vf[u]);
        bv[u] = bb[c];
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kf[u][i] = vf[u][i] = 0.0f;
        bv[u] = kNegInf;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float sg[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.0f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) d += qr[g][i] * kf[u][i];
        // butterfly over the LPR lanes of the row: every lane gets the sum
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(kFull, d, o);
        sg[g] = d * scale + bv[u];
      }
      if (ok[u]) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float m_new = fmaxf(m[g], sg[g]);
          const float p = expf(sg[g] - m_new);
          const float corr = expf(m[g] - m_new);
          l[g] = l[g] * corr + p;
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            acc[g][i] = acc[g][i] * corr + p * vf[u][i];
          m[g] = m_new;
        }
      }
    }
  }

  // merge the RPW sub-warp states of the warp into sub-warp 0 (a sub-warp
  // that took no slot holds m = -1e30, l = 0, acc = 0)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(kFull, m[g], o);
      const float lo = __shfl_xor_sync(kFull, l[g], o);
      const float mg = fmaxf(m[g], mo);
      const float ca = expf(m[g] - mg), cb = expf(mo - mg);
      l[g] = l[g] * ca + lo * cb;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float ao = __shfl_xor_sync(kFull, acc[g][i], o);
        acc[g][i] = acc[g][i] * ca + ao * cb;
      }
      m[g] = mg;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) sm_acc[warp][g][part * VEC + i] = acc[g][i];
      if (part == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps' states in warp order; one thread per output element
  const size_t bkg = (size_t)(b * K + h) * G;
  for (int e = threadIdx.x; e < G * D; e += kWarps * 32) {
    const int g = e / D, d = e % D;
    float mg = sm_m[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mg = fmaxf(mg, sm_m[w][g]);
    float lt = 0.0f, at = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - mg);
      lt = lt + sm_l[w][g] * c;
      at = at + sm_acc[w][g][d] * c;
    }
    if constexpr (kPartial) {
      const size_t r = (size_t)s * B * K * G + bkg + g;  // (S,B,K,G) index
      acc_o[r * D + d] = at;
      if (d == 0) {
        m_o[r] = mg;
        l_o[r] = lt;
      }
    } else {
      store(out + (bkg + g) * D + d, at / fmaxf(lt, 1e-30f));
    }
  }
}

// acc (S, R, Dv), m and l (S, R) f32 with R = B*K*G rows -> out (R, Dv).
// One block per (b, kv head): its G rows; shards summed in order 0..S-1.
template <typename T>
__global__ void __launch_bounds__(128)
combine_kernel(const float* __restrict__ acc, const float* __restrict__ m,
               const float* __restrict__ l, int S, int R, int G, int Dv,
               T* __restrict__ out) {
  const int r0 = blockIdx.x * G;
  for (int e = threadIdx.x; e < G * Dv; e += blockDim.x) {
    const int r = r0 + e / Dv, d = e % Dv;
    float mg = m[r];
    for (int s = 1; s < S; ++s) mg = fmaxf(mg, m[(size_t)s * R + r]);
    float lt = 0.0f, at = 0.0f;
    for (int s = 0; s < S; ++s) {
      const size_t i = (size_t)s * R + r;
      const float corr = expf(m[i] - mg);
      lt = lt + l[i] * corr;
      at = at + acc[i * Dv + d] * corr;
    }
    store(out + (size_t)r * Dv + d, at / fmaxf(lt, 1e-30f));
  }
}

template <typename T, int D, int G>
void launch(const void* q, const void* k, const void* v, const float* bias,
            void* out, float* acc, float* m, float* l, int B, int C, int K,
            int S, bool partial, float scale, cudaStream_t st) {
  const dim3 grid(S, K, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  if (partial)
    flash_decode_kernel<T, D, G, true><<<grid, kWarps * 32, 0, st>>>(
        qt, kt, vt, bias, C, C / S, scale, nullptr, acc, m, l);
  else
    flash_decode_kernel<T, D, G, false><<<grid, kWarps * 32, 0, st>>>(
        qt, kt, vt, bias, C, C, scale, static_cast<T*>(out), nullptr,
        nullptr, nullptr);
}

template <typename T, int D>
int launch_g(int G, const void* q, const void* k, const void* v,
             const float* bias, void* out, float* acc, float* m, float* l,
             int B, int C, int K, int S, bool partial, float scale,
             cudaStream_t st) {
  switch (G) {
    case 2:
      launch<T, D, 2>(q, k, v, bias, out, acc, m, l, B, C, K, S, partial,
                      scale, st);
      return 0;
    case 4:
      launch<T, D, 4>(q, k, v, bias, out, acc, m, l, B, C, K, S, partial,
                      scale, st);
      return 0;
    case 6:
      launch<T, D, 6>(q, k, v, bias, out, acc, m, l, B, C, K, S, partial,
                      scale, st);
      return 0;
  }
  return 1;
}

template <typename T>
int launch_d(int D, int G, const void* q, const void* k, const void* v,
             const float* bias, void* out, float* acc, float* m, float* l,
             int B, int C, int K, int S, bool partial, float scale,
             cudaStream_t st) {
  switch (D) {
    case 32:
      return launch_g<T, 32>(G, q, k, v, bias, out, acc, m, l, B, C, K, S,
                             partial, scale, st);
    case 64:
      return launch_g<T, 64>(G, q, k, v, bias, out, acc, m, l, B, C, K, S,
                             partial, scale, st);
    case 128:
      return launch_g<T, 128>(G, q, k, v, bias, out, acc, m, l, B, C, K, S,
                              partial, scale, st);
  }
  return 1;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v and out alike); D in {32, 64, 128},
// G in {2, 4, 6}, S >= 1 dividing C.  partial = 0: out (B,K,G,D), S = 1;
// partial = 1: acc (S,B,K,G,D), m and l (S,B,K,G) f32.  Every array is
// contiguous; q, k and v 16-byte aligned.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* bias, void* out, void* acc,
                                  void* m, void* l, int B, int C, int K,
                                  int G, int D, int S, int dtype, int partial,
                                  float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bi = static_cast<const float*>(bias);
  float* a = static_cast<float*>(acc);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  if (S < 1 || C % S || (!partial && S != 1))
    return (int)cudaErrorInvalidValue;
  int bad = 1;
  if (dtype == 0)
    bad = launch_d<float>(D, G, q, k, v, bi, out, a, mm, ll, B, C, K, S,
                          partial != 0, scale, st);
  else if (dtype == 1)
    bad = launch_d<__nv_bfloat16>(D, G, q, k, v, bi, out, a, mm, ll, B, C,
                                  K, S, partial != 0, scale, st);
  if (bad) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// acc (S,R,Dv), m and l (S,R) f32, R = B*K*G -> out (R,Dv) in dtype
// (0 = f32, 1 = bf16); one block per (b, kv head).
extern "C" int repro_flash_decode_combine(const void* acc, const void* m,
                                          const void* l, void* out, int S,
                                          int BK, int G, int Dv, int dtype,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(acc);
  const float* mm = static_cast<const float*>(m);
  const float* ll = static_cast<const float*>(l);
  const int R = BK * G;
  if (dtype == 0)
    combine_kernel<float><<<BK, 128, 0, st>>>(a, mm, ll, S, R, G, Dv,
                                              static_cast<float*>(out));
  else if (dtype == 1)
    combine_kernel<__nv_bfloat16><<<BK, 128, 0, st>>>(
        a, mm, ll, S, R, G, Dv, static_cast<__nv_bfloat16*>(out));
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
