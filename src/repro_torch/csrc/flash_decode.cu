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
// Arithmetic, in the TPU kernel's order, chunk by chunk of kChunk slots:
// s = (q . k) * scale + bias for the chunk and all G heads, one max per
// head per chunk, m_new = max(m_prev, max_c s), p = exp(s - m_new) once per
// slot, one corr = exp(m_prev - m_new) per head per chunk, l = l * corr +
// sum p, acc = acc * corr + p v with f32 p (the reference's f32
// probabilities), m starting at -1e30; the flush is acc / max(l, 1e-30).
// expf, not __expf.  Masked slots carry bias = -1e30 and are not skipped:
// s rounds to exactly -1e30, so an all-masked shard flushes m = -1e30, l =
// its slot count (a sum of exact ones) and acc = sum v, as
// flash_decode_partial_ref does, and the combine's exp(-1e30 - mg) = 0
// removes it against any shard with a valid slot.  Slots past the end of a
// block's range (the last chunk of a split that is no whole number of
// chunks) are zero-filled and get s = -inf, so p = 0 and they count nowhere.
//
// What bounds it: bytes.  Each K and V row is read once (128, 256 or 512 B
// of bf16 per head at D = 64, 128 or 256) for about 4 G flops: about G flops per
// byte against the card's ~20 f32 flops per byte of HBM.  All G query heads
// of the group share each row as it is read (the point of GQA at decode).
// Streaming at the card's rate needs a few MB in flight, more than one
// (shard, kv head, row) holds, and a per-slot arithmetic chain short enough
// to hide behind the loads.  What each part does about it:
//
// * The capacity split across a thread-block cluster.  The grid is (S P, K,
//   B): the P blocks of one (shard, kv head, row) form a cluster along x,
//   and block p of it takes slots [s n + p n / P, s n + (p + 1) n / P) of
//   shard s (n = C / S).  P (1, 2, 4 or 8: portable cluster sizes) comes
//   from the host's planner, kernels/flash_decode.py::plan_splits: enough
//   blocks for ~2 per SM, and no split shorter than a chunk unless the shard
//   is.  Each block ends with its (m, l, acc) in shared memory; after a
//   cluster barrier the blocks read each other's states through distributed
//   shared memory and merge them in split order with the combine's rule
//   (max m, corr = exp(m_p - max), l and acc summed in order p = 0..P-1),
//   each block a share of the G x D outputs; a second cluster barrier keeps
//   every block's shared memory alive until the last remote read.  One
//   launch, no global workspace, nothing to zero before a CUDA graph is
//   captured, and the same bits on every call.
// * A ring of chunks in shared memory.  Chunk i of a block's range goes to
//   warp i % kWarps, which streams its chunks of kChunk slots of K and V
//   plus the bias through the stages of its own ring, filled with 16-byte
//   cp.async.cg copies (4-byte ones for the bias), the cache read in its
//   own (B, C, K, D) layout (slot stride K D, no transposed copy): the
//   block's ring holds kWarps x STAGES chunks, kWarps of them in flight
//   while the warps compute on the others, and the loop has no block
//   barrier.  Two stages a warp measured faster at the serving shapes than
//   three or four (more shared memory a block for no more bytes in flight
//   a SM), and 4 warps of 16-slot chunks faster than 2 or 8 warps or
//   32-slot chunks.  Where two stages do not fit a block's 227 KB (f32 at
//   D 256: 4 warps x 2 x 33 KB), each warp keeps one stage and waits for
//   each chunk's copies before it computes (Shape::STAGES); bf16 at D 256
//   keeps two (137 KB).  Rows are padded by 16 bytes, so the 8 rows of an
//   ldmatrix (or of a quarter-warp's 16-byte reads) hit 8 different bank
//   groups.
// * Tensor cores for bf16.  q . k is mma.m16n8k16 (bf16 in, f32 sums: each
//   product is exact) with the G heads as rows 0..G-1 of the A tile (the
//   rest zero), q's fragments held in registers for the whole range, k's
//   loaded by ldmatrix.  The chunk's softmax runs on the score fragments in
//   registers (the 4 lanes of a row reduce with two shuffles).  p . v keeps
//   f32 p: p = p_hi + p_lo, two bf16 terms (|p - p_hi - p_lo| <= 2^-18 p),
//   each an mma against v's fragments (ldmatrix.trans) into f32 sums.
//   f32 inputs run the same structure with the products in f32 FMAs, the
//   registers laid out as the fragments.
// * The block merges its warps' states in warp order (shared memory), then
//   the cluster merges the splits as above.
//
// Plain C interface for ctypes: the caller allocates every output, the
// launch goes on the caller's stream, and each function returns the launch's
// error or cudaGetLastError().
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;  // the mask's bias and the initial max
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 16;         // slots per warp per ring stage
constexpr int kMaxSplits = 8;      // the portable cluster size
constexpr int kSmemLimit = 227 * 1024;  // a block's dynamic shared memory
constexpr int kSmemSM = 228 * 1024;     // an SM's, 1 KB a block reserved
constexpr unsigned kFull = 0xffffffffu;

// the shared-memory plan of one instantiation
template <typename T, int D, int G>
struct Shape {
  static constexpr bool MMA = sizeof(T) == 2;  // bf16: tensor cores
  static constexpr int RU = D * (int)sizeof(T) / 16;  // 16-byte units a row
  static constexpr int ROW = RU + 1;          // padded row, in units
  static constexpr int NT = kChunk / 8;       // 8-slot score tiles a chunk
  static constexpr int KS = kChunk / 16;      // 16-slot P . V steps a chunk
  static constexpr int DN = D / 8;            // 8-column output tiles
  static constexpr int KV_BYTES = kChunk * ROW * 16;  // K or V of a chunk
  static constexpr int STAGE = 2 * KV_BYTES + kChunk * 4;
  static constexpr int STATE = (G * D + 16) * 4;  // acc, m, l in f32
  // the block's state, then (f32) q as f32 rows of D + 4
  static constexpr int FIXED = STATE + (MMA ? 0 : G * (D + 4) * 4);
  // ring stages a warp: two, or one where two do not fit (f32 at D 256:
  // 4 warps x 2 stages x 33 KB); one stage waits for each chunk's copies
  static constexpr int STAGES =
      FIXED + kWarps * 2 * STAGE <= kSmemLimit ? 2 : 1;
  static constexpr int WARP_RING = STAGES * STAGE;
  static constexpr int SMEM = FIXED + kWarps * WARP_RING;
  // blocks an SM must hold: caps the registers, so that mixtral's 256
  // blocks (8-block clusters of ~73 KB of shared memory at D 128) are all
  // resident at once (at the compiler's own count they measured slower);
  // where shared memory admits fewer, the registers are not capped below
  // what that count allows (D 256: one block, P . V's 32 n-tiles of f32
  // sums a thread)
  static constexpr int MIN_BLOCKS = 3 * (SMEM + 1024) <= kSmemSM   ? 3
                                    : 2 * (SMEM + 1024) <= kSmemSM ? 2
                                                                   : 1;
  static_assert(RU >= 4 && RU <= 64 && D % 16 == 0 && G <= 8 &&
                    WARP_RING >= STATE && SMEM <= kSmemLimit,
                "head dim, group or shared memory");
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// global -> shared, asynchronous; bytes < size zero-fills the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lane i gives the row address of matrix i / 8
__device__ __forceinline__ void ldsm4(const void* p, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4_t(const void* p, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += A B, A 16x16 bf16 with rows 8-15 zero (a0: rows 0-7, k 0-7; a2:
// rows 0-7, k 8-15), B 16x8 bf16, c 16x8 f32
__device__ __forceinline__ void mma16816(float (&c)[4], unsigned a0,
                                         unsigned a2, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bf16x2(__nv_bfloat162 h) {
  return *reinterpret_cast<unsigned*>(&h);
}

// q (B,K,G,D), k/v (B,C,K,D), bias (B,C) f32.  Shard s of S = gridDim.x / P
// covers slots [s n, (s + 1) n); split p of it (the block's rank in its
// cluster of P) slots [s n + p n / P, s n + (p + 1) n / P), in chunks of
// kChunk slots, chunk i to warp i % kWarps.  kPartial: acc (S,B,K,G,D), m
// and l (S,B,K,G) f32; else out (B,K,G,D) in T (S = 1).
//
// Registers follow mma.m16n8k16's fragments: lane (g, t) = (lane / 4,
// lane % 4) holds row g (query head g; rows G..15 are padding) and columns
// 2t, 2t + 1 of each 8-column tile: the chunk's scores s[nt] (slots nt 8 +
// 2t, + 1), its softmax state (m, l of head g, the same in the 4 lanes of
// the row) and acc[dn] (columns dn 8 + 2t, + 1 of head g's output).
template <typename T, int D, int G, bool kPartial>
__global__ void __launch_bounds__(kThreads, (Shape<T, D, G>::MIN_BLOCKS))
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    int C, int n, int P, float scale, T* __restrict__ out,
                    float* __restrict__ acc_o, float* __restrict__ m_o,
                    float* __restrict__ l_o) {
  using Sh = Shape<T, D, G>;
  constexpr int RU = Sh::RU, ROW = Sh::ROW, NT = Sh::NT, KS = Sh::KS;
  constexpr int DN = Sh::DN, ST = Sh::STAGES;
  constexpr int VEC = 16 / sizeof(T);

  extern __shared__ __align__(16) unsigned char smem[];
  float* sAcc = reinterpret_cast<float*>(smem);  // the block's state
  float* sM = sAcc + G * D;
  float* sL = sM + 8;
  float* sQ = sL + 8;  // f32 only

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int shard = blockIdx.x / P;
  const int h = blockIdx.y, b = blockIdx.z;
  const int K = gridDim.y, B = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* ring = smem + Sh::FIXED + warp * Sh::WARP_RING;

  const int base = shard * n;
  const int c0 = base + static_cast<int>((long long)split * n / P);
  const int c1 = base + static_cast<int>((long long)(split + 1) * n / P);
  const int len = c1 - c0;
  const int nch = (len + kChunk - 1) / kChunk;
  const int mine = warp < nch ? (nch - warp + kWarps - 1) / kWarps : 0;

  const T* qb = q + (size_t)(b * K + h) * G * D;
  // bf16: q as mma A fragments (row g, columns ks 16 + 2t, + 1 and + 8)
  unsigned qa[Sh::MMA ? D / 16 : 1][2];
  if constexpr (Sh::MMA) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const unsigned* qr =
          reinterpret_cast<const unsigned*>(qb + g * D + ks * 16 + 2 * t);
      qa[ks][0] = g < G ? qr[0] : 0u;
      qa[ks][1] = g < G ? qr[4] : 0u;
    }
  } else {
    for (int e = tid; e < G * D; e += kThreads)
      sQ[(e / D) * (D + 4) + e % D] = qb[e];
    __syncthreads();
  }

  const size_t row = (size_t)K * D;  // elements between slots c and c + 1
  const T* kb = k + ((size_t)b * C * K + h) * D;
  const T* vb = v + ((size_t)b * C * K + h) * D;
  const float* bb = bias + (size_t)b * C;

  // the warp's j-th chunk into its stage j % ST; rows past the split's end
  // are zero-filled (their source address stays inside the split)
  auto load = [&](int j) {
    unsigned char* st = ring + (j % ST) * Sh::STAGE;
    const int cb = c0 + (warp + j * kWarps) * kChunk;
    const int cnt = min(kChunk, c1 - cb);
#pragma unroll
    for (int e = lane; e < 2 * kChunk * RU; e += 32) {
      const int which = e / (kChunk * RU);  // 0: K, 1: V
      const int r = (e / RU) % kChunk, u = e % RU;
      const T* src = (which ? vb : kb) + (size_t)(cb + min(r, cnt - 1)) * row +
                     u * VEC;
      cp_async16(st + which * Sh::KV_BYTES + (r * ROW + u) * 16, src,
                 r < cnt ? 16 : 0);
    }
    if (lane < kChunk)
      cp_async4(st + 2 * Sh::KV_BYTES + lane * 4,
                bb + cb + min(lane, cnt - 1), lane < cnt ? 4 : 0);
  };

#pragma unroll
  for (int j = 0; j < ST - 1; ++j) {
    if (j < mine) load(j);
    cp_async_commit();  // an empty group keeps the count uniform
  }

  float m = kNegInf, l = 0.0f;
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[dn][x] = 0.0f;

  for (int j = 0; j < mine; ++j) {
    if constexpr (ST == 1) {
      __syncwarp();  // the warp is done with chunk j - 1: its stage is free
      load(j);
      cp_async_commit();
      cp_async_wait<0>();  // this lane's copies of chunk j landed
      __syncwarp();        // and the warp's
    } else {
      cp_async_wait<ST - 2>();  // this lane's copies of chunk j landed
      __syncwarp();  // and the warp's; stage (j - 1) % ST is free
      if (j + ST - 1 < mine) load(j + ST - 1);
      cp_async_commit();
    }

    const unsigned char* st = ring + (j % ST) * Sh::STAGE;
    const unsigned char* sK = st;
    const unsigned char* sV = st + Sh::KV_BYTES;
    const float* sB = reinterpret_cast<const float*>(st + 2 * Sh::KV_BYTES);
    const int cnt = min(kChunk, len - (warp + j * kWarps) * kChunk);

    // scores of the chunk: q . k for slots nt 8 + 2t, + 1, head g
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) s[nt][x] = 0.0f;
    if constexpr (Sh::MMA) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int ks = 0; ks < D / 16; ks += 2) {
          unsigned kf[4];  // B fragments of k-steps ks and ks + 1
          ldsm4(sK + (nt * 8 + (lane & 7)) * ROW * 16 +
                    (ks * 16 + (lane >> 3) * 8) * 2,
                kf);
          mma16816(s[nt], qa[ks][0], qa[ks][1], kf[0], kf[1]);
          mma16816(s[nt], qa[ks + 1][0], qa[ks + 1][1], kf[2], kf[3]);
        }
      }
    } else if (g < G) {
      const float* qr = sQ + g * (D + 4);
      const float* kr = reinterpret_cast<const float*>(sK);
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 qq = *reinterpret_cast<const float4*>(qr + d);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const float4 kk = *reinterpret_cast<const float4*>(
                kr + (nt * 8 + 2 * t + x) * ROW * 4 + d);
            s[nt][x] = fmaf(qq.x, kk.x, s[nt][x]);
            s[nt][x] = fmaf(qq.y, kk.y, s[nt][x]);
            s[nt][x] = fmaf(qq.z, kk.z, s[nt][x]);
            s[nt][x] = fmaf(qq.w, kk.w, s[nt][x]);
          }
      }
    }

    // one max per head per chunk, one exp per slot, one correction
    float mx = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int c = nt * 8 + 2 * t + x;
        s[nt][x] = c < cnt ? fmaf(s[nt][x], scale, sB[c])
                           : __int_as_float(0xff800000);  // -inf: no slot
        mx = fmaxf(mx, s[nt][x]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m, mx);
    float sum = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        s[nt][x] = expf(s[nt][x] - m_new);  // now p
        sum += s[nt][x];
      }
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    const float corr = expf(m - m_new);
    l = l * corr + sum;
    m = m_new;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      acc[dn][0] *= corr;
      acc[dn][1] *= corr;
    }

    // acc += p v with f32 p: on tensor cores as p_hi + p_lo, two bf16 terms
    // (p - p_hi rounds to bf16 with |error| <= 2^-18 p), against exact bf16
    // v; in f32 FMAs for f32
    if constexpr (Sh::MMA) {
#pragma unroll
      for (int kj = 0; kj < KS; ++kj) {
        const __nv_bfloat162 h0 =
            __floats2bfloat162_rn(s[2 * kj][0], s[2 * kj][1]);
        const __nv_bfloat162 h2 =
            __floats2bfloat162_rn(s[2 * kj + 1][0], s[2 * kj + 1][1]);
        const float2 f0 = __bfloat1622float2(h0);
        const float2 f2 = __bfloat1622float2(h2);
        const unsigned hi0 = bf16x2(h0), hi2 = bf16x2(h2);
        const unsigned lo0 = bf16x2(__floats2bfloat162_rn(
            s[2 * kj][0] - f0.x, s[2 * kj][1] - f0.y));
        const unsigned lo2 = bf16x2(__floats2bfloat162_rn(
            s[2 * kj + 1][0] - f2.x, s[2 * kj + 1][1] - f2.y));
#pragma unroll
        for (int dn = 0; dn < DN; dn += 2) {
          unsigned vf[4];  // B fragments of column tiles dn and dn + 1
          ldsm4_t(sV + (kj * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ROW *
                           16 +
                      (dn * 8 + (lane >> 4) * 8) * 2,
                  vf);
          mma16816(acc[dn], hi0, hi2, vf[0], vf[1]);
          mma16816(acc[dn], lo0, lo2, vf[0], vf[1]);
          mma16816(acc[dn + 1], hi0, hi2, vf[2], vf[3]);
          mma16816(acc[dn + 1], lo0, lo2, vf[2], vf[3]);
        }
      }
    } else {
      const float* vr = reinterpret_cast<const float*>(sV);
#pragma unroll
      for (int tt = 0; tt < 4; ++tt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            // p of head g at slot nt 8 + 2 tt + x, from lane (g, tt)
            const float p =
                __shfl_sync(kFull, s[nt][x], (lane & ~3) | tt);
            const float* vs = vr + (nt * 8 + 2 * tt + x) * ROW * 4 + 2 * t;
#pragma unroll
            for (int dn = 0; dn < DN; ++dn) {
              const float2 vv = *reinterpret_cast<const float2*>(vs + dn * 8);
              acc[dn][0] = fmaf(p, vv.x, acc[dn][0]);
              acc[dn][1] = fmaf(p, vv.y, acc[dn][1]);
            }
          }
    }
  }

  // the warp's state into its own ring, then the block's: the warps merged
  // in warp order with the combine's rule
  cp_async_wait<0>();
  __syncwarp();
  float* wAcc = reinterpret_cast<float*>(ring);
  if (g < G) {
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      wAcc[g * D + dn * 8 + 2 * t] = acc[dn][0];
      wAcc[g * D + dn * 8 + 2 * t + 1] = acc[dn][1];
    }
    if (t == 0) {
      wAcc[G * D + g] = m;
      wAcc[G * D + 8 + g] = l;
    }
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += kThreads) {
    const int gg = e / D;
    float ms[kWarps];
    float mg = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* st = reinterpret_cast<const float*>(
          smem + Sh::FIXED + w * Sh::WARP_RING);
      ms[w] = st[G * D + gg];
      mg = fmaxf(mg, ms[w]);
    }
    float lt = 0.0f, at = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* st = reinterpret_cast<const float*>(
          smem + Sh::FIXED + w * Sh::WARP_RING);
      const float cw = expf(ms[w] - mg);
      lt = lt + st[G * D + 8 + gg] * cw;
      at = at + st[e] * cw;
    }
    sAcc[e] = at;
    if (e % D == 0) {
      sM[gg] = mg;
      sL[gg] = lt;
    }
  }
  cluster.sync();  // every split's state is in its shared memory

  // merge the P splits in split order; each block takes a share of the
  // G x D outputs, reading the others' states through distributed smem
  for (int e = split * kThreads + tid; e < G * D; e += P * kThreads) {
    const int gg = e / D, d = e % D;
    float ms[kMaxSplits];
    float mg = kNegInf;
#pragma unroll
    for (int p = 0; p < kMaxSplits; ++p) {
      if (p < P) {
        ms[p] = *cluster.map_shared_rank(sM + gg, p);
        mg = fmaxf(mg, ms[p]);
      }
    }
    float lt = 0.0f, at = 0.0f;
#pragma unroll
    for (int p = 0; p < kMaxSplits; ++p) {
      if (p < P) {
        const float corr = expf(ms[p] - mg);
        lt = lt + *cluster.map_shared_rank(sL + gg, p) * corr;
        at = at + *cluster.map_shared_rank(sAcc + e, p) * corr;
      }
    }
    if constexpr (kPartial) {
      const size_t r = (((size_t)shard * B + b) * K + h) * G + gg;
      acc_o[r * D + d] = at;
      if (d == 0) {
        m_o[r] = mg;
        l_o[r] = lt;
      }
    } else {
      store(out + ((size_t)(b * K + h) * G + gg) * D + d,
            at / fmaxf(lt, 1e-30f));
    }
  }
  cluster.sync();  // no block leaves while another still reads its smem
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

// one launch of P-block clusters over the (S P, K, B) grid
template <typename T, int D, int G, bool kPartial>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, void* out, float* acc, float* m,
                   float* l, int B, int C, int K, int S, int P, float scale,
                   cudaStream_t st) {
  using Sh = Shape<T, D, G>;
  void (*kern)(const T*, const T*, const T*, const float*, int, int, int,
               float, T*, float*, float*, float*) =
      flash_decode_kernel<T, D, G, kPartial>;
  // above 48 KB of dynamic shared memory needs the attribute; a host-side
  // setting, so a launch under CUDA-graph capture may set it too
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * P, K, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = Sh::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(q),
                            static_cast<const T*>(k), static_cast<const T*>(v),
                            bias, C, C / S, P, scale, static_cast<T*>(out),
                            acc, m, l);
}

template <typename T, int D, int G>
cudaError_t launch_p(bool partial, const void* q, const void* k,
                     const void* v, const float* bias, void* out, float* acc,
                     float* m, float* l, int B, int C, int K, int S, int P,
                     float scale, cudaStream_t st) {
  return partial ? launch<T, D, G, true>(q, k, v, bias, out, acc, m, l, B, C,
                                         K, S, P, scale, st)
                 : launch<T, D, G, false>(q, k, v, bias, out, acc, m, l, B,
                                          C, K, S, P, scale, st);
}

template <typename T, int D>
cudaError_t launch_g(int G, bool partial, const void* q, const void* k,
                     const void* v, const float* bias, void* out, float* acc,
                     float* m, float* l, int B, int C, int K, int S, int P,
                     float scale, cudaStream_t st) {
  switch (G) {
    case 2:
      return launch_p<T, D, 2>(partial, q, k, v, bias, out, acc, m, l, B, C,
                               K, S, P, scale, st);
    case 4:
      return launch_p<T, D, 4>(partial, q, k, v, bias, out, acc, m, l, B, C,
                               K, S, P, scale, st);
    case 6:
      return launch_p<T, D, 6>(partial, q, k, v, bias, out, acc, m, l, B, C,
                               K, S, P, scale, st);
    case 8:
      return launch_p<T, D, 8>(partial, q, k, v, bias, out, acc, m, l, B, C,
                               K, S, P, scale, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_d(int D, int G, bool partial, const void* q,
                     const void* k, const void* v, const float* bias,
                     void* out, float* acc, float* m, float* l, int B, int C,
                     int K, int S, int P, float scale, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch_g<T, 32>(G, partial, q, k, v, bias, out, acc, m, l, B, C,
                             K, S, P, scale, st);
    case 64:
      return launch_g<T, 64>(G, partial, q, k, v, bias, out, acc, m, l, B, C,
                             K, S, P, scale, st);
    case 128:
      return launch_g<T, 128>(G, partial, q, k, v, bias, out, acc, m, l, B,
                              C, K, S, P, scale, st);
    case 256:
      return launch_g<T, 256>(G, partial, q, k, v, bias, out, acc, m, l, B,
                              C, K, S, P, scale, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v and out alike); D in {32, 64, 128,
// 256}, G in {2, 4, 6, 8}, S >= 1 dividing C, P in {1, 2, 4, 8} capacity splits per
// shard with P <= C / S.  partial = 0: out (B,K,G,D), S = 1; partial = 1:
// acc (S,B,K,G,D), m and l (S,B,K,G) f32.  Every array is contiguous; q, k
// and v 16-byte aligned.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* bias, void* out, void* acc,
                                  void* m, void* l, int B, int C, int K,
                                  int G, int D, int S, int P, int dtype,
                                  int partial, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bi = static_cast<const float*>(bias);
  float* a = static_cast<float*>(acc);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  if (S < 1 || C % S || (!partial && S != 1) || P < 1 || P > kMaxSplits ||
      (P & (P - 1)) || P > C / S)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = launch_d<float>(D, G, partial != 0, q, k, v, bi, out, a, mm, ll, B,
                          C, K, S, P, scale, st);
  else if (dtype == 1)
    err = launch_d<__nv_bfloat16>(D, G, partial != 0, q, k, v, bi, out, a, mm,
                                  ll, B, C, K, S, P, scale, st);
  if (err != cudaSuccess) return (int)err;
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
