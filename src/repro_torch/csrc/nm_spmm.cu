// 2:4 compressed matmul for Hopper: out (M, N) = x (M, K) @ W (K, N), with W
// pruned 2:4 along K and given compressed as vals (K/2, N) plus in-group
// positions, either packed 4-per-byte (K/8, N) uint8 or int8 (K/2, N); and
// its expert-banked form, out (E, M, N) = x (E, M, K) @ W (E, K, N), one such
// product per expert of an MoE bank.
//
// Replaces the TPU kernels src/repro/kernels/nm_spmm.py::nm_matmul
// (_nm_matmul_kernel) and ::nm_matmul_expert (_nm_matmul_expert_kernel).  On
// the TPU the compressed tile was expanded to dense with a masked select and
// fed to the MXU.  Here nothing is expanded.
//
// bf16 inputs (the serving paths): the sparse tensor cores.  The kernel
// computes y^T (N x M) = W^T (N x K, 2:4 along K) . x^T (K x M) with
// mma.sp m16n8k32: W^T is the sparse A operand, vals^T its compressed
// values, and x, row-major (M, K), is already B's "col" layout.  A block
// owns 64 output columns (A rows) and up to 64 rows of x (B columns, in n8
// tiles), so each weight tile is read from device memory once for all of a
// block's rows, up to 64; more rows take more 64-row tiles of the grid
// (at 128 rows two tiles ran faster on the H100 than one 16-warp block).
// Four warps split the block's columns, one m16 A tile each; up to 40 rows
// they take every n8 tile, for 64 rows two such rows of warps split the n8
// tiles.  vals, index and x tiles stream through a ring of 3
// shared-memory stages filled with 16-byte cp.async copies (XOR-swizzled so
// the ldmatrix reads hit distinct banks); the A fragments come out with
// ldmatrix.trans, since vals is N-contiguous.
// The metadata is the packed2 plane as stored: byte (r, n) holds the 2-bit
// positions of groups 2r (bits 0-3) and 2r+1 (bits 4-7), ascending, which is
// the nibble mma.sp takes for 2:4 on 16-bit types; per thread it is
// arranged as the PTX ISA's m16n8k32 metadata layout (thread 4g + t, t in
// {0, 1}: 16 bits of row g, then 16 of row g + 8, for groups 4t..4t+3 of the
// k32 step).  The int8 plane is packed into the same bytes as it is staged.
// Tails (K % 32, ragged N and M) are zero-filled in shared memory, and a
// zero nibble (nothing stored) becomes the valid code 0x4 over zero values.
//
// f32 inputs: the SIMT kernel (each thread owns two adjacent output columns
// and walks the 2:4 groups, gathering x from shared memory; f32 FMAs).
//
// Both kernels split K across blocks when the expert x N x M grid is under
// ~2 blocks per SM.  Split-K takes one launch: every block writes its f32
// partial tile, and the last block to arrive at a tile (an arrival counter
// per tile) adds the partials in split order, so the sum is deterministic,
// and resets the counter for the next launch (CUDA-graph replay repeats it
// bit for bit).
//
// What bounds it: at decode (M = serving slots, or the MoE capacity C, a
// handful) the work is ~M flops per weight byte, far under the ~295
// flops/byte at which the H100's bf16 rate and HBM rate balance, so the
// bound is the bytes of the compressed weight (1.125 B per weight with the
// packed plane): one Mixtral-8x22B expert bank, 8 x 6144 x 16384 weights, is
// 0.906 GB, 0.27 ms at 3.35 TB/s.  At M = 64-128 the operations' bound is
// still under the bytes', but this kernel is not: every 64-column block
// re-reads its rows of x from L2, and each k32 step is a chain of ldmatrix
// and mma.sp latencies with few warps to hide it (wgmma is the next step).
// Blocks per SM matter more than ring depth: on the H100 a 4-stage ring
// (a block fewer per SM) was slower at 24-40 rows, and no faster at
// decode.
//
// Plain C interface for ctypes: the caller allocates the output, the split-K
// workspace and the tile counters (zeroed once; the kernel leaves them
// zero), the launch goes on the caller's stream, and the function returns
// cudaGetLastError() without synchronising.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 64;        // output columns per block (both kernels)

// ---------------------------------------------------------------------------
// Split-K in one launch: the last block at a tile sums the partials
// ---------------------------------------------------------------------------

// After every thread wrote its share of this block's partial tile to ws:
// true in the block that arrives last at the tile (all partials visible).
__device__ __forceinline__ bool last_to_arrive(int* counter, int ksplit) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == ksplit - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The last block's pass: out[o] = the sum over splits, in split order, of
// ws[s * stride + o] for the tile's mt x kBN elements o = base + m N + n
// (n < ncols).  A thread takes U elements at a time and loads KU splits of
// each before it adds them, so U x KU loads are in flight at once.
template <int kThreadsT, typename TOut>
__device__ void add_splits(const float* __restrict__ ws,
                           TOut* __restrict__ out, size_t base, int mt,
                           int ncols, int N, size_t stride, int ksplit) {
  constexpr int U = 4, KU = 8;
  for (int i0 = threadIdx.x; i0 < mt * kBN; i0 += U * kThreadsT) {
    float s[U];
    const float* p[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kThreadsT, m = i / kBN, n = i % kBN;
      ok[u] = i < mt * kBN && n < ncols;
      p[u] = ws + base + (size_t)m * N + n;
      s[u] = 0.f;
    }
    for (int k0 = 0; k0 < ksplit; k0 += KU) {
      float v[KU][U];
#pragma unroll
      for (int kk = 0; kk < KU; ++kk)
#pragma unroll
        for (int u = 0; u < U; ++u)
          v[kk][u] = ok[u] && k0 + kk < ksplit
                         ? __ldcg(p[u] + (k0 + kk) * stride) : 0.f;
#pragma unroll
      for (int kk = 0; kk < KU; ++kk)
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (k0 + kk < ksplit) s[u] += v[kk][u];
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (ok[u]) store(out + (p[u] - ws), s[u]);
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sp on the sparse tensor cores
// ---------------------------------------------------------------------------

constexpr int kStages = 3;     // shared-memory ring

// Four warps along N, each one m16 A tile (16 output columns), times WM
// warps along M, each TM n8 tiles (8 rows of x).
template <int TM, int WM>
struct Tile {
  static constexpr int kWarpsN = kBN / 16;
  static constexpr int kWarpsM = WM;
  static constexpr int THREADS = 32 * kWarpsN * kWarpsM;
  static constexpr int BM = kWarpsM * TM * 8;     // rows of x per block
  static constexpr int KC = 128;                  // logical K per stage
  static constexpr int KS = KC / 32;              // k32 steps per stage
  static constexpr int A_BYTES = (KC / 2) * kBN * 2;  // vals [c][n], bf16
  static constexpr int I_BYTES = (KC / 8) * kBN;      // packed idx [r][n]
  static constexpr int X_BYTES = BM * KC * 2;         // x [m][k], bf16
  static constexpr int STAGE = A_BYTES + I_BYTES + X_BYTES;
  static constexpr int OUT_LD = kBN + 4;              // f32 epilogue tile
  static constexpr int SMEM = kStages * STAGE > BM * OUT_LD * 4
                                  ? kStages * STAGE : BM * OUT_LD * 4;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, the bytes past src_bytes zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += A (16 x 32, 2:4, compressed 16 x 16) . B (32 x 8); e: metadata from
// threads t 0-1 of each quad (sparsity selector 0)
__device__ __forceinline__ void mma_sp(float (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[4], uint32_t e) {
  asm volatile(
#if (__CUDACC_VER_MAJOR__ > 12) || \
    (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 5)
      "mma.sp::ordered_metadata.sync.aligned.m16n8k32.row.col.f32.bf16.bf16"
      ".f32 "
#else
      "mma.sp.sync.aligned.m16n8k32.row.col.f32.bf16.bf16.f32 "
#endif
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9,%10,%11}, {%0,%1,%2,%3}, %12, "
      "0x0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "r"(b[2]), "r"(b[3]), "r"(e));
}

// one metadata register: 16 bits (groups 4t'..4t'+3 of a k32 step) of A row
// n, then of row n + 8; byte rows 2t', 2t'+1 of the step's four.  A zero
// nibble (zero-filled tail) becomes 0x4, positions (0, 1), over zero values.
__device__ __forceinline__ uint32_t meta_word(const uint8_t* idx_step, int n,
                                              int tp) {
  const uint8_t* p = idx_step + 2 * tp * kBN + n;
  uint32_t e = (uint32_t)p[0] | ((uint32_t)p[kBN] << 8) |
               ((uint32_t)p[8] << 16) | ((uint32_t)p[kBN + 8] << 24);
  const uint32_t zero = ~(e | (e >> 1) | (e >> 2) | (e >> 3)) & 0x11111111u;
  return e | (zero << 2);
}

struct MmaArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* vals;
  const uint8_t* idx;
  void* out;
  float* ws;
  int* counters;
  int E, M, K, N, ksplit, stages_per_split;
  bool out_bf16, packed, x_vec, vals_vec, idx_vec;
};

// Stage `st` of this block's K range into ring slot `buf`: vals rows
// [k0/2, (k0+KC)/2), index byte rows [k0/8, (k0+KC)/8) and x columns
// [k0, k0+KC) of the block's rows, zero past K, N and M.  16-byte cp.async
// where rows and pointers allow, else element loads (the int8 plane always:
// it is packed to the packed2 bytes here).
template <class T>
__device__ __forceinline__ void load_stage(
    uint8_t* smem, int buf, int k0, const MmaArgs& a,
    const __nv_bfloat16* x, const __nv_bfloat16* vals, const uint8_t* idx,
    int n_blk, int m_blk) {
  uint8_t* sa = smem + buf * T::STAGE;
  uint8_t* si = sa + T::A_BYTES;
  uint8_t* sx = si + T::I_BYTES;
  const int K = a.K, N = a.N, M = a.M, half_k = K / 2;
  // vals: KC/2 rows x 8 chunks of 8 columns; chunk q of row c at q ^ (c & 7)
  if (a.vals_vec) {
    for (int i = threadIdx.x; i < (T::KC / 2) * 8; i += T::THREADS) {
      const int c = i >> 3, q = i & 7;
      const int cg = k0 / 2 + c, n = n_blk + 8 * q;
      const bool ok = cg < half_k && n < N;
      cp_async16(smem_addr(sa + c * (kBN * 2) + ((q ^ (c & 7)) << 4)),
                 ok ? (const void*)(vals + (size_t)cg * N + n) : vals,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < (T::KC / 2) * (kBN / 2); i += T::THREADS) {
      const int c = i / (kBN / 2), j = 2 * (i % (kBN / 2));
      const int cg = k0 / 2 + c, n = n_blk + j;
      uint32_t v = 0;
      if (cg < half_k && n < N)  // N even: the pair is whole
        v = *reinterpret_cast<const uint32_t*>(vals + (size_t)cg * N + n);
      *reinterpret_cast<uint32_t*>(sa + c * (kBN * 2) +
                                   (((j >> 3) ^ (c & 7)) << 4) +
                                   (j & 7) * 2) = v;
    }
  }
  // index: KC/8 byte rows of kBN bytes, unswizzled
  if (a.idx_vec) {
    for (int i = threadIdx.x; i < (T::KC / 8) * (kBN / 16); i += T::THREADS) {
      const int r = i / (kBN / 16), q = i % (kBN / 16);
      const int rg = k0 / 8 + r, n = n_blk + 16 * q;
      const bool ok = rg < K / 8 && n < N;
      cp_async16(smem_addr(si + r * kBN + 16 * q),
                 ok ? (const void*)(idx + (size_t)rg * N + n) : idx,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < (T::KC / 8) * kBN; i += T::THREADS) {
      const int r = i / kBN, j = i % kBN;
      const int rg = k0 / 8 + r, n = n_blk + j;
      uint32_t byte = 0;
      if (n < N) {
        if (a.packed) {
          if (rg < K / 8) byte = idx[(size_t)rg * N + n];
        } else {  // compressed rows 4rg..4rg+3, two bits each
          for (int u = 0; u < 4; ++u) {
            const int c = 4 * rg + u;
            if (c < half_k) byte |= (uint32_t)(idx[(size_t)c * N + n] & 3)
                                    << (2 * u);
          }
        }
      }
      si[r * kBN + j] = (uint8_t)byte;
    }
  }
  // x: BM rows x KC/8 chunks of 8; chunk q of row m at q ^ (m & 7)
  if (a.x_vec) {
    for (int i = threadIdx.x; i < T::BM * (T::KC / 8); i += T::THREADS) {
      const int m = i / (T::KC / 8), q = i % (T::KC / 8);
      const int mg = m_blk + m, k = k0 + 8 * q;
      const bool ok = mg < M && k < K;
      cp_async16(smem_addr(sx + m * (T::KC * 2) + ((q ^ (m & 7)) << 4)),
                 ok ? (const void*)(x + (size_t)mg * K + k) : x, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < T::BM * (T::KC / 2); i += T::THREADS) {
      const int m = i / (T::KC / 2), j = 2 * (i % (T::KC / 2));
      const int mg = m_blk + m, k = k0 + j;
      uint32_t v = 0;
      if (mg < M && k < K)  // K % 4 == 0: the pair is whole
        v = *reinterpret_cast<const uint32_t*>(x + (size_t)mg * K + k);
      *reinterpret_cast<uint32_t*>(sx + m * (T::KC * 2) +
                                   (((j >> 3) ^ (m & 7)) << 4) +
                                   (j & 7) * 2) = v;
    }
  }
}

// grid: (ceil(N / kBN), ksplit, E * ceil(M / BM)); block (bx, s, z) with
// z = e * ceil(M / BM) + bz computes expert e's columns [bx*kBN, +kBN) of
// rows [bz*BM, +BM) over the s-th range of K stages.
template <int TM, int WM>
__global__ void __launch_bounds__(Tile<TM, WM>::THREADS)
nm_mma_kernel(const MmaArgs a) {
  using T = Tile<TM, WM>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int mtiles = (a.M + T::BM - 1) / T::BM;
  const int e = blockIdx.z / mtiles;
  const int m_blk = (blockIdx.z - e * mtiles) * T::BM;
  const int n_blk = blockIdx.x * kBN;
  const int K = a.K, N = a.N, M = a.M;
  const __nv_bfloat16* x = a.x + (size_t)e * M * K;
  const __nv_bfloat16* vals = a.vals + (size_t)e * (K / 2) * N;
  const uint8_t* idx = a.idx + (size_t)e * (a.packed ? K / 8 : K / 2) * N;

  const int stages = (K + T::KC - 1) / T::KC;
  const int st_lo = blockIdx.y * a.stages_per_split;
  const int n_st = min(stages, st_lo + a.stages_per_split) - st_lo;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wn = (warp % T::kWarpsN) * 16;       // warp's first A row
  const int wm = (warp / T::kWarpsN) * TM * 8;   // warp's first x row
  const int g = lane >> 2, t = lane & 3;

  float acc[TM][4];
#pragma unroll
  for (int j = 0; j < TM; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_st)
      load_stage<T>(smem, s, (st_lo + s) * T::KC, a, x, vals, idx, n_blk,
                    m_blk);
    cp_async_commit();
  }

  // per-lane ldmatrix offsets: A (trans) row c = r + 8 (mat >> 1) at
  // chunk a_q (columns wn + 8 (mat & 1)); B row m = wm + 8 j + r at chunk
  // mat of the k32 step
  const int r8 = lane & 7, mat = lane >> 3;
  const int a_row = r8 + 8 * (mat >> 1), a_q = (wn >> 3) + (mat & 1);
  for (int s = 0; s < n_st; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed; stage s - 1 is consumed
    const int nxt = s + kStages - 1;
    if (nxt < n_st)
      load_stage<T>(smem, nxt % kStages, (st_lo + nxt) * T::KC, a, x, vals,
                    idx, n_blk, m_blk);
    cp_async_commit();

    const uint8_t* sa = smem + (s % kStages) * T::STAGE;
    const uint8_t* si = sa + T::A_BYTES;
    const uint8_t* sx = si + T::I_BYTES;
    const int k_left = K - (st_lo + s) * T::KC;
#pragma unroll
    for (int ks = 0; ks < T::KS; ++ks) {
      if (ks * 32 >= k_left) break;  // zero past K: nothing to add
      uint32_t af[4];
      ldsm_x4_trans(af, smem_addr(sa + (16 * ks + a_row) * (kBN * 2) +
                                  ((a_q ^ r8) << 4)));
      const uint32_t meta = meta_word(si + 4 * ks * kBN, wn + g, t & 1);
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        uint32_t bf[4];
        const int m = wm + 8 * j + r8;
        ldsm_x4(bf, smem_addr(sx + m * (T::KC * 2) +
                              (((4 * ks + mat) ^ r8) << 4)));
        mma_sp(acc[j], af, bf, meta);
      }
    }
  }

  // epilogue: the f32 tile through shared memory, then coalesced stores
  cp_async_wait<0>();
  __syncthreads();
  float* so = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < TM; ++j) {
    const int n = wn + g, m = wm + 8 * j + 2 * t;
    so[m * T::OUT_LD + n] = acc[j][0];
    so[(m + 1) * T::OUT_LD + n] = acc[j][1];
    so[m * T::OUT_LD + n + 8] = acc[j][2];
    so[(m + 1) * T::OUT_LD + n + 8] = acc[j][3];
  }
  __syncthreads();
  const int mt = min(T::BM, M - m_blk);
  const size_t emn = (size_t)a.E * M * N;
  const size_t base = (size_t)e * M * N + (size_t)m_blk * N + n_blk;
  for (int i = threadIdx.x; i < mt * kBN; i += T::THREADS) {
    const int m = i / kBN, n = i % kBN;
    if (n_blk + n >= N) continue;
    const float v = so[m * T::OUT_LD + n];
    const size_t o = base + (size_t)m * N + n;
    if (a.ksplit > 1) {
      a.ws[blockIdx.y * emn + o] = v;
    } else if (a.out_bf16) {
      static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16(v);
    } else {
      static_cast<float*>(a.out)[o] = v;
    }
  }
  if (a.ksplit == 1) return;
  int* counter = a.counters + blockIdx.z * gridDim.x + blockIdx.x;
  if (!last_to_arrive(counter, a.ksplit)) return;
  if (a.out_bf16) {
    add_splits<T::THREADS>(a.ws, static_cast<__nv_bfloat16*>(a.out), base, mt,
                         N - n_blk, N, emn, a.ksplit);
  } else {
    add_splits<T::THREADS>(a.ws, static_cast<float*>(a.out), base, mt,
                         N - n_blk, N, emn, a.ksplit);
  }
  if (threadIdx.x == 0) *counter = 0;
}

template <int TM, int WM>
cudaError_t launch_mma(const MmaArgs& a, cudaStream_t stream) {
  using T = Tile<TM, WM>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      nm_mma_kernel<TM, WM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (attr != cudaSuccess) return attr;
  const long long z = (long long)a.E * ((a.M + T::BM - 1) / T::BM);
  if (z > 65535 || a.ksplit > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((a.N + kBN - 1) / kBN, a.ksplit, (unsigned)z);
  nm_mma_kernel<TM, WM><<<grid, T::THREADS, T::SMEM, stream>>>(a);
  return cudaGetLastError();
}

// the block's row tile from M: 8, 16, 32, 40 rows (4 warps), else 64 (8
// warps); 40 is the MoE capacity of a 128-token prompt
cudaError_t launch_mma_rows(const MmaArgs& a, cudaStream_t s) {
  if (a.M <= 8) return launch_mma<1, 1>(a, s);
  if (a.M <= 16) return launch_mma<2, 1>(a, s);
  if (a.M <= 32) return launch_mma<4, 1>(a, s);
  if (a.M <= 40) return launch_mma<5, 1>(a, s);
  return launch_mma<4, 2>(a, s);
}

// ---------------------------------------------------------------------------
// f32: the SIMT kernel
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;              // warps splitting the block's K range
constexpr int kSimtThreads = 32 * kWarps;
constexpr int kMaxBM = 16;             // rows of x per block, at most
constexpr int kKC = 256;               // dense K rows of x staged per chunk
constexpr int kSmemFloats = kWarps * kMaxBM * kBN;  // 32 KB; >= kMaxBM * kKC

// grid: (ceil(N / kBN), ksplit, E * ceil(M / BM)).  Block (bx, s, z) with
// z = e * ceil(M / BM) + bz computes, for expert e, columns
// [bx*kBN, bx*kBN + kBN) of rows [bz*BM, bz*BM + BM) over the s-th
// contiguous range of 2:4 groups.  With ksplit == 1 it writes `out`;
// otherwise f32 partial sums go to ws[s][e] and the last block adds them.
template <bool kPacked, int BM>
__global__ void __launch_bounds__(kSimtThreads)
nm_simt_kernel(const float* __restrict__ x, const float* __restrict__ vals,
               const uint8_t* __restrict__ idx, float* __restrict__ out,
               float* __restrict__ ws, int* __restrict__ counters, int E,
               int M, int K, int N, int ksplit) {
  __shared__ float smem[kSmemFloats];

  const size_t mn = (size_t)M * N;
  // this expert's operands: x (M, K), vals (K/2, N), idx (K/8 | K/2, N),
  // out and each split's workspace slice (M, N)
  const int e = blockIdx.z / ((M + BM - 1) / BM);
  x += (size_t)e * M * K;
  vals += (size_t)e * (K / 2) * N;
  idx += (size_t)e * (kPacked ? K / 8 : K / 2) * N;
  out += (size_t)e * mn;

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
    for (int i = threadIdx.x; i < BM * rows; i += kSimtThreads) {
      const int m = i / rows, k = i - m * rows;
      smem[m * kKC + k] = m < mt ? x[(size_t)(m0 + m) * K + 4 * c0 + k] : 0.f;
    }
    __syncthreads();
    if (n0 < N) {
      for (int g = c0 + warp; g < c1; g += kWarps) {
        const float2 v0 =
            *reinterpret_cast<const float2*>(vals + (size_t)(2 * g) * N + n0);
        const float2 v1 = *reinterpret_cast<const float2*>(
            vals + (size_t)(2 * g + 1) * N + n0);
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
  const size_t emn = (size_t)E * mn;
  for (int i = threadIdx.x; i < mt * kBN; i += kSimtThreads) {
    const int m = i / kBN, c = i - m * kBN;
    const int n = blockIdx.x * kBN + c;
    if (n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += smem[(w * BM + m) * kBN + c];
    const size_t o = (size_t)(m0 + m) * N + n;
    if (ksplit == 1) {
      out[o] = s;
    } else {
      ws[blockIdx.y * emn + e * mn + o] = s;
    }
  }
  if (ksplit == 1) return;
  int* counter = counters + blockIdx.z * gridDim.x + blockIdx.x;
  if (!last_to_arrive(counter, ksplit)) return;
  // out was offset by e * mn above; ws still starts at expert 0
  add_splits<kSimtThreads>(ws + e * mn, out, (size_t)m0 * N + blockIdx.x * kBN,
                           mt, N - (int)blockIdx.x * kBN, N, emn, ksplit);
  if (threadIdx.x == 0) *counter = 0;
}

struct SimtArgs {
  const float* x;
  const float* vals;
  const uint8_t* idx;
  float* out;
  float* ws;
  int* counters;
  int E, M, K, N, ksplit;
};

template <bool kPacked, int BM>
cudaError_t launch_simt(const SimtArgs& a, cudaStream_t stream) {
  const long long z = (long long)a.E * ((a.M + BM - 1) / BM);
  if (z > 65535 || a.ksplit > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((a.N + kBN - 1) / kBN, a.ksplit, (unsigned)z);
  nm_simt_kernel<kPacked, BM><<<grid, kSimtThreads, 0, stream>>>(
      a.x, a.vals, a.idx, a.out, a.ws, a.counters, a.E, a.M, a.K, a.N,
      a.ksplit);
  return cudaGetLastError();
}

template <bool kPacked>
cudaError_t launch_simt_rows(const SimtArgs& a, cudaStream_t s) {
  if (a.M <= 1) return launch_simt<kPacked, 1>(a, s);
  if (a.M <= 2) return launch_simt<kPacked, 2>(a, s);
  if (a.M <= 4) return launch_simt<kPacked, 4>(a, s);
  if (a.M <= 8) return launch_simt<kPacked, 8>(a, s);
  return launch_simt<kPacked, kMaxBM>(a, s);
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

template <int TM, int WM>
int mma_smem(int* static_bytes, int* dynamic_bytes) {
  return smem_of(nm_mma_kernel<TM, WM>, Tile<TM, WM>::SMEM, static_bytes,
                 dynamic_bytes);
}

template <bool kPacked>
int simt_smem(int M, int* static_bytes, int* dynamic_bytes) {
  if (M <= 1) return smem_of(nm_simt_kernel<kPacked, 1>, 0, static_bytes,
                             dynamic_bytes);
  if (M <= 2) return smem_of(nm_simt_kernel<kPacked, 2>, 0, static_bytes,
                             dynamic_bytes);
  if (M <= 4) return smem_of(nm_simt_kernel<kPacked, 4>, 0, static_bytes,
                             dynamic_bytes);
  if (M <= 8) return smem_of(nm_simt_kernel<kPacked, 8>, 0, static_bytes,
                             dynamic_bytes);
  return smem_of(nm_simt_kernel<kPacked, kMaxBM>, 0, static_bytes,
                 dynamic_bytes);
}

}  // namespace

// The shared memory of the instantiation repro_nm_matmul_expert launches
// for M rows, in_bf16 and packed as it takes them (see smem_of).
extern "C" int repro_nm_matmul_smem(int M, int in_bf16, int packed,
                                    int* static_bytes, int* dynamic_bytes) {
  if (in_bf16) {
    if (M <= 8) return mma_smem<1, 1>(static_bytes, dynamic_bytes);
    if (M <= 16) return mma_smem<2, 1>(static_bytes, dynamic_bytes);
    if (M <= 32) return mma_smem<4, 1>(static_bytes, dynamic_bytes);
    if (M <= 40) return mma_smem<5, 1>(static_bytes, dynamic_bytes);
    return mma_smem<4, 2>(static_bytes, dynamic_bytes);
  }
  return packed ? simt_smem<true>(M, static_bytes, dynamic_bytes)
                : simt_smem<false>(M, static_bytes, dynamic_bytes);
}

// out (E, M, N) = x (E, M, K) @ W (E, K, N), per expert, W given as vals
// (E, K/2, N) and idx (E, K/8, N) packed or (E, K/2, N) int8; the 2-D
// product is E = 1.  in_bf16: x and vals bf16, the mma.sp kernel (out bf16
// or, out_bf16 = 0, f32); else x, vals and out f32, the SIMT kernel.
// packed: the packed plane (K % 8 == 0), else the int8 plane.  ws: ksplit x
// E x M x N f32 scratch and counters: one int per output tile (grid x by z),
// zero, when ksplit > 1.  stages_per_split: K stages (mma.sp tiles: 128 K
// for M <= 32, else 64) per split.  Requires N even, K % 4 == 0, every
// operand contiguous.
extern "C" int repro_nm_matmul_expert(const void* x, const void* vals,
                                      const void* idx, void* out, void* ws,
                                      void* counters, int E, int M, int K,
                                      int N, int in_bf16, int out_bf16,
                                      int packed, int ksplit,
                                      int stages_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    const auto aligned = [](const void* p) {
      return reinterpret_cast<uintptr_t>(p) % 16 == 0;
    };
    const MmaArgs a{static_cast<const __nv_bfloat16*>(x),
                    static_cast<const __nv_bfloat16*>(vals),
                    static_cast<const uint8_t*>(idx),
                    out,
                    static_cast<float*>(ws),
                    static_cast<int*>(counters),
                    E, M, K, N, ksplit, stages_per_split,
                    out_bf16 != 0, packed != 0,
                    K % 8 == 0 && aligned(x),
                    N % 8 == 0 && aligned(vals),
                    packed && N % 16 == 0 && aligned(idx)};
    return (int)launch_mma_rows(a, s);
  }
  if (out_bf16) return (int)cudaErrorInvalidValue;
  const SimtArgs a{static_cast<const float*>(x),
                   static_cast<const float*>(vals),
                   static_cast<const uint8_t*>(idx),
                   static_cast<float*>(out),
                   static_cast<float*>(ws),
                   static_cast<int*>(counters),
                   E, M, K, N, ksplit};
  return (int)(packed ? launch_simt_rows<true>(a, s)
                      : launch_simt_rows<false>(a, s));
}
