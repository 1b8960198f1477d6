// Flash-attention backward for Hopper (sm_90a), bf16 in and out, fp32
// accumulation.
//
// Replaces mlx_video_tpu/ops/flash_attention.py:_flash_attention_bwd_impl (the
// Pallas kernels _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel). From q, k,
// v, the forward's output o, its gradient dO (all (B, S, H, D) bf16) and the
// forward's per-row logsumexp lse ((B, H, S) fp32) it computes
//   p  = exp(scale * q k^T - lse)      dp = dO v^T
//   Dr = rowsum(dO * o)  (fp32)         dS = p * (dp - Dr) * scale
//   dQ = dS k    dK = dS^T q    dV = p^T dO
// with p and dS rounded to bf16 as the A operands of the last three products,
// as the Pallas kernels round them. Keys at or past S are masked (p = 0); rows
// at or past S are never written.
//
// What bounds it on the H100: 7 products of S x S x D per (batch, head) (two
// to rebuild p and dp in each kernel, one more in the dq kernel and two more
// in the dkv kernel) on 8 * S * D * 2 bytes of operands and outputs: some S / 2
// operations per byte, so the tensor cores and the exponentials, not device
// memory, bound it at the DiT's lengths.
//
// Design (correct and deterministic first; wgmma, TMA and one fused kernel are
// later work):
// - Two kernels, launched in order on one stream, neither with atomics, so
//   repeated runs give bitwise-equal gradients.
//   * dq: a block owns BLOCK_M = 64 query rows of one (batch, head), 4 warps
//     of 16 rows each, and streams 64-key tiles of k and v. It computes Dr for
//     its rows once and writes it to a (B, H, S) fp32 scratch, which the dkv
//     kernel reads instead of recomputing Dr for every key block.
//   * dkv: a block owns BLOCK_N = 64 key rows, 4 warps of 16 keys each, and
//     streams 32-row tiles of q, dO, lse and Dr. It builds the transposed
//     tiles p^T and dS^T directly (k q^T and v dO^T), so no transpose is
//     stored anywhere. Padded query rows of the last tile get p = 0.
// - Operands are read in place through their strides (the last dimension
//   contiguous, 16-byte aligned), as the forward kernel reads them.
// - Tiles sit in shared memory with rows padded by 8 bf16, so the 32-bit
//   fragment loads hit distinct banks. All products are mma.sync m16n8k16
//   (bf16 x bf16 -> fp32), the forward kernel's instruction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;  // dq kernel: query rows per block
constexpr int BLOCK_N = 64;  // key rows per tile (dq) and per block (dkv)
constexpr int BLOCK_Q = 32;  // dkv kernel: query rows per streamed tile
constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int PAD = 8;

typedef __nv_bfloat16 bf16;

struct Operand {
  const bf16* ptr;
  int64_t sb, ss, sh;  // element strides of batch, sequence and head
};

struct BwdParams {
  Operand q, k, v, o, dout;
  const float* lse;  // (B, H, S)
  float* rowdot;     // (B, H, S) scratch: Dr, written by dq, read by dkv
  bf16* dq;          // (B, S, H, D) contiguous
  bf16* dk;
  bf16* dv;
  int S, H;
  float scale;
};

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage `rows` rows of D bf16 from sequence row `row0` into shared memory
// (row stride D + PAD), 16 bytes per load; rows at or past S become zeros.
template <int D>
__device__ __forceinline__ void load_tile(bf16* smem, const bf16* base, int64_t row_stride,
                                          int row0, int S, int rows) {
  constexpr int VEC = 8;
  constexpr int VECS_PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < rows * VECS_PER_ROW; i += NUM_THREADS) {
    const int r = i / VECS_PER_ROW;
    const int c = (i % VECS_PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) {
      val = *reinterpret_cast<const uint4*>(base + static_cast<int64_t>(row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(smem + r * (D + PAD) + c) = val;
  }
}

// A fragment (16 x 16, row-major) of rows [r, r + 16) of a shared tile,
// columns [c, c + 16): this thread's rows r + g and r + g + 8.
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* tile, int ld, int r, int c, int g,
                                       int t) {
  const bf16* row0 = tile + (r + g) * ld + c + 2 * t;
  const bf16* row1 = row0 + 8 * ld;
  a[0] = ld32(row0);
  a[1] = ld32(row1);
  a[2] = ld32(row0 + 8);
  a[3] = ld32(row1 + 8);
}

// B fragment of X^T (16 x 8) where X is a shared tile whose row n is column n
// of B: rows [n, n + 8) of X, columns [c, c + 16).
__device__ __forceinline__ void load_b_rows(uint32_t b[2], const bf16* tile, int ld, int n, int c,
                                            int g, int t) {
  const bf16* row = tile + (n + g) * ld + c + 2 * t;
  b[0] = ld32(row);
  b[1] = ld32(row + 8);
}

// B fragment (16 x 8) of a shared tile X used as it stands: k runs down rows
// [k0, k0 + 16), n across columns [n0, n0 + 8).
__device__ __forceinline__ void load_b_cols(uint32_t b[2], const bf16* tile, int ld, int k0, int n0,
                                            int g, int t) {
  const bf16* p = tile + (k0 + 2 * t) * ld + n0 + g;
  b[0] = pack_bf16(p[0], p[ld]);
  b[1] = pack_bf16(p[8 * ld], p[9 * ld]);
}

// The accumulator fragments of 16 rows x 16 columns (n-tiles 2kk and 2kk + 1)
// as an A fragment, rounded to bf16.
__device__ __forceinline__ void acc_as_a(uint32_t a[4], const float (*s)[4], int kk) {
  a[0] = pack_floats(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack_floats(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack_floats(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack_floats(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

template <int D>
__global__ void __launch_bounds__(NUM_THREADS) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + BLOCK_M * LD;
  bf16* sK = sdO + BLOCK_M * LD;
  bf16* sV = sK + BLOCK_N * LD;
  float* sLse = reinterpret_cast<float*>(sV + BLOCK_N * LD);
  float* sDr = sLse + BLOCK_M;

  const int S = p.S, H = p.H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const int m0 = blockIdx.x * BLOCK_M;

  const bf16* qb = p.q.ptr + b * p.q.sb + h * p.q.sh;
  const bf16* kb = p.k.ptr + b * p.k.sb + h * p.k.sh;
  const bf16* vb = p.v.ptr + b * p.v.sb + h * p.v.sh;
  const bf16* ob = p.o.ptr + b * p.o.sb + h * p.o.sh;
  const bf16* dob = p.dout.ptr + b * p.dout.sb + h * p.dout.sh;

  load_tile<D>(sQ, qb, p.q.ss, m0, S, BLOCK_M);
  load_tile<D>(sdO, dob, p.dout.ss, m0, S, BLOCK_M);

  // Dr = rowsum(dO * o) in fp32, two threads (neighbouring lanes) a row; it
  // goes to shared memory and, once per row, to the scratch for dkv.
  {
    const int r = threadIdx.x >> 1;
    const int half = threadIdx.x & 1;
    const int row = m0 + r;
    float dot = 0.f;
    if (row < S) {
      const bf16* orow = ob + static_cast<int64_t>(row) * p.o.ss + half * (D / 2);
      const bf16* drow = dob + static_cast<int64_t>(row) * p.dout.ss + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
        const bf16* o8 = reinterpret_cast<const bf16*>(&ov);
        const bf16* d8 = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
        for (int e = 0; e < 8; ++e) dot += __bfloat162float(o8[e]) * __bfloat162float(d8[e]);
      }
    }
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    if (half == 0) {
      sDr[r] = dot;
      sLse[r] = row < S ? p.lse[bh * S + row] : 0.f;
      if (row < S) p.rowdot[bh * S + row] = dot;
    }
  }
  __syncthreads();

  const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8 of the block
  const float lse_r[2] = {sLse[r0], sLse[r0 + 8]};
  const float dr_r[2] = {sDr[r0], sDr[r0 + 8]};

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  const int num_tiles = (S + BLOCK_N - 1) / BLOCK_N;
  for (int j = 0; j < num_tiles; ++j) {
    const int n0 = j * BLOCK_N;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(sK, kb, p.k.ss, n0, S, BLOCK_N);
    load_tile<D>(sV, vb, p.v.ss, n0, S, BLOCK_N);
    __syncthreads();

    // s = q k^T and dp = dO v^T for this warp's 16 rows and 64 keys.
    float s[BLOCK_N / 8][4];
    float dp[BLOCK_N / 8][4];
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a(qa, sQ, LD, warp * 16, kk * 16, g, t);
      load_a(da, sdO, LD, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
        uint32_t kf[2], vf[2];
        load_b_rows(kf, sK, LD, nt * 8, kk * 16, g, t);
        load_b_rows(vf, sV, LD, nt * 8, kk * 16, g, t);
        mma_16816(s[nt], qa, kf);
        mma_16816(dp[nt], da, vf);
      }
    }

    // p = exp(scale s - lse) (0 for keys at or past S); dS = p (dp - Dr) scale
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n0 + nt * 8 + 2 * t + (i & 1);
        const int r = i >> 1;
        const float pv = col < S ? expf(s[nt][i] * p.scale - lse_r[r]) : 0.f;
        s[nt][i] = pv * (dp[nt][i] - dr_r[r]) * p.scale;
      }
    }

    // dQ += dS k: dS's fragments are the A operand, k's rows run down k.
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      uint32_t a[4];
      acc_as_a(a, s, kk);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t kf[2];
        load_b_cols(kf, sK, LD, kk * 16, dt * 8, g, t);
        mma_16816(acc[dt], a, kf);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + r0 + 8 * r;
    if (row >= S) continue;
    bf16* orow = p.dq + ((static_cast<int64_t>(b) * S + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8) = pack_floats(acc[dt][2 * r], acc[dt][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NUM_THREADS) flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BLOCK_N * LD;
  bf16* sQ = sV + BLOCK_N * LD;
  bf16* sdO = sQ + BLOCK_Q * LD;
  float* sLse = reinterpret_cast<float*>(sdO + BLOCK_Q * LD);
  float* sDr = sLse + BLOCK_Q;

  const int S = p.S, H = p.H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const int n0 = blockIdx.x * BLOCK_N;

  const bf16* qb = p.q.ptr + b * p.q.sb + h * p.q.sh;
  const bf16* kb = p.k.ptr + b * p.k.sb + h * p.k.sh;
  const bf16* vb = p.v.ptr + b * p.v.sb + h * p.v.sh;
  const bf16* dob = p.dout.ptr + b * p.dout.sb + h * p.dout.sh;

  load_tile<D>(sK, kb, p.k.ss, n0, S, BLOCK_N);
  load_tile<D>(sV, vb, p.v.ss, n0, S, BLOCK_N);

  // This thread's key rows r0 and r0 + 8 of the block: dK and dV.
  const int r0 = warp * 16 + g;
  float dk[D / 8][4];
  float dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.f;
    dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.f;
  }

  for (int i0 = 0; i0 < S; i0 += BLOCK_Q) {
    __syncthreads();  // every warp is done with the previous q/dO tile
    load_tile<D>(sQ, qb, p.q.ss, i0, S, BLOCK_Q);
    load_tile<D>(sdO, dob, p.dout.ss, i0, S, BLOCK_Q);
    if (threadIdx.x < BLOCK_Q) {
      const int row = i0 + threadIdx.x;
      sLse[threadIdx.x] = row < S ? p.lse[bh * S + row] : 0.f;
      sDr[threadIdx.x] = row < S ? p.rowdot[bh * S + row] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T and dp^T = v dO^T: 16 keys x 32 queries for this warp.
    float s[BLOCK_Q / 8][4];
    float dp[BLOCK_Q / 8][4];
#pragma unroll
    for (int nt = 0; nt < BLOCK_Q / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, sK, LD, warp * 16, kk * 16, g, t);
      load_a(va, sV, LD, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < BLOCK_Q / 8; ++nt) {
        uint32_t qf[2], df[2];
        load_b_rows(qf, sQ, LD, nt * 8, kk * 16, g, t);
        load_b_rows(df, sdO, LD, nt * 8, kk * 16, g, t);
        mma_16816(s[nt], ka, qf);
        mma_16816(dp[nt], va, df);
      }
    }

    // p^T = exp(scale s^T - lse[query]), 0 for query rows at or past S;
    // dS^T = p^T (dp^T - Dr[query]) scale.
#pragma unroll
    for (int nt = 0; nt < BLOCK_Q / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = nt * 8 + 2 * t + (i & 1);
        const float pv = i0 + qi < S ? expf(s[nt][i] * p.scale - sLse[qi]) : 0.f;
        s[nt][i] = pv;
        dp[nt][i] = pv * (dp[nt][i] - sDr[qi]) * p.scale;
      }
    }

    // dV += p^T dO and dK += dS^T q: the queries run down k.
#pragma unroll
    for (int kk = 0; kk < BLOCK_Q / 16; ++kk) {
      uint32_t pa[4], sa[4];
      acc_as_a(pa, s, kk);
      acc_as_a(sa, dp, kk);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t df[2], qf[2];
        load_b_cols(df, sdO, LD, kk * 16, dt * 8, g, t);
        load_b_cols(qf, sQ, LD, kk * 16, dt * 8, g, t);
        mma_16816(dv[dt], pa, df);
        mma_16816(dk[dt], sa, qf);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = n0 + r0 + 8 * r;
    if (row >= S) continue;
    const int64_t off = ((static_cast<int64_t>(b) * S + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(p.dk + off + dt * 8) = pack_floats(dk[dt][2 * r], dk[dt][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(p.dv + off + dt * 8) = pack_floats(dv[dt][2 * r], dv[dt][2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch(const BwdParams& p, int B, cudaStream_t stream) {
  constexpr int LD = D + PAD;
  const int smem_dq = (2 * BLOCK_M + 2 * BLOCK_N) * LD * static_cast<int>(sizeof(bf16)) +
                      2 * BLOCK_M * static_cast<int>(sizeof(float));
  const int smem_dkv = (2 * BLOCK_N + 2 * BLOCK_Q) * LD * static_cast<int>(sizeof(bf16)) +
                       2 * BLOCK_Q * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dkv);
  if (err != cudaSuccess) return err;
  const dim3 grid_dq((p.S + BLOCK_M - 1) / BLOCK_M, B * p.H);
  flash_bwd_dq_kernel<D><<<grid_dq, NUM_THREADS, smem_dq, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_dkv((p.S + BLOCK_N - 1) / BLOCK_N, B * p.H);
  flash_bwd_dkv_kernel<D><<<grid_dkv, NUM_THREADS, smem_dkv, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. `strides` holds 15 element strides: (batch,
// sequence, head) of q, k, v, o and dout, in that order; each operand's last
// dimension is contiguous. lse is a contiguous (B, H, S) fp32 tensor, rowdot a
// (B, H, S) fp32 scratch, dq, dk and dv contiguous (B, S, H, D) bf16 outputs.
// Launches the dq kernel, then the dkv kernel, on `stream`; returns the
// cudaError_t of the launches (0 on success).
extern "C" int mvt_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* rowdot, void* dq, void* dk, void* dv,
    int B, int S, int H, int D, const long long* strides, float scale, void* stream) {
  const void* ptrs[5] = {q, k, v, o, dout};
  Operand ops[5];
  for (int i = 0; i < 5; ++i) {
    ops[i] = Operand{static_cast<const bf16*>(ptrs[i]), strides[3 * i], strides[3 * i + 1],
                     strides[3 * i + 2]};
  }
  const BwdParams p{ops[0], ops[1], ops[2], ops[3], ops[4], lse, rowdot,
                    static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                    S, H, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch<128>(p, B, st);
  if (D == 64) return launch<64>(p, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
