// Short-KV text cross-attention for Hopper (sm_90a), bf16 in, fp32 accumulation.
//
// Replaces mlx_video_tpu/ops/flash_attention.py:_flash_cross_attention_impl
// (the Pallas kernel _cross_kernel). It computes
//   o = softmax(scale * Q K^T + bias[b, key]) V
// for queries (B, Sq, H, D) and caption keys and values (B, Skv, H, D), where
// Sq (the video tokens) is much longer than Skv (the caption). The optional
// bias is the caption mask as an additive per-key fp32 row, (B, Skv); keys at
// or past Skv are masked to -inf. Any Skv works: the softmax is online.
//
// What bounds it on the H100: at the dev path's shape (B = 2, Sq = 5184,
// Skv = 128, H = 32, D = 128) the two products are 4 * Sq * Skv * D * H
// operations, ~1.4e10 (0.014 ms at the bf16 peak), on 170 MB of q read and o
// written (0.051 ms at 3.35 TB/s); K and V are 4 MB. So it is bound by device
// memory, and the design reads each q row once and writes each o row once.
// Only with a long caption (the trainer's 1024 keys) does the operation count
// take over.
//
// Layout and work split (the first version of K1's, csrc/flash_attention_fwd.cu):
// - A block owns BLOCK_M = 64 query rows of one (batch, head); 4 warps own 16
//   rows each. grid = (ceil(Sq / 64), B * H).
// - q, k and v are read in place through their strides (the last dimension
//   must be contiguous). Query rows at or past Sq are zero-filled in shared
//   memory and not written; key rows at or past Skv are zero-filled and their
//   bias is -inf.
// - Key/value tiles of BLOCK_N = 64 rows are staged in shared memory with the
//   tile's 64 bias values; the small caption stays in L2 across the query
//   blocks that re-read it.
// - Q K^T and P V run on the tensor cores as mma.sync m16n8k16 (bf16 x bf16
//   -> fp32); the bias is added in fp32 before the running max. P is rounded
//   to bf16 for P V, as the Pallas kernel does; the row sum uses the fp32 P.
// - A row whose keys are all masked by a -1e9 bias stays finite: the bias
//   swamps the fp32 logits, they are all equal, and the softmax is uniform
//   over the Skv keys, as in the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;
constexpr int BLOCK_N = 64;
constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int PAD = 8;

typedef __nv_bfloat16 bf16;

struct CrossParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* bias;  // (B, Skv) rows, row stride bias_sb; or null
  bf16* o;            // contiguous (B, Sq, H, D)
  int Sq, Skv, H;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t bias_sb;
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

// Stage `rows` rows of D bf16 from sequence row `row0` into shared memory
// (row stride D + PAD), 16 bytes per load; rows at or past `len` are zeros.
template <int D>
__device__ __forceinline__ void load_tile(bf16* smem, const bf16* base, int64_t row_stride,
                                          int row0, int len, int rows) {
  constexpr int VEC = 8;
  constexpr int VECS_PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < rows * VECS_PER_ROW; i += NUM_THREADS) {
    const int r = i / VECS_PER_ROW;
    const int c = (i % VECS_PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < len) {
      val = *reinterpret_cast<const uint4*>(base + static_cast<int64_t>(row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(smem + r * (D + PAD) + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(NUM_THREADS) flash_cross_kernel(const CrossParams p) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BLOCK_M * LD;
  bf16* sV = sK + BLOCK_N * LD;
  float* sBias = reinterpret_cast<float*>(sV + BLOCK_N * LD);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int m0 = blockIdx.x * BLOCK_M;

  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const float* biasb = p.bias != nullptr ? p.bias + b * p.bias_sb : nullptr;

  load_tile<D>(sQ, qb, p.q_ss, m0, p.Sq, BLOCK_M);
  __syncthreads();

  uint32_t qf[D / 16][4];
  {
    const bf16* row0 = sQ + (warp * 16 + g) * LD + 2 * t;
    const bf16* row1 = row0 + 8 * LD;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(row0 + kk * 16);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(row1 + kk * 16);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(row0 + kk * 16 + 8);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(row1 + kk * 16 + 8);
    }
  }

  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }

  const int num_tiles = (p.Skv + BLOCK_N - 1) / BLOCK_N;
  for (int j = 0; j < num_tiles; ++j) {
    const int n0 = j * BLOCK_N;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(sK, kb, p.k_ss, n0, p.Skv, BLOCK_N);
    load_tile<D>(sV, vb, p.v_ss, n0, p.Skv, BLOCK_N);
    if (threadIdx.x < BLOCK_N) {
      const int col = n0 + threadIdx.x;
      sBias[threadIdx.x] = col < p.Skv ? (biasb != nullptr ? biasb[col] : 0.f) : -INFINITY;
    }
    __syncthreads();

    float s[BLOCK_N / 8][4];
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* krow = sK + (nt * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bfrag[2];
        bfrag[0] = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        bfrag[1] = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_16816(s[nt], qf[kk], bfrag);
      }
    }

    // Scale, add the per-key bias (-inf past Skv), and take the row max.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float val = s[nt][i] * p.scale + sBias[nt * 8 + 2 * t + (i & 1)];
        s[nt][i] = val;
        mx[i >> 1] = fmaxf(mx[i >> 1], val);
      }
    }
    float alpha[2];
    float m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // Key n0 < Skv and the bias is finite, so every tile has a finite max.
      m_new[r] = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new[r]);
    }

    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pr = expf(s[nt][i] - m_new[i >> 1]);
        s[nt][i] = pr;
        rs[i >> 1] += pr;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_run[r] = l_run[r] * alpha[r] + rs[r];
      m_run[r] = m_new[r];
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      uint32_t afrag[4];
      afrag[0] = pack_floats(s[2 * kk][0], s[2 * kk][1]);
      afrag[1] = pack_floats(s[2 * kk][2], s[2 * kk][3]);
      afrag[2] = pack_floats(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      afrag[3] = pack_floats(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const bf16* vrow = sV + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const bf16* vp = vrow + dt * 8;
        uint32_t bfrag[2];
        bfrag[0] = pack_bf16(vp[0], vp[LD]);
        bfrag[1] = pack_bf16(vp[8 * LD], vp[9 * LD]);
        mma_16816(acc[dt], afrag, bfrag);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + g + 8 * r;
    if (row >= p.Sq) continue;
    const float inv = 1.f / l_run[r];
    bf16* orow = p.o + ((static_cast<int64_t>(b) * p.Sq + row) * p.H + h) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          pack_floats(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    }
  }
}

template <int D>
cudaError_t launch(const CrossParams& p, int B, cudaStream_t stream) {
  const int smem = (BLOCK_M + 2 * BLOCK_N) * (D + PAD) * static_cast<int>(sizeof(bf16)) +
                   BLOCK_N * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_cross_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BLOCK_M - 1) / BLOCK_M, B * p.H);
  flash_cross_kernel<D><<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. `strides` holds 10 element strides: (batch,
// sequence, head) of q, k and v, then the bias's batch stride; each operand's
// last dimension is contiguous. bias is a (B, Skv) fp32 tensor with a
// contiguous last dimension, or NULL; o is a contiguous (B, Sq, H, D) bf16
// tensor. Returns the cudaError_t of the launch (0 on success).
extern "C" int mvt_flash_cross_attention_bf16(
    const void* q, const void* k, const void* v, const float* bias, void* o,
    int B, int Sq, int Skv, int H, int D, const long long* strides, float scale, void* stream) {
  const CrossParams p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v), bias, static_cast<bf16*>(o),
                      Sq, Skv, H,
                      strides[0], strides[1], strides[2],
                      strides[3], strides[4], strides[5],
                      strides[6], strides[7], strides[8],
                      strides[9], scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch<128>(p, B, st);
  if (D == 64) return launch<64>(p, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
