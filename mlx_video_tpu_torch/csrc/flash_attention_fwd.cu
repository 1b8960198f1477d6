// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulation.
//
// Replaces mlx_video_tpu/ops/flash_attention.py:_flash_attention_impl (the
// Pallas kernels _single_pass_kernel and _flash_kernel). It computes
// softmax(scale * Q K^T) V over (B, S, H, D) tensors, bidirectional, with an
// exact online softmax at every S (no +/-80 logit clamp), and optionally the
// per-row logsumexp in (B, H, S) fp32.
//
// Layout and work split:
// - A block owns BLOCK_M = 64 query rows of one (batch, head); 4 warps own 16
//   rows each. grid = (ceil(S / 64), B * H).
// - q, k and v are read in place through their strides (the last dimension
//   must be contiguous), so no head transpose or pad copy happens before the
//   call. Rows at or past S are zero-filled in shared memory and their keys
//   get -inf logits; their outputs are not written.
// - Key/value tiles of BLOCK_N = 64 rows are staged in shared memory. Rows
//   are padded by 8 bf16 so the per-thread 32-bit fragment loads below hit
//   32 distinct banks.
// - Q K^T and P V run on the tensor cores as mma.sync m16n8k16 (bf16 x bf16
//   -> fp32). The S accumulator fragment is re-packed in registers as the A
//   operand of P V (no shared-memory round trip for P). P is rounded to bf16
//   for P V, as the Pallas kernel does; the row sum uses the fp32 P.

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

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats -> one register of two bf16; `lo` lands in the low half, which
// the mma fragments hold the lower-indexed element in.
__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Stage `rows` rows of D bf16 starting at sequence row `row0` into shared
// memory (row stride D + PAD), 16 bytes per thread and load; rows at or past
// S become zeros.
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

template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 int S, int H,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 float scale) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BLOCK_M * LD;
  bf16* sV = sK + BLOCK_N * LD;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int m0 = blockIdx.x * BLOCK_M;

  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;

  load_tile<D>(sQ, qb, q_ss, m0, S, BLOCK_M);
  __syncthreads();

  // This warp's 16 query rows as A fragments, one set per 16-wide d step.
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

  // Rows g and g + 8 of the warp's 16: running max, running sum, output.
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }

  const int num_tiles = (S + BLOCK_N - 1) / BLOCK_N;
  for (int j = 0; j < num_tiles; ++j) {
    const int n0 = j * BLOCK_N;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(sK, kb, k_ss, n0, S, BLOCK_N);
    load_tile<D>(sV, vb, v_ss, n0, S, BLOCK_N);
    __syncthreads();

    // Logits for 64 keys: 8 n-tiles of 8 keys.
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

    // Scale, mask the ragged tail, and take the row max over this tile.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n0 + nt * 8 + 2 * t + (i & 1);
        const float val = col < S ? s[nt][i] * scale : -INFINITY;
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
      // Key n0 < S, so every tile has a finite max; exp(-inf) = 0 on tile 0.
      m_new[r] = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new[r]);
    }

    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[nt][i] - m_new[i >> 1]);
        s[nt][i] = p;
        rs[i >> 1] += p;
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

    // acc += P V: P's accumulator fragments are the A operand; V's B
    // fragments pair two key rows of one column.
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

  // Normalise and store rows g and g + 8 (those below S).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + g + 8 * r;
    if (row >= S) continue;
    const float inv = 1.f / l_run[r];
    bf16* orow = o + ((static_cast<int64_t>(b) * S + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          pack_floats(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    }
    if (lse != nullptr && t == 0) {
      lse[(static_cast<int64_t>(b) * H + h) * S + row] = m_run[r] + logf(l_run[r]);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int B, int S, int H,
                   int64_t q_sb, int64_t q_ss, int64_t q_sh,
                   int64_t k_sb, int64_t k_ss, int64_t k_sh,
                   int64_t v_sb, int64_t v_ss, int64_t v_sh,
                   float scale, cudaStream_t stream) {
  const int smem = (BLOCK_M + 2 * BLOCK_N) * (D + PAD) * static_cast<int>(sizeof(bf16));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BLOCK_M - 1) / BLOCK_M, B * H);
  flash_fwd_kernel<D><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, S, H, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
      scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Strides are in elements; o is a contiguous
// (B, S, H, D) bf16 tensor and lse a contiguous (B, H, S) fp32 tensor or
// NULL. Returns the cudaError_t of the launch (0 on success).
extern "C" int mvt_flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int B, int S, int H, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) {
    return launch<128>(q, k, v, o, lse, B, S, H, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                       v_ss, v_sh, scale, st);
  }
  if (D == 64) {
    return launch<64>(q, k, v, o, lse, B, S, H, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                      v_ss, v_sh, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* mvt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
