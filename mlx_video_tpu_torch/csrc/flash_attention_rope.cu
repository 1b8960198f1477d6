// Flash-attention forward with split RoPE fused in, for Hopper (sm_90a), bf16
// in, fp32 accumulation.
//
// Replaces mlx_video_tpu/ops/flash_attention.py:_flash_attention_split_rope_impl
// (the Pallas kernel _flash_rope_kernel). It computes K1's function
// (csrc/flash_attention_fwd.cu) on q and k rotated by the DiT's split RoPE:
//   rot(x) = [x1 * cos - sin * x2, x2 * cos + sin * x1]   (x = [x1, x2] halves)
// in fp32 from (B, H, S, D/2) fp32 cos and sin tables, rounded to bf16, then
//   o = softmax(scale * rot(Q) rot(K)^T) V,
// bidirectional, with an exact online softmax and optionally the per-row
// logsumexp in (B, H, S) fp32 (the backward, K3 on the rotated inputs, reads it).
//
// The rotation is the plain one (ops/flash_attention.py:rotate_split, which
// the DiT's unfused path calls), operation for operation in fp32 (__fmul_rn,
// __fsub_rn and __fadd_rn keep nvcc from contracting it into fused
// multiply-adds) and rounded to nearest even, so the rotated tiles are bit
// for bit the tensors the unfused path writes to device memory. So K5 on
// plainly rotated q and k under identity tables (cos = 1, sin = 0) gives its
// own output bit for bit. The loop below is the first version of K1
// (mma.sync over 64-row blocks and 64-key tiles, synchronous loads), kept as
// it was; K1 itself now runs on wgmma fed by TMA (csrc/flash_attention_fwd.cu),
// so the two agree to K1's bars, not bit for bit.
//
// What bounds it on the H100: at the dev path's shape (B = 2, S = 5184,
// H = 32, D = 128) the two products are 4 * S * S * D * H operations, 8.8e14
// (0.89 ms at the bf16 peak), on 340 MB of q, k, v and o and 170 MB of fp32
// tables (0.15 ms at 3.35 TB/s): it is bound by the tensor cores, like K1.
// What the fusion saves is the unfused path's rotation pass (read q, k and
// the tables, write rotated q and k: ~500 MB). What it costs: each query block
// rotates every K tile again, ceil(S / 64) times over, and reads the tables'
// K rows with it (twice k's bytes, from L2 mostly). That is the trade the
// JAX package measured as a loss on its chip; this kernel keeps the simple
// form and its time is measured against K1 plus the torch rotation.
//
// Layout and work split (the first K1's):
// - A block owns BLOCK_M = 64 query rows of one (batch, head); 4 warps own 16
//   rows each. grid = (ceil(S / 64), B * H).
// - q, k, v and the tables are read in place through their strides (each last
//   dimension contiguous); the tables may be the transposed view that
//   split_freqs_cis returns. The block's query rows are rotated once as they
//   are staged; each K tile is rotated as it is staged. Rows at or past S are
//   zero-filled (a zero row rotates to zeros), their keys get -inf logits and
//   their outputs are not written.
// - Q K^T and P V run on the tensor cores as mma.sync m16n8k16 (bf16 x bf16
//   -> fp32); P is rounded to bf16 for P V, the row sum uses the fp32 P.

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

struct Operand {
  const bf16* ptr;
  int64_t sb, ss, sh;
};

struct Table {
  const float* ptr;
  int64_t sb, sh, ss;  // (B, H, S, D/2): batch, head, sequence
};

struct RopeParams {
  Operand q, k, v;
  Table cos, sin;
  bf16* o;     // contiguous (B, S, H, D)
  float* lse;  // contiguous (B, H, S), or null
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

__device__ __forceinline__ void unpack8(const uint4& v, float out[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w[i] & 0xffffu)));
    out[2 * i + 1] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w[i] >> 16)));
  }
}

__device__ __forceinline__ void load8(const float* p, float out[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// Stage `rows` rows of D bf16 from sequence row `row0`, rotated by the rows of
// the tables, into shared memory (row stride D + PAD). Each step takes 8
// columns of the first half and the same 8 of the second half of one row, and
// their 8 cos and 8 sin values; rows at or past S become zeros.
template <int D>
__device__ __forceinline__ void load_rotated_tile(bf16* smem, const bf16* base, int64_t row_stride,
                                                  const float* cos_b, const float* sin_b,
                                                  int64_t cos_ss, int64_t sin_ss,
                                                  int row0, int S, int rows) {
  constexpr int HALF = D / 2;
  constexpr int VEC = 8;
  constexpr int VECS_PER_HALF = HALF / VEC;
  for (int i = threadIdx.x; i < rows * VECS_PER_HALF; i += NUM_THREADS) {
    const int r = i / VECS_PER_HALF;
    const int c = (i % VECS_PER_HALF) * VEC;
    uint4 lo = make_uint4(0u, 0u, 0u, 0u);
    uint4 hi = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) {
      const int64_t row = row0 + r;
      const bf16* x = base + row * row_stride + c;
      float x1[8], x2[8], cs[8], sn[8];
      unpack8(*reinterpret_cast<const uint4*>(x), x1);
      unpack8(*reinterpret_cast<const uint4*>(x + HALF), x2);
      load8(cos_b + row * cos_ss + c, cs);
      load8(sin_b + row * sin_ss + c, sn);
      float y1[8], y2[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        y1[e] = __fsub_rn(__fmul_rn(x1[e], cs[e]), __fmul_rn(sn[e], x2[e]));
        y2[e] = __fadd_rn(__fmul_rn(x2[e], cs[e]), __fmul_rn(sn[e], x1[e]));
      }
      lo = make_uint4(pack_floats(y1[0], y1[1]), pack_floats(y1[2], y1[3]),
                      pack_floats(y1[4], y1[5]), pack_floats(y1[6], y1[7]));
      hi = make_uint4(pack_floats(y2[0], y2[1]), pack_floats(y2[2], y2[3]),
                      pack_floats(y2[4], y2[5]), pack_floats(y2[6], y2[7]));
    }
    *reinterpret_cast<uint4*>(smem + r * (D + PAD) + c) = lo;
    *reinterpret_cast<uint4*>(smem + r * (D + PAD) + HALF + c) = hi;
  }
}

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
__global__ void __launch_bounds__(NUM_THREADS) flash_rope_kernel(const RopeParams p) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BLOCK_M * LD;
  bf16* sV = sK + BLOCK_N * LD;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int m0 = blockIdx.x * BLOCK_M;
  const int S = p.S;

  const bf16* qb = p.q.ptr + b * p.q.sb + h * p.q.sh;
  const bf16* kb = p.k.ptr + b * p.k.sb + h * p.k.sh;
  const bf16* vb = p.v.ptr + b * p.v.sb + h * p.v.sh;
  const float* cos_b = p.cos.ptr + b * p.cos.sb + h * p.cos.sh;
  const float* sin_b = p.sin.ptr + b * p.sin.sb + h * p.sin.sh;

  load_rotated_tile<D>(sQ, qb, p.q.ss, cos_b, sin_b, p.cos.ss, p.sin.ss, m0, S, BLOCK_M);
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

  const int num_tiles = (S + BLOCK_N - 1) / BLOCK_N;
  for (int j = 0; j < num_tiles; ++j) {
    const int n0 = j * BLOCK_N;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rotated_tile<D>(sK, kb, p.k.ss, cos_b, sin_b, p.cos.ss, p.sin.ss, n0, S, BLOCK_N);
    load_tile<D>(sV, vb, p.v.ss, n0, S, BLOCK_N);
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

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n0 + nt * 8 + 2 * t + (i & 1);
        const float val = col < S ? s[nt][i] * p.scale : -INFINITY;
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
    if (row >= S) continue;
    const float inv = 1.f / l_run[r];
    bf16* orow = p.o + ((static_cast<int64_t>(b) * S + row) * p.H + h) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          pack_floats(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    }
    if (p.lse != nullptr && t == 0) {
      p.lse[(static_cast<int64_t>(b) * p.H + h) * S + row] = m_run[r] + logf(l_run[r]);
    }
  }
}

template <int D>
cudaError_t launch(const RopeParams& p, int B, cudaStream_t stream) {
  const int smem = (BLOCK_M + 2 * BLOCK_N) * (D + PAD) * static_cast<int>(sizeof(bf16));
  cudaError_t err = cudaFuncSetAttribute(flash_rope_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BLOCK_M - 1) / BLOCK_M, B * p.H);
  flash_rope_kernel<D><<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. `strides` holds 15 element strides: (batch,
// sequence, head) of q, k and v, then (batch, head, sequence) of cos and sin;
// every operand's last dimension is contiguous. cos and sin are (B, H, S, D/2)
// fp32, o a contiguous (B, S, H, D) bf16 tensor and lse a contiguous (B, H, S)
// fp32 tensor or NULL. Returns the cudaError_t of the launch (0 on success).
extern "C" int mvt_flash_attention_rope_bf16(
    const void* q, const void* k, const void* v, const float* cos, const float* sin, void* o,
    float* lse, int B, int S, int H, int D, const long long* strides, float scale, void* stream) {
  const RopeParams p{
      Operand{static_cast<const bf16*>(q), strides[0], strides[1], strides[2]},
      Operand{static_cast<const bf16*>(k), strides[3], strides[4], strides[5]},
      Operand{static_cast<const bf16*>(v), strides[6], strides[7], strides[8]},
      Table{cos, strides[9], strides[10], strides[11]},
      Table{sin, strides[12], strides[13], strides[14]},
      static_cast<bf16*>(o), lse, S, H, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch<128>(p, B, st);
  if (D == 64) return launch<64>(p, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
