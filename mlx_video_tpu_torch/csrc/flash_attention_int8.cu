// Int8 single-pass attention for Hopper (sm_90a): int8 x int8 -> int32 on the
// tensor cores for both products.
//
// Replaces mlx_video_tpu/ops/flash_attention.py:flash_attention_int8 (the
// Pallas kernel _single_pass_int8_kernel). The quantization prologue stays
// outside the kernel, in plain PyTorch (ops/flash_attention.py), as it stays
// in XLA in the JAX package; the kernel takes its codes and scales:
// - q_q, k_q: (B*H, S_pad, D) int8, one per-tensor scale each;
// - v_t: (B*H, D, S_pad) int8, v's codes transposed so that the keys of one
//   channel are contiguous (the B operand of P V wants them so, and ldmatrix
//   has no transpose for 8-bit elements); per-(B*H, channel) scales v_scale;
// - qk_scale: one fp32 on the device, s_q * s_k * softmax scale.
// Rows and keys past S are zero codes (S_pad is a multiple of 64).
//
// It computes, per query row, what the Pallas kernel computes over a whole
// resident row: logits = fp32(int32(q_q k_q^T)) * qk_scale, keys >= S at
// -inf; m = the row max; p = exp(logits - m); p_q = round(127 p) as int8
// (half to even); l = max(sum p_q, 1); out = fp32(int32(p_q v_q)) * v_scale
// / l, cast to the output type (bf16 or fp32). Optionally it writes p_q to a
// (B*H, S, S) int8 tensor, so a check can count the codes that differ from
// the plain version's.
//
// The logits are rounded products (__fmul_rn) and their difference to the
// max a rounded subtraction (__fsub_rn): nvcc would otherwise contract the
// two into one fma and round once, and p_q would drift from the plain
// version's.
//
// Why two passes over the keys: an online softmax rescales against a running
// max, and p_q rounded against a stale max would be other codes than the
// Pallas kernel's. A 64-row block of fp32 logits at S = 5184 is 1.3 MB, far
// beyond shared memory, so pass 1 computes the exact row max and pass 2
// recomputes the logits, quantizes p against that max and accumulates
// sum(p_q) and the int32 P V. Both passes are exact integer products, so
// pass 2's logits are pass 1's bit for bit.
//
// Layout and work split: a block owns 64 query rows of one (batch, head), 4
// warps own 16 rows each; grid = (S_pad / 64, B * H). Q, K and V^T tiles are
// staged in shared memory with 16 bytes of padding a row, so the 32-bit
// fragment loads hit 32 distinct banks. Both products are
// mma.sync.m16n8k32.s8.s8.s32: exact, since |q k| <= 127^2 D and
// |p v| <= 127^2 S are far below 2^31.
//
// P never leaves the registers and needs no shuffle: the int32 accumulator of
// Q K^T gives a thread keys (2t, 2t+1, 8+2t, 9+2t) of each 16-key step, and
// the s8 A fragment of P V wants four consecutive "k" columns a register. The
// product sums over keys in any order, so the kernel uses the thread's own
// keys as its four "k" columns and reads V^T at the same keys for the B
// fragment (two 16-bit loads a register).
//
// What bounds it on the H100: 4 S^2 D operations a head on int8 q, k, v
// (2*S*S_pad*D of them redone by pass 1), ~S/2 operations a byte, far above
// the card's ~590 int8 operations a byte: tensor-core issue and the
// exponentials of the softmax, as in K1. The exponential is IEEE expf (not
// __expf), so p_q differs from the plain version's only where an ulp moves
// 127 p across a half.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;
constexpr int BLOCK_N = 64;
constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int PAD = 16;  // bytes

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four int8 codes (0..127) -> one register; `b0` in the low byte, the
// fragment's lowest-indexed element.
__device__ __forceinline__ uint32_t pack4(int b0, int b1, int b2, int b3) {
  return static_cast<uint32_t>(b0) | (static_cast<uint32_t>(b1) << 8) |
         (static_cast<uint32_t>(b2) << 16) | (static_cast<uint32_t>(b3) << 24);
}

// Stage `rows` rows of `cols` int8 bytes (a multiple of 16) from `base` (row
// stride `stride` bytes) into shared memory with row stride cols + PAD.
template <int COLS>
__device__ __forceinline__ void load_tile(int8_t* smem, const int8_t* base, int64_t stride, int rows) {
  constexpr int VECS = COLS / 16;
  for (int i = threadIdx.x; i < rows * VECS; i += NUM_THREADS) {
    const int r = i / VECS;
    const int c = (i % VECS) * 16;
    *reinterpret_cast<uint4*>(smem + r * (COLS + PAD) + c) =
        *reinterpret_cast<const uint4*>(base + static_cast<int64_t>(r) * stride + c);
  }
}

// This warp's logits for one 64-key tile: s[nt][i] is row g + 8 (i >> 1),
// key nt * 8 + 2t + (i & 1) of the tile, as int32.
template <int D>
__device__ __forceinline__ void qk_tile(int s[BLOCK_N / 8][4], const uint32_t qf[D / 32][4],
                                        const int8_t* sK, int g, int t) {
  constexpr int LDK = D + PAD;
#pragma unroll
  for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0;
    const int8_t* krow = sK + (nt * 8 + g) * LDK + 4 * t;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      uint32_t bfrag[2];
      bfrag[0] = *reinterpret_cast<const uint32_t*>(krow + kk * 32);
      bfrag[1] = *reinterpret_cast<const uint32_t*>(krow + kk * 32 + 16);
      mma_s8(s[nt], qf[kk], bfrag);
    }
  }
}

template <int D, typename OutT>
__global__ void __launch_bounds__(NUM_THREADS)
flash_int8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                  const int8_t* __restrict__ vt, const float* __restrict__ qk_scale_ptr,
                  const float* __restrict__ v_scale, OutT* __restrict__ o,
                  int8_t* __restrict__ p_codes, int S, int S_pad, int H) {
  constexpr int LDQ = D + PAD;
  constexpr int LDV = BLOCK_N + PAD;
  __shared__ __align__(16) int8_t sQ[BLOCK_M * LDQ];
  __shared__ __align__(16) int8_t sK[BLOCK_N * LDQ];
  __shared__ __align__(16) int8_t sV[D * LDV];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * BLOCK_M;
  const float qk_scale = *qk_scale_ptr;

  const int8_t* qb = q + static_cast<int64_t>(bh) * S_pad * D;
  const int8_t* kb = k + static_cast<int64_t>(bh) * S_pad * D;
  const int8_t* vb = vt + static_cast<int64_t>(bh) * D * S_pad;

  load_tile<D>(sQ, qb + static_cast<int64_t>(m0) * D, D, BLOCK_M);
  __syncthreads();

  // This warp's 16 query rows as A fragments, one set per 32-wide d step.
  uint32_t qf[D / 32][4];
  {
    const int8_t* row0 = sQ + (warp * 16 + g) * LDQ + 4 * t;
    const int8_t* row1 = row0 + 8 * LDQ;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(row0 + kk * 32);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(row1 + kk * 32);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(row0 + kk * 32 + 16);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(row1 + kk * 32 + 16);
    }
  }

  const int num_tiles = S_pad / BLOCK_N;

  // Pass 1: the exact row max of rows g and g + 8.
  float m_row[2] = {-INFINITY, -INFINITY};
  for (int j = 0; j < num_tiles; ++j) {
    const int n0 = j * BLOCK_N;
    __syncthreads();  // every warp is done with the previous K tile
    load_tile<D>(sK, kb + static_cast<int64_t>(n0) * D, D, BLOCK_N);
    __syncthreads();
    int s[BLOCK_N / 8][4];
    qk_tile<D>(s, qf, sK, g, t);
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n0 + nt * 8 + 2 * t + (i & 1);
        if (col < S) m_row[i >> 1] = fmaxf(m_row[i >> 1], __fmul_rn(static_cast<float>(s[nt][i]), qk_scale));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 1));
    m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 2));
  }

  // Pass 2: p_q against the row max, its sum and the int32 P V.
  int l_row[2] = {0, 0};
  int acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0;
  const int row_g = m0 + warp * 16 + g;  // rows row_g and row_g + 8

  for (int j = 0; j < num_tiles; ++j) {
    const int n0 = j * BLOCK_N;
    __syncthreads();
    load_tile<D>(sK, kb + static_cast<int64_t>(n0) * D, D, BLOCK_N);
    load_tile<BLOCK_N>(sV, vb + n0, S_pad, D);
    __syncthreads();
    int s[BLOCK_N / 8][4];
    qk_tile<D>(s, qf, sK, g, t);
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n0 + nt * 8 + 2 * t + (i & 1);
        const float logit = col < S ? __fmul_rn(static_cast<float>(s[nt][i]), qk_scale) : -INFINITY;
        const int pq = __float2int_rn(__fmul_rn(expf(__fsub_rn(logit, m_row[i >> 1])), 127.0f));
        s[nt][i] = pq;
        l_row[i >> 1] += pq;
        if (p_codes != nullptr) {
          const int row = row_g + 8 * (i >> 1);
          if (row < S && col < S) {
            p_codes[(static_cast<int64_t>(bh) * S + row) * S + col] = static_cast<int8_t>(pq);
          }
        }
      }
    }
    // acc += P V over two 32-key chunks. The A register of row g holds keys
    // (2t, 2t+1, 8+2t, 9+2t) of a 16-key half; the B register reads V^T at
    // the same keys of channel g of the n8 tile.
#pragma unroll
    for (int c = 0; c < BLOCK_N / 32; ++c) {
      uint32_t afrag[4];
      afrag[0] = pack4(s[4 * c][0], s[4 * c][1], s[4 * c + 1][0], s[4 * c + 1][1]);
      afrag[1] = pack4(s[4 * c][2], s[4 * c][3], s[4 * c + 1][2], s[4 * c + 1][3]);
      afrag[2] = pack4(s[4 * c + 2][0], s[4 * c + 2][1], s[4 * c + 3][0], s[4 * c + 3][1]);
      afrag[3] = pack4(s[4 * c + 2][2], s[4 * c + 2][3], s[4 * c + 3][2], s[4 * c + 3][3]);
      const int8_t* vcol = sV + g * LDV + c * 32 + 2 * t;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const int8_t* vp = vcol + dt * 8 * LDV;
        uint32_t bfrag[2];
        bfrag[0] = static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(vp)) |
                   (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(vp + 8)) << 16);
        bfrag[1] = static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(vp + 16)) |
                   (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(vp + 24)) << 16);
        mma_s8(acc[dt], afrag, bfrag);
      }
    }
  }

  // Normalise by the codes' own sum and store rows g and g + 8 below S into
  // the (B, S, H, D) output.
  const int b = bh / H;
  const int h = bh % H;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int sum = l_row[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float l = fmaxf(static_cast<float>(sum), 1.0f);
    const int row = row_g + 8 * r;
    if (row >= S) continue;
    OutT* orow = o + ((static_cast<int64_t>(b) * S + row) * H + h) * D + 2 * t;
    const float* vs = v_scale + static_cast<int64_t>(bh) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const float o0 = static_cast<float>(acc[dt][2 * r]) * vs[dt * 8] / l;
      const float o1 = static_cast<float>(acc[dt][2 * r + 1]) * vs[dt * 8 + 1] / l;
      if constexpr (sizeof(OutT) == 2) {
        __nv_bfloat162 pair = __floats2bfloat162_rn(o0, o1);
        *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) = pair;
      } else {
        *reinterpret_cast<float2*>(orow + dt * 8) = make_float2(o0, o1);
      }
    }
  }
}

template <int D, typename OutT>
cudaError_t launch(const void* q, const void* k, const void* vt, const float* qk_scale,
                   const float* v_scale, void* o, void* p_codes, int B, int S, int S_pad, int H,
                   cudaStream_t stream) {
  const dim3 grid(S_pad / BLOCK_M, B * H);
  flash_int8_kernel<D, OutT><<<grid, NUM_THREADS, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(vt), qk_scale, v_scale, static_cast<OutT*>(o),
      static_cast<int8_t*>(p_codes), S, S_pad, H);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. q_q, k_q: contiguous (B*H, S_pad, D) int8;
// v_t: contiguous (B*H, D, S_pad) int8; qk_scale: one fp32; v_scale:
// contiguous (B*H, D) fp32; o: contiguous (B, S, H, D), bf16 (out_fp32 = 0)
// or fp32; p_codes: contiguous (B*H, S, S) int8 or NULL. S_pad is a multiple
// of 64, D is 64 or 128. Returns the cudaError_t of the launch (0 on success).
extern "C" int mvt_flash_attention_int8(const void* q, const void* k, const void* vt,
                                        const float* qk_scale, const float* v_scale, void* o,
                                        void* p_codes, int B, int S, int S_pad, int H, int D,
                                        int out_fp32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S_pad % BLOCK_M != 0 || S_pad < S) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 128) {
    return out_fp32 ? launch<128, float>(q, k, vt, qk_scale, v_scale, o, p_codes, B, S, S_pad, H, st)
                    : launch<128, __nv_bfloat16>(q, k, vt, qk_scale, v_scale, o, p_codes, B, S, S_pad, H, st);
  }
  if (D == 64) {
    return out_fp32 ? launch<64, float>(q, k, vt, qk_scale, v_scale, o, p_codes, B, S, S_pad, H, st)
                    : launch<64, __nv_bfloat16>(q, k, vt, qk_scale, v_scale, o, p_codes, B, S, S_pad, H, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
