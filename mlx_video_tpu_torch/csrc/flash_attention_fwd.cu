// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulation.
//
// Replaces mlx_video_tpu/ops/flash_attention.py:_flash_attention_impl (the
// Pallas kernels _single_pass_kernel and _flash_kernel). It computes
// softmax(scale * Q K^T) V over (B, S, H, D) tensors, bidirectional, with an
// exact online softmax at every S (no +/-80 logit clamp), and optionally the
// per-row logsumexp in (B, H, S) fp32 (K3, the backward, reads it).
//
// What bounds it on the H100: at the DiT's shapes (H = 32, D = 128, S = 320
// to 5184) the two products are 4 * S^2 * D * H operations on 8 * S * H * D
// bytes of q, k, v and o, some S / 2 operations a byte against the card's
// ~295 bf16 operations a byte: the tensor cores bound it (0.1979 ms at
// (1, 3456) and 0.4451 ms at (1, 5184) at 989 TFLOP/s), and beside them the
// 2^x of every logit on the special-function units.
//
// What the design does about it:
// - Both products run as wgmma.mma_async (m64nNk16, bf16 -> fp32), the only
//   route to the tensor cores' full rate on this card. S = Q K^T reads Q and
//   K from shared memory, both K-major. O += P V takes P from registers: the
//   fp32 S accumulator is rounded to bf16 in place, since its layout is the A
//   operand's; V is the MN-major B operand (the transpose bit, which bf16
//   allows), so no transpose of V is ever made.
// - A block owns BLOCK_M = 128 query rows of one (batch, head): two
//   warpgroups of 64 rows share every K/V tile. grid = (ceil(S / 128), B * H).
// - Tiles arrive by TMA (cp.async.bulk.tensor) into a ring of STAGES = 2 K/V
//   stages, each with an mbarrier per operand: tile j + 1 is in flight while
//   tile j is multiplied. One thread issues the copies. The tensor maps are
//   4-D {D, H, S, B} over the caller's strides, so q, k and v are read in
//   place; rows at or past S arrive zero-filled, their keys get -inf logits
//   and their outputs are not written.
// - Shared memory uses the 128-byte swizzle that TMA writes and the wgmma
//   descriptors read: a row of D bf16 is D / 64 panels of 128 bytes, each
//   panel a separate TMA box, 8-row atoms 1024 bytes apart.
// - The softmax is exact and online: fp32 running max and sum over logits
//   pre-scaled by scale * log2(e), 2^x by exp2f; the lse is returned in
//   natural log. P is rounded to bf16 for P V, as the Pallas kernel does; the
//   row sum uses the fp32 P.
//
// Measured by chip_smoke.py's phase 3 (one call through the Python wrapper,
// host work included) on an NVIDIA H100 80GB HBM3, 700 W, in turns with the
// same phase of the first version of this kernel (mma.sync, 64-row blocks,
// synchronous loads) on the same card: 0.4812 ms at (B, S) = (1, 3456) with
// lse (41 % of the bound; the first version 1.3388 ms), 0.9463 ms at
// (1, 5184) with lse (47 %; 2.8182 ms), 0.0498 ms at (1, 320) (0.0735 ms).
// Tried and slower there, so not kept: a producer warpgroup with setmaxnreg
// and two consumers taking turns at the tensor cores (ptxas keeps the
// consumers at 168 registers and spills), and issuing each tile's P V behind
// the next tile's Q K^T (no faster at D = 128, slower at D = 64).

#include "hopper.cuh"

namespace {

constexpr int WG_ROWS = 64;     // query rows of one warpgroup (wgmma's M)
constexpr int WARPGROUPS = 2;
constexpr int BLOCK_M = WARPGROUPS * WG_ROWS;  // query rows of one block
constexpr int NUM_THREADS = WARPGROUPS * 128;
constexpr int BLOCK_N = 128;    // keys of one K/V tile
constexpr int STAGES = 2;       // K/V tiles in the ring

// Byte offsets of the block's shared memory, from a 1024-byte aligned base.
template <int D>
struct Layout {
  static constexpr int Q_BYTES = BLOCK_M * D * 2;
  static constexpr int TILE_BYTES = BLOCK_N * D * 2;  // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * TILE_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * TILE_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(NUM_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, float* __restrict__ lse, int S,
                 int H, float scale_log2) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = base + L::K_OFF;  // stage s at + s * TILE_BYTES
  const uint32_t sv = base + L::V_OFF;
  const uint32_t bar_q = base + L::BAR_OFF;
  const uint32_t bar_k = bar_q + 8;                // stage s at + 8 * s
  const uint32_t bar_v = bar_q + 8 * (1 + STAGES);  // stage s at + 8 * s

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;  // 16 rows of the warpgroup's 64
  const int lane = tid % 32;
  const int g = lane >> 2;  // accumulator row group: rows g and g + 8
  const int t = lane & 3;   // columns 2t, 2t + 1 of every 8
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int m0 = blockIdx.x * BLOCK_M;
  const int num_tiles = (S + BLOCK_N - 1) / BLOCK_N;

  if (tid == 0) {
    for (int i = 0; i < 1 + 2 * STAGES; ++i) mbar_init(bar_q + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    load_rows<D, BLOCK_M>(sq, &tq, bar_q, BLOCK_M, h, m0, b);
    for (int j = 0; j < STAGES && j < num_tiles; ++j) {
      load_rows<D, BLOCK_N>(sk + j * L::TILE_BYTES, &tk, bar_k + 8 * j, BLOCK_N, h, j * BLOCK_N, b);
      load_rows<D, BLOCK_N>(sv + j * L::TILE_BYTES, &tv, bar_v + 8 * j, BLOCK_N, h, j * BLOCK_N, b);
    }
  }

  // Q and K are K-major operands: 8-row atoms 1024 bytes apart (the leading
  // offset is unused); a 16-column k step moves 32 bytes along the swizzled
  // 128-byte row, then to the next 64-column panel. V is the MN-major B of
  // P V: 8-key atoms 1024 bytes apart, its 64-column panels BLOCK_N rows
  // apart; a 16-key step moves 16 rows.
  const uint64_t desc_q = make_desc(sq + wg * WG_ROWS * PANEL_ROW_BYTES, 16, 1024);
  const uint64_t desc_k = make_desc(sk, 16, 1024);
  const uint64_t desc_v = make_desc(sv, BLOCK_N * PANEL_ROW_BYTES, 1024);

  // This thread's rows g and g + 8 of the warp's 16: running max (log2
  // domain), running sum and the output accumulator (m64nD layout: element
  // 4 * c + 2 * r + e is row g + 8r, column 8c + 2t + e).
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int j = 0; j < num_tiles; ++j) {
    const int stage = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    const int n0 = j * BLOCK_N;

    // S = Q K^T for BLOCK_N keys, in the m64n128 accumulator layout.
    float s[BLOCK_N / 2];
    mbar_wait(bar_k + 8 * stage, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t q_off = (kk / 4) * BLOCK_M * PANEL_ROW_BYTES + (kk % 4) * 32;
      const uint32_t k_off = stage * L::TILE_BYTES + (kk / 4) * BLOCK_N * PANEL_ROW_BYTES + (kk % 4) * 32;
      wgmma_ss_n128(s, desc_q + (q_off >> 4), desc_k + (k_off >> 4), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Scale into the log2 domain, mask the ragged tail, take the row max.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BLOCK_N / 2; ++i) {
      float x = s[i] * scale_log2;
      if (n0 + BLOCK_N > S && n0 + (i / 4) * 8 + 2 * t + (i & 1) >= S) x = -INFINITY;
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float m_new[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // Key n0 < S, so every tile has a finite max; 2^-inf = 0 on tile 0.
      m_new[r] = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new[r]);
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BLOCK_N / 2; ++i) {
      const float p = exp2f(s[i] - m_new[(i >> 1) & 1]);
      s[i] = p;
      rs[(i >> 1) & 1] += p;
    }
    // P in bf16 as the A operand of P V: the k16 step kk takes accumulator
    // columns 16kk .. 16kk + 15, which this thread holds as elements 8kk .. 8kk + 7.
    uint32_t pa[BLOCK_N / 16][4];
    acc_to_a<BLOCK_N>(pa, s);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_run[r] = l_run[r] * alpha[r] + rs[r];
      m_run[r] = m_new[r];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V.
    mbar_wait(bar_v + 8 * stage, parity);
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      const uint64_t dv = desc_v + ((stage * L::TILE_BYTES + kk * 16 * PANEL_ROW_BYTES) >> 4);
      wgmma_rs<D>(acc, pa[kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);

    // Every warpgroup is done with this stage: refill it with tile j + STAGES.
    __syncthreads();
    if (tid == 0 && j + STAGES < num_tiles) {
      const int n = (j + STAGES) * BLOCK_N;
      load_rows<D, BLOCK_N>(sk + stage * L::TILE_BYTES, &tk, bar_k + 8 * stage, BLOCK_N, h, n, b);
      load_rows<D, BLOCK_N>(sv + stage * L::TILE_BYTES, &tv, bar_v + 8 * stage, BLOCK_N, h, n, b);
    }
  }

  // Normalise and store rows g and g + 8 (those below S).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + wg * WG_ROWS + warp * 16 + g + 8 * r;
    if (row >= S) continue;
    const float inv = 1.f / l_run[r];
    bf16* orow = o + ((static_cast<int64_t>(b) * S + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<uint32_t*>(orow + c * 8) = pack_floats(acc[4 * c + 2 * r] * inv, acc[4 * c + 2 * r + 1] * inv);
    }
    if (lse != nullptr && t == 0) {
      lse[(static_cast<int64_t>(b) * H + h) * S + row] = m_run[r] * LN2 + logf(l_run[r]);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S, int H,
                   long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh, float scale, cudaStream_t stream) {
  using L = Layout<D>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, B, S, H, D, q_sb, q_ss, q_sh, BLOCK_M);
  if (err == cudaSuccess) err = make_map(&tk, k, B, S, H, D, k_sb, k_ss, k_sh, BLOCK_N);
  if (err == cudaSuccess) err = make_map(&tv, v, B, S, H, D, v_sb, v_ss, v_sh, BLOCK_N);
  static bool smem_set[MAX_DEVICES] = {};
  if (err == cudaSuccess) err = opt_in_smem(flash_fwd_kernel<D>, L::BYTES, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BLOCK_M - 1) / BLOCK_M, B * H);
  flash_fwd_kernel<D><<<grid, NUM_THREADS, L::BYTES, stream>>>(tq, tk, tv, static_cast<bf16*>(o), lse, S, H,
                                                              scale * LOG2E);
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
    return launch<128>(q, k, v, o, lse, B, S, H, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, st);
  }
  if (D == 64) {
    return launch<64>(q, k, v, o, lse, B, S, H, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* mvt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
