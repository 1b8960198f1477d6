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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WG_ROWS = 64;     // query rows of one warpgroup (wgmma's M)
constexpr int WARPGROUPS = 2;
constexpr int BLOCK_M = WARPGROUPS * WG_ROWS;  // query rows of one block
constexpr int NUM_THREADS = WARPGROUPS * 128;
constexpr int BLOCK_N = 128;    // keys of one K/V tile
constexpr int STAGES = 2;       // K/V tiles in the ring
constexpr int PANEL_COLS = 64;  // bf16 columns of one 128-byte swizzled row
constexpr int PANEL_ROW_BYTES = 128;
constexpr int MAX_DEVICES = 64;  // devices whose shared-memory opt-in is remembered
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

typedef __nv_bfloat16 bf16;

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of the given parity has completed. A barrier that
// never completes (a copy that never lands) traps after ~2^34 cycles instead
// of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = -1;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) {
      start = now;
    } else if (now - start > (1ll << 34)) {
      __trap();
    }
  }
}

// One TMA box of the 4-D {D, H, S, B} tensor map into shared memory; the
// barrier counts its bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int d0, int h,
                                         int row0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(h), "r"(row0), "r"(b)
      : "memory");
}

// `rows` rows of D bf16 starting at sequence row `row0`: one box per 64-column panel.
template <int D>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar, int rows, int h,
                                          int row0, int b) {
  mbar_expect_tx(bar, rows * D * 2);
#pragma unroll
  for (int p = 0; p < D / PANEL_COLS; ++p) {
    tma_load(dst + p * rows * PANEL_ROW_BYTES, map, bar, p * PANEL_COLS, h, row0, b);
  }
}

// wgmma shared-memory descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lead_bytes, uint32_t stride_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lead_bytes & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((stride_bytes & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from moving reads or writes of accumulator or A-operand registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// Two floats -> one register of two bf16; `lo` lands in the low half, which
// the fragments hold the lower-indexed element in.
__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128, fp32) += A (64 x 16, shared) * B (128 x 16, shared), both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 128, fp32) += A (64 x 16, registers) * B (16 x 128, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, registers) * B (16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

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
    load_rows<D>(sq, &tq, bar_q, BLOCK_M, h, m0, b);
    for (int j = 0; j < STAGES && j < num_tiles; ++j) {
      load_rows<D>(sk + j * L::TILE_BYTES, &tk, bar_k + 8 * j, BLOCK_N, h, j * BLOCK_N, b);
      load_rows<D>(sv + j * L::TILE_BYTES, &tv, bar_v + 8 * j, BLOCK_N, h, j * BLOCK_N, b);
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
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[kk][i] = pack_floats(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
    }
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
      if constexpr (D == 128) {
        wgmma_rs_n128(acc, pa[kk], dv);
      } else {
        wgmma_rs_n64(acc, pa[kk], dv);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);

    // Every warpgroup is done with this stage: refill it with tile j + STAGES.
    __syncthreads();
    if (tid == 0 && j + STAGES < num_tiles) {
      const int n = (j + STAGES) * BLOCK_N;
      load_rows<D>(sk + stage * L::TILE_BYTES, &tk, bar_k + 8 * stage, BLOCK_N, h, n, b);
      load_rows<D>(sv + stage * L::TILE_BYTES, &tv, bar_v + 8 * stage, BLOCK_N, h, n, b);
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function; the runtime hands it out, so
// the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The 4-D {D, H, S, B} tensor map of one (B, S, H, D) operand (strides in
// elements), in boxes of 64 columns x `rows` sequence rows, 128-byte
// swizzled; rows past S read as zeros.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D, long long sb, long long ss,
                     long long sh, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // A dimension of size 1 is never stepped: give it a packed layout's stride.
  if (H == 1) sh = D;
  if (S == 1) ss = static_cast<long long>(H) * sh;
  if (B == 1) sb = static_cast<long long>(S) * ss;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {PANEL_COLS, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
                              elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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
  // The shared-memory opt-in belongs to the function on a device: set it
  // once a device (a second setting from a racing thread is harmless).
  static bool smem_set[MAX_DEVICES] = {};
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= MAX_DEVICES || !smem_set[dev])) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err == cudaSuccess && dev < MAX_DEVICES) smem_set[dev] = true;
  }
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
