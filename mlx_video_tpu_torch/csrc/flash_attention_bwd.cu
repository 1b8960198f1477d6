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
// What bounds it on the H100: the gradients need 5 products of S x S x D a
// (batch, head) on 8 * S * D * 2 bytes of operands and outputs, some S / 2
// operations a byte against the card's ~295: the tensor cores bound it
// (0.4947 ms at (B, S, H, D) = (1, 3456, 32, 128) at 989 TFLOP/s), and beside
// them the 2^x of every logit. The two kernels below run 7 products: each
// rebuilds p and dp (two products) before its own.
//
// What the design does about it (K1's, flash_attention_fwd.cu):
// - Two kernels, launched in order on one stream, neither with atomics, so
//   repeated runs give bitwise-equal gradients.
//   * dq: a block owns 128 query rows of one (batch, head), two warpgroups of
//     64. Q and dO arrive once; 128-key K/V tiles stream through the ring.
//     S = Q K^T and dP = dO V^T are SS wgmma (both operands K-major); p and dS
//     are formed in the accumulator registers; dQ += dS K takes dS from
//     registers, rounded in place, with K as the MN-major B (the transpose
//     bit) of the very tile that was S's K-major B. Dr for the block's rows is
//     computed once from o and dO and written to a (B, H, S) fp32 scratch.
//   * dkv: a block owns 128 keys, two warpgroups of 64. K and V arrive once;
//     64-row query tiles of q and dO stream through the ring, with their lse
//     and Dr (cp.async into a ring of their own). S^T = K Q^T and dP^T =
//     V dO^T are SS wgmma; p^T and dS^T are formed in registers, each
//     column's (query's) lse and Dr read from shared memory; dV += p^T dO and
//     dK += dS^T Q are RS wgmma whose B operands dO and Q are the MN-major
//     reading of the same swizzled tiles. Query rows at or past S get p = 0
//     by index: TMA zero-fills them, but their lse is no number.
// - Every product is wgmma.mma_async (m64nNk16, bf16 -> fp32). Tiles arrive
//   by TMA into 128-byte swizzled shared memory through a 2-stage mbarrier
//   ring: tile j + 1 is in flight while tile j is multiplied; one thread
//   issues the copies. The tensor maps are 4-D {D, H, S, B} over the caller's
//   strides, 64-row boxes, so q, k, v and dO are read in place (o only for
//   Dr, by plain loads).
// - Exponentials are exp2f of logits pre-scaled by scale * log2(e) less
//   lse * log2(e). The shared-memory opt-in is set once a device.
// - No producer warpgroup and no setmaxnreg: K1 found both slower.
// - Registers: dkv at D = 128 holds 64 + 64 fp32 of dK and dV and 32 + 32 of
//   S^T and dP^T for a 64-query tile (ptxas: 222 a thread, no spills); dq 64
//   of dQ and 64 + 64 of S and dP for a 128-key tile (218).
//
// Measured by chip_smoke.py's phase 5 (one call through the Python wrapper,
// CUDA events, host work included) on an NVIDIA H100 80GB HBM3, 700 W:
// 1.4360-1.4691 ms at (B, S, H, D) = (1, 3456, 32, 128), 34 % of the
// bound, of which dq 0.49 and dkv 0.73 ms of device time; 2.6514-2.8022 ms
// at (1, 5184). The first version of this kernel (mma.sync m16n8k16 over
// 64-row blocks, synchronous loads through registers) took 4.9004-5.1736 ms
// and 10.2955-10.2984 ms on the same card type. Tried there and not kept:
// 64-key dq tiles (dq ~9 % slower), 32-row dkv query tiles (dkv ~29 %
// slower), a 3-stage ring and issuing dV's product before dS^T is formed
// (no gain beyond the noise).

#include "hopper.cuh"

namespace {

constexpr int WG_ROWS = 64;       // rows of one warpgroup (wgmma's M)
constexpr int NUM_THREADS = 256;  // two warpgroups
constexpr int BLOCK = 128;        // query rows of a dq block, keys of a dkv block
constexpr int KEY_TILE = 128;     // keys of a streamed dq tile
constexpr int QUERY_TILE = 64;    // query rows of a streamed dkv tile
constexpr int BOX = 64;           // rows of a TMA box
constexpr int STAGES = 2;         // streamed tiles in the ring

struct Operand {
  const bf16* ptr;
  long long sb, ss, sh;  // element strides of batch, sequence and head
};

struct BwdArgs {
  Operand o, dout;   // read by plain loads for Dr
  const float* lse;  // (B, H, S)
  float* rowdot;     // (B, H, S) scratch: Dr, written by dq, read by dkv
  bf16* dq;          // (B, S, H, D) contiguous
  bf16* dk;
  bf16* dv;
  int S, H;
  float scale;
};

// Byte offsets of a block's shared memory, from a 1024-byte aligned base:
// two BLOCK-row operands held for the whole block, two streamed operands of
// TILE rows in STAGES stages, FLOATS fp32 values and the barriers (2 for the
// held operands, 2 * STAGES for the ring).
template <int D, int TILE, int FLOATS>
struct Layout {
  static constexpr int HELD_BYTES = BLOCK * D * 2;
  static constexpr int TILE_BYTES = TILE * D * 2;
  static constexpr int HELD1_OFF = HELD_BYTES;
  static constexpr int RING0_OFF = 2 * HELD_BYTES;  // stage s at + s * TILE_BYTES
  static constexpr int RING1_OFF = RING0_OFF + STAGES * TILE_BYTES;
  static constexpr int FLOAT_OFF = RING1_OFF + STAGES * TILE_BYTES;
  static constexpr int BAR_OFF = FLOAT_OFF + FLOATS * 4;
  static constexpr int BYTES = BAR_OFF + 8 * (2 + 2 * STAGES) + 1024;  // + alignment slack
};

template <int D>
using DqLayout = Layout<D, KEY_TILE, BLOCK>;  // Q, dO held; K, V streamed; Dr of the block's rows
template <int D>
using DkvLayout = Layout<D, QUERY_TILE, 2 * STAGES * QUERY_TILE>;  // K, V held; Q, dO streamed; lse, Dr rings

// 4 bytes global -> shared without the registers; `valid` 0 writes a zero.
__device__ __forceinline__ void cp_async_f32(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

template <int D>
__global__ void __launch_bounds__(NUM_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const BwdArgs a) {
  using L = DqLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sdo = base + L::HELD1_OFF;
  const uint32_t sk = base + L::RING0_OFF;
  const uint32_t sv = base + L::RING1_OFF;
  float* s_dr = reinterpret_cast<float*>(smem_raw + (base - raw) + L::FLOAT_OFF);
  const uint32_t bar_q = base + L::BAR_OFF;
  const uint32_t bar_do = bar_q + 8;
  const uint32_t bar_k = bar_q + 16;               // stage s at + 8 * s
  const uint32_t bar_v = bar_q + 8 * (2 + STAGES);  // stage s at + 8 * s

  const int S = a.S, H = a.H;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;  // 16 rows of the warpgroup's 64
  const int lane = tid % 32;
  const int g = lane >> 2;  // accumulator row group: rows g and g + 8
  const int t = lane & 3;   // columns 2t, 2t + 1 of every 8
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const long long bh = static_cast<long long>(b) * H + h;
  const int m0 = blockIdx.x * BLOCK;
  const int num_tiles = (S + KEY_TILE - 1) / KEY_TILE;
  const float scale_log2 = a.scale * LOG2E;

  if (tid == 0) {
    for (int i = 0; i < 2 + 2 * STAGES; ++i) mbar_init(bar_q + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    load_rows<D, BOX>(sq, &tq, bar_q, BLOCK, h, m0, b);
    load_rows<D, BOX>(sdo, &tdo, bar_do, BLOCK, h, m0, b);
    for (int j = 0; j < STAGES && j < num_tiles; ++j) {
      load_rows<D, BOX>(sk + j * L::TILE_BYTES, &tk, bar_k + 8 * j, KEY_TILE, h, j * KEY_TILE, b);
      load_rows<D, BOX>(sv + j * L::TILE_BYTES, &tv, bar_v + 8 * j, KEY_TILE, h, j * KEY_TILE, b);
    }
  }

  // Dr = rowsum(dO * o) in fp32 while the tiles land, two threads (neighbouring
  // lanes) a row; to shared memory and, once a row, to the scratch for dkv.
  {
    const int r = tid >> 1;
    const int half = tid & 1;
    const int row = m0 + r;
    float dot = 0.f;
    if (row < S) {
      const bf16* orow = a.o.ptr + b * a.o.sb + h * a.o.sh + row * a.o.ss + half * (D / 2);
      const bf16* drow = a.dout.ptr + b * a.dout.sb + h * a.dout.sh + row * a.dout.ss + half * (D / 2);
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
      s_dr[r] = dot;
      if (row < S) a.rowdot[bh * S + row] = dot;
    }
  }
  __syncthreads();

  // This thread's rows g and g + 8 of its warp's 16: lse (log2 domain) and Dr.
  // Rows at or past S take 0 for both: their dO is zero, so dS is too.
  float lse2[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = wg * WG_ROWS + warp * 16 + g + 8 * r;
    lse2[r] = m0 + lr < S ? a.lse[bh * S + m0 + lr] * LOG2E : 0.f;
    dr[r] = s_dr[lr];
  }

  // Q and dO are the K-major A of S and dP (the warpgroup's 64 rows, panels
  // BLOCK rows apart); K and V the K-major B (panels KEY_TILE rows apart); K again
  // the MN-major B of dQ += dS K (leading offset: the panel stride).
  const uint64_t desc_q = make_desc(sq + wg * WG_ROWS * PANEL_ROW_BYTES, 16, 1024);
  const uint64_t desc_do = make_desc(sdo + wg * WG_ROWS * PANEL_ROW_BYTES, 16, 1024);
  const uint64_t desc_k = make_desc(sk, 16, 1024);
  const uint64_t desc_v = make_desc(sv, 16, 1024);
  const uint64_t desc_kt = make_desc(sk, KEY_TILE * PANEL_ROW_BYTES, 1024);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_q, 0);
  mbar_wait(bar_do, 0);
  for (int j = 0; j < num_tiles; ++j) {
    const int stage = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    const int n0 = j * KEY_TILE;

    // S = Q K^T and dP = dO V^T for KEY_TILE keys.
    float s[KEY_TILE / 2], dp[KEY_TILE / 2];
    mbar_wait(bar_k + 8 * stage, parity);
    mbar_wait(bar_v + 8 * stage, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * BLOCK * PANEL_ROW_BYTES + (kk % 4) * 32;
      const uint32_t b_off = stage * L::TILE_BYTES + (kk / 4) * KEY_TILE * PANEL_ROW_BYTES + (kk % 4) * 32;
      wgmma_ss<KEY_TILE>(s, desc_q + (a_off >> 4), desc_k + (b_off >> 4), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * BLOCK * PANEL_ROW_BYTES + (kk % 4) * 32;
      const uint32_t b_off = stage * L::TILE_BYTES + (kk / 4) * KEY_TILE * PANEL_ROW_BYTES + (kk % 4) * 32;
      wgmma_ss<KEY_TILE>(dp, desc_do + (a_off >> 4), desc_v + (b_off >> 4), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // p = 2^(S scale log2(e) - lse log2(e)), 0 for keys at or past S;
    // dS = p (dP - Dr) scale, in place of S.
#pragma unroll
    for (int i = 0; i < KEY_TILE / 2; ++i) {
      const int r = (i >> 1) & 1;
      float p = exp2f(fmaf(s[i], scale_log2, -lse2[r]));
      if (n0 + KEY_TILE > S && n0 + (i / 4) * 8 + 2 * t + (i & 1) >= S) p = 0.f;
      s[i] = p * (dp[i] - dr[r]) * a.scale;
    }
    uint32_t da[KEY_TILE / 16][4];
    acc_to_a<KEY_TILE>(da, s);

    // dQ += dS K.
    fence_regs(acc);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KEY_TILE / 16; ++kk) {
      wgmma_rs<D>(acc, da[kk], desc_kt + ((stage * L::TILE_BYTES + kk * 16 * PANEL_ROW_BYTES) >> 4));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);

    // Every warpgroup is done with this stage: refill it with tile j + STAGES.
    __syncthreads();
    if (tid == 0 && j + STAGES < num_tiles) {
      const int n = (j + STAGES) * KEY_TILE;
      load_rows<D, BOX>(sk + stage * L::TILE_BYTES, &tk, bar_k + 8 * stage, KEY_TILE, h, n, b);
      load_rows<D, BOX>(sv + stage * L::TILE_BYTES, &tv, bar_v + 8 * stage, KEY_TILE, h, n, b);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + wg * WG_ROWS + warp * 16 + g + 8 * r;
    if (row >= S) continue;
    bf16* dst = a.dq + ((static_cast<long long>(b) * S + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<uint32_t*>(dst + c * 8) = pack_floats(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NUM_THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                     const BwdArgs a) {
  using L = DkvLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sk = base;
  const uint32_t sv = base + L::HELD1_OFF;
  const uint32_t sq = base + L::RING0_OFF;
  const uint32_t sdo = base + L::RING1_OFF;
  // lse (natural log) and Dr of the streamed query rows, QUERY_TILE a stage.
  const uint32_t s_lse_addr = base + L::FLOAT_OFF;
  const uint32_t s_dr_addr = s_lse_addr + STAGES * QUERY_TILE * 4;
  const float* s_lse = reinterpret_cast<const float*>(smem_raw + (base - raw) + L::FLOAT_OFF);
  const float* s_dr = s_lse + STAGES * QUERY_TILE;
  const uint32_t bar_k = base + L::BAR_OFF;
  const uint32_t bar_v = bar_k + 8;
  const uint32_t bar_q = bar_k + 16;                // stage s at + 8 * s
  const uint32_t bar_do = bar_k + 8 * (2 + STAGES);  // stage s at + 8 * s

  const int S = a.S, H = a.H;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const long long bh = static_cast<long long>(b) * H + h;
  const int n0 = blockIdx.x * BLOCK;
  const int num_tiles = (S + QUERY_TILE - 1) / QUERY_TILE;
  const float scale_log2 = a.scale * LOG2E;
  const float* lse_bh = a.lse + bh * S;
  const float* dr_bh = a.rowdot + bh * S;

  if (tid == 0) {
    for (int i = 0; i < 2 + 2 * STAGES; ++i) mbar_init(bar_k + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    load_rows<D, BOX>(sk, &tk, bar_k, BLOCK, h, n0, b);
    load_rows<D, BOX>(sv, &tv, bar_v, BLOCK, h, n0, b);
    for (int j = 0; j < STAGES && j < num_tiles; ++j) {
      load_rows<D, BOX>(sq + j * L::TILE_BYTES, &tq, bar_q + 8 * j, QUERY_TILE, h, j * QUERY_TILE, b);
      load_rows<D, BOX>(sdo + j * L::TILE_BYTES, &tdo, bar_do + 8 * j, QUERY_TILE, h, j * QUERY_TILE, b);
    }
  }
  // lse and Dr of the first STAGES query tiles (stage s holds tile s).
  if (tid < STAGES * QUERY_TILE) {
    const int row = tid;
    const bool valid = row < S;
    cp_async_f32(s_lse_addr + 4 * tid, lse_bh + (valid ? row : 0), valid);
    cp_async_f32(s_dr_addr + 4 * tid, dr_bh + (valid ? row : 0), valid);
  }
  cp_async_wait_all();
  __syncthreads();

  // K and V are the K-major A of S^T and dP^T (the warpgroup's 64 keys,
  // panels BLOCK rows apart); Q and dO the K-major B (panels QUERY_TILE rows apart),
  // then the MN-major B of dK += dS^T Q and dV += p^T dO.
  const uint64_t desc_k = make_desc(sk + wg * WG_ROWS * PANEL_ROW_BYTES, 16, 1024);
  const uint64_t desc_v = make_desc(sv + wg * WG_ROWS * PANEL_ROW_BYTES, 16, 1024);
  const uint64_t desc_q = make_desc(sq, 16, 1024);
  const uint64_t desc_do = make_desc(sdo, 16, 1024);
  const uint64_t desc_qt = make_desc(sq, QUERY_TILE * PANEL_ROW_BYTES, 1024);
  const uint64_t desc_dot = make_desc(sdo, QUERY_TILE * PANEL_ROW_BYTES, 1024);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(bar_k, 0);
  mbar_wait(bar_v, 0);
  for (int j = 0; j < num_tiles; ++j) {
    const int stage = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    const int i0 = j * QUERY_TILE;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x QUERY_TILE queries a warpgroup.
    float s[QUERY_TILE / 2], dp[QUERY_TILE / 2];
    mbar_wait(bar_q + 8 * stage, parity);
    mbar_wait(bar_do + 8 * stage, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * BLOCK * PANEL_ROW_BYTES + (kk % 4) * 32;
      const uint32_t b_off = stage * L::TILE_BYTES + (kk / 4) * QUERY_TILE * PANEL_ROW_BYTES + (kk % 4) * 32;
      wgmma_ss<QUERY_TILE>(s, desc_k + (a_off >> 4), desc_q + (b_off >> 4), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * BLOCK * PANEL_ROW_BYTES + (kk % 4) * 32;
      const uint32_t b_off = stage * L::TILE_BYTES + (kk / 4) * QUERY_TILE * PANEL_ROW_BYTES + (kk % 4) * 32;
      wgmma_ss<QUERY_TILE>(dp, desc_v + (a_off >> 4), desc_do + (b_off >> 4), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // p^T = 2^(S^T scale log2(e) - lse log2(e)) with the lse of each column
    // (query), 0 for queries at or past S; dS^T = p^T (dP^T - Dr) scale.
    const float* lse_t = s_lse + stage * QUERY_TILE;
    const float* dr_t = s_dr + stage * QUERY_TILE;
#pragma unroll
    for (int i = 0; i < QUERY_TILE / 2; ++i) {
      const int c = (i / 4) * 8 + 2 * t + (i & 1);
      float p = exp2f(fmaf(s[i], scale_log2, -lse_t[c] * LOG2E));
      if (i0 + QUERY_TILE > S && i0 + c >= S) p = 0.f;
      s[i] = p;
      dp[i] = p * (dp[i] - dr_t[c]) * a.scale;
    }
    uint32_t pa[QUERY_TILE / 16][4], da[QUERY_TILE / 16][4];
    acc_to_a<QUERY_TILE>(pa, s);
    acc_to_a<QUERY_TILE>(da, dp);

    // dV += p^T dO, then dK += dS^T Q.
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QUERY_TILE / 16; ++kk) {
      wgmma_rs<D>(dv, pa[kk], desc_dot + ((stage * L::TILE_BYTES + kk * 16 * PANEL_ROW_BYTES) >> 4));
    }
#pragma unroll
    for (int kk = 0; kk < QUERY_TILE / 16; ++kk) {
      wgmma_rs<D>(dk, da[kk], desc_qt + ((stage * L::TILE_BYTES + kk * 16 * PANEL_ROW_BYTES) >> 4));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);

    // The lse and Dr of tile j + 1 (issued one tile ago) have landed, and
    // every warpgroup is done with this stage: refill it with tile j + STAGES.
    cp_async_wait_all();
    __syncthreads();
    if (j + STAGES < num_tiles) {
      const int i1 = (j + STAGES) * QUERY_TILE;
      if (tid == 0) {
        load_rows<D, BOX>(sq + stage * L::TILE_BYTES, &tq, bar_q + 8 * stage, QUERY_TILE, h, i1, b);
        load_rows<D, BOX>(sdo + stage * L::TILE_BYTES, &tdo, bar_do + 8 * stage, QUERY_TILE, h, i1, b);
      }
      if (tid < QUERY_TILE) {
        const int row = i1 + tid;
        const bool valid = row < S;
        cp_async_f32(s_lse_addr + 4 * (stage * QUERY_TILE + tid), lse_bh + (valid ? row : 0), valid);
        cp_async_f32(s_dr_addr + 4 * (stage * QUERY_TILE + tid), dr_bh + (valid ? row : 0), valid);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = n0 + wg * WG_ROWS + warp * 16 + g + 8 * r;
    if (row >= S) continue;
    const long long off = ((static_cast<long long>(b) * S + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<uint32_t*>(a.dk + off + c * 8) = pack_floats(dk[4 * c + 2 * r], dk[4 * c + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(a.dv + off + c * 8) = pack_floats(dv[4 * c + 2 * r], dv[4 * c + 2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch(const void* const* ptrs, const long long* strides, const BwdArgs& a, int B,
                   cudaStream_t stream) {
  // q, k, v and dO through 64-row boxes; o is read by plain loads.
  CUtensorMap maps[4];
  const int order[4] = {0, 1, 2, 4};
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 4 && err == cudaSuccess; ++i) {
    const long long* st = strides + 3 * order[i];
    err = make_map(&maps[i], ptrs[order[i]], B, a.S, a.H, D, st[0], st[1], st[2], BOX);
  }
  static bool dq_set[MAX_DEVICES] = {};
  static bool dkv_set[MAX_DEVICES] = {};
  if (err == cudaSuccess) err = opt_in_smem(flash_bwd_dq_kernel<D>, DqLayout<D>::BYTES, dq_set);
  if (err == cudaSuccess) err = opt_in_smem(flash_bwd_dkv_kernel<D>, DkvLayout<D>::BYTES, dkv_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + BLOCK - 1) / BLOCK, B * a.H);
  flash_bwd_dq_kernel<D><<<grid, NUM_THREADS, DqLayout<D>::BYTES, stream>>>(maps[0], maps[1], maps[2], maps[3], a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<D><<<grid, NUM_THREADS, DkvLayout<D>::BYTES, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                                                            a);
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
  const BwdArgs a{{static_cast<const bf16*>(o), strides[9], strides[10], strides[11]},
                  {static_cast<const bf16*>(dout), strides[12], strides[13], strides[14]},
                  lse, rowdot, static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                  S, H, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch<128>(ptrs, strides, a, B, st);
  if (D == 64) return launch<64>(ptrs, strides, a, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
