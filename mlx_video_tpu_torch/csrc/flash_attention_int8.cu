// Int8 attention for Hopper (sm_90a), K6: int8 x int8 -> int32 on the tensor
// cores for both products, behind a quantization prologue of two exact passes.
//
// Replaces mlx_video_tpu/ops/flash_attention.py:flash_attention_int8: the
// Pallas kernel _single_pass_int8_kernel and the XLA prologue fused around
// it, which quantizes q, k and v.
//
// The prologue, two launches (ops/flash_attention.py:int8_attention_prologue):
// - absmax_kernel reads q, k and v once, through the caller's (B, S, H, D)
//   strides, and takes |q|max, |k|max and |v|max per (b*h, channel) over the
//   tokens: atomicMax on the bits of non-negative floats, exact in any order.
// - quantize_kernel reads them again and writes the codes
//   clip(rint(x / sc), -127, 127), sc = max(absmax / 127, 1e-12), every
//   division a correctly rounded __fdiv_rn as ops/int8.py:scale_from_absmax
//   and the plain prologue divide (never a product with a reciprocal): q_q
//   and k_q as (B*H, S_pad, D), v_t as (B*H, D, S_pad), their zero padding
//   included; qk_scale = (s_q * s_k) * scale in fp32 and v_scale (B*H, D).
//   Its output is the plain prologue's (int8_attention_operands) bit for bit.
//
// The attention computes, per query row, what the Pallas kernel computes
// over a whole resident row: logits = fp32(int32(q_q k_q^T)) * qk_scale,
// keys >= S at -inf; m = the row max; p = exp(logits - m); p_q = round(127 p)
// as int8 (half to even); l = max(sum p_q, 1); out = fp32(int32(p_q v_q)) *
// v_scale / l, cast to the output type (bf16 or fp32). Optionally it writes
// p_q to a (B*H, S, S) int8 tensor, so a check can count the codes that
// differ from the plain version's.
//
// What bounds it on the H100: 4 S^2 D H int8 operations on ~5 S H D bytes,
// ~S/2 operations a byte against the card's ~590: not memory. Beside the
// tensor cores, the softmax: S^2 H logits of ~10 instructions and one
// MUFU exponential each, issued at one warp instruction a clock per SM
// sub-partition, the MUFU at an eighth of that.
//
// What the design does about it:
// - Two passes over the keys, because a p_q rounded against a stale running
//   max would give other codes than the Pallas kernel's. Pass 1 takes only
//   the int32 row extreme: int32 -> fp32 is exact (|s| <= 127^2 D < 2^24)
//   and __fmul_rn by qk_scale is monotone, so fp32(max s) * qk_scale is the
//   max logit bit for bit (the min where a negative scale makes qk_scale
//   negative), keys >= S masked to INT_MIN (INT_MAX). Pass 1 converts and
//   multiplies nothing a logit.
// - Pass 2's conversions run on the FMA pipe with exact magic numbers, not
//   on the quarter-rate conversion units: int -> float is
//   __int_as_float(0x4B400000 + s) - 1.5 * 2^23 (exact for |s| < 2^22), and
//   round half to even of 127 p in [0, 127] is the bits of 127 p + 1.5 * 2^23
//   less 0x4B400000, whose low byte is the code. The logit and its
//   difference to the max stay the plain version's rounded product and
//   difference (__fmul_rn, __fsub_rn: nvcc would contract them into one
//   fma). The exponential is ex2.approx of that difference times log2(e),
//   one MUFU instruction where IEEE expf costs eight: on an H100 it moved
//   none of the 1.8e9 p_q codes of (B, S) = (1, 1280) and (2, 5184), H = 32,
//   D = 128, against the plain version's expf.
// - Both products are wgmma.mma_async m64nNk32 s8 x s8 -> s32, exact
//   (|q k| <= 127^2 D, |p v| <= 127^2 S < 2^31). S = Q K^T reads Q and K from
//   shared memory, both K-major along d. O += P V takes P from registers; as
//   8-bit wgmma has no transpose, its B operand is v_t, K-major along keys:
//   the prologue's transpose is the layout it needs.
// - P stays in registers. The s32 accumulator gives a thread keys 8c + 2t
//   and 8c + 2t + 1 of rows g and g + 8; the A fragment wants keys 4t .. 4t + 3
//   and 16 + 4t .. 16 + 4t + 3 of each 32-key step. In each 16-key half that
//   is a fixed permutation of 2-byte key pairs inside a quad: one exchange
//   with the neighbour (lane xor 1; rows g and g + 8 share one word), then
//   threads 1 and 2 swap.
// - A block owns 128 query rows of one (batch, head): two consumer
//   warpgroups of 64 rows and one producer warp; grid = (ceil(S / 128), B * H).
//   The producer brings Q once, then 128-key tiles by TMA into a ring of
//   STAGES stages, each with a full and an empty mbarrier: pass 1's K tiles,
//   then pass 2's K and V^T tiles. (Nine warps leave a thread 168 registers;
//   giving the producer's work to a consumer thread instead, for 255, ran
//   slower on an H100.)
// - Issuing a wgmma holds a warp about as long as its products take, so a
//   warpgroup cannot run its softmax under its own products. So pass 1
//   issues tile j + 1's Q K^T before it takes tile j's extreme, and in pass
//   2 the warpgroups take turns at the tensor cores (named barriers, as
//   FlashAttention-3's ping-pong): one issues tile j's P V while the other
//   runs its softmax, then passes the turn and issues tile j + 1's Q K^T.
//   It waits for P V before it issues Q K^T: the A fragments, the next
//   tile's logits and O would not fit the 168 registers a thread together.
// - Shared memory holds Q and K rows of D bytes under the D-byte swizzle
//   (128 at D = 128, 64 at D = 64) and V^T rows of 128 keys under the
//   128-byte swizzle, as TMA writes them and the descriptors read them. The
//   maps of q_q and k_q are 3-D {D, S_pad, B*H}, so a 128-row box past a
//   head's S_pad (a multiple of 64) reads zeros, not the next head.

#include "hopper.cuh"

#include <limits.h>

namespace {

constexpr int WG_ROWS = 64;  // query rows of one warpgroup (wgmma's M)
constexpr int CONSUMERS = 2;
constexpr int BLOCK_M = CONSUMERS * WG_ROWS;       // query rows of one block
constexpr int PRODUCER_WARP = CONSUMERS * 4;       // the warp after the consumers
constexpr int NUM_THREADS = CONSUMERS * 128 + 32;  // + the producer warp
constexpr int BLOCK_N = 128;                       // keys of one tile
constexpr int STAGES = 4;                          // tiles in the ring
constexpr int MAGIC_BITS = 0x4B400000;             // the bits of 1.5 * 2^23
constexpr float MAGIC = 12582912.f;                // 1.5 * 2^23: integers have ulp 1 around it
constexpr unsigned FULL = 0xffffffffu;

// Byte offsets of the block's shared memory, from a 1024-byte aligned base.
template <int D>
struct Layout {
  static constexpr int TILE_BYTES = BLOCK_N * D;  // a K tile or a V^T tile
  static constexpr int Q_BYTES = BLOCK_M * D;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // K, then V^T
  static constexpr int STAGE_OFF = Q_BYTES;
  static constexpr int BAR_OFF = STAGE_OFF + STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

// S = Q K^T for one 128-key tile: D / 32 products of k32, both operands
// K-major along d; a k32 step moves 32 bytes along the swizzled row. The
// first step overwrites s, so the previous tile's logits die before it.
template <int D>
__device__ __forceinline__ void qk_products(int (&s)[BLOCK_N / 2], uint64_t desc_q, uint64_t desc_k) {
  wgmma_s8_ss_n128_first(s, desc_q, desc_k);
#pragma unroll
  for (int kk = 1; kk < D / 32; ++kk) wgmma_s8_ss_n128(s, desc_q + 2 * kk, desc_k + 2 * kk, 1);
}

// Named barriers 1 and 2 give the two warpgroups turns at the tensor cores:
// a warpgroup waits on its own barrier (bar.sync, its 128 threads) until the
// other has issued its products and arrived there (bar.arrive, the other 128).
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(CONSUMERS * 128) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(CONSUMERS * 128) : "memory");
}

// Wait until at most N of this warpgroup's committed product groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special-function unit; subnormal results flush to 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Pass 1: the running int32 max (min with MIN) of rows g and g + 8 over one
// tile; element i of the accumulator is row g + 8 ((i >> 1) & 1), key
// n0 + 8 (i >> 2) + 2t + (i & 1).
template <bool MIN, bool RAGGED>
__device__ __forceinline__ void row_extreme(int (&ext)[2], const int (&s)[BLOCK_N / 2], int n0, int S, int t) {
#pragma unroll
  for (int i = 0; i < BLOCK_N / 2; ++i) {
    int v = s[i];
    if (RAGGED && n0 + (i >> 2) * 8 + 2 * t + (i & 1) >= S) v = MIN ? INT_MAX : INT_MIN;
    ext[(i >> 1) & 1] = MIN ? min(ext[(i >> 1) & 1], v) : max(ext[(i >> 1) & 1], v);
  }
}

// Pass 2: each logit's code, as the bits 0x4B400000 + p_q (keys >= S: 0);
// with CODES also stored to the (B*H, S, S) codes of rows row_g, row_g + 8.
template <bool RAGGED, bool CODES>
__device__ __forceinline__ void p_codes_tile(int (&s)[BLOCK_N / 2], float qk, const float (&m)[2], int n0, int S,
                                             int t, int8_t* codes, int row_g) {
#pragma unroll
  for (int i = 0; i < BLOCK_N / 2; ++i) {
    const float logit = __fmul_rn(__fsub_rn(__int_as_float(s[i] + MAGIC_BITS), MAGIC), qk);
    const float p = exp2_approx(__fmul_rn(__fsub_rn(logit, m[(i >> 1) & 1]), LOG2E));
    int bits = __float_as_int(__fadd_rn(__fmul_rn(p, 127.f), MAGIC));
    const int key = n0 + (i >> 2) * 8 + 2 * t + (i & 1);
    if (RAGGED && key >= S) bits = MAGIC_BITS;
    if (CODES) {
      const int row = row_g + 8 * ((i >> 1) & 1);
      if (row < S && key < S) codes[static_cast<int64_t>(row) * S + key] = static_cast<int8_t>(bits);
    }
    s[i] = bits;
  }
}

// The low bytes of four codes' bits, `a` lowest.
__device__ __forceinline__ uint32_t low_bytes(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// The tile's codes as the s8 A fragments of P V: pa[kk] holds keys 32 kk ..
// 32 kk + 31 as {row g, keys 4t..4t+3}, {row g + 8, same}, {row g, keys
// 16+4t..16+4t+3}, {row g + 8, same}. In 16-key half h of step kk the thread
// holds pair t (accumulator block c0 = 4kk + 2h) and pair 4 + t (block c0 + 1)
// of rows g and g + 8; even threads keep pair t and take their neighbour's,
// odd threads keep pair 4 + t and take their neighbour's pair 3 + t, which
// leaves threads 0..3 with pairs (0, 1), (4, 5), (2, 3), (6, 7); then threads
// 1 and 2 swap.
__device__ __forceinline__ void codes_to_a(uint32_t (&pa)[BLOCK_N / 32][4], const int (&s)[BLOCK_N / 2], bool odd,
                                           uint32_t sel_g, uint32_t sel_g8, int swap_lane) {
#pragma unroll
  for (int kk = 0; kk < BLOCK_N / 32; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c0 = 4 * kk + 2 * h;
      const uint32_t x = low_bytes(s[4 * c0], s[4 * c0 + 1], s[4 * c0 + 2], s[4 * c0 + 3]);
      const uint32_t y = low_bytes(s[4 * c0 + 4], s[4 * c0 + 5], s[4 * c0 + 6], s[4 * c0 + 7]);
      const uint32_t keep = odd ? y : x;
      const uint32_t recv = __shfl_xor_sync(FULL, odd ? x : y, 1);
      pa[kk][2 * h] = __shfl_sync(FULL, __byte_perm(keep, recv, sel_g), swap_lane);
      pa[kk][2 * h + 1] = __shfl_sync(FULL, __byte_perm(keep, recv, sel_g8), swap_lane);
    }
  }
}

template <int D, typename OutT, bool CODES>
__global__ void __launch_bounds__(NUM_THREADS, 1)
flash_int8_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const float* __restrict__ qk_scale_ptr,
                  const float* __restrict__ v_scale, OutT* __restrict__ o, int8_t* __restrict__ p_codes, int S,
                  int H) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t ring = base + L::STAGE_OFF;  // stage s: K at + s * STAGE_BYTES, V^T TILE_BYTES after
  const uint32_t bar_q = base + L::BAR_OFF;
  const uint32_t bar_full = bar_q + 8;                // stage s at + 8 * s
  const uint32_t bar_empty = bar_full + 8 * STAGES;  // stage s at + 8 * s

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * BLOCK_M;
  const int num_tiles = (S + BLOCK_N - 1) / BLOCK_N;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid / 32 == PRODUCER_WARP) {
    // Load i < num_tiles is pass 1's K tile i, load num_tiles + j pass 2's K
    // and V^T tile j; each waits until both warpgroups released its stage.
    if (tid % 32 == 0) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
      tma_load_3d(sq, &tq, bar_q, 0, m0, bh);
      for (int i = 0; i < 2 * num_tiles; ++i) {
        const int stage = i % STAGES;
        const bool pass2 = i >= num_tiles;
        const int n0 = (pass2 ? i - num_tiles : i) * BLOCK_N;
        const uint32_t dst = ring + stage * L::STAGE_BYTES;
        const uint32_t full = bar_full + 8 * stage;
        mbar_wait(bar_empty + 8 * stage, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full, pass2 ? L::STAGE_BYTES : L::TILE_BYTES);
        tma_load_3d(dst, &tk, full, 0, n0, bh);
        if (pass2) tma_load_2d(dst + L::TILE_BYTES, &tv, full, n0, bh * D);
      }
    }
    return;
  }

  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;  // 16 rows of the warpgroup's 64
  const int lane = tid % 32;
  const int g = lane >> 2;  // accumulator row group: rows g and g + 8
  const int t = lane & 3;   // columns 2t, 2t + 1 of every 8
  const bool odd = t & 1;
  const uint32_t sel_g = odd ? 0x1054 : 0x5410;
  const uint32_t sel_g8 = odd ? 0x3276 : 0x7632;
  const int swap_lane = (lane & ~3) | (t == 1 ? 2 : t == 2 ? 1 : t);
  const bool releases = tid % 128 == 0;  // one arrival a warpgroup frees a stage
  const float qk = *qk_scale_ptr;
  const bool neg = qk < 0.f;
  const uint64_t desc_q = make_desc_sw(sq + wg * WG_ROWS * D, 8 * D, D);

  mbar_wait(bar_q, 0);

  // Pass 1: the int32 extreme of rows g and g + 8 over every key below S;
  // tile j + 1's Q K^T runs while tile j's extreme is taken.
  int ext[2] = {neg ? INT_MAX : INT_MIN, neg ? INT_MAX : INT_MIN};
  auto issue_qk = [&](int (&sv)[BLOCK_N / 2], int j) {
    const int stage = j % STAGES;
    mbar_wait(bar_full + 8 * stage, (j / STAGES) & 1);
    wgmma_fence();
    qk_products<D>(sv, desc_q, make_desc_sw(ring + stage * L::STAGE_BYTES, 8 * D, D));
    wgmma_commit();
  };
  auto extreme = [&](int (&cur)[BLOCK_N / 2], int (&nxt)[BLOCK_N / 2], int j) {
    if (j + 1 < num_tiles) {
      issue_qk(nxt, j + 1);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(cur);
    if (releases) mbar_arrive(bar_empty + 8 * (j % STAGES));
    const int n0 = j * BLOCK_N;
    if (n0 + BLOCK_N > S) {
      if (neg) row_extreme<true, true>(ext, cur, n0, S, t); else row_extreme<false, true>(ext, cur, n0, S, t);
    } else {
      if (neg) row_extreme<true, false>(ext, cur, n0, S, t); else row_extreme<false, false>(ext, cur, n0, S, t);
    }
  };
  int sa[BLOCK_N / 2], sb[BLOCK_N / 2];
  issue_qk(sa, 0);
  for (int j = 0; j < num_tiles; j += 2) {
    extreme(sa, sb, j);
    if (j + 1 < num_tiles) extreme(sb, sa, j + 1);
  }
  float m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      const int other = __shfl_xor_sync(FULL, ext[r], x);
      ext[r] = neg ? min(ext[r], other) : max(ext[r], other);
    }
    m[r] = __fmul_rn(static_cast<float>(ext[r]), qk);
  }

  // Pass 2: p_q against the row max, its sum and the int32 P V. In its
  // turn a warpgroup issues tile j's P V and waits for it (warpgroup 0
  // first), then passes the turn and issues tile j + 1's Q K^T, so that one's
  // softmax runs while the other's products do. The last turn of warpgroup 1
  // passes no turn: nobody waits for it. The logits reuse pass 1's first
  // array.
  const int row_g = m0 + wg * WG_ROWS + warp * 16 + g;  // rows row_g and row_g + 8
  int8_t* codes = CODES ? p_codes + static_cast<int64_t>(bh) * S * S : nullptr;
  int acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0;
  int l_row[2] = {0, 0};
  int (&s)[BLOCK_N / 2] = sa;
  if (wg == 1) turn_pass(wg);
  turn_wait(wg);
  mbar_wait(bar_full + 8 * (num_tiles % STAGES), (num_tiles / STAGES) & 1);
  wgmma_fence();
  qk_products<D>(s, desc_q, make_desc_sw(ring + (num_tiles % STAGES) * L::STAGE_BYTES, 8 * D, D));
  wgmma_commit();
  turn_pass(wg);
  wgmma_wait<0>();
  fence_regs(s);
  for (int j = 0; j < num_tiles; ++j) {
    const int i = num_tiles + j;
    const int stage = i % STAGES;
    const int n0 = j * BLOCK_N;
    if (n0 + BLOCK_N > S) {
      p_codes_tile<true, CODES>(s, qk, m, n0, S, t, codes, row_g);
    } else {
      p_codes_tile<false, CODES>(s, qk, m, n0, S, t, codes, row_g);
    }
    uint32_t pa[BLOCK_N / 32][4];
    codes_to_a(pa, s, odd, sel_g, sel_g8, swap_lane);
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 32; ++kk) {
      l_row[0] = __dp4a(static_cast<int>(pa[kk][0]), 0x01010101, l_row[0]);
      l_row[0] = __dp4a(static_cast<int>(pa[kk][2]), 0x01010101, l_row[0]);
      l_row[1] = __dp4a(static_cast<int>(pa[kk][1]), 0x01010101, l_row[1]);
      l_row[1] = __dp4a(static_cast<int>(pa[kk][3]), 0x01010101, l_row[1]);
    }

    // O += P V: V^T rows of 128 keys; a 32-key step moves 32 bytes.
    fence_regs(pa);
    wgmma_fence();
    const uint64_t desc_v = make_desc_sw(ring + stage * L::STAGE_BYTES + L::TILE_BYTES, 1024, 128);
    turn_wait(wg);
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 32; ++kk) wgmma_s8_rs<D>(acc, pa[kk], desc_v + 2 * kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (wg == 0 || j + 1 < num_tiles) turn_pass(wg);
    if (j + 1 < num_tiles) {
      const int next = (i + 1) % STAGES;
      mbar_wait(bar_full + 8 * next, ((i + 1) / STAGES) & 1);
      wgmma_fence();
      qk_products<D>(s, desc_q, make_desc_sw(ring + next * L::STAGE_BYTES, 8 * D, D));
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(s);
    if (releases) mbar_arrive(bar_empty + 8 * stage);
  }

  // Normalise by the codes' own sum and store rows g and g + 8 below S into
  // the (B, S, H, D) output.
  const int b = bh / H;
  const int h = bh % H;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int sum = l_row[r];
    sum += __shfl_xor_sync(FULL, sum, 1);
    sum += __shfl_xor_sync(FULL, sum, 2);
    const float l = fmaxf(static_cast<float>(sum), 1.0f);
    const int row = row_g + 8 * r;
    if (row >= S) continue;
    OutT* orow = o + ((static_cast<int64_t>(b) * S + row) * H + h) * D + 2 * t;
    const float* vs = v_scale + static_cast<int64_t>(bh) * D + 2 * t;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const float o0 = __fdiv_rn(__fmul_rn(__int2float_rn(acc[4 * c + 2 * r]), vs[c * 8]), l);
      const float o1 = __fdiv_rn(__fmul_rn(__int2float_rn(acc[4 * c + 2 * r + 1]), vs[c * 8 + 1]), l);
      if constexpr (sizeof(OutT) == 2) {
        *reinterpret_cast<uint32_t*>(orow + c * 8) = pack_floats(o0, o1);
      } else {
        *reinterpret_cast<float2*>(orow + c * 8) = make_float2(o0, o1);
      }
    }
  }
}

template <int D, typename OutT, bool CODES>
cudaError_t launch(const void* q, const void* k, const void* vt, const float* qk_scale, const float* v_scale,
                   void* o, void* p_codes, int BH, int S, int S_pad, int H, cudaStream_t stream) {
  using L = Layout<D>;
  const CUtensorMapSwizzle qk_swizzle = D == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const long long head_bytes = static_cast<long long>(S_pad) * D;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map_3d(&tq, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, D, S_pad, BH, D, head_bytes, D, BLOCK_M,
                                qk_swizzle);
  if (err == cudaSuccess) {
    err = make_map_3d(&tk, k, CU_TENSOR_MAP_DATA_TYPE_UINT8, D, S_pad, BH, D, head_bytes, D, BLOCK_N, qk_swizzle);
  }
  if (err == cudaSuccess) {
    err = make_map_2d(&tv, vt, CU_TENSOR_MAP_DATA_TYPE_UINT8, S_pad, static_cast<long long>(BH) * D, S_pad, BLOCK_N,
                      D, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  static bool smem_set[MAX_DEVICES] = {};
  if (err == cudaSuccess) err = opt_in_smem(flash_int8_kernel<D, OutT, CODES>, L::BYTES, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BLOCK_M - 1) / BLOCK_M, BH);
  flash_int8_kernel<D, OutT, CODES><<<grid, NUM_THREADS, L::BYTES, stream>>>(
      tq, tk, tv, qk_scale, v_scale, static_cast<OutT*>(o), static_cast<int8_t*>(p_codes), S, H);
  return cudaGetLastError();
}

template <int D, typename OutT>
cudaError_t launch_codes(const void* q, const void* k, const void* vt, const float* qk_scale, const float* v_scale,
                         void* o, void* p_codes, int BH, int S, int S_pad, int H, cudaStream_t stream) {
  return p_codes != nullptr
             ? launch<D, OutT, true>(q, k, vt, qk_scale, v_scale, o, p_codes, BH, S, S_pad, H, stream)
             : launch<D, OutT, false>(q, k, vt, qk_scale, v_scale, o, p_codes, BH, S, S_pad, H, stream);
}

// ---------------------------------------------------------------------------
// The quantization prologue
// ---------------------------------------------------------------------------

constexpr int PRO_THREADS = 128;
constexpr int AMAX_ROWS = 64;   // sequence rows an absmax block reads
constexpr int QUANT_ROWS = 64;  // sequence rows a quantize block writes (S_pad is a multiple)
constexpr int QUANT_PITCH = QUANT_ROWS + 16;  // bytes of a channel's row in the v transpose tile

// One (B, S, H, D) input and its strides, in elements.
struct Operand {
  const void* ptr;
  long long sb, ss, sh, sd;
};

// q, k and v.
struct Inputs {
  Operand x[3];
};

// Tensor `which` of the three, selected field by field: a parameter array
// indexed at run time would be copied to local memory.
__device__ __forceinline__ Operand pick(const Inputs& in, int which) {
  return which == 0 ? in.x[0] : which == 1 ? in.x[1] : in.x[2];
}

__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

// VEC consecutive channels from p: one 16-byte load when VEC > 1 (the
// channel stride is then 1), else one element.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(float (&x)[VEC], const T* p) {
  if constexpr (VEC == 1) {
    x[0] = to_float(*p);
  } else if constexpr (sizeof(T) == 2) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(pairs[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else {
    const float4 u = *reinterpret_cast<const float4*>(p);
    x[0] = u.x;
    x[1] = u.y;
    x[2] = u.z;
    x[3] = u.w;
  }
}

// max(absmax / 127, 1e-12), the quotient correctly rounded.
__device__ __forceinline__ float int8_scale(unsigned int absmax_bits) {
  const float sc = __fdiv_rn(__uint_as_float(absmax_bits), 127.f);
  return sc < 1e-12f ? 1e-12f : sc;
}

// clip(rint(x / sc), -127, 127), rint rounding half to even.
__device__ __forceinline__ int quantize(float x, float sc) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(x, sc)), -127.f), 127.f));
}

// amax[0] = |q|max, amax[1] = |k|max, amax[2 + bh * D + d] = |v|max of
// (bh, d) over tokens, as float bits (zeroed before). Block (x, y, z) reads
// VEC channels a thread of rows y * AMAX_ROWS .. + AMAX_ROWS of tensor z % 3,
// batch z / 3.
template <typename T, int VEC>
__global__ void __launch_bounds__(PRO_THREADS)
absmax_kernel(Inputs in, int S, int H, int D, unsigned int* __restrict__ amax) {
  const int which = blockIdx.z % 3;
  const int b = blockIdx.z / 3;
  const Operand x = pick(in, which);
  const int col = (blockIdx.x * PRO_THREADS + threadIdx.x) * VEC;  // h * D + d
  const bool active = col < H * D;
  const int h = col / D;
  const int d0 = col - h * D;
  float mx[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) mx[e] = 0.f;
  if (active) {
    const T* p = static_cast<const T*>(x.ptr) + b * x.sb + h * x.sh + d0 * x.sd;
    const int s1 = min(S, static_cast<int>(blockIdx.y + 1) * AMAX_ROWS);
#pragma unroll 8
    for (int s = blockIdx.y * AMAX_ROWS; s < s1; ++s) {
      float val[VEC];
      load_vec<T, VEC>(val, p + s * x.ss);
#pragma unroll
      for (int e = 0; e < VEC; ++e) mx[e] = fmaxf(mx[e], fabsf(val[e]));
    }
  }
  if (which == 2) {
    if (active) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) atomicMax(&amax[2 + (b * H + h) * D + d0 + e], __float_as_uint(mx[e]));
    }
    return;
  }
  __shared__ float part[PRO_THREADS / 32];
  float m = mx[0];
#pragma unroll
  for (int e = 1; e < VEC; ++e) m = fmaxf(m, mx[e]);
#pragma unroll
  for (int lanes = 16; lanes >= 1; lanes >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, lanes));
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < PRO_THREADS / 32; ++w) m = fmaxf(m, part[w]);
    atomicMax(&amax[which], __float_as_uint(m));
  }
}

// The codes of rows blockIdx.x * QUANT_ROWS .. + QUANT_ROWS of head
// blockIdx.y of tensor blockIdx.z (q, k, v), rows >= S as zeros; v goes
// through a shared tile to its transposed (B*H, D, S_pad) layout. Block
// (0, 0, 0) writes qk_scale, the blocks of v's first rows v_scale.
template <typename T, int VEC>
__global__ void __launch_bounds__(PRO_THREADS)
quantize_kernel(Inputs in, int S, int S_pad, int H, int D, const unsigned int* __restrict__ amax, float scale,
                int8_t* __restrict__ q_q, int8_t* __restrict__ k_q, int8_t* __restrict__ v_t,
                float* __restrict__ qk_scale, float* __restrict__ v_scale) {
  __shared__ float vs[128];
  __shared__ __align__(16) int8_t tile[128 * QUANT_PITCH];
  const int which = blockIdx.z;
  const int bh = blockIdx.y;
  const int s0 = blockIdx.x * QUANT_ROWS;
  const Operand x = pick(in, which);
  const T* src = static_cast<const T*>(x.ptr) + (bh / H) * x.sb + (bh % H) * x.sh;

  if (which < 2) {
    const float sc = int8_scale(amax[which]);
    if (which == 0 && bh == 0 && blockIdx.x == 0 && threadIdx.x == 0) {
      *qk_scale = __fmul_rn(__fmul_rn(sc, int8_scale(amax[1])), scale);
    }
    int8_t* out = (which == 0 ? q_q : k_q) + (static_cast<int64_t>(bh) * S_pad + s0) * D;
    const int vecs = D / VEC;
    for (int i = threadIdx.x; i < QUANT_ROWS * vecs; i += PRO_THREADS) {
      const int r = i / vecs;
      const int d = (i - r * vecs) * VEC;
      uint32_t word[(VEC + 3) / 4] = {};
      if (s0 + r < S) {
        float val[VEC];
        load_vec<T, VEC>(val, src + (s0 + r) * x.ss + d * x.sd);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          word[e / 4] |= (static_cast<uint32_t>(quantize(val[e], sc)) & 0xFFu) << (8 * (e % 4));
        }
      }
      int8_t* dst = out + r * D + d;
      if constexpr (VEC == 8) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(word[0], word[1]);
      } else if constexpr (VEC == 4) {
        *reinterpret_cast<uint32_t*>(dst) = word[0];
      } else {
        *dst = static_cast<int8_t>(word[0]);
      }
    }
    return;
  }

  for (int d = threadIdx.x; d < D; d += PRO_THREADS) {
    vs[d] = int8_scale(amax[2 + bh * D + d]);
    if (blockIdx.x == 0) v_scale[static_cast<int64_t>(bh) * D + d] = vs[d];
  }
  __syncthreads();
  // Neighbouring threads take neighbouring rows (a 32-byte sector each), so
  // their byte writes into a channel's row of the tile share banks' words.
  constexpr int GROUP = 2 * VEC;
  for (int i = threadIdx.x; i < QUANT_ROWS * (D / GROUP); i += PRO_THREADS) {
    const int r = i % QUANT_ROWS;
    const int d0 = (i / QUANT_ROWS) * GROUP;
    const bool real = s0 + r < S;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int d = d0 + half * VEC;
      float val[VEC] = {};
      if (real) load_vec<T, VEC>(val, src + (s0 + r) * x.ss + d * x.sd);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        tile[(d + e) * QUANT_PITCH + r] = real ? static_cast<int8_t>(quantize(val[e], vs[d + e])) : int8_t(0);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D * (QUANT_ROWS / 16); i += PRO_THREADS) {
    const int d = i / (QUANT_ROWS / 16);
    const int c = (i % (QUANT_ROWS / 16)) * 16;
    *reinterpret_cast<uint4*>(v_t + (static_cast<int64_t>(bh) * D + d) * S_pad + s0 + c) =
        *reinterpret_cast<const uint4*>(tile + d * QUANT_PITCH + c);
  }
}

template <typename T, int VEC>
cudaError_t prologue(const Inputs& in, int B, int S, int H, int D, int S_pad, float scale, void* q_q, void* k_q,
                     void* v_t, float* qk_scale, float* v_scale, unsigned int* amax, cudaStream_t stream) {
  const dim3 grid_max((H * D / VEC + PRO_THREADS - 1) / PRO_THREADS, (S + AMAX_ROWS - 1) / AMAX_ROWS, 3 * B);
  absmax_kernel<T, VEC><<<grid_max, PRO_THREADS, 0, stream>>>(in, S, H, D, amax);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_quant(S_pad / QUANT_ROWS, B * H, 3);
  quantize_kernel<T, VEC><<<grid_quant, PRO_THREADS, 0, stream>>>(
      in, S, S_pad, H, D, amax, scale, static_cast<int8_t*>(q_q), static_cast<int8_t*>(k_q),
      static_cast<int8_t*>(v_t), qk_scale, v_scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes, the attention. q_q, k_q: contiguous
// (B*H, S_pad, D) int8; v_t: contiguous (B*H, D, S_pad) int8; qk_scale: one
// fp32; v_scale: contiguous (B*H, D) fp32; o: contiguous (B, S, H, D), bf16
// (out_fp32 = 0) or fp32; p_codes: contiguous (B*H, S, S) int8 or NULL. S_pad
// is a multiple of 64, D is 64 or 128. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int mvt_flash_attention_int8(const void* q, const void* k, const void* vt, const float* qk_scale,
                                        const float* v_scale, void* o, void* p_codes, int B, int S, int S_pad, int H,
                                        int D, int out_fp32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || S_pad % QUANT_ROWS != 0 || S_pad < S) return static_cast<int>(cudaErrorInvalidValue);
  const int BH = B * H;
  if (D == 128) {
    return out_fp32 ? launch_codes<128, float>(q, k, vt, qk_scale, v_scale, o, p_codes, BH, S, S_pad, H, st)
                    : launch_codes<128, bf16>(q, k, vt, qk_scale, v_scale, o, p_codes, BH, S, S_pad, H, st);
  }
  if (D == 64) {
    return out_fp32 ? launch_codes<64, float>(q, k, vt, qk_scale, v_scale, o, p_codes, BH, S, S_pad, H, st)
                    : launch_codes<64, bf16>(q, k, vt, qk_scale, v_scale, o, p_codes, BH, S, S_pad, H, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Plain C entry point for ctypes, the prologue. q, k, v: (B, S, H, D), all
// bf16 (in_fp32 = 0) or all fp32, read through `strides` (12 element strides:
// q's b, s, h, d, then k's, then v's); vec = 1 when every channel stride is 1,
// every other stride a multiple of 16 bytes' worth of elements and every
// pointer 16-byte aligned. Writes the contiguous outputs of
// int8_attention_operands (q_q, k_q, v_t, qk_scale, v_scale; S_pad a
// multiple of 64 >= S) and uses `amax`, 2 + B*H*D uint32, as its scratch.
// Returns the first cudaError_t of its launches (0 on success).
extern "C" int mvt_int8_attention_operands(const void* q, const void* k, const void* v, const long long* strides,
                                           int B, int S, int H, int D, int S_pad, int in_fp32, int vec, float scale,
                                           void* q_q, void* k_q, void* v_t, float* qk_scale, float* v_scale,
                                           void* amax, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || S_pad % QUANT_ROWS != 0 || S_pad < S || D > 128 || D % 16 != 0 || 3 * B > 65535 ||
      (S + AMAX_ROWS - 1) / AMAX_ROWS > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Inputs in;
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    in.x[i] = Operand{ptrs[i], strides[4 * i], strides[4 * i + 1], strides[4 * i + 2], strides[4 * i + 3]};
  }
  unsigned int* scratch = static_cast<unsigned int*>(amax);
  cudaError_t err = cudaMemsetAsync(scratch, 0, (2 + static_cast<size_t>(B) * H * D) * sizeof(unsigned int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (in_fp32) {
    err = vec ? prologue<float, 4>(in, B, S, H, D, S_pad, scale, q_q, k_q, v_t, qk_scale, v_scale, scratch, st)
              : prologue<float, 1>(in, B, S, H, D, S_pad, scale, q_q, k_q, v_t, qk_scale, v_scale, scratch, st);
  } else {
    err = vec ? prologue<bf16, 8>(in, B, S, H, D, S_pad, scale, q_q, k_q, v_t, qk_scale, v_scale, scratch, st)
              : prologue<bf16, 1>(in, B, S, H, D, S_pad, scale, q_q, k_q, v_t, qk_scale, v_scale, scratch, st);
  }
  return static_cast<int>(err);
}
