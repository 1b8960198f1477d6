// Dequantizing matmul for group-affine quantized linears, Hopper (sm_90a).
//
// Replaces mlx_video_tpu/ops/quant_matmul.py:quant_matmul (the Pallas kernel
// _qmm_kernel). It computes y = x @ W^T for bf16 x (M, K) and a weight W
// (N, K) stored as MLX group-affine words: packed (N, K * bits / 32) uint32,
// LSB-first, 32 / bits values per word, and scales/biases (N, K / group) in
// fp32, bf16 or fp16. W = q * scale + bias is computed in fp32 (multiply,
// then add, each rounded, as the plain PyTorch version computes it), rounded
// to bf16, and multiplied with fp32 accumulation; y is bf16.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s: a ridge of ~295
// operations per byte): a product reads K * N weights once for 2 * M * K * N
// operations. Packed 4-bit words with group-64 fp32 scales are ~0.63 bytes a
// weight, 3.2 * M operations a byte, so the tensor-core rate is the floor at
// every M of the path (M = 128 to 3456). Beside the tensor cores, every
// weight value costs ALU work to dequantize (shift, mask, convert, multiply,
// add, pack) once for every tile of x rows it meets, a block re-reads its x
// tile from L2 for every weight tile, and at M = 128 and 320 a grid of one
// tile a block leaves most of the 132 SMs idle.
//
// What the design does about it:
// - The operands are swapped: a block computes a y^T tile = W x^T of
//   BW = 128 weight rows by BX = 128, 160 or 256 x rows (wgmma's N), so each
//   weight value is dequantized once per BX x rows, not once per 128.
// - x is the K-major B operand: 64-value K steps of BX rows arrive by TMA
//   into 128-byte-swizzled shared memory, through a ring of as many stages as
//   shared memory holds (3 to 8), one mbarrier a stage. The words of the same
//   step come by TMA into the same stage where their rows are a multiple of
//   16 bytes; otherwise (bits 2 at K = 96: 24-byte rows) every thread copies
//   4-byte pieces by cp.async. Where every K step lies in one group and a
//   row of scales is a multiple of 16 bytes, the scales and biases come by
//   TMA too, the 16 bytes of each row that hold the step's group; otherwise
//   by cp.async, bf16 and fp16 as the 4-byte words that hold them (4-byte
//   cp.asyncs of every row's scale each step took 12-20 % of the kernel's
//   time on the card). Every thread's copies arrive on the stage's barrier
//   (cp.async.mbarrier.arrive).
// - The weight is the K-major A operand in shared memory (SS wgmma): each
//   warpgroup dequantizes its 64 rows of a K step (32 values a thread, one
//   read of the packed words, q to float by the exact magic-number trick
//   without I2F) into a 128-byte-swizzled bf16 tile, one of two: while it
//   dequantizes step i into one, step i - 1's products on the other run
//   (wgmma.wait_group 1), so the ALU work overlaps the tensor cores. The
//   RS form (the A fragment dequantized straight into registers) was
//   measured too: its products alone ran 21-26 % slower on the card than
//   the same products in SS form (PERF.md §6).
// - The grid fills the card: the host picks BX and a split of K over a
//   thread-block cluster of 1, 2 or 4 blocks from the shape and the SM count
//   (the fewest waves of work). The blocks of a cluster each sum their share
//   of K into an fp32 tile in their own shared memory, and then each block
//   adds the cluster's tiles for its share of the rows through distributed
//   shared memory in rank order: deterministic, no atomics, no workspace.
//   A cluster of 1 stores its own tile. y leaves in 16-byte stores.
// - Groups that are a multiple of 64 (every K step in one group) read a
//   row's scale and bias once a step; other groups take one instance
//   (BX = 128) that looks them up for every pair of values.
// - Rows past M arrive as TMA zeros, weight rows past N and values past K
//   as zero words with zero scales and biases; none of them is stored.

#include <cuda_fp16.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int WG_ROWS = 64;  // weight rows of one warpgroup (wgmma's M)
constexpr int WARPGROUPS = 2;
constexpr int BW = WARPGROUPS * WG_ROWS;  // weight rows of one block
constexpr int NUM_THREADS = WARPGROUPS * 128;
constexpr int BK = 64;            // values of one K step (one 128-byte x panel)
constexpr int MAX_NG = 16;        // scale entries a row can need in one K step (group 4)
constexpr int MAX_SPLITS = 4;
constexpr int MAX_RING = 8;       // stages of the ring, as many as shared memory holds
constexpr int A_BYTES = WG_ROWS * BK * 2;  // one warpgroup's dequantized bf16 weight tile of a K step
constexpr int P_STRIDE = BW + 4;  // floats between rows of the fp32 y tile (no bank conflicts)
// Shared memory from a 1024-aligned base: the barriers, two A tiles a
// warpgroup, then the ring from BASE; the epilogue's y tile reuses all but
// the barriers.
constexpr int BASE = 1024 + 2 * WARPGROUPS * A_BYTES;
constexpr int SMEM_BYTES = 232448 - 1024;  // a block's most, less the alignment slack

struct Params {
  const uint32_t* packed;
  const void* scales;
  const void* biases;
  bf16* y;
  int M, N, K, group;
  int gshift;         // log2(group) if group is a power of two, else -1
  int steps;          // K steps of BK values: ceil(K / BK)
  int splits;         // blocks of a cluster, each a share of the K steps
  int ng;             // scale entries a row in each stage's slot
  int ring;           // stages in the ring
  int stage_bytes;    // x, words, scale and bias words of one stage
  int tma_words;      // rows of words are a multiple of 16 bytes: the words come by TMA
  int tma_scales;     // the scales and biases come by TMA: `box` entries a row, aligned to `box`
  int box;            // entries of a row's TMA box: a multiple of 16 bytes that holds a step's groups
  int sb_bytes;       // a stage's scale words then bias words
};

// Bytes of one stage: x (BX rows of BK bf16), the words of BW rows, and the
// scales and biases: `ng` 4-byte words a row each by cp.async, or a row of
// a TMA box each.
template <int BITS, int BX>
constexpr int stage_bytes(int sb_bytes) {
  return BX * BK * 2 + BW * BK * BITS / 8 + sb_bytes;
}
static_assert(2 * stage_bytes<8, 256>(2 * MAX_NG * BW * 4) <= SMEM_BYTES - BASE, "two stages must fit");
static_assert(256 * P_STRIDE * 4 <= SMEM_BYTES - 1024, "the fp32 y tile must fit");

// Wait until at most N of this warpgroup's committed product groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A 4-byte cp.async from src; only the first `valid` bytes are read, the
// rest of the destination is zero-filled.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid) : "memory");
}

// The barrier counts one arrival of this thread once its cp.asyncs so far have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Four fp32 of the shared memory of block `rank` of the cluster at this block's address `addr`.
__device__ __forceinline__ float4 ld_cluster(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// A scale or bias from the 32-bit word that holds it: an fp32 is the word;
// a bf16 or fp16 is its low or high half (`high`: the element's index is odd).
template <typename S>
__device__ __forceinline__ float entry_value(uint32_t word, bool high) {
  if constexpr (sizeof(S) == 4) {
    return __uint_as_float(word);
  } else {
    const uint32_t h = high ? word >> 16 : word & 0xFFFFu;
    if constexpr (sizeof(S) == 2 && std::is_same<S, bf16>::value) {
      return __uint_as_float(h << 16);
    } else {
      return __half2float(__ushort_as_half(static_cast<unsigned short>(h)));
    }
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// q (0 .. 2^bits - 1) to float without I2F: 2^23 + q has q in its mantissa.
__device__ __forceinline__ float q_to_float(uint32_t q) {
  return __fsub_rn(__uint_as_float(0x4B000000u | q), 8388608.f);
}

// bf16(fp32(q * s) + b), each step rounded as the plain version's.
__device__ __forceinline__ float dequant(uint32_t q, float s, float b) { return __fadd_rn(__fmul_rn(q_to_float(q), s), b); }

// The words of 32 consecutive values of one row (BITS words), from `src`.
template <int BITS>
__device__ __forceinline__ void load_words(const unsigned char* src, uint32_t (&w)[BITS]) {
  if constexpr (BITS == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    w[0] = v.x, w[1] = v.y;
  } else {
#pragma unroll
    for (int j = 0; j < BITS / 4; ++j) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + 16 * j);
      w[4 * j] = v.x, w[4 * j + 1] = v.y, w[4 * j + 2] = v.z, w[4 * j + 3] = v.w;
    }
  }
}

// Value v (0 .. 31) of those words (LSB first).
template <int BITS>
__device__ __forceinline__ uint32_t value_of(const uint32_t (&w)[BITS], int v) {
  return (w[v * BITS / 32] >> ((v * BITS) % 32)) & ((1u << BITS) - 1u);
}

// ONE_GROUP: the group is a multiple of BK, so every K step lies in one
// group and a row's scale and bias are read once a step.
template <int BITS, typename S, int BX, bool ONE_GROUP>
__global__ void __launch_bounds__(NUM_THREADS, 1)
quant_matmul_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                    const __grid_constant__ CUtensorMap ts, const __grid_constant__ CUtensorMap tb, const Params p) {
  constexpr int X_BYTES = BX * BK * 2;
  constexpr int W_ROW = BK * BITS / 8;  // bytes of words of one row in one stage
  constexpr int W_BYTES = BW * W_ROW;
  constexpr bool HALF_SCALES = sizeof(S) == 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base;  // slot s's data has landed: + 8 s
  const uint32_t ring = base + BASE;
  unsigned char* const ring_ptr = smem_raw + (ring - smem_addr(smem_raw));
  const uint32_t tile_addr = base + 1024;  // the fp32 y tile of the epilogue, over the A tiles and the ring
  float* const tile = reinterpret_cast<float*>(smem_raw + (tile_addr - smem_addr(smem_raw)));
  const int stage_bytes = p.stage_bytes;  // a multiple of 1024: every stage's x stays 1024-aligned

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int splits = p.splits;  // the blocks of a cluster, each a share of K
  const int rank = static_cast<int>(blockIdx.x) % splits;
  const int m0 = (blockIdx.x / splits) * BX;
  const int n0 = blockIdx.y * BW;
  const int step_begin = static_cast<int>(static_cast<long long>(rank) * p.steps / splits);
  const int local_steps = static_cast<int>(static_cast<long long>(rank + 1) * p.steps / splits) - step_begin;
  const int groups = p.K / p.group;
  const long long entries = static_cast<long long>(p.N) * groups;
  const long long row_bytes = static_cast<long long>(p.K) * BITS / 8;
  // Entries a row of the scales' TMA box holds: 16 bytes where a step lies in one group.
  const int box = ONE_GROUP ? 16 / static_cast<int>(sizeof(S)) : p.box;

  if (tid == 0) {
    for (int s = 0; s < p.ring; ++s) mbar_init(full + 8 * s, NUM_THREADS + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Stage `i` of this block's K steps into ring slot `slot`: x (and the
  // words and the scales, where their rows allow) by TMA from one thread;
  // the rest by every thread's cp.async, whose arrival counts once its
  // copies have landed.
  const CUtensorMap* const map_x = &tx;
  const CUtensorMap* const map_w = &tw;
  const CUtensorMap* const map_s = &ts;
  const CUtensorMap* const map_b = &tb;
  auto load = [&](int i, int slot) {
    const int step = step_begin + i;
    const int k0 = step * BK;
    const uint32_t st = ring + slot * stage_bytes;
    const uint32_t bar = full + 8 * slot;
    const uint32_t sw = st + X_BYTES;
    if (tid == 0) {
      mbar_expect_tx(bar, X_BYTES + (p.tma_words ? W_BYTES : 0) + (p.tma_scales ? p.sb_bytes : 0));
      tma_load_2d(st, map_x, bar, k0, m0);
      if (p.tma_words) tma_load_2d(sw, map_w, bar, step * (W_ROW / 4), n0);
      if (p.tma_scales) {  // the aligned box of each row that holds this step's groups
        const int g0 = k0 / p.group & ~(box - 1);
        tma_load_2d(sw + W_BYTES, map_s, bar, g0, n0);
        tma_load_2d(sw + W_BYTES + BW * box * static_cast<int>(sizeof(S)), map_b, bar, g0, n0);
      }
    }
    if (!p.tma_words) {  // rows of words 4-byte aligned only: 4-byte copies
      const unsigned char* words = reinterpret_cast<const unsigned char*>(p.packed);
      const long long col = static_cast<long long>(step) * W_ROW;
      for (int c = tid; c < BW * W_ROW / 4; c += NUM_THREADS) {
        const int row = c / (W_ROW / 4);
        const int off = (c % (W_ROW / 4)) * 4;
        const int valid = (n0 + row < p.N && col + off < row_bytes) ? 4 : 0;
        cp_async4(sw + row * W_ROW + off, valid ? words + (n0 + row) * row_bytes + col + off : words, valid);
      }
    }
    // Scale entries e = 0 .. ng - 1 of this step are groups g0 + e up to the
    // group of its last value; a later one (or a row past N) is zero.
    const uint32_t ssb = sw + W_BYTES;
    const int g0 = k0 / p.group;
    const int g_last = (min(k0 + BK, p.K) - 1) / p.group;
    for (int c = tid; !p.tma_scales && c < p.ng * BW; c += NUM_THREADS) {
      const int e = c / BW;
      const int row = c % BW;
      const bool ok = n0 + row < p.N && g0 + e <= g_last;
      const long long idx = static_cast<long long>(n0 + row) * groups + g0 + e;
      const uint32_t dst = ssb + (e * BW + row) * 4;
      if (HALF_SCALES) {  // the 4-byte word that holds element idx; past the end only its low half
        const long long w = idx & ~1ll;
        const int valid = ok ? ((idx | 1) < entries ? 4 : 2) : 0;
        cp_async4(dst, ok ? static_cast<const S*>(p.scales) + w : p.scales, valid);
        cp_async4(dst + p.ng * BW * 4, ok ? static_cast<const S*>(p.biases) + w : p.biases, valid);
      } else {
        cp_async4(dst, ok ? static_cast<const S*>(p.scales) + idx : p.scales, ok ? 4 : 0);
        cp_async4(dst + p.ng * BW * 4, ok ? static_cast<const S*>(p.biases) + idx : p.biases, ok ? 4 : 0);
      }
    }
    cp_async_arrive(bar);
  };

  for (int i = 0; i < p.ring && i < local_steps; ++i) load(i, i);

  // x is the K-major B operand and the dequantized weight the K-major A
  // operand: 8-row atoms 1024 bytes apart; a k16 step moves 32 bytes along
  // the swizzled 128-byte row.
  const uint64_t desc_x = make_desc(ring, 16, 1024);
  const uint32_t a_tiles = base + 1024 + wg * 2 * A_BYTES;  // this warpgroup's two A tiles
  const uint64_t desc_a = make_desc(a_tiles, 16, 1024);
  // This thread dequantizes 32 values of one weight row of its warpgroup:
  // row wrow, values 32 * half .. 32 * half + 31 of each K step.
  const int wrow = (tid % 128) / 2;
  const int half = tid % 2;
  const int row = wg * WG_ROWS + wrow;  // in the block's BW
  float acc[BX / 2];
#pragma unroll
  for (int i = 0; i < BX / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);

  // Step i's weight tile is dequantized into one of two A tiles while step
  // i - 1's products, which read the other, run.
  for (int i = 0; i < local_steps; ++i) {
    wgmma_wait<1>();  // step i - 2's products are done: its A tile is free
    if (i >= 2) {     // and, once both warpgroups are here, its ring slot
      __syncthreads();
      if (i - 2 + p.ring < local_steps) load(i - 2 + p.ring, (i - 2) % p.ring);
    }
    const int slot = i % p.ring;
    const int k0 = (step_begin + i) * BK;
    const int g0 = k0 / p.group;
    const unsigned char* sw = ring_ptr + slot * stage_bytes + X_BYTES;
    const uint32_t* ssc = reinterpret_cast<const uint32_t*>(sw + W_BYTES);
    const uint32_t* sbi = ssc + p.ng * BW;
    mbar_wait(full + 8 * slot, (i / p.ring) & 1);
    const uint32_t a_tile = a_tiles + (i & 1) * A_BYTES;
    unsigned char* const a_ptr = smem_raw + (a_tile - smem_addr(smem_raw));
    uint32_t w[BITS];
    load_words<BITS>(sw + row * W_ROW + half * (W_ROW / 2), w);
    float sc = 0.f, bi = 0.f;
    if constexpr (ONE_GROUP) {
      if (p.tma_scales) {
        const S* srow = reinterpret_cast<const S*>(sw + W_BYTES) + row * box;
        const int e = g0 & (box - 1);
        sc = to_float(srow[e]);
        bi = to_float(srow[BW * box + e]);
      } else {
        const bool high = HALF_SCALES && ((static_cast<long long>(n0 + row) * groups + g0) & 1) != 0;
        sc = entry_value<S>(ssc[row], high);
        bi = entry_value<S>(sbi[row], high);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // 8 values, one 16-byte chunk of the swizzled bf16 row
      uint32_t packed[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int v = 8 * c + 2 * q;
        // A pair of values lies in one group (groups are even), and 8
        // values do where the group is a multiple of 8.
        if (!ONE_GROUP && (q == 0 || p.group % 8 != 0)) {
          const int k = k0 + 32 * half + v;
          const int gk = p.gshift >= 0 ? k >> p.gshift : k / p.group;
          if (p.tma_scales) {
            const S* srow = reinterpret_cast<const S*>(sw + W_BYTES) + row * box;
            const int e = gk - (g0 & ~(box - 1));
            sc = to_float(srow[e]);
            bi = to_float(srow[BW * box + e]);
          } else {
            const int e = gk - g0;
            const bool high = HALF_SCALES && ((static_cast<long long>(n0 + row) * groups + gk) & 1) != 0;
            sc = entry_value<S>(ssc[e * BW + row], high);
            bi = entry_value<S>(sbi[e * BW + row], high);
          }
        }
        packed[q] = pack_floats(dequant(value_of<BITS>(w, v), sc, bi), dequant(value_of<BITS>(w, v + 1), sc, bi));
      }
      const int chunk = (4 * half + c) ^ (wrow & 7);
      *reinterpret_cast<uint4*>(a_ptr + wrow * 128 + chunk * 16) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
    // The tile's generic writes, then the warpgroup's products on it.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    wgmma_fence();
    const uint64_t dx = desc_x + ((slot * stage_bytes) >> 4);
    const uint64_t da = desc_a + (((i & 1) * A_BYTES) >> 4);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_ss<BX>(acc, da + kk * 2, dx + kk * 2, 1);
    wgmma_commit();
  }
  wgmma_wait_all();
  fence_regs(acc);

  // The fp32 tile, as y (x rows) by weight rows, over the A tiles and the
  // ring: element 4c + 2r + e is weight row r0 + 8r, x row 8c + 2t + e.
  // Every copy into this block has landed: it waited for all of its steps.
  const int r0 = wg * WG_ROWS + warp * 16 + g;
  __syncthreads();  // both warpgroups' products are done before the tile overwrites their operands
#pragma unroll
  for (int c = 0; c < BX / 8; ++c) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int e = 0; e < 2; ++e) tile[(8 * c + 2 * t + e) * P_STRIDE + r0 + 8 * r] = acc[4 * c + 2 * r + e];
    }
  }
  cluster_sync();

  // This block's share of the tile's rows: the tiles of its splits of K
  // summed in rank order, rounded to bf16, 8 columns a thread.
  const int rows = BX / splits;
  for (int c = tid; c < rows * (BW / 8); c += NUM_THREADS) {
    const int lr = rank * rows + c / (BW / 8);
    const int ln = (c % (BW / 8)) * 8;
    const int m = m0 + lr;
    const int n = n0 + ln;
    if (m >= p.M || n >= p.N) continue;
    const uint32_t addr = tile_addr + (lr * P_STRIDE + ln) * 4;
    float4 lo = ld_cluster(addr, 0), hi = ld_cluster(addr + 16, 0);
    for (int s = 1; s < splits; ++s) {
      const float4 l2 = ld_cluster(addr, s), h2 = ld_cluster(addr + 16, s);
      lo.x += l2.x, lo.y += l2.y, lo.z += l2.z, lo.w += l2.w;
      hi.x += h2.x, hi.y += h2.y, hi.z += h2.z, hi.w += h2.w;
    }
    bf16* out = p.y + static_cast<long long>(m) * p.N + n;
    if (p.N % 8 == 0) {
      *reinterpret_cast<uint4*>(out) =
          make_uint4(pack_floats(lo.x, lo.y), pack_floats(lo.z, lo.w), pack_floats(hi.x, hi.y), pack_floats(hi.z, hi.w));
    } else {
      const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      for (int j = 0; j < 8 && n + j < p.N; ++j) out[j] = __float2bfloat16(v[j]);
    }
  }
  if (splits > 1) cluster_sync();  // no block leaves while another reads its tile
}

// Scale entries a row can need in one K step of BK values starting at a
// multiple of BK: the groups that the window meets.
int entries_per_step(int group) {
  if (BK % group == 0) return BK / group;
  if (group % BK == 0) return 1;
  return (BK - 1 + group - 1) / group + 1;
}

// The x tile (BX rows) and split of K with the least modelled time: blocks
// run in waves of one a SM; a block's K step takes the longer of its
// products (BX rows) and its dequantization (about as long as 96 rows'
// products), plus a fixed share, and a block adds a prologue and an
// epilogue of about 4 steps.
struct Tiling {
  int bx, splits;
};

Tiling pick_tiles(int M, int N, int steps, int sms, bool one_group) {
  Tiling best = {128, 1};
  long long best_cost = -1;
  const long long n_tiles = (N + BW - 1) / BW;
  for (int x : {256, 160, 128}) {
    if (!one_group && x != 128) continue;  // other groups have one instance, BX = 128
    for (int s = 1; s <= MAX_SPLITS && s <= steps; s *= 2) {
      const long long blocks = s * ((M + x - 1) / x) * n_tiles;
      const long long cost = (blocks + sms - 1) / sms * ((steps + s - 1) / s + 4) * (std::max(x, 96) + 32);
      if (best_cost < 0 || cost < best_cost) best_cost = cost, best = {x, s};
    }
  }
  return best;
}

template <int BITS, typename S, int BX, bool ONE_GROUP>
cudaError_t launch(Params p, const void* x, cudaStream_t stream) {
  constexpr int W_ROW = BK * BITS / 8;
  // Scales by TMA where a step's groups lie in one aligned box of a row: the
  // group divides BK or is a multiple of it; rows of 16-byte multiples.
  const long long groups = p.K / p.group;
  p.box = std::max(16 / static_cast<int>(sizeof(S)), p.ng);
  p.tma_scales = (BK % p.group == 0 || p.group % BK == 0) && (groups * sizeof(S)) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(p.scales) % 16 == 0 && reinterpret_cast<uintptr_t>(p.biases) % 16 == 0;
  p.sb_bytes = p.tma_scales ? 2 * BW * p.box * static_cast<int>(sizeof(S)) : 2 * p.ng * BW * 4;
  p.stage_bytes = stage_bytes<BITS, BX>(p.sb_bytes);
  const int tile = 1024 + BX * P_STRIDE * 4;
  p.ring = std::min((SMEM_BYTES - BASE) / p.stage_bytes, MAX_RING);
  const int smem = std::max(BASE + p.ring * p.stage_bytes, tile) + 1024;  // + alignment slack
  CUtensorMap tx, tw = {}, ts = {}, tb = {};
  cudaError_t err = make_map_2d(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.K, p.M, 2ll * p.K, BK, BX,
                                CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess && p.tma_words) {
    err = make_map_2d(&tw, p.packed, CU_TENSOR_MAP_DATA_TYPE_UINT32, static_cast<long long>(p.K) * BITS / 32, p.N,
                      static_cast<long long>(p.K) * BITS / 8, W_ROW / 4, BW, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err == cudaSuccess && p.tma_scales) {
    constexpr CUtensorMapDataType dtype = sizeof(S) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                          : std::is_same<S, bf16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
    err = make_map_2d(&ts, p.scales, dtype, groups, p.N, groups * sizeof(S), p.box, BW, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err == cudaSuccess) {
      err = make_map_2d(&tb, p.biases, dtype, groups, p.N, groups * sizeof(S), p.box, BW, CU_TENSOR_MAP_SWIZZLE_NONE);
    }
  }
  static bool smem_set[MAX_DEVICES] = {};
  if (err == cudaSuccess) err = opt_in_smem(quant_matmul_kernel<BITS, S, BX, ONE_GROUP>, SMEM_BYTES + 1024, smem_set);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(((p.M + BX - 1) / BX) * p.splits), (p.N + BW - 1) / BW);
  config.blockDim = dim3(NUM_THREADS);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, quant_matmul_kernel<BITS, S, BX, ONE_GROUP>, tx, tw, ts, tb, p);
  return err == cudaSuccess ? cudaGetLastError() : err;
}

template <int BITS, typename S>
cudaError_t launch_tile(const Tiling& t, const Params& p, const void* x, cudaStream_t stream) {
  if (p.group % BK != 0) return launch<BITS, S, 128, false>(p, x, stream);
  switch (t.bx) {
    case 256: return launch<BITS, S, 256, true>(p, x, stream);
    case 160: return launch<BITS, S, 160, true>(p, x, stream);
    default: return launch<BITS, S, 128, true>(p, x, stream);
  }
}

template <typename S>
cudaError_t launch_bits(int bits, const Tiling& t, const Params& p, const void* x, cudaStream_t stream) {
  switch (bits) {
    case 2: return launch_tile<2, S>(t, p, x, stream);
    case 4: return launch_tile<4, S>(t, p, x, stream);
    case 8: return launch_tile<8, S>(t, p, x, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The device's SM count, read once a device.
int sm_count(int dev) {
  static int counts[MAX_DEVICES] = {};
  if (dev < MAX_DEVICES && counts[dev] > 0) return counts[dev];
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev < MAX_DEVICES) counts[dev] = sms;
  return sms;
}

}  // namespace

// Plain C entry point for ctypes. x is a contiguous (M, K) bf16 tensor
// (16-byte aligned), packed (N, K * bits / 32) uint32 words (4-byte
// aligned), scales and biases (N, K / group) of scale_dtype 0 = fp32,
// 1 = bf16, 2 = fp16 (4-byte aligned), y a contiguous (M, N) bf16 tensor
// (16-byte aligned). bits is 2, 4 or 8; group_size is a multiple of
// 32 / bits (whole words) and divides K; K is a multiple of 8 (16-byte rows
// of x). Returns the cudaError_t of the launch (0 on success).
extern "C" int mvt_quant_matmul_bf16(const void* x, const void* packed, const void* scales,
                                     const void* biases, void* y, int M, int N, int K, int bits,
                                     int group_size, int scale_dtype, void* stream) {
  if (M < 1 || N < 1 || K < 1 || K % 8 != 0 || (bits != 2 && bits != 4 && bits != 8) ||
      group_size < 1 || group_size % (32 / bits) != 0 || K % group_size != 0 ||
      (N + BW - 1) / BW > 65535 || reinterpret_cast<uintptr_t>(scales) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(biases) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count(dev);
  if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
  Params p = {};
  p.packed = static_cast<const uint32_t*>(packed);
  p.scales = scales;
  p.biases = biases;
  p.y = static_cast<bf16*>(y);
  p.M = M, p.N = N, p.K = K, p.group = group_size;
  p.gshift = (group_size & (group_size - 1)) == 0 ? __builtin_ctz(group_size) : -1;
  p.steps = (K + BK - 1) / BK;
  p.ng = entries_per_step(group_size);
  p.tma_words = (static_cast<long long>(K) * bits / 8) % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  const Tiling tiling = pick_tiles(M, N, p.steps, sms, group_size % BK == 0);
  p.splits = tiling.splits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (scale_dtype) {
    case 0: return static_cast<int>(launch_bits<float>(bits, tiling, p, x, st));
    case 1: return static_cast<int>(launch_bits<bf16>(bits, tiling, p, x, st));
    case 2: return static_cast<int>(launch_bits<__half>(bits, tiling, p, x, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
