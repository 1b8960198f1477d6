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
// memory: each q row must be read once and each o row written once, with
// enough copies in flight to keep the memory busy. With the trainer's long
// caption (1024 keys) the operation count takes over, as in K1.
//
// What the design does about it, on K1's (csrc/flash_attention_fwd.cu,
// helpers in csrc/hopper.cuh):
// - 128 query rows a tile in two warpgroups. S = Q K^T is SS wgmma with both
//   operands K-major; O += P V is RS wgmma with P from registers and V
//   MN-major (the transpose bit). Tiles arrive by TMA in 128-byte swizzled
//   shared memory; q's tensor map spans Sq rows, k's and v's Skv rows, so TMA
//   zero-fills rows past either length. Keys at or past Skv get -inf by
//   index (through the bias row), query rows past Sq are never written.
// - The bias row goes into shared memory by plain loads, prescaled by
//   log2(e): 4 * Skv bytes are no TMA box unless a multiple of 16. It is
//   added to the scaled logits before the row max. A row whose keys all carry
//   the -1e9 mask stays the uniform average of v: the bias swamps the fp32
//   logits, they are all equal and every key gets p = 1.
// - Skv <= 128 (the dev path: a 128-token caption): cross_resident_kernel.
//   The caption tile, K, V and the bias, is loaded once per (batch, head) and
//   stays in shared memory while the block's query tiles stream past it
//   through a 2-stage TMA ring, so tile i + 1 lands while tile i is
//   multiplied (at D = 128 the ring, the caption tile and the o staging tile
//   take 161 KB). Measured on an H100 at (2, 5184, 128): rings of 3 and 4
//   stages were no faster (device time 0.0719-0.0746 ms against
//   0.0706-0.0711 ms). The grid is persistent, one wave of as many blocks as fit
//   on the card; block i takes the i-th of equal runs of consecutive
//   (batch * head, query tile) items, so every SM gets the same number of
//   tiles (19 or 20 at (2, 5184) on 132 SMs) and a run spans at most a
//   couple of (batch, head)s: the caption tile is reloaded only there.
// - Skv > 128 (the trainer's 1024 caption keys): cross_stream_kernel, K1's
//   loop: a block owns one query tile and K/V tiles stream through K1's
//   2-stage ring, each stage with its 128 bias values.
// - o leaves through shared memory: each warpgroup writes its normalised
//   64 rows in bf16 into a swizzled tile and a TMA store
//   (cp.async.bulk.tensor, global <- shared) copies them out; TMA drops rows
//   past Sq. In the resident kernel the staging tile is its own, so a store
//   overlaps the next tile's products. Copying the staged tile out by
//   coalesced 16-byte stores instead took 0.0763-0.0770 ms of device time
//   at (2, 5184, 128) on an H100, against the TMA store's 0.0708-0.0714 ms.
// - The shared-memory opt-in, the SM count and the occupancy are read once
//   a device, not on every call.

#include "hopper.cuh"

namespace {

constexpr int WG_ROWS = 64;  // query rows of one warpgroup (wgmma's M)
constexpr int WARPGROUPS = 2;
constexpr int BLOCK_M = WARPGROUPS * WG_ROWS;  // query rows of one tile
constexpr int NUM_THREADS = WARPGROUPS * 128;
constexpr int BLOCK_N = 128;  // keys of one K/V tile
constexpr int Q_STAGES = 2;   // query tiles in the resident kernel's ring
constexpr int KV_STAGES = 2;  // K/V tiles in the streaming kernel's ring

// Byte offsets of the resident kernel's shared memory, from a 1024-byte aligned base.
template <int D>
struct ResidentLayout {
  static constexpr int Q_BYTES = BLOCK_M * D * 2;  // one query (or o) tile
  static constexpr int KV_BYTES = BLOCK_N * D * 2;
  static constexpr int K_OFF = Q_STAGES * Q_BYTES;
  static constexpr int V_OFF = K_OFF + KV_BYTES;
  static constexpr int O_OFF = V_OFF + KV_BYTES;
  static constexpr int BIAS_OFF = O_OFF + Q_BYTES;
  static constexpr int BAR_OFF = BIAS_OFF + BLOCK_N * 4;
  static constexpr int BYTES = BAR_OFF + 8 * (Q_STAGES + 2) + 1024;  // + alignment slack
};

// Byte offsets of the streaming kernel's shared memory (K1's, plus the bias ring).
template <int D>
struct StreamLayout {
  static constexpr int Q_BYTES = BLOCK_M * D * 2;  // also the o staging tile
  static constexpr int TILE_BYTES = BLOCK_N * D * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + KV_STAGES * TILE_BYTES;
  static constexpr int BIAS_OFF = V_OFF + KV_STAGES * TILE_BYTES;
  static constexpr int BAR_OFF = BIAS_OFF + KV_STAGES * BLOCK_N * 4;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * KV_STAGES) + 1024;
};

struct CrossArgs {
  const float* bias;  // (B, Skv) rows, row stride bias_sb; or null
  int Sq, Skv, H;
  long long bias_sb;
  float scale_log2;
};

// One TMA box of shared memory (64 columns x `rows` rows, swizzled) to the
// 4-D {D, H, S, B} tensor map, in the thread's bulk group; rows past S are dropped.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int d0, int h, int row0, int b) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(d0), "r"(h), "r"(row0), "r"(b)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// The thread's bulk stores have read their shared memory (it may be reused).
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }

// The thread's bulk stores are complete.
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// Generic-proxy writes to shared memory become visible to the async proxy (TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier of the 128 threads of warpgroup `wg` (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// The bias of key `col` in the log2 domain: -inf at or past Skv.
__device__ __forceinline__ float key_bias(const CrossArgs& a, int b, int col) {
  if (col >= a.Skv) return -INFINITY;
  return a.bias != nullptr ? a.bias[b * a.bias_sb + col] * LOG2E : 0.f;
}

// This warpgroup's fp32 logits of one 128-key tile: s = Q K^T (SS wgmma, both
// K-major), then scale * s + bias in the log2 domain. `sq` is the query
// tile's base (panels BLOCK_M rows apart), `sk` the key tile's.
template <int D>
__device__ __forceinline__ void tile_logits(float (&s)[BLOCK_N / 2], uint32_t sq, uint32_t sk, int wg,
                                            const float* sbias, float scale_log2) {
  const uint64_t desc_q = make_desc(sq + wg * WG_ROWS * PANEL_ROW_BYTES, 16, 1024);
  const uint64_t desc_k = make_desc(sk, 16, 1024);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t q_off = (kk / 4) * BLOCK_M * PANEL_ROW_BYTES + (kk % 4) * 32;
    const uint32_t k_off = (kk / 4) * BLOCK_N * PANEL_ROW_BYTES + (kk % 4) * 32;
    wgmma_ss_n128(s, desc_q + (q_off >> 4), desc_k + (k_off >> 4), kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int c = 0; c < BLOCK_N / 8; ++c) {
    const float2 bias = *reinterpret_cast<const float2*>(sbias + 8 * c + 2 * t);
    s[4 * c] = fmaf(s[4 * c], scale_log2, bias.x);
    s[4 * c + 1] = fmaf(s[4 * c + 1], scale_log2, bias.y);
    s[4 * c + 2] = fmaf(s[4 * c + 2], scale_log2, bias.x);
    s[4 * c + 3] = fmaf(s[4 * c + 3], scale_log2, bias.y);
  }
}

// acc += P V for one 128-key tile (RS wgmma, V MN-major at `sv`).
template <int D>
__device__ __forceinline__ void tile_pv(float (&acc)[D / 2], uint32_t (&pa)[BLOCK_N / 16][4], uint32_t sv) {
  const uint64_t desc_v = make_desc(sv, BLOCK_N * PANEL_ROW_BYTES, 1024);
  fence_regs(acc);
  fence_regs(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
    wgmma_rs<D>(acc, pa[kk], desc_v + ((kk * 16 * PANEL_ROW_BYTES) >> 4));
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
}

// Write this warpgroup's 64 rows of acc * inv (bf16) to o through the
// swizzled staging tile `so` (panels BLOCK_M rows apart, the warpgroup's
// rows at wg * 64), then out by TMA store, which thread 0 of the warpgroup
// issues. Query row m0 + wg * 64 + r; TMA drops rows past Sq. The caller made
// sure no earlier store still reads `so`.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], const float (&inv)[2], uint32_t so_base,
                                           unsigned char* so_ptr, const CUtensorMap* to, int Sq, int b, int h,
                                           int m0, int wg) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int g = (tid % 32) >> 2;
  const int t = tid & 3;
  const int wg_off = wg * WG_ROWS * PANEL_ROW_BYTES;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;  // of the warpgroup's 64; row % 8 == g
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int off = (c / 8) * BLOCK_M * PANEL_ROW_BYTES + wg_off + row * PANEL_ROW_BYTES +
                      (((c % 8) ^ g) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(so_ptr + off) =
          pack_floats(acc[4 * c + 2 * r] * inv[r], acc[4 * c + 2 * r + 1] * inv[r]);
    }
  }
  const int row0 = m0 + wg * WG_ROWS;
  fence_proxy_async();
  warpgroup_sync(wg);
  if (tid == 0 && row0 < Sq) {
#pragma unroll
    for (int p = 0; p < D / PANEL_COLS; ++p) {
      tma_store(to, so_base + p * BLOCK_M * PANEL_ROW_BYTES + wg_off, p * PANEL_COLS, h, row0, b);
    }
    bulk_commit();
  }
}

// Before this warpgroup writes its staging rows again: its earlier store
// has read them.
__device__ __forceinline__ void staging_free(int wg) {
  if (threadIdx.x % 128 == 0) bulk_wait_read();
  warpgroup_sync(wg);
}

// Row max over the 128 keys of rows g and g + 8, then p = 2^(x - max) in
// place, P in bf16 as the A operand of P V, and the row sums of the fp32 p.
__device__ __forceinline__ void softmax_tile(float (&s)[BLOCK_N / 2], const float (&m_prev)[2], float (&m_new)[2],
                                             float (&rs)[2], uint32_t (&pa)[BLOCK_N / 16][4]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BLOCK_N / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // Key 0 of every tile is below Skv and the bias is finite: the max is finite.
    m_new[r] = fmaxf(m_prev[r], mx[r]);
    rs[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < BLOCK_N / 2; ++i) {
    const float p = exp2f(s[i] - m_new[(i >> 1) & 1]);
    s[i] = p;
    rs[(i >> 1) & 1] += p;
  }
  acc_to_a<BLOCK_N>(pa, s);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
  }
}

// Skv <= 128. Block blockIdx.x takes items [w0, w1) of the B * H * nq
// (batch * head, query tile) items, in order.
template <int D>
__global__ void __launch_bounds__(NUM_THREADS, 1)
cross_resident_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                      const CrossArgs a, long long items) {
  using L = ResidentLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - raw);
  const uint32_t sq = base;  // stage s at + s * Q_BYTES
  const uint32_t sk = base + L::K_OFF;
  const uint32_t sv = base + L::V_OFF;
  const uint32_t so = base + L::O_OFF;
  float* sbias = reinterpret_cast<float*>(base_ptr + L::BIAS_OFF);
  const uint32_t bar_q = base + L::BAR_OFF;  // stage s at + 8 * s
  const uint32_t bar_k = bar_q + 8 * Q_STAGES;
  const uint32_t bar_v = bar_k + 8;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int nq = (a.Sq + BLOCK_M - 1) / BLOCK_M;
  const long long w0 = items * blockIdx.x / gridDim.x;
  const int n = static_cast<int>(items * (blockIdx.x + 1) / gridDim.x - w0);

  if (tid == 0) {
    for (int i = 0; i < Q_STAGES + 2; ++i) mbar_init(bar_q + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < Q_STAGES && i < n; ++i) {
      const long long w = w0 + i;
      const int bh = static_cast<int>(w / nq);
      load_rows<D, BLOCK_M>(sq + i * L::Q_BYTES, &tq, bar_q + 8 * i, BLOCK_M, bh % a.H,
                            static_cast<int>(w % nq) * BLOCK_M, bh / a.H);
    }
  }

  int cur_bh = -1;
  uint32_t kv_parity = 1;  // flips to 0 at the first load
  for (int i = 0; i < n; ++i) {
    const long long w = w0 + i;
    const int bh = static_cast<int>(w / nq);
    const int b = bh / a.H;
    const int h = bh % a.H;
    const int m0 = static_cast<int>(w % nq) * BLOCK_M;
    const int stage = i % Q_STAGES;

    if (bh != cur_bh) {
      // A new (batch, head): every thread is done with the old caption tile.
      if (cur_bh >= 0) __syncthreads();
      if (tid == 0) {
        load_rows<D, BLOCK_N>(sk, &tk, bar_k, BLOCK_N, h, 0, b);
        load_rows<D, BLOCK_N>(sv, &tv, bar_v, BLOCK_N, h, 0, b);
      }
      if (tid < BLOCK_N) sbias[tid] = key_bias(a, b, tid);
      __syncthreads();
      cur_bh = bh;
      kv_parity ^= 1;
    }

    float s[BLOCK_N / 2];
    mbar_wait(bar_k, kv_parity);
    mbar_wait(bar_q + 8 * stage, (i / Q_STAGES) & 1);
    tile_logits<D>(s, sq + stage * L::Q_BYTES, sk, wg, sbias, a.scale_log2);

    // Both warpgroups are done with this query stage: refill it. (Letting the
    // second warpgroup to finish refill it, through a shared counter, so that
    // neither waits here, measured no faster on an H100.)
    __syncthreads();
    if (tid == 0 && i + Q_STAGES < n) {
      const long long wn = w + Q_STAGES;
      const int bhn = static_cast<int>(wn / nq);
      load_rows<D, BLOCK_M>(sq + stage * L::Q_BYTES, &tq, bar_q + 8 * stage, BLOCK_M, bhn % a.H,
                            static_cast<int>(wn % nq) * BLOCK_M, bhn / a.H);
    }

    const float m_prev[2] = {-INFINITY, -INFINITY};
    float m_new[2], rs[2];
    uint32_t pa[BLOCK_N / 16][4];
    softmax_tile(s, m_prev, m_new, rs, pa);
    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    mbar_wait(bar_v, kv_parity);
    tile_pv<D>(acc, pa, sv);

    const float inv[2] = {1.f / rs[0], 1.f / rs[1]};
    staging_free(wg);
    store_rows<D>(acc, inv, so, base_ptr + L::O_OFF, &to, a.Sq, b, h, m0, wg);
  }
  if (tid % 128 == 0) bulk_wait();
}

// Any Skv: K1's loop over K/V tiles for one query tile, grid = (nq, B * H).
template <int D>
__global__ void __launch_bounds__(NUM_THREADS, 1)
cross_stream_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                    const CrossArgs a) {
  using L = StreamLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - raw);
  const uint32_t sq = base;
  const uint32_t sk = base + L::K_OFF;  // stage s at + s * TILE_BYTES
  const uint32_t sv = base + L::V_OFF;
  float* sbias = reinterpret_cast<float*>(base_ptr + L::BIAS_OFF);  // stage s at + s * BLOCK_N
  const uint32_t bar_q = base + L::BAR_OFF;
  const uint32_t bar_k = bar_q + 8;                   // stage s at + 8 * s
  const uint32_t bar_v = bar_q + 8 * (1 + KV_STAGES);  // stage s at + 8 * s

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y % a.H;
  const int m0 = blockIdx.x * BLOCK_M;
  const int num_tiles = (a.Skv + BLOCK_N - 1) / BLOCK_N;

  if (tid == 0) {
    for (int i = 0; i < 1 + 2 * KV_STAGES; ++i) mbar_init(bar_q + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Warpgroup j fills the bias of tile j.
  if (wg < num_tiles) sbias[wg * BLOCK_N + tid % 128] = key_bias(a, b, wg * BLOCK_N + tid % 128);
  __syncthreads();
  if (tid == 0) {
    load_rows<D, BLOCK_M>(sq, &tq, bar_q, BLOCK_M, h, m0, b);
    for (int j = 0; j < KV_STAGES && j < num_tiles; ++j) {
      load_rows<D, BLOCK_N>(sk + j * L::TILE_BYTES, &tk, bar_k + 8 * j, BLOCK_N, h, j * BLOCK_N, b);
      load_rows<D, BLOCK_N>(sv + j * L::TILE_BYTES, &tv, bar_v + 8 * j, BLOCK_N, h, j * BLOCK_N, b);
    }
  }

  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int j = 0; j < num_tiles; ++j) {
    const int stage = j % KV_STAGES;
    const uint32_t parity = (j / KV_STAGES) & 1;

    float s[BLOCK_N / 2];
    mbar_wait(bar_k + 8 * stage, parity);
    tile_logits<D>(s, sq, sk + stage * L::TILE_BYTES, wg, sbias + stage * BLOCK_N, a.scale_log2);
    float m_new[2], rs[2];
    uint32_t pa[BLOCK_N / 16][4];
    softmax_tile(s, m_run, m_new, rs, pa);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float alpha = exp2f(m_run[r] - m_new[r]);  // 2^-inf = 0 on tile 0
      l_run[r] = l_run[r] * alpha + rs[r];
      m_run[r] = m_new[r];
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        acc[4 * c + 2 * r] *= alpha;
        acc[4 * c + 2 * r + 1] *= alpha;
      }
    }
    mbar_wait(bar_v + 8 * stage, parity);
    tile_pv<D>(acc, pa, sv + stage * L::TILE_BYTES);

    // Every warpgroup is done with this stage: refill it with tile j + KV_STAGES.
    __syncthreads();
    if (j + KV_STAGES < num_tiles) {
      const int n = (j + KV_STAGES) * BLOCK_N;
      if (tid == 0) {
        load_rows<D, BLOCK_N>(sk + stage * L::TILE_BYTES, &tk, bar_k + 8 * stage, BLOCK_N, h, n, b);
        load_rows<D, BLOCK_N>(sv + stage * L::TILE_BYTES, &tv, bar_v + 8 * stage, BLOCK_N, h, n, b);
      }
      // Read at tile j + KV_STAGES, after the barrier that ends tile j + 1.
      if (tid < BLOCK_N) sbias[stage * BLOCK_N + tid] = key_bias(a, b, n + tid);
    }
  }

  // The query tile is spent: each warpgroup stages its own 64 rows of o there.
  const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
  store_rows<D>(acc, inv, sq, base_ptr, &to, a.Sq, b, h, m0, wg);
  if (tid % 128 == 0) bulk_wait();
}

// The resident kernel's persistent grid on the current device: its SM count
// times the blocks that fit on an SM, read once a device.
template <int D>
cudaError_t resident_blocks(int* out) {
  static int blocks[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && blocks[dev] > 0) {
    *out = blocks[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cross_resident_kernel<D>, NUM_THREADS,
                                                        ResidentLayout<D>::BYTES);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = sms * per_sm;
  if (dev < MAX_DEVICES) blocks[dev] = *out;
  return cudaSuccess;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias, void* o, int B, int Sq, int Skv,
                   int H, const long long* st, float scale, cudaStream_t stream) {
  const bool resident = Skv <= BLOCK_N;
  CUtensorMap tq, tk, tv, to;
  cudaError_t err = make_map(&tq, q, B, Sq, H, D, st[0], st[1], st[2], BLOCK_M);
  if (err == cudaSuccess) err = make_map(&tk, k, B, Skv, H, D, st[3], st[4], st[5], BLOCK_N);
  if (err == cudaSuccess) err = make_map(&tv, v, B, Skv, H, D, st[6], st[7], st[8], BLOCK_N);
  const long long o_ss = static_cast<long long>(H) * D;
  if (err == cudaSuccess) err = make_map(&to, o, B, Sq, H, D, Sq * o_ss, o_ss, D, WG_ROWS);
  static bool resident_set[MAX_DEVICES] = {};
  static bool stream_set[MAX_DEVICES] = {};
  if (err == cudaSuccess) {
    err = resident ? opt_in_smem(cross_resident_kernel<D>, ResidentLayout<D>::BYTES, resident_set)
                   : opt_in_smem(cross_stream_kernel<D>, StreamLayout<D>::BYTES, stream_set);
  }
  if (err != cudaSuccess) return err;
  const CrossArgs a{bias, Sq, Skv, H, st[9], scale * LOG2E};
  const int nq = (Sq + BLOCK_M - 1) / BLOCK_M;
  if (resident) {
    int blocks = 0;
    err = resident_blocks<D>(&blocks);
    if (err != cudaSuccess) return err;
    const long long items = static_cast<long long>(B) * H * nq;
    const int grid = static_cast<int>(items < blocks ? items : blocks);
    cross_resident_kernel<D><<<grid, NUM_THREADS, ResidentLayout<D>::BYTES, stream>>>(tq, tk, tv, to, a, items);
  } else {
    const dim3 grid(nq, B * H);
    cross_stream_kernel<D><<<grid, NUM_THREADS, StreamLayout<D>::BYTES, stream>>>(tq, tk, tv, to, a);
  }
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch<128>(q, k, v, bias, o, B, Sq, Skv, H, strides, scale, st);
  if (D == 64) return launch<64>(q, k, v, bias, o, B, Sq, Skv, H, strides, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
