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
// operations. Dense bf16 weights give M operations per byte: weight bytes
// bind at M = 128, M = 320 sits at the ridge, and the tensor-core rate binds
// at M = 1280. The plain dequantize-then-matmul path moves ~4.6 bytes per
// weight, so bytes bind it at M = 128 and 320. Packed 4-bit words with
// group-64 fp32 scales are ~0.63 bytes per weight (3.2 * M operations per
// byte), so for this kernel the tensor-core rate is the floor at every M of
// the path; this simple version takes several times that floor, limited by
// its unpacking and its shared-memory round trip.
//
// What the design does about it: x, the words and the scales are read in
// place; no dequantized weight is written to device memory.
// - A block of 8 warps owns a BM x BN = 128 x 64 output tile (grid.x over M,
//   so blocks that share a weight tile run side by side and meet in L2) and
//   walks K in steps of BK = 64 values.
// - Each step, every thread holds its share of the next x tile (16-byte
//   loads) and of the packed words with their group's scale and bias in
//   registers, issued before the current step's products so the loads are in
//   flight while the tensor cores run.
// - The words are unpacked in registers (shift, mask, fp32 affine, round to
//   bf16) into a shared bf16 tile; both tiles rows are padded by 8 bf16 so
//   the fragment loads hit 32 distinct banks.
// - Each warp computes 32 x 32 of the tile with bf16 mma.sync m16n8k16.
// - Rows past M, columns past N and values past K are zero-filled and not
//   stored. wgmma, TMA, cp.async pipelines and dequantizing straight into the
//   B fragments are left for later.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int NUM_WARPS = 8;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int PAD = 8;
constexpr int LD = BK + PAD;
constexpr int X_VECS = BM * BK / 8 / NUM_THREADS;  // 16-byte x loads per thread

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats -> one register of two bf16 (round to nearest even); `lo` lands
// in the low half, the lower-indexed element.
__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <int BITS, typename S>
__global__ void __launch_bounds__(NUM_THREADS)
quant_matmul_kernel(const bf16* __restrict__ x, const uint32_t* __restrict__ packed,
                    const S* __restrict__ scales, const S* __restrict__ biases,
                    bf16* __restrict__ y, int M, int N, int K, int group_size) {
  constexpr int VPW = 32 / BITS;  // values per word
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  constexpr int WPR = BK / VPW;  // words per tile row
  constexpr int W_PER_THREAD = BN * WPR / NUM_THREADS;
  static_assert(BN * WPR % NUM_THREADS == 0, "word tile must split evenly");

  __shared__ __align__(16) bf16 sX[BM * LD];
  __shared__ __align__(16) bf16 sW[BN * LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int wm = (warp / 2) * 32;  // this warp's rows and columns in the tile
  const int wn = (warp % 2) * 32;
  const int64_t words_per_row = K / VPW;
  const int64_t groups = K / group_size;

  uint4 xr[X_VECS];
  uint32_t wr[W_PER_THREAD];
  float sr[W_PER_THREAD];
  float br[W_PER_THREAD];

  // Global -> registers for the K step starting at k0; out of range is zero
  // (a zero word with zero scale and bias dequantizes to 0).
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < X_VECS; ++i) {
      const int idx = tid + i * NUM_THREADS;
      const int r = idx / (BK / 8);
      const int c = (idx % (BK / 8)) * 8;
      xr[i] = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M && k0 + c < K) {
        xr[i] = *reinterpret_cast<const uint4*>(x + static_cast<int64_t>(m0 + r) * K + k0 + c);
      }
    }
#pragma unroll
    for (int i = 0; i < W_PER_THREAD; ++i) {
      const int idx = tid + i * NUM_THREADS;
      const int n = n0 + idx / WPR;
      const int kv = k0 + (idx % WPR) * VPW;  // first value of the word
      wr[i] = 0u;
      sr[i] = 0.f;
      br[i] = 0.f;
      if (n < N && kv < K) {
        wr[i] = packed[static_cast<int64_t>(n) * words_per_row + kv / VPW];
        const int64_t s = static_cast<int64_t>(n) * groups + kv / group_size;
        sr[i] = to_float(scales[s]);
        br[i] = to_float(biases[s]);
      }
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
    }
  }

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    // Registers -> shared: x as it is, the words unpacked to bf16.
#pragma unroll
    for (int i = 0; i < X_VECS; ++i) {
      const int idx = tid + i * NUM_THREADS;
      *reinterpret_cast<uint4*>(sX + (idx / (BK / 8)) * LD + (idx % (BK / 8)) * 8) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < W_PER_THREAD; ++i) {
      const int idx = tid + i * NUM_THREADS;
      bf16* dst = sW + (idx / WPR) * LD + (idx % WPR) * VPW;
#pragma unroll
      for (int j = 0; j < VPW; j += 2) {
        const float q0 = static_cast<float>((wr[i] >> (j * BITS)) & MASK);
        const float q1 = static_cast<float>((wr[i] >> ((j + 1) * BITS)) & MASK);
        *reinterpret_cast<uint32_t*>(dst + j) =
            pack_floats(__fadd_rn(__fmul_rn(q0, sr[i]), br[i]), __fadd_rn(__fmul_rn(q1, sr[i]), br[i]));
      }
    }
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);  // next step's loads overlap this step's products

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t afrag[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const bf16* row0 = sX + (wm + mt * 16 + g) * LD + kk + 2 * t;
        afrag[mt][0] = *reinterpret_cast<const uint32_t*>(row0);
        afrag[mt][1] = *reinterpret_cast<const uint32_t*>(row0 + 8 * LD);
        afrag[mt][2] = *reinterpret_cast<const uint32_t*>(row0 + 8);
        afrag[mt][3] = *reinterpret_cast<const uint32_t*>(row0 + 8 * LD + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* wrow = sW + (wn + nt * 8 + g) * LD + kk + 2 * t;
        uint32_t bfrag[2];
        bfrag[0] = *reinterpret_cast<const uint32_t*>(wrow);
        bfrag[1] = *reinterpret_cast<const uint32_t*>(wrow + 8);
        mma_16816(acc[0][nt], afrag[0], bfrag);
        mma_16816(acc[1][nt], afrag[1], bfrag);
      }
    }
    __syncthreads();  // every warp is done with the tiles before they are rewritten
  }

  // Accumulator (row g or g + 8, columns 2t and 2t + 1) -> y, inside M x N.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn + nt * 8 + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + wm + mt * 16 + g + 8 * r;
        if (row >= M) continue;
        bf16* out = y + static_cast<int64_t>(row) * N + col;
        if (col < N) out[0] = __float2bfloat16(acc[mt][nt][2 * r]);
        if (col + 1 < N) out[1] = __float2bfloat16(acc[mt][nt][2 * r + 1]);
      }
    }
  }
}

template <int BITS, typename S>
cudaError_t launch(const void* x, const void* packed, const void* scales, const void* biases,
                   void* y, int M, int N, int K, int group_size, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  quant_matmul_kernel<BITS, S><<<grid, NUM_THREADS, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint32_t*>(packed),
      static_cast<const S*>(scales), static_cast<const S*>(biases), static_cast<bf16*>(y), M,
      N, K, group_size);
  return cudaGetLastError();
}

template <typename S>
cudaError_t launch_bits(int bits, const void* x, const void* packed, const void* scales,
                        const void* biases, void* y, int M, int N, int K, int group_size,
                        cudaStream_t stream) {
  switch (bits) {
    case 2: return launch<2, S>(x, packed, scales, biases, y, M, N, K, group_size, stream);
    case 4: return launch<4, S>(x, packed, scales, biases, y, M, N, K, group_size, stream);
    case 8: return launch<8, S>(x, packed, scales, biases, y, M, N, K, group_size, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes. x is a contiguous (M, K) bf16 tensor,
// packed (N, K * bits / 32) uint32 words, scales and biases (N, K / group)
// of scale_dtype 0 = fp32, 1 = bf16, 2 = fp16, y a contiguous (M, N) bf16
// tensor. bits is 2, 4 or 8; group_size is a multiple of 32 / bits (whole
// words) and divides K; K is a multiple of 8 (16-byte rows of x).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int mvt_quant_matmul_bf16(const void* x, const void* packed, const void* scales,
                                     const void* biases, void* y, int M, int N, int K, int bits,
                                     int group_size, int scale_dtype, void* stream) {
  if (M < 1 || N < 1 || K < 1 || K % 8 != 0 || (bits != 2 && bits != 4 && bits != 8) ||
      group_size < 1 || group_size % (32 / bits) != 0 || K % group_size != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (scale_dtype) {
    case 0: return launch_bits<float>(bits, x, packed, scales, biases, y, M, N, K, group_size, st);
    case 1: return launch_bits<bf16>(bits, x, packed, scales, biases, y, M, N, K, group_size, st);
    case 2: return launch_bits<__half>(bits, x, packed, scales, biases, y, M, N, K, group_size, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
