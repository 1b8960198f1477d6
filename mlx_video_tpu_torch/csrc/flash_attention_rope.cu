// Flash-attention forward with split RoPE, for Hopper (sm_90a): one exact
// rotation pass, then K1's kernel.
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
// What bounds it on the H100: at the dev path's shape (B = 2, S = 5184,
// H = 32, D = 128) the two products are 4 * S * S * D * H operations, 8.8e14
// (0.89 ms at the bf16 peak), on 340 MB of q, k, v and o and 170 MB of fp32
// tables (0.15 ms at 3.35 TB/s): the tensor cores bound it, as they bound K1.
// The rotation itself is bytes: reading q, k and both tables once and
// writing the rotated q and k in bf16 moves 510 MB, 0.15 ms.
//
// What the design does about it:
// - rope_rotate_kernel reads q and k through their strides and the tables
//   through theirs (the DiT's are the transposed view of a (B, S, H * D/2)
//   array; batched CFG concatenates them to B = 2) and writes contiguous
//   rotated qr and kr into workspaces the caller allocates. A thread takes
//   8 (x1, x2) pairs of one row with 16-byte loads; each table element is
//   read once and serves both q and k. A block row of the grid is one
//   (batch, sequence) position, so no thread divides by S or H; consecutive
//   threads walk the columns, then the heads, so q, k and the DiT's tables
//   are read in order.
// - Then K1's kernel runs unchanged on (qr, kr, v) through its C entry
//   (mvt_flash_attention_fwd_bf16): wgmma for both products, TMA ring,
//   128-row blocks. Rotating inside the attention loop instead re-rotates
//   every K tile once per query block (ceil(S / 128) times over) and re-reads
//   the tables with it: that was this kernel's first design, 4.6x K1's time
//   at (2, 5184) on an H100.
// - The arithmetic is the plain rotation's (ops/flash_attention.py:
//   rotate_split, which the DiT's unfused path calls), operation for
//   operation in fp32: __fmul_rn, __fsub_rn and __fadd_rn keep nvcc from
//   contracting it into fused multiply-adds, and the bf16 rounding is to
//   nearest even. So qr and kr are rotate_split's tensors bit for bit, and
//   K5's o and lse are K1's on them, bit for bit.
// The rotation kernel uses no shared memory, so it needs no opt-in; K1 sets
// its own once a device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" int mvt_flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                                            int B, int S, int H, int D, long long q_sb, long long q_ss,
                                            long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                                            long long v_sb, long long v_ss, long long v_sh, float scale,
                                            void* stream);

namespace {

constexpr int ROTATE_THREADS = 256;
constexpr int PAIRS = 8;  // (x1, x2) pairs a thread rotates: 16 bytes of each half

typedef __nv_bfloat16 bf16;

struct RotateParams {
  const bf16* q;
  const bf16* k;
  const float* cos;
  const float* sin;
  bf16* qr;  // contiguous (B, S, H, D)
  bf16* kr;
  int S, H;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh;  // (batch, sequence, head)
  long long c_sb, c_sh, c_ss, s_sb, s_sh, s_ss;  // (batch, head, sequence)
};

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// Rotate 8 pairs: x[0..8) with x[half..half + 8) into y at the same columns.
__device__ __forceinline__ void rotate8(const bf16* x, bf16* y, int half, const float cs[8], const float sn[8]) {
  float x1[8], x2[8];
  unpack8(*reinterpret_cast<const uint4*>(x), x1);
  unpack8(*reinterpret_cast<const uint4*>(x + half), x2);
  float y1[8], y2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    y1[e] = __fsub_rn(__fmul_rn(x1[e], cs[e]), __fmul_rn(sn[e], x2[e]));
    y2[e] = __fadd_rn(__fmul_rn(x2[e], cs[e]), __fmul_rn(sn[e], x1[e]));
  }
  *reinterpret_cast<uint4*>(y) = make_uint4(pack_floats(y1[0], y1[1]), pack_floats(y1[2], y1[3]),
                                            pack_floats(y1[4], y1[5]), pack_floats(y1[6], y1[7]));
  *reinterpret_cast<uint4*>(y + half) = make_uint4(pack_floats(y2[0], y2[1]), pack_floats(y2[2], y2[3]),
                                                   pack_floats(y2[4], y2[5]), pack_floats(y2[6], y2[7]));
}

// grid = (B * S, ceil(H * D / 16 / ROTATE_THREADS)): blockIdx.x is one
// (batch, sequence) position, thread j of block row y its (head, column)
// item y * ROTATE_THREADS + j.
template <int D>
__global__ void __launch_bounds__(ROTATE_THREADS) rope_rotate_kernel(const RotateParams p) {
  constexpr int HALF = D / 2;
  constexpr int VECS = HALF / PAIRS;
  const int item = blockIdx.y * ROTATE_THREADS + threadIdx.x;
  if (item >= p.H * VECS) return;
  const int c = (item % VECS) * PAIRS;
  const long long h = item / VECS;
  const long long s = blockIdx.x % p.S;
  const long long b = blockIdx.x / p.S;
  float cs[8], sn[8];
  load8(p.cos + b * p.c_sb + h * p.c_sh + s * p.c_ss + c, cs);
  load8(p.sin + b * p.s_sb + h * p.s_sh + s * p.s_ss + c, sn);
  const long long out = ((b * p.S + s) * p.H + h) * D + c;
  rotate8(p.q + b * p.q_sb + s * p.q_ss + h * p.q_sh + c, p.qr + out, HALF, cs, sn);
  rotate8(p.k + b * p.k_sb + s * p.k_ss + h * p.k_sh + c, p.kr + out, HALF, cs, sn);
}

cudaError_t rotate(const RotateParams& p, int B, int D, cudaStream_t stream) {
  const long long positions = static_cast<long long>(B) * p.S;
  const int items = p.H * (D / (2 * PAIRS));
  if (positions > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(positions), (items + ROTATE_THREADS - 1) / ROTATE_THREADS);
  if (D == 128) {
    rope_rotate_kernel<128><<<grid, ROTATE_THREADS, 0, stream>>>(p);
  } else if (D == 64) {
    rope_rotate_kernel<64><<<grid, ROTATE_THREADS, 0, stream>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// `strides` holds (batch, sequence, head) of q and k, then (batch, head,
// sequence) of cos and sin.
RotateParams rotate_params(const void* q, const void* k, const float* cos, const float* sin, void* qr, void* kr,
                           int S, int H, const long long* qk, const long long* tables) {
  return RotateParams{static_cast<const bf16*>(q), static_cast<const bf16*>(k), cos, sin,
                      static_cast<bf16*>(qr), static_cast<bf16*>(kr), S, H,
                      qk[0], qk[1], qk[2], qk[3], qk[4], qk[5],
                      tables[0], tables[1], tables[2], tables[3], tables[4], tables[5]};
}

}  // namespace

// Plain C entry points for ctypes. Every operand's last dimension is
// contiguous; cos and sin are (B, H, S, D/2) fp32; qr and kr are contiguous
// (B, S, H, D) bf16 workspaces the rotated q and k are written to. Each
// returns the cudaError_t of its launches (0 on success).

// The rotation alone. `strides` holds 12 element strides: (batch, sequence,
// head) of q and k, then (batch, head, sequence) of cos and sin.
extern "C" int mvt_rope_rotate_bf16(const void* q, const void* k, const float* cos, const float* sin, void* qr,
                                    void* kr, int B, int S, int H, int D, const long long* strides, void* stream) {
  const RotateParams p = rotate_params(q, k, cos, sin, qr, kr, S, H, strides, strides + 6);
  return static_cast<int>(rotate(p, B, D, static_cast<cudaStream_t>(stream)));
}

// K5: the rotation, then K1 on (qr, kr, v). `strides` holds 15 element
// strides: (batch, sequence, head) of q, k and v, then (batch, head,
// sequence) of cos and sin. o is a contiguous (B, S, H, D) bf16 tensor and
// lse a contiguous (B, H, S) fp32 tensor or NULL.
extern "C" int mvt_flash_attention_rope_bf16(const void* q, const void* k, const void* v, const float* cos,
                                             const float* sin, void* qr, void* kr, void* o, float* lse, int B, int S,
                                             int H, int D, const long long* strides, float scale, void* stream) {
  const RotateParams p = rotate_params(q, k, cos, sin, qr, kr, S, H, strides, strides + 9);
  const cudaError_t err = rotate(p, B, D, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ss = static_cast<long long>(H) * D;
  return mvt_flash_attention_fwd_bf16(qr, kr, v, o, lse, B, S, H, D, S * ss, ss, D, S * ss, ss, D, strides[6],
                                      strides[7], strides[8], scale, stream);
}
