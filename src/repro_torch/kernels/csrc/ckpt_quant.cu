// Per-block symmetric int8 quantization and its inverse, for Hopper (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/ckpt_quant.py::_quant_kernel
// and ::_dequant_kernel.  What they compute, for a flat array cut into
// blocks of `block` elements:
//
//   scale_b = amax_b * float32(1/127)       (1.0 for an all-zero block)
//   code_i  = clip(round_half_even(x_i / scale_b), -127, 127)   (int8)
//   out_i   = float(code_i) * scale_b, cast to the output type
//
// x is float32 or bfloat16, the scales float32, the output float32 or
// bfloat16.  The scale is a multiply by the float32 constant 1/127 (what
// XLA makes of the Pallas kernel's `amax / 127.0`); x / scale is IEEE
// division (__fdiv_rn; the build has no --use_fast_math) and the rounding
// rintf (half to even), so the kernels equal their plain PyTorch versions
// bit for bit.  A NaN or an inf gives what the plain version and the
// Pallas kernel give: the absmax keeps a NaN (fmaxf would drop it), a NaN
// absmax fails `amax > 0` and takes the scale 1.0, an inf absmax gives an
// inf scale, and an element whose x / scale is NaN gets the code 0.
//
// Design.  Quantize: one warp per block of the input, 8 warps a CTA, a
// grid-stride loop over blocks.  Pass 1 reads the block as 16-byte vectors
// (4 float32 or 8 bfloat16 a lane; lane l takes vectors l, l + 32, ...),
// so each load instruction of the warp covers 512 contiguous bytes; a
// warp-shuffle max gives the absmax, and every lane computes the scale.
// Pass 2 reads the block again (it is still in L1: 2 KB of float32 at
// block 512) and writes the codes, 4 or 8 bytes a lane.  The Pallas
// kernel's (block_rows x block) tiling and its n_blocks % block_rows
// assertion are not kept: any number of blocks is taken, and any block
// that is a multiple of 32 up to 4096 (scalar loads where the block or the
// pointer does not allow 16-byte vectors).  Dequantize: a grid-stride
// elementwise pass, 4 codes a thread (one 4-byte load, one scale load,
// one 16- or 8-byte store).
//
// Bound on the H100: bytes.  At the mamba2-130m embedding leaf (38,615,040
// float32 elements, 75,420 blocks of 512) quantize reads 154.5 MB and
// writes 38.6 MB of codes and 0.3 MB of scales, about 0.058 ms at
// 3.35 TB/s; dequantize moves the same bytes the other way.  Its
// arithmetic (a max, a division and a rounding an element) is far below
// the card's rate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;          // 8 warps a CTA
constexpr int kMaxBlock = 4096;
constexpr long long kMaxCtas = 1 << 20;
constexpr float kInv127 = 1.0f / 127.0f;   // folded to float32(1/127)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Elements of T in one 16-byte vector.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
};

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {   // low half first: element 2k
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// max(a, b) that keeps a NaN of either side, as torch.amax and jnp.max do.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ int8_t code(float v, float scale) {
  float r = rintf(__fdiv_rn(v, scale));
  if (r != r) return 0;
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int8_t>(__float2int_rn(r));
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ scales, long long n_blocks,
                    int block) {
  constexpr int V = Vec<T>::n;
  const int lane = threadIdx.x & (kWarp - 1);
  const long long n_warps = (static_cast<long long>(gridDim.x) * kThreads) /
                            kWarp;
  for (long long w =
           (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) /
           kWarp;
       w < n_blocks; w += n_warps) {
    const T* xb = x + w * block;
    int8_t* qb = q + w * block;
    float amax = 0.0f;
    if constexpr (kVec) {
      for (int i = lane * V; i < block; i += kWarp * V) {
        float v[V];
        load_vec(xb + i, v);
#pragma unroll
        for (int k = 0; k < V; ++k) amax = nan_max(amax, fabsf(v[k]));
      }
    } else {
      for (int i = lane; i < block; i += kWarp)
        amax = nan_max(amax, fabsf(to_f(xb[i])));
    }
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1)
      amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = amax > 0.0f ? __fmul_rn(amax, kInv127) : 1.0f;
    if (lane == 0) scales[w] = scale;
    if constexpr (kVec) {
      for (int i = lane * V; i < block; i += kWarp * V) {
        float v[V];
        load_vec(xb + i, v);
        union {
          int8_t c[V];
          uint32_t u[V / 4];
        } out;
#pragma unroll
        for (int k = 0; k < V; ++k) out.c[k] = code(v[k], scale);
        if constexpr (V == 4)
          *reinterpret_cast<uint32_t*>(qb + i) = out.u[0];
        else
          *reinterpret_cast<uint2*>(qb + i) = make_uint2(out.u[0], out.u[1]);
      }
    } else {
      for (int i = lane; i < block; i += kWarp)
        qb[i] = code(to_f(xb[i]), scale);
    }
  }
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16x2(a, b), bf16x2(c, d));
}

// n4 = N / 4 groups of 4 codes; block % 4 == 0, so a group has one scale.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ scales, T* __restrict__ out,
                      long long n4, int block) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       j < n4; j += stride) {
    const char4 c = reinterpret_cast<const char4*>(q)[j];
    const float s = scales[(4 * j) / block];
    store4(out + 4 * j, __fmul_rn(static_cast<float>(c.x), s),
           __fmul_rn(static_cast<float>(c.y), s),
           __fmul_rn(static_cast<float>(c.z), s),
           __fmul_rn(static_cast<float>(c.w), s));
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int ctas(long long work_items) {
  long long n = (work_items + kThreads - 1) / kThreads;
  if (n > kMaxCtas) n = kMaxCtas;
  return static_cast<int>(n < 1 ? 1 : n);
}

template <typename T>
cudaError_t quantize(const void* x, void* q, float* scales, long long n_blocks,
                     int block, cudaStream_t stream) {
  const int grid = ctas(n_blocks * kWarp);
  const bool vec = aligned16(x) && block % (kWarp * Vec<T>::n) == 0;
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  if (vec)
    quantize_kernel<T, true><<<grid, kThreads, 0, stream>>>(xt, qt, scales,
                                                            n_blocks, block);
  else
    quantize_kernel<T, false><<<grid, kThreads, 0, stream>>>(xt, qt, scales,
                                                             n_blocks, block);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dequantize(const void* q, const float* scales, void* out,
                       long long n_blocks, int block, cudaStream_t stream) {
  const long long n4 = n_blocks * block / 4;
  dequantize_kernel<T><<<ctas(n4), kThreads, 0, stream>>>(
      static_cast<const int8_t*>(q), scales, static_cast<T*>(out), n4, block);
  return cudaGetLastError();
}

bool bad_shape(long long n_blocks, int block) {
  return n_blocks <= 0 || block <= 0 || block % kWarp != 0 ||
         block > kMaxBlock;
}

}  // namespace

extern "C" {

// codes q (n_blocks * block int8) and scales (n_blocks float32) from x
// (float32, or bfloat16 when `bf16`).  Returns the cudaError_t of the
// launch (0 on success); a block that is not a multiple of 32 in
// [32, 4096], or no blocks, is refused with cudaErrorInvalidValue.
int ckpt_quantize_launch(const void* x, void* q, float* scales, int bf16,
                         long long n_blocks, int block, void* stream) {
  if (bad_shape(n_blocks, block))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return static_cast<int>(
        quantize<__nv_bfloat16>(x, q, scales, n_blocks, block, s));
  return static_cast<int>(quantize<float>(x, q, scales, n_blocks, block, s));
}

// out (n_blocks * block, float32 or bfloat16 when `bf16_out`, 16-byte
// aligned) from codes q (4-byte aligned) and scales.  Same return codes.
int ckpt_dequantize_launch(const void* q, const float* scales, void* out,
                           int bf16_out, long long n_blocks, int block,
                           void* stream) {
  if (bad_shape(n_blocks, block) || !aligned16(out) ||
      (reinterpret_cast<uintptr_t>(q) & 3u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_out)
    return static_cast<int>(
        dequantize<__nv_bfloat16>(q, scales, out, n_blocks, block, s));
  return static_cast<int>(
      dequantize<float>(q, scales, out, n_blocks, block, s));
}

const char* ckpt_quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
