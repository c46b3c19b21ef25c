// GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (entry flash_attention).  What it computes, for q (BG, R, Sq, D) and k, v
// (BG, Skv, D) -- kv groups folded into BG, the R query heads of a group
// sharing one kv head:
//
//   s[i, j] = (q_i . k_j) * scale                               (float32)
//   s       = tanh(s / softcap) * softcap            (when softcap > 0)
//   key j is visible to query i iff j <= i + Skv - Sq (bottom-right causal
//   mask; every key when not causal), and every key j < Skv
//   o_i     = sum_j p_ij v_j / sum_j p_ij,  p_ij = exp(s_ij - max_j s_ij)
//
// by the online softmax (float32 running max m, sum l and accumulator), and
// written in the input's type.  A row that sees no key (Sq > Skv under the
// causal mask) gets 0, as the Pallas kernel gives it: m starts at -1e30
// (not -inf, so exp(m_prev - m_new) is never inf - inf), a masked score
// contributes p = 0 and the final division is by l, or by 1 where l = 0.
//
// Design.  One block of 256 threads (16 x 16) per (bg, r, 64-row q block),
// the heaviest causal q blocks first; a loop over 64-key tiles takes the
// place of the Pallas grid's sequential kv axis and stops at the block's
// last visible key, so tiles above the diagonal are never loaded.  The q
// tile and each k tile sit in shared memory transposed, (D, 64) float32,
// and the v tile as (64, D), all converted from the input type on load (a
// bf16 input is read as 8-byte pairs and widened in registers).  Each
// thread owns a 4 x 4 patch of the score tile (rows 4 ty.., columns
// 4 tx..) and four rows of the output accumulator; a row's max and sum are
// taken across its 16 threads with warp shuffles.  The probability tile
// goes through shared memory to the p v product.  Rows and keys past the
// ends are zero-filled and masked, so any Sq and Skv work; q, k and v are
// read through their batch, head and row strides, with unit stride along
// D.  Products run on the float32 SIMT units, as the Pallas kernel's are
// float32.
//
// Bound on the H100.  At olmo-1b's prefill shape (BG 128, R 1, Sq = Skv =
// 1024, D 128, bf16) the causal work is 4 D flop per visible (i, j) pair,
// 34.4 GFLOP, 0.035 ms at the bf16 tensor-core rate (989 TFLOP/s) and
// 0.51 ms at the float32 SIMT rate (67 TFLOP/s); q, k, v and o are 134 MB,
// 0.040 ms at 3.35 TB/s.  The least time is therefore ~0.04 ms, set by the
// bytes; this kernel keeps the TPU kernel's float32 products, so the
// float32 rate bounds it at ~0.5 ms.  Tensor cores (wgmma), TMA and a
// split-KV decode form are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kBq = 64;         // query rows a block owns
constexpr int kBk = 64;         // keys a tile holds
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x;
  o[1] = t.y;
  o[2] = t.z;
  o[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  // a bfloat16 is the high half of a float32: widening is a shift
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(t.x << 16);
  o[1] = __uint_as_float(t.x & 0xffff0000u);
  o[2] = __uint_as_float(t.y << 16);
  o[3] = __uint_as_float(t.y & 0xffff0000u);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Rows [row0, row0 + n) of a (rows, D) operand with row stride `rs` into a
// transposed (D, 64) float32 tile; rows past n are zero.  Consecutive
// threads take consecutive rows, so the transposed stores hit distinct
// banks.
template <typename T, int D>
__device__ __forceinline__ void load_t(float* dst, const T* src, long long rs,
                                       int row0, int n, int tid) {
  for (int e = tid; e < kBq * (D / 4); e += kThreads) {
    const int r = e % kBq, c = (e / kBq) * 4;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (r < n) load4(src + (row0 + r) * rs + c, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[(c + i) * kBq + r] = v[i];
  }
}

// The same rows into a row-major (64, D) float32 tile.
template <typename T, int D>
__device__ __forceinline__ void load_r(float* dst, const T* src, long long rs,
                                       int row0, int n, int tid) {
  for (int e = tid; e < kBk * (D / 4); e += kThreads) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (r < n) load4(src + (row0 + r) * rs + c, v);
    *reinterpret_cast<float4*>(dst + r * D + c) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Output column of accumulator slot jj for the thread in column tx: for
// D >= 64, groups of four consecutive columns (one 16-byte v read); for
// D < 64, every 16th column.
template <int D>
__device__ __forceinline__ int out_col(int tx, int jj) {
  if constexpr (D >= 64) return (jj / 4) * 64 + tx * 4 + (jj % 4);
  return tx + 16 * jj;
}

struct Args {
  int R, Sq, Skv, n_qb;
  long long q_bg, q_r, q_s, k_bg, k_s, v_bg, v_s;
  float scale, softcap;  // softcap <= 0: none
  int causal;
};

template <int D>
constexpr int smem_floats() {
  return 2 * D * kBq + kBk * D + kBq * kBk;   // q^T, k^T, v, p
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           Args a) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // (D, 64)
  float* Kt = Qt + D * kBq;                      // (D, 64)
  float* Vs = Kt + D * kBk;                      // (64, D)
  float* Ps = Vs + kBk * D;                      // (64, 64)
  constexpr int NJ = D / 16;                     // output columns a thread

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  int bid = blockIdx.x;
  const int qb = a.n_qb - 1 - bid % a.n_qb;      // heaviest causal blocks first
  bid /= a.n_qb;
  const int r = bid % a.R, bg = bid / a.R;
  const int q0 = qb * kBq;
  const int nq = min(kBq, a.Sq - q0);
  const int off = a.Skv - a.Sq;                  // bottom-right alignment

  const T* qp = q + bg * a.q_bg + r * a.q_r;
  const T* kp = k + bg * a.k_bg;
  const T* vp = v + bg * a.v_bg;
  load_t<T, D>(Qt, qp, a.q_s, q0, nq, tid);

  // keys [0, kv_end) may be visible to some row of the block
  const int kv_end = a.causal ? min(a.Skv, q0 + nq + off) : a.Skv;

  float acc[4][NJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.0f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += kBk) {
    const int nk = min(kBk, a.Skv - k0);
    __syncthreads();   // the previous tile's readers are done; q is stored
    load_t<T, D>(Kt, kp, a.k_s, k0, nk, tid);
    load_r<T, D>(Vs, vp, a.v_s, k0, nk, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(Qt + d * kBq + ty * 4);
      const float4 kb = *reinterpret_cast<const float4*>(Kt + d * kBk + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;   // query row within Sq
      bool vis[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        float x = s[i][j] * a.scale;
        if (a.softcap > 0.0f) x = tanhf(x / a.softcap) * a.softcap;
        vis[j] = col < a.Skv && (!a.causal || col <= row + off);
        s[i][j] = x;
        if (vis[j]) mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float p[4], rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = vis[j] ? expf(s[i][j] - m_new) : 0.0f;
        rs += p[j];
      }
      *reinterpret_cast<float4*>(Ps + (ty * 4 + i) * kBk + tx * 4) =
          make_float4(p[0], p[1], p[2], p[3]);
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, w);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();

    // acc += p v over the tile's 64 keys (p is 0 and v zero past nk)
#pragma unroll 2
    for (int t = 0; t < kBk; t += 4) {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 pp =
            *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * kBk + t);
        pv[i][0] = pp.x;
        pv[i][1] = pp.y;
        pv[i][2] = pp.z;
        pv[i][3] = pp.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[NJ];
        if constexpr (D >= 64) {
#pragma unroll
          for (int g = 0; g < D / 64; ++g) {
            const float4 v4 = *reinterpret_cast<const float4*>(
                Vs + (t + u) * D + g * 64 + tx * 4);
            vv[4 * g] = v4.x;
            vv[4 * g + 1] = v4.y;
            vv[4 * g + 2] = v4.z;
            vv[4 * g + 3] = v4.w;
          }
        } else {
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) vv[jj] = Vs[(t + u) * D + tx + 16 * jj];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj)
            acc[i][jj] = fmaf(pv[i][u], vv[jj], acc[i][jj]);
      }
    }
  }

  T* op = o + ((static_cast<long long>(bg) * a.R + r) * a.Sq) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.Sq) continue;
    const float den = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      op[static_cast<long long>(row) * D + out_col<D>(tx, jj)] =
          from_f<T>(acc[i][jj] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BG, const Args& a, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(a.n_qb) * a.R * BG;
  flash_attention_kernel<T, D>
      <<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* o, int BG, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, BG, a, stream);
    case 32: return launch<T, 32>(q, k, v, o, BG, a, stream);
    case 64: return launch<T, 64>(q, k, v, o, BG, a, stream);
    case 128: return launch<T, 128>(q, k, v, o, BG, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared memory one block asks for, in bytes (0 for a head_dim it does not
// take).
long long flash_attention_smem_bytes(int D) {
  switch (D) {
    case 16: return sizeof(float) * smem_floats<16>();
    case 32: return sizeof(float) * smem_floats<32>();
    case 64: return sizeof(float) * smem_floats<64>();
    case 128: return sizeof(float) * smem_floats<128>();
    default: return 0;
  }
}

// o (BG, R, Sq, D), contiguous, in the inputs' type, from q (BG, R, Sq, D)
// and k, v (BG, Skv, D).  `bf16` selects bfloat16 (else float32).  Strides
// are in elements, D's is 1; every row must start 16-byte aligned for
// float32 and 8-byte aligned for bfloat16.  softcap <= 0 means none.
// Returns the cudaError_t of the launch (0 on success); shapes it does not
// take (D not in {16, 32, 64, 128}, an empty tensor, more than 2^31 - 1
// blocks) are refused with cudaErrorInvalidValue, so 0 always means a
// launch.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int bf16, int BG, int R, int Sq, int Skv,
                           int D, long long q_bg, long long q_r, long long q_s,
                           long long k_bg, long long k_s, long long v_bg,
                           long long v_s, float scale, int causal,
                           float softcap, void* stream) {
  if (BG <= 0 || R <= 0 || Sq <= 0 || Skv <= 0 ||
      flash_attention_smem_bytes(D) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{R, Sq, Skv, (Sq + kBq - 1) / kBq, q_bg, q_r, q_s, k_bg, k_s,
         v_bg, v_s, scale, softcap, causal};
  if (static_cast<long long>(a.n_qb) * R * BG > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return static_cast<int>(dispatch<__nv_bfloat16>(D, q, k, v, o, BG, a, st));
  return static_cast<int>(dispatch<float>(D, q, k, v, o, BG, a, st));
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
