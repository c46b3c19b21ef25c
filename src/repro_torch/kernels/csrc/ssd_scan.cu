// Mamba2 SSD chunked scan, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::_ssd_kernel.
// What it computes, per (batch, head), walking the chunks of Q positions
// in order and carrying the (P, N) float32 state:
//
//   cum_i    = sum_{k <= i} dt_k A                        (within the chunk)
//   y_intra  = ((C B^T) o L) (dt x),  L[i,j] = exp(cum_i - cum_j), i >= j
//   y_inter  = (C e^{cum}) state^T
//   state   <- state e^{cum_Q} + (dt x e^{cum_Q - cum})^T B
//
// y is written in x's type, the final state in float32.  All sums are in
// float32.  Layouts: x (b, s, h, p) with (h, p) contiguous, dt (b, s, h)
// with h contiguous, B and C (b, s, n) with n contiguous (one group shared
// by every head); the batch and sequence strides are arguments, so the
// strided slices of the model's projection are read in place.  A (h,), the
// optional initial state (b, h, p, n), y (b, s, h, p) and the final state
// (b, h, p, n) are contiguous.
//
// Design.  One block of 256 threads per (batch, head); a loop over chunks
// takes the place of the Pallas grid's sequential chunk axis, with the
// state in shared memory between chunks.  The (Q, Q) score tile does not
// fit in shared memory at Q = 256, so the chunk's rows are cut into tiles
// of 64: for each row tile, the column tiles at or left of the diagonal
// give 64x64 score tiles (only i >= j is computed; the masked triangle is
// never exponentiated, so exp(cum_i - cum_j) cannot overflow into inf*0),
// which multiply the column tile of x into 16 float32 accumulators per
// thread.  Then the row tile's inter-chunk term is added and y stored;
// last, one pass over the chunk's column tiles updates the state (32
// entries per thread).  Rows in shared memory are padded by one float so
// that the threads of a warp read distinct banks.  Products run on the
// float32 SIMT units; C B^T is recomputed for every head (the TPU kernel
// does the same).
//
// Bound on the H100.  At the serving shape (b 8, s 1024, h 24, p 64,
// n 128, Q 256) the least work is ~10 GFLOP of which ~9.7 have a float32
// operand (the state, the decay-weighted dt x, the masked scores) and
// ~68 MB must move: by the float32 rate (67 TFLOP/s) the operations bound
// it at ~0.15 ms, by bytes (3.35 TB/s) ~0.02 ms, so it is bound by
// operations.  This first version uses no tensor cores (wgmma) and no TMA;
// with one 134 KB block per SM the 192 blocks take two waves.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;   // rows (i) and columns (j) of a score tile
constexpr int kMaxP = 64;   // head_dim: 16 threads x 4
constexpr int kMaxN = 128;  // d_state: 16 threads x 8

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

struct Strides {
  long long xb, xs, dtb, dts, bb, bs, cb, cs;
};

// Shared memory, in floats: state P x (N+1), C tile and B tile 64 x (N+1)
// each, x tile 64 x P, scores 64 x 65, dt and cum Q each.
__host__ __device__ inline long long smem_floats(int P, int N, int Q) {
  return (long long)P * (N + 1) + 2LL * kTile * (N + 1) +
         (long long)kTile * P + (long long)kTile * (kTile + 1) + 2LL * Q;
}

// Rows r0 .. r0+64 of a (s, width) slice with row stride `rs` into a
// 64 x ld float tile, zero beyond `nr` rows.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long rs, int nr, int width) {
  for (int e = threadIdx.x; e < kTile * width; e += kThreads) {
    const int r = e / width, c = e - r * width;
    dst[r * ld + c] = r < nr ? to_f(src[r * rs + c]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ init,
                    T* __restrict__ y, float* __restrict__ fin, int s, int H,
                    int P, int N, int Q, Strides st) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int NL = N + 1;
  float* S = smem;                  // P x NL      carried state
  float* Ct = S + P * NL;           // 64 x NL     C rows of the row tile
  float* Bt = Ct + kTile * NL;      // 64 x NL     B rows of the column tile
  float* Xt = Bt + kTile * NL;      // 64 x P      x rows of the column tile
  float* Sc = Xt + kTile * P;       // 64 x 65     masked, dt-scaled scores
  float* dts = Sc + kTile * (kTile + 1);  // Q
  float* cum = dts + Q;                   // Q

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float a = A[h];
  const long long stride_h = (long long)P * N;
  const long long base_state = ((long long)b * H + h) * stride_h;

  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    S[p * NL + n] = init != nullptr ? init[base_state + e] : 0.0f;
  }

  const T* xbh = x + (long long)b * st.xb + (long long)h * P;
  const float* dtbh = dt + (long long)b * st.dtb + h;
  const T* Bb = Bm + (long long)b * st.bb;
  const T* Cb = Cm + (long long)b * st.cb;
  T* ybh = y + ((long long)b * s * H + h) * P;
  const long long ys = (long long)H * P;
  const int n_tiles = (Q + kTile - 1) / kTile;

  for (int t0 = 0; t0 < s; t0 += Q) {
    __syncthreads();  // the previous chunk's readers of dts / cum are done
    for (int q = tid; q < Q; q += kThreads)
      dts[q] = dtbh[(long long)(t0 + q) * st.dts];
    __syncthreads();
    if (tid == 0) {
      float acc = 0.0f;
      for (int q = 0; q < Q; ++q) {
        acc += dts[q] * a;
        cum[q] = acc;
      }
    }
    __syncthreads();

    // ---- outputs, one row tile at a time --------------------------------
    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kTile, ni = min(kTile, Q - i0);
      load_tile(Ct, NL, Cb + (long long)(t0 + i0) * st.cs, st.cs, ni, N);
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = 0.0f;

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile, nj = min(kTile, Q - j0);
        __syncthreads();  // Bt / Xt / Sc free
        load_tile(Bt, NL, Bb + (long long)(t0 + j0) * st.bs, st.bs, nj, N);
        load_tile(Xt, P, xbh + (long long)(t0 + j0) * st.xs, st.xs, nj, P);
        __syncthreads();
        // scores of rows ty*4+r against columns tx+16k, lower triangle only
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int ii = ty * 4 + r;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int jj = tx + 16 * k;
            float v = 0.0f;
            if (ii < ni && jj < nj && i0 + ii >= j0 + jj) {
              const float* cr = Ct + ii * NL;
              const float* br = Bt + jj * NL;
              float d = 0.0f;
              for (int n = 0; n < N; ++n) d += cr[n] * br[n];
              v = d * expf(cum[i0 + ii] - cum[j0 + jj]) * dts[j0 + jj];
            }
            Sc[ii * (kTile + 1) + jj] = v;
          }
        }
        __syncthreads();
        for (int jj = 0; jj < nj; ++jj) {
          float xv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int p = tx + 16 * k;
            xv[k] = p < P ? Xt[jj * P + p] : 0.0f;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float sv = Sc[(ty * 4 + r) * (kTile + 1) + jj];
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[r][k] += sv * xv[k];
          }
        }
      }

      // inter-chunk term from the state entering the chunk, then store
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ii = ty * 4 + r;
        if (ii >= ni) continue;
        const float e = expf(cum[i0 + ii]);
        const float* cr = Ct + ii * NL;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = tx + 16 * k;
          if (p >= P) continue;
          const float* sr = S + p * NL;
          float d = 0.0f;
          for (int n = 0; n < N; ++n) d += cr[n] * sr[n];
          ybh[(long long)(t0 + i0 + ii) * ys + p] = from_f<T>(acc[r][k] + e * d);
        }
      }
      __syncthreads();  // Ct free
    }

    // ---- state update ------------------------------------------------------
    const float cl = cum[Q - 1];
    float upd[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 8; ++k) upd[r][k] = 0.0f;
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int j0 = jt * kTile, nj = min(kTile, Q - j0);
      __syncthreads();
      load_tile(Bt, NL, Bb + (long long)(t0 + j0) * st.bs, st.bs, nj, N);
      load_tile(Xt, P, xbh + (long long)(t0 + j0) * st.xs, st.xs, nj, P);
      __syncthreads();
      for (int jj = 0; jj < nj; ++jj) {
        const float w = dts[j0 + jj] * expf(cl - cum[j0 + jj]);
        float bv[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int n = tx + 16 * k;
          bv[k] = n < N ? Bt[jj * NL + n] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = ty * 4 + r;
          const float xw = p < P ? w * Xt[jj * P + p] : 0.0f;
#pragma unroll
          for (int k = 0; k < 8; ++k) upd[r][k] += xw * bv[k];
        }
      }
    }
    __syncthreads();
    const float decay = expf(cl);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = ty * 4 + r;
      if (p >= P) continue;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int n = tx + 16 * k;
        if (n < N) S[p * NL + n] = S[p * NL + n] * decay + upd[r][k];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    fin[base_state + e] = S[p * NL + n];
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* init, void* y,
                   float* fin, int b, int s, int h, int P, int N, int Q,
                   const Strides& st, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(P, N, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T><<<dim3(h, b), kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), init, static_cast<T*>(y), fin, s, h, P, N, Q,
      st);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block asks for, in bytes.
long long ssd_scan_smem_bytes(int P, int N, int Q) {
  return static_cast<long long>(sizeof(float)) * smem_floats(P, N, Q);
}

// y (b, s, h, p) in x's type and fin (b, h, p, n) in float32 from x, dt,
// A, B, C and an optional initial state (nullptr: zeros).  `bf16` selects
// bfloat16 x / B / C / y (else float32).  Strides are in elements.
// Returns the cudaError_t of the launch (0 on success); shapes it does not
// take (p > 64, n > 128, s not a multiple of Q, an empty tensor) are
// refused with cudaErrorInvalidValue, so 0 always means a launch.
int ssd_scan_launch(const void* x, const float* dt, const float* A,
                    const void* Bm, const void* Cm, const float* init, void* y,
                    float* fin, int bf16, int b, int s, int h, int P, int N,
                    int Q, long long xb, long long xs, long long dtb,
                    long long dts, long long bb, long long bs, long long cb,
                    long long cs, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || P <= 0 || N <= 0 || Q <= 0 ||
      P > kMaxP || N > kMaxN || s % Q != 0 || h > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{xb, xs, dtb, dts, bb, bs, cb, cs};
  const cudaStream_t cs_ = static_cast<cudaStream_t>(stream);
  if (bf16)
    return static_cast<int>(launch<__nv_bfloat16>(
        x, dt, A, Bm, Cm, init, y, fin, b, s, h, P, N, Q, st, cs_));
  return static_cast<int>(
      launch<float>(x, dt, A, Bm, Cm, init, y, fin, b, s, h, P, N, Q, st, cs_));
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
