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
// Two implementations, chosen by the wrapper's route(dtype, p, n, Q)
// alone.
//
// The tensor-core route (bf16 x / B / C, p a multiple of 16 up to 64, n 64
// or 128, Q a multiple of 64 up to 256; the serving path) splits the work
// as Mamba2's GPU kernels do, in three launches (see the section below):
// the chunk-local states over a grid of (chunk, head, batch), a short
// sequential state-passing pass per (batch, head), and the chunk scan over
// (64-row tile, chunk, batch), which computes G = C B^T once for the
// tile's rows and shares it across all heads.  The products run on the
// tensor cores as mma.sync.m16n8k16 (bf16 in, float32 accumulate) on tiles
// loaded by cp.async and read with ldmatrix; a float32 operand is split
// into three bf16 parts.  mma.sync rather than wgmma: every product but C B^T
// has an operand computed per element in float32 registers (the masked,
// decayed scores; the decay-weighted x), split per element, and consumed
// by one warp's 16 rows, and x, B and the state enter as the B operand in
// both majors -- ldmatrix (.trans) serves both from one shared copy, where
// wgmma would need each operand rewritten into a swizzled shared layout
// per head.
//
// The SIMT route (float32, and shapes the tensor-core route does not
// take; the float32 parity paths): one block of 256 threads per (batch,
// head); a loop over chunks takes the place of the Pallas grid's
// sequential chunk axis, with the state in shared memory between chunks.
// The (Q, Q) score tile does not fit in shared memory at Q = 256, so the
// chunk's rows are cut into tiles of 64 and only score tiles at or below
// the diagonal are computed (the masked triangle is never exponentiated,
// so exp(cum_i - cum_j) cannot overflow into inf*0).  Products run on the
// float32 SIMT units; C B^T is recomputed for every head.
//
// Bound on the H100.  At the serving shape (b 8, s 1024, h 24, p 64,
// n 128, Q 256) the least work is ~10 GFLOP, of which ~9.7 have a float32
// operand, and ~68 MB must move: with every operation at the bf16 tensor
// rate, counted once (the tensor-core route issues the float32-operand
// products as three bf16 passes), the operations take ~0.010 ms and the
// bytes ~0.020 ms at 3.35 TB/s, so the card's bound is the bytes, 0.0203
// ms.  The SIMT route's own bound is its float32 rate (67 TFLOP/s), ~0.14
// ms.  The tensor-core route is held back by its chunk-scan kernel: 128
// blocks (one wave, one block an SM) walk the 24 heads twelve to a
// stream, and the float32-operand products are issued three times (hi,
// mid, lo).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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


// ===========================================================================
// The tensor-core route: bf16 x / B / C, p a multiple of 16 up to 64,
// n 64 or 128, Q a multiple of 64 up to 256.  Three launches:
//   1. ssd_chunk_state_kernel, grid (chunk, head, batch): the chunk's
//      cumulative decay (a block scan) and its local state
//      (dt x e^{cum_Q - cum})^T B;
//   2. ssd_state_pass_kernel, grid (state elements / 256, head, batch):
//      the state entering each chunk, state_c = state_{c-1} e^{cum_Q} +
//      local_{c-1}, from the initial state, and the final state;
//   3. ssd_chunk_scan_kernel, grid (64-row tile, chunk, batch), 8 warps:
//      G = C B^T once for the tile's rows (shared by every head), then per
//      head y = (G o L o dt) x + e^{cum} C state_in^T, the heads in two
//      streams of 4 warps (one stream's loads under the other's products).
// Products run on the tensor cores as mma.sync.m16n8k16 bf16 with float32
// accumulation.  C B^T has bf16 operands and is exact in float32; each
// product with a float32 operand (the masked, decayed scores; the
// decay-weighted x; the state) splits that operand into three bf16 parts,
// hi = bf16(a), mid = bf16(a - hi), lo = bf16(a - hi - mid), and issues
// three products: ~2^-25 relative error where one bf16 rounding would
// give 2^-9 (and two parts ~2^-17).
// ===========================================================================

using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;    // 4 warps
constexpr int kRowTile = 64;       // rows of the chunk a scan block owns
constexpr int kMaxQ = 256;         // chunk length the route takes
constexpr int kPad = 8;            // bf16 of padding per shared row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// Four 8x8 bf16 matrices from shared memory; `t`: transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d (16 x 8, float32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

// The three bf16 parts of the float32 pair (u, v): hi = bf16(u), mid =
// bf16(u - hi), lo = bf16(u - hi - mid) (both differences are exact), each
// packed as an mma operand register (u in the low half).  hi + mid + lo
// carries u to ~2^-25 relative; hi + mid alone (~2^-17) turned out too
// coarse for the 24-layer logits check against the plain path.
__device__ __forceinline__ void split3(float u, float v, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
  const float2 hf = __bfloat1622float2(h);
  u -= hf.x;
  v -= hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(u, v);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(u - mf.x, v - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int P, int N>
struct TcSmem {
  static constexpr int LP = P + kPad, LN = N + kPad;
  // chunk-state kernel: x (Q, LP), B (Q, LN), cum (Q), w (Q), 4 warp sums
  __host__ __device__ static long long state_bytes(int Q) {
    return 2LL * Q * (LP + LN) + 8LL * Q + 16;
  }
  // chunk-scan kernel: G (4 row groups x Q/8 tiles x 32 lanes float4),
  // then per head stream x (Q, LP) bf16, the state (P, N + 4) float32, cum
  // and dt (Q each); the B rows and C tile of G's pass (Q + 64, LN) bf16
  // are staged in the streams' space before it is used
  __host__ __device__ static long long g_bytes(int Q) {
    return 16LL * 4 * (Q / 8) * 32;
  }
  __host__ __device__ static long long stream_bytes(int Q) {
    return 2LL * Q * LP + 4LL * P * (N + 4) + 8LL * Q;
  }
  __host__ __device__ static long long scan_bytes(int Q) {
    const long long streams = 2 * stream_bytes(Q);
    const long long staging = 2LL * (Q + kRowTile) * LN;
    return g_bytes(Q) + (streams > staging ? streams : staging);
  }
};

template <int P, int N>
__global__ void __launch_bounds__(kTcThreads)
    ssd_chunk_state_kernel(const bf16* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ A,
                           const bf16* __restrict__ Bm,
                           float* __restrict__ cum, float* __restrict__ sloc,
                           int s, int H, int Q, Strides st) {
  using L = TcSmem<P, N>;
  constexpr int LP = L::LP, LN = L::LN;
  extern __shared__ float4 smem_tc[];
  bf16* Xs = reinterpret_cast<bf16*>(smem_tc);
  bf16* Bs = Xs + Q * LP;
  float* cums = reinterpret_cast<float*>(Bs + Q * LN);
  float* ws = cums + Q;
  float* wsum = ws + Q;

  const int c = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int nc = s / Q, t0 = c * Q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  const bf16* xb = x + b * st.xb + static_cast<long long>(t0) * st.xs + hh * P;
  for (int e = tid; e < Q * (P / 8); e += kTcThreads) {
    const int r = e / (P / 8), cc = (e % (P / 8)) * 8;
    cp_async16(Xs + r * LP + cc, xb + r * st.xs + cc);
  }
  const bf16* Bb = Bm + b * st.bb + static_cast<long long>(t0) * st.bs;
  for (int e = tid; e < Q * (N / 8); e += kTcThreads) {
    const int r = e / (N / 8), cc = (e % (N / 8)) * 8;
    cp_async16(Bs + r * LN + cc, Bb + r * st.bs + cc);
  }

  // cum = cumsum(dt a) over the chunk by a block scan, while x and B land:
  // each thread sums its E consecutive steps, a warp scan of the thread
  // sums, then the sums of the warps before it
  const float a = A[hh];
  const float* dtb = dt + b * st.dtb + static_cast<long long>(t0) * st.dts + hh;
  constexpr int E = kMaxQ / kTcThreads;
  const int per = (Q + kTcThreads - 1) / kTcThreads;
  float v[E], run = 0.0f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int q = tid * per + e;
    const float d = (e < per && q < Q) ? dtb[q * st.dts] : 0.0f;
    if (e < per && q < Q) ws[q] = d;
    run += d * a;
    v[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  float base = incl - run;
  for (int w = 0; w < warp; ++w) base += wsum[w];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int q = tid * per + e;
    if (e < per && q < Q) cums[q] = base + v[e];
  }
  __syncthreads();
  const long long hq = ((static_cast<long long>(b) * nc + c) * H + hh);
  const float last = cums[Q - 1];
  for (int q = tid; q < Q; q += kTcThreads) {
    cum[hq * Q + q] = cums[q];
    ws[q] = ws[q] * expf(last - cums[q]);   // dt e^{cum_Q - cum}
  }
  cp_async_wait_all();
  __syncthreads();

  // local state (P, N) = (w o x)^T B: warp w owns state rows 16w .. 16w+15
  if (warp < P / 16) {
    float acc[N / 8][4];
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
    for (int kk = 0; kk < Q / 16; ++kk) {
      uint32_t xa[4], a3[3][4];
      ldsm_x4_t(xa, Xs + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * LP +
                        warp * 16 + ((lane >> 3) & 1) * 8);
      const int j = kk * 16 + 2 * t;
      const float w0 = ws[j], w1 = ws[j + 1], w2 = ws[j + 8], w3 = ws[j + 9];
      const float2 f0 = unpack_bf16(xa[0]), f1 = unpack_bf16(xa[1]);
      const float2 f2 = unpack_bf16(xa[2]), f3 = unpack_bf16(xa[3]);
      split3(f0.x * w0, f0.y * w1, a3[0][0], a3[1][0], a3[2][0]);
      split3(f1.x * w0, f1.y * w1, a3[0][1], a3[1][1], a3[2][1]);
      split3(f2.x * w2, f2.y * w3, a3[0][2], a3[1][2], a3[2][2]);
      split3(f3.x * w2, f3.y * w3, a3[0][3], a3[1][3], a3[2][3]);
#pragma unroll
      for (int np = 0; np < N / 16; ++np) {
        uint32_t bq[4];
        ldsm_x4_t(bq, Bs + (kk * 16 + (lane & 15)) * LN + np * 16 +
                          (lane >> 4) * 8);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          mma_bf16(acc[2 * np], a3[k], bq[0], bq[1]);
          mma_bf16(acc[2 * np + 1], a3[k], bq[2], bq[3]);
        }
      }
    }
    float* out = sloc + hq * P * N;
    const int p0 = warp * 16 + g;
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const int n = i * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + p0 * N + n) =
          make_float2(acc[i][0], acc[i][1]);
      *reinterpret_cast<float2*>(out + (p0 + 8) * N + n) =
          make_float2(acc[i][2], acc[i][3]);
    }
  }
}

// The state entering each chunk and the final state, in float32: one
// thread per state element of one (batch, head), the chunks in order.
__global__ void __launch_bounds__(256)
    ssd_state_pass_kernel(const float* __restrict__ cum,
                          const float* __restrict__ sloc,
                          const float* __restrict__ init,
                          float* __restrict__ sin, float* __restrict__ fin,
                          int nc, int H, int Q, int PN) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int hh = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  const long long bh = static_cast<long long>(b) * H + hh;
  float sv = init != nullptr ? init[bh * PN + e] : 0.0f;
  for (int c = 0; c < nc; ++c) {
    const long long hq = (static_cast<long long>(b) * nc + c) * H + hh;
    sin[hq * PN + e] = sv;
    sv = sv * expf(cum[hq * Q + Q - 1]) + sloc[hq * PN + e];
  }
  fin[bh * PN + e] = sv;
}

__device__ __forceinline__ void stream_sync(int stream) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + stream), "r"(kTcThreads)
               : "memory");
}

// Two head streams of 4 warps each: warps 0-3 take the even heads, 4-7
// the odd ones, each stream with its own x / state buffers and its own
// named barrier, so one stream's loads run under the other's products.
// Warps w and w + 4 own the same 16 rows of the tile.
template <int P, int N>
__global__ void __launch_bounds__(2 * kTcThreads)
    ssd_chunk_scan_kernel(const bf16* __restrict__ x,
                          const float* __restrict__ dt,
                          const bf16* __restrict__ Bm,
                          const bf16* __restrict__ Cm,
                          const float* __restrict__ cum,
                          const float* __restrict__ sin,
                          bf16* __restrict__ y, int s, int H, int Q,
                          Strides st) {
  using L = TcSmem<P, N>;
  constexpr int LP = L::LP, LN = L::LN, LS = N + 4;
  extern __shared__ float4 smem_tc[];
  float4* Gs = smem_tc;
  uint8_t* streams = reinterpret_cast<uint8_t*>(smem_tc) + L::g_bytes(Q);
  bf16* Bs = reinterpret_cast<bf16*>(streams);                 // (Q, LN)
  bf16* Cs = Bs + Q * LN;                                      // (64, LN)

  const int it = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = s / Q, t0 = c * Q, i0 = it * kRowTile;
  const int jn = i0 + kRowTile;     // the tile's rows see columns [0, jn)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp & 3, hs = warp >> 2, lt = tid & (kTcThreads - 1);

  const bf16* Cb = Cm + b * st.cb + static_cast<long long>(t0 + i0) * st.cs;
  for (int e = tid; e < kRowTile * (N / 8); e += 2 * kTcThreads) {
    const int r = e / (N / 8), cc = (e % (N / 8)) * 8;
    cp_async16(Cs + r * LN + cc, Cb + r * st.cs + cc);
  }
  const bf16* Bb = Bm + b * st.bb + static_cast<long long>(t0) * st.bs;
  for (int e = tid; e < jn * (N / 8); e += 2 * kTcThreads) {
    const int r = e / (N / 8), cc = (e % (N / 8)) * 8;
    cp_async16(Bs + r * LN + cc, Bb + r * st.bs + cc);
  }
  cp_async_wait_all();
  __syncthreads();

  // this warp's 16 rows of C as A fragments, kept for every head
  uint32_t ca[N / 16][4];
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    ldsm_x4(ca[kk], Cs + (wr * 16 + (lane & 15)) * LN + kk * 16 +
                        (lane >> 4) * 8);

  // G = C B^T for the rows' 16-column steps at or left of their diagonal,
  // once for all heads (the two warps of a row group take alternate
  // steps); each accumulator fragment goes to its thread's own slot
  const int n_k = i0 / 16 + wr + 1;
  for (int jp = hs; jp < n_k; jp += 2) {
    float a0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, a1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t bq[4];
      ldsm_x4(bq, Bs + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LN +
                      kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(a0, ca[kk], bq[0], bq[1]);
      mma_bf16(a1, ca[kk], bq[2], bq[3]);
    }
    Gs[(wr * (Q / 8) + 2 * jp) * 32 + lane] =
        make_float4(a0[0], a0[1], a0[2], a0[3]);
    Gs[(wr * (Q / 8) + 2 * jp + 1) * 32 + lane] =
        make_float4(a1[0], a1[1], a1[2], a1[3]);
  }
  __syncthreads();   // G is whole; the staging space goes to the streams

  uint8_t* mine = streams + hs * L::stream_bytes(Q);
  bf16* Xs = reinterpret_cast<bf16*>(mine);                     // (Q, LP)
  float* Ss = reinterpret_cast<float*>(Xs + Q * LP);            // (P, LS)
  float* cums = Ss + P * LS;
  float* dts = cums + Q;
  const long long ys = static_cast<long long>(H) * P;
  const int r0 = i0 + wr * 16 + g, r1 = r0 + 8;   // rows within the chunk
  for (int hh = hs; hh < H; hh += 2) {
    const bf16* xb =
        x + b * st.xb + static_cast<long long>(t0) * st.xs + hh * P;
    for (int e = lt; e < jn * (P / 8); e += kTcThreads) {
      const int r = e / (P / 8), cc = (e % (P / 8)) * 8;
      cp_async16(Xs + r * LP + cc, xb + r * st.xs + cc);
    }
    const long long hq = (static_cast<long long>(b) * nc + c) * H + hh;
    const float* sb = sin + hq * P * N;
    for (int e = lt; e < P * (N / 4); e += kTcThreads) {
      const int r = e / (N / 4), cc = (e % (N / 4)) * 4;
      cp_async16(Ss + r * LS + cc, sb + r * N + cc);
    }
    const float* dtb =
        dt + b * st.dtb + static_cast<long long>(t0) * st.dts + hh;
    for (int q = lt; q < jn; q += kTcThreads) {
      cums[q] = cum[hq * Q + q];
      dts[q] = dtb[q * st.dts];
    }
    cp_async_wait_all();
    stream_sync(hs);

    float yv[P / 8][4], yi[P / 8][4];
#pragma unroll
    for (int i = 0; i < P / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) yv[i][e] = yi[i][e] = 0.0f;

    // inter-chunk: C state_in^T, the state split hi + mid + lo in
    // registers as the B fragments are read
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
      for (int pt = 0; pt < P / 8; ++pt) {
        const float* sr = Ss + (pt * 8 + g) * LS + kk * 16 + 2 * t;
        const float2 f0 = *reinterpret_cast<const float2*>(sr);
        const float2 f1 = *reinterpret_cast<const float2*>(sr + 8);
        uint32_t b0[3], b1[3];
        split3(f0.x, f0.y, b0[0], b0[1], b0[2]);
        split3(f1.x, f1.y, b1[0], b1[1], b1[2]);
#pragma unroll
        for (int k = 0; k < 3; ++k) mma_bf16(yi[pt], ca[kk], b0[k], b1[k]);
      }

    // intra-chunk: (G o L o dt) x, the masked scores as hi + mid + lo
    const float c0 = cums[r0], c1 = cums[r1];
    for (int kk = 0; kk < n_k; ++kk) {
      const float4 g0 = Gs[(wr * (Q / 8) + 2 * kk) * 32 + lane];
      const float4 g1 = Gs[(wr * (Q / 8) + 2 * kk + 1) * 32 + lane];
      const int j = kk * 16 + 2 * t;
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      float m[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = j + (e & 1) + (e >> 2) * 8;
        const int row = (e & 2) ? r1 : r0;
        const float ci = (e & 2) ? c1 : c0;
        m[e] = row >= col ? gv[e] * expf(ci - cums[col]) * dts[col] : 0.0f;
      }
      uint32_t a3[3][4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split3(m[2 * e], m[2 * e + 1], a3[0][e], a3[1][e], a3[2][e]);
#pragma unroll
      for (int pp = 0; pp < P / 16; ++pp) {
        uint32_t bq[4];
        ldsm_x4_t(bq, Xs + (kk * 16 + (lane & 15)) * LP + pp * 16 +
                          (lane >> 4) * 8);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          mma_bf16(yv[2 * pp], a3[k], bq[0], bq[1]);
          mma_bf16(yv[2 * pp + 1], a3[k], bq[2], bq[3]);
        }
      }
    }

    // y = intra + e^{cum} inter, rounded once to bf16
    const float e0 = expf(c0), e1 = expf(c1);
    bf16* yb = y + (static_cast<long long>(b) * s + t0) * ys + hh * P;
#pragma unroll
    for (int pt = 0; pt < P / 8; ++pt) {
      const int col = pt * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(yb + r0 * ys + col) =
          __floats2bfloat162_rn(yv[pt][0] + e0 * yi[pt][0],
                                yv[pt][1] + e0 * yi[pt][1]);
      *reinterpret_cast<__nv_bfloat162*>(yb + r1 * ys + col) =
          __floats2bfloat162_rn(yv[pt][2] + e1 * yi[pt][2],
                                yv[pt][3] + e1 * yi[pt][3]);
    }
    stream_sync(hs);   // this stream's buffers are free for its next head
  }
}

template <int P, int N>
cudaError_t tc_launch(const bf16* x, const float* dt, const float* A,
                      const bf16* Bm, const bf16* Cm, const float* init,
                      bf16* y, float* fin, float* cum, float* sloc,
                      float* sin, int b, int s, int h, int Q, const Strides& st,
                      cudaStream_t stream) {
  using L = TcSmem<P, N>;
  const int nc = s / Q;
  const int s1 = static_cast<int>(L::state_bytes(Q));
  const int s3 = static_cast<int>(L::scan_bytes(Q));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state_kernel<P, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, s1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_chunk_scan_kernel<P, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, s3);
  if (err != cudaSuccess) return err;
  ssd_chunk_state_kernel<P, N><<<dim3(nc, h, b), kTcThreads, s1, stream>>>(
      x, dt, A, Bm, cum, sloc, s, h, Q, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_state_pass_kernel<<<dim3((P * N + 255) / 256, h, b), 256, 0, stream>>>(
      cum, sloc, init, sin, fin, nc, h, Q, P * N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_chunk_scan_kernel<P, N>
      <<<dim3(Q / kRowTile, nc, b), 2 * kTcThreads, s3, stream>>>(
          x, dt, Bm, Cm, cum, sin, y, s, h, Q, st);
  return cudaGetLastError();
}

template <int P>
cudaError_t tc_dispatch_n(int N, const bf16* x, const float* dt,
                          const float* A, const bf16* Bm, const bf16* Cm,
                          const float* init, bf16* y, float* fin, float* cum,
                          float* sloc, float* sin, int b, int s,
                          int h, int Q, const Strides& st,
                          cudaStream_t stream) {
  if (N == 128)
    return tc_launch<P, 128>(x, dt, A, Bm, Cm, init, y, fin, cum, sloc,
                             sin, b, s, h, Q, st, stream);
  if (N == 64)
    return tc_launch<P, 64>(x, dt, A, Bm, Cm, init, y, fin, cum, sloc,
                            sin, b, s, h, Q, st, stream);
  return cudaErrorInvalidValue;
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

// The tensor-core route (three launches on `stream`): bf16 x, B, C and y,
// P a multiple of 16 up to 64, N 64 or 128, Q a multiple of 64 up to 256,
// s a multiple of Q.  The batch and sequence strides of x, B and C must be
// multiples of 8 elements and their bases 16-byte aligned (16-byte
// cp.async rows).  Scratch, contiguous, from the caller: cum (b, s/Q, h,
// Q), sloc and sin (b, s/Q, h, P, N), all float32.  Returns the
// cudaError_t of the launches (0 on success); what it does not take is
// cudaErrorInvalidValue.
int ssd_scan_tc_launch(const void* x, const float* dt, const float* A,
                       const void* Bm, const void* Cm, const float* init,
                       void* y, float* fin, float* cum, float* sloc,
                       float* sin, int b, int s, int h, int P,
                       int N, int Q, long long xb, long long xs,
                       long long dtb, long long dts, long long bb,
                       long long bs, long long cb, long long cs,
                       void* stream) {
  const bool aligned =
      (xb | xs | bb | bs | cb | cs) % 8 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bm) |
        reinterpret_cast<uintptr_t>(Cm)) & 15) == 0;
  if (b <= 0 || s <= 0 || h <= 0 || P <= 0 || P > kMaxP || P % 16 != 0 ||
      (N != 64 && N != 128) || Q <= 0 || Q % kRowTile != 0 || Q > kMaxQ ||
      s % Q != 0 || h > 65535 || b > 65535 || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{xb, xs, dtb, dts, bb, bs, cb, cs};
  const cudaStream_t cs_ = static_cast<cudaStream_t>(stream);
  const bf16* xx = static_cast<const bf16*>(x);
  const bf16* B_ = static_cast<const bf16*>(Bm);
  const bf16* C_ = static_cast<const bf16*>(Cm);
  bf16* yy = static_cast<bf16*>(y);
  switch (P) {
    case 16: return static_cast<int>(tc_dispatch_n<16>(
        N, xx, dt, A, B_, C_, init, yy, fin, cum, sloc, sin, b, s, h, Q, st,
        cs_));
    case 32: return static_cast<int>(tc_dispatch_n<32>(
        N, xx, dt, A, B_, C_, init, yy, fin, cum, sloc, sin, b, s, h, Q, st,
        cs_));
    case 48: return static_cast<int>(tc_dispatch_n<48>(
        N, xx, dt, A, B_, C_, init, yy, fin, cum, sloc, sin, b, s, h, Q, st,
        cs_));
    default: return static_cast<int>(tc_dispatch_n<64>(
        N, xx, dt, A, B_, C_, init, yy, fin, cum, sloc, sin, b, s, h, Q, st,
        cs_));
  }
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
