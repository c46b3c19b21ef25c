// GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (entry flash_attention).  What it computes, for q (BG, R, Sq, D) and k, v
// (BG, Skv, D) -- kv groups folded into BG, the R query heads of a group
// sharing one kv head:
//
//   s[i, j] = (q_i . k_j) * scale                               (float32)
//   s       = tanh(s / softcap) * softcap            (when softcap > 0)
//   key j is visible to query i iff j <= i + off (causal; every key when
//   not causal), and every key j < Skv.  The diagonal offset `off` is the
//   caller's: Skv - Sq (bottom-right alignment) by default, -s for a part
//   of the keys that starts at position s with q holding every query row
//   from position 0 (context parallelism)
//   o_i     = sum_j p_ij v_j / sum_j p_ij,  p_ij = exp(s_ij - max_j s_ij)
//
// by the online softmax (float32 running max m, sum l and accumulator), and
// written in the input's type.  A row that sees no key (Sq > Skv under the
// causal mask, or a negative `off` that puts the part's first key past the
// row) gets 0, as the Pallas kernel gives it: m starts at -1e30 (not -inf,
// so exp(m_prev - m_new) is never inf - inf), a masked score contributes
// p = 0 and the final division is by l, or by 1 where l = 0.
//
// On request (m_out, l_out not null) each row's float32 statistics go out
// beside o, (BG, R, Sq) each: m = the row's max of the (scaled, softcapped)
// scores over its visible keys, in natural units, and l = sum_j exp(s_ij -
// m).  A row that sees no key gives m = -1e30 (never -inf) and l = 0, so
// that a combine of several key parts, sum over parts of l exp(m - M) o,
// gives it weight 0.  Whole q blocks of such rows (a negative `off`) issue
// no load: the tensor-core producer skips every TMA when the block has no
// visible key, and the consumers still write their zero rows and the
// empty rows' statistics.
//
// Two kernels, chosen by the wrapper's route(dtype, D) alone.
//
// The tensor-core kernel (flash_tc_kernel: bf16, D 64 or 128; the serving
// path).  One block of 384 threads per (bg, r, 128-row q block), the
// heaviest causal blocks first.  Warpgroup 0 is the producer: one thread
// loads the q tile once and the K and V tiles of 128 keys into a
// two-stage ring in shared memory by TMA (tensor maps made on the host per
// call, carrying q's batch, head and row strides; rows past Sq or Skv are
// zero-filled), with an mbarrier per stage for "full" (transaction bytes)
// and one for "empty" (an arrival per consumer warp).  Warpgroups 1 and 2
// each own 64 query rows (setmaxnreg moves registers from the producer to
// them).  Tiles are (rows, 64)-column panels with the 128-byte swizzle
// that TMA writes and wgmma reads: q 32 KB + 2 x (K 32 KB + V 32 KB) =
// 160 KB at D = 128.  Per tile, S = q k^T is one wgmma m64n128k16 per 16
// columns of D (A and B from shared memory, K-major); the online softmax
// runs on the accumulator registers (a row's max and sum across the 4
// threads of its quad; scores in log2 units, ex2.approx); P is rounded to
// bf16 in registers, where the accumulator layout of S is the A fragment
// of O += P V, wgmma m64nDk16 with V from shared memory MN-major (the
// instruction's transpose bit).  The loop is software-pipelined: S_j is
// issued, then P_{j-1} V_{j-1}, and the softmax of S_j runs while the
// second product is in flight.  m, l (from the unrounded p) and O stay in
// float32; the mask is applied only on tiles that cross the diagonal or
// Skv; a warpgroup stops at its own last visible key.  The products equal
// the Pallas kernel's: q k^T of bf16 values is exact in float32, and P is
// rounded to bf16 as the TPU's default-precision float32 dot rounds it.
// Each wgmma stage is one asm statement with its descriptors computed
// before the stage opens and no instruction redefining a register it
// reads while it is in flight: otherwise ptxas serializes every wgmma of
// the kernel (warning C7513).
//
// The SIMT kernel (flash_attention_kernel: float32, and head_dim 16 or
// 32; the float32 parity paths).  One block of 256 threads (16 x 16) per
// (bg, r, 64-row q block), the heaviest causal q blocks first; a loop over
// 64-key tiles takes the place of the Pallas grid's sequential kv axis and
// stops at the block's last visible key, so tiles above the diagonal are
// never loaded.  The q tile and each k tile sit in shared memory
// transposed, (D, 64) float32, and the v tile as (64, D), all converted
// from the input type on load.  Each thread owns a 4 x 4 patch of the
// score tile and four rows of the output accumulator; a row's max and sum
// are taken across its 16 threads with warp shuffles.  The probability
// tile goes through shared memory to the p v product.  Products run on the
// float32 SIMT units, as the Pallas kernel's are float32.
//
// Both read q, k and v through their batch, head and row strides (unit
// stride along D, every other stride a multiple of 16 bytes), and take any
// Sq and Skv: rows and keys past the ends are zero-filled and masked.
// Unmasked (causal = 0: whisper's encoder and cross-attention), every
// block and warpgroup runs all ceil(Skv / tile) key tiles whatever Sq,
// the block order is immaterial, and only the tile that holds Skv (1,500
// keys: 11 tiles of 128 and one of 92) takes the mask.
//
// Bound on the H100.  At olmo-1b's prefill shape (BG 128, R 1, Sq = Skv =
// 1024, D 128, bf16) the causal work is 4 D flop per visible (i, j) pair,
// 34.4 GFLOP, 0.035 ms at the bf16 tensor-core rate (989 TFLOP/s) and
// 0.51 ms at the float32 SIMT rate (67 TFLOP/s); q, k, v and o are 134 MB,
// 0.040 ms at 3.35 TB/s.  The least time is therefore ~0.04 ms, set by the
// bytes.  The tensor-core kernel is bound by operations in practice: a
// block's two warpgroups share one SM's tensor cores, and the softmax
// between the products is not hidden behind the other warpgroup's
// products (no ping-pong scheduling) -- later work, with a split-KV decode
// form and a backward.  The SIMT kernel is bound at ~0.5 ms by the float32
// rate.
#include <cuda.h>   // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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
  int off;               // key j is visible to row i iff j <= i + off
  float* m_out;          // (BG, R, Sq) row statistics, or null
  float* l_out;
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
  // heaviest causal blocks first: a row's visible keys grow with the row
  // whatever the offset
  const int qb = a.n_qb - 1 - bid % a.n_qb;
  bid /= a.n_qb;
  const int r = bid % a.R, bg = bid / a.R;
  const int q0 = qb * kBq;
  const int nq = min(kBq, a.Sq - q0);
  const int off = a.off;

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

  const long long row_base = (static_cast<long long>(bg) * a.R + r) * a.Sq;
  T* op = o + row_base * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.Sq) continue;
    const float den = l[i] == 0.0f ? 1.0f : l[i];
    if (a.m_out != nullptr && tx == 0) {   // m and l are the row's on all 16
      a.m_out[row_base + row] = l[i] == 0.0f ? kNegInf : m[i];
      a.l_out[row_base + row] = l[i];
    }
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


// ===========================================================================
// The tensor-core route: bf16, head_dim 64 or 128 (Hopper wgmma + TMA).
// ===========================================================================

constexpr int kTcRows = 128;       // query rows a block owns (2 x 64)
constexpr int kTcKeys = 128;       // keys a K/V tile holds
constexpr int kTcStages = 2;       // K/V ring depth
constexpr int kTcThreads = 384;    // producer warpgroup + 2 consumer warpgroups
constexpr int kPanel = 64;         // bf16 columns of a 128-byte swizzled panel

struct TcArgs {
  int R, Sq, Skv, n_qb;
  float scale, softcap;  // softcap <= 0: none
  int causal;
  int off;               // key j is visible to row i iff j <= i + off
  float* m_out;          // (BG, R, Sq) row statistics, or null
  float* l_out;
};

// Shared memory of one block, in bytes from a 1024-byte aligned base: the
// q tile, then the ring of K tiles and of V tiles, each (rows, D) bf16 cut
// into D / 64 panels of (rows, 64) with the 128-byte swizzle TMA writes
// and wgmma reads; then the mbarriers.
template <int D>
struct TcLayout {
  static constexpr int kPanels = D / kPanel;
  static constexpr int kQBytes = kTcRows * D * 2;
  static constexpr int kTileBytes = kTcKeys * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kTcStages * kTileBytes;
  static constexpr int kBar = kV + kTcStages * kTileBytes;
  // q_full, k_full[2], v_full[2], empty[2]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kTcStages);
  static constexpr int kAlloc = kBytes + 1024;   // room to align the base
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Spin until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading byte offset (K-major: unused, 16; MN-major: the stride
// between 64-column panels), stride byte offset 1024 (the next 8 rows).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Keep the compiler from moving accesses of accumulator registers across
// an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulator operand list of an m64 wgmma: %0 .. %63.
#define WGMMA_ACC64 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29," \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43," \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57," \
  "%58, %59, %60, %61, %62, %63" \
  "}"

// The accumulator operand list of an m64 wgmma: %0 .. %31.
#define WGMMA_ACC32 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29," \
  "%30, %31" \
  "}"

// d (m64 x n128, float32) = the sum over 8 k16 steps of A (shared, K-major)
// B (shared, K-major), the first step overwriting d: one asm statement, so
// that no other instruction sits between the wgmmas of the stage and
// every descriptor is live in a register of its own until the last one is
// issued.
__device__ __forceinline__ void wgmma_ss_n128_x8(
    float (&d)[64], const uint64_t (&da)[8], const uint64_t (&db)[8]) {
  asm volatile(
      "{\n.reg .pred p0, p1;\n"
      "setp.ne.b32 p0, %80, 0;\n"
      "setp.eq.b32 p1, %80, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_ACC64
      ", %64, %72, p0, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_ACC64
      ", %65, %73, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_ACC64
      ", %66, %74, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_ACC64
      ", %67, %75, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_ACC64
      ", %68, %76, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_ACC64
      ", %69, %77, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_ACC64
      ", %70, %78, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_ACC64
      ", %71, %79, p1, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da[0]), "l"(da[1]), "l"(da[2]), "l"(da[3]), "l"(da[4]),
        "l"(da[5]), "l"(da[6]), "l"(da[7]), "l"(db[0]), "l"(db[1]),
        "l"(db[2]), "l"(db[3]), "l"(db[4]), "l"(db[5]), "l"(db[6]),
        "l"(db[7]), "r"(0));
}

// d (m64 x n128, float32) = the sum over 4 k16 steps of A (shared, K-major)
// B (shared, K-major), the first step overwriting d: one asm statement, so
// that no other instruction sits between the wgmmas of the stage and
// every descriptor is live in a register of its own until the last one is
// issued.
__device__ __forceinline__ void wgmma_ss_n128_x4(
    float (&d)[64], const uint64_t (&da)[4], const uint64_t (&db)[4]) {
  asm volatile(
      "{\n.reg .pred p0, p1;\n"
      "setp.ne.b32 p0, %72, 0;\n"
      "setp.eq.b32 p1, %72, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_ACC64
      ", %64, %68, p0, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_ACC64
      ", %65, %69, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_ACC64
      ", %66, %70, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_ACC64
      ", %67, %71, p1, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da[0]), "l"(da[1]), "l"(da[2]), "l"(da[3]), "l"(db[0]),
        "l"(db[1]), "l"(db[2]), "l"(db[3]), "r"(0));
}

// d (m64 x n128, float32) += the sum over 8 k16 steps of A (registers)
// B (shared, MN-major), in one asm statement.
__device__ __forceinline__ void wgmma_rs_n128_x8(
    float (&d)[64], const uint32_t (&a)[8][4], const uint64_t (&db)[8]) {
  asm volatile(
      "{\n.reg .pred p1;\n"
      "setp.eq.b32 p1, %104, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_ACC64
      ", {%64, %65, %66, %67}, %96, p1, 1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_ACC64
      ", {%68, %69, %70, %71}, %97, p1, 1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_ACC64
      ", {%72, %73, %74, %75}, %98, p1, 1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_ACC64
      ", {%76, %77, %78, %79}, %99, p1, 1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_ACC64
      ", {%80, %81, %82, %83}, %100, p1, 1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_ACC64
      ", {%84, %85, %86, %87}, %101, p1, 1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_ACC64
      ", {%88, %89, %90, %91}, %102, p1, 1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_ACC64
      ", {%92, %93, %94, %95}, %103, p1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]), "r"(a[1][0]),
        "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]), "r"(a[2][0]), "r"(a[2][1]),
        "r"(a[2][2]), "r"(a[2][3]), "r"(a[3][0]), "r"(a[3][1]), "r"(a[3][2]),
        "r"(a[3][3]), "r"(a[4][0]), "r"(a[4][1]), "r"(a[4][2]), "r"(a[4][3]),
        "r"(a[5][0]), "r"(a[5][1]), "r"(a[5][2]), "r"(a[5][3]), "r"(a[6][0]),
        "r"(a[6][1]), "r"(a[6][2]), "r"(a[6][3]), "r"(a[7][0]), "r"(a[7][1]),
        "r"(a[7][2]), "r"(a[7][3]), "l"(db[0]), "l"(db[1]), "l"(db[2]),
        "l"(db[3]), "l"(db[4]), "l"(db[5]), "l"(db[6]), "l"(db[7]), "r"(0));
}

// d (m64 x n64, float32) += the sum over 8 k16 steps of A (registers)
// B (shared, MN-major), in one asm statement.
__device__ __forceinline__ void wgmma_rs_n64_x8(
    float (&d)[32], const uint32_t (&a)[8][4], const uint64_t (&db)[8]) {
  asm volatile(
      "{\n.reg .pred p1;\n"
      "setp.eq.b32 p1, %72, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_ACC32
      ", {%32, %33, %34, %35}, %64, p1, 1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_ACC32
      ", {%36, %37, %38, %39}, %65, p1, 1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_ACC32
      ", {%40, %41, %42, %43}, %66, p1, 1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_ACC32
      ", {%44, %45, %46, %47}, %67, p1, 1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_ACC32
      ", {%48, %49, %50, %51}, %68, p1, 1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_ACC32
      ", {%52, %53, %54, %55}, %69, p1, 1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_ACC32
      ", {%56, %57, %58, %59}, %70, p1, 1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_ACC32
      ", {%60, %61, %62, %63}, %71, p1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31])
      : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]), "r"(a[1][0]),
        "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]), "r"(a[2][0]), "r"(a[2][1]),
        "r"(a[2][2]), "r"(a[2][3]), "r"(a[3][0]), "r"(a[3][1]), "r"(a[3][2]),
        "r"(a[3][3]), "r"(a[4][0]), "r"(a[4][1]), "r"(a[4][2]), "r"(a[4][3]),
        "r"(a[5][0]), "r"(a[5][1]), "r"(a[5][2]), "r"(a[5][3]), "r"(a[6][0]),
        "r"(a[6][1]), "r"(a[6][2]), "r"(a[6][3]), "r"(a[7][0]), "r"(a[7][1]),
        "r"(a[7][2]), "r"(a[7][3]), "l"(db[0]), "l"(db[1]), "l"(db[2]),
        "l"(db[3]), "l"(db[4]), "l"(db[5]), "l"(db[6]), "l"(db[7]), "r"(0));
}


struct TcMaps {
  CUtensorMap q, k, v;   // (D, Sq, R, BG), (D, Skv, BG), (D, Skv, BG)
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
__device__ __forceinline__ float minus_inf() {
  return __int_as_float(0xff800000u);
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_frag(uint32_t (&r)[kTcKeys / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kTcKeys / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[kk][e])::"memory");
}

// Open a wgmma stage (wgmma.fence) and issue S = q k^T for one
// warpgroup: m64 n128, D / 16 steps of k16 (32 bytes along a panel); q
// and k are (rows, D) tiles of 64-column panels.  The descriptors are
// made before the stage opens and passed to one asm statement: an
// instruction that redefines a descriptor register between two wgmmas
// makes ptxas serialize every wgmma of the kernel.
template <int D>
__device__ __forceinline__ void qk_tile(float (&s)[64], const uint8_t* q,
                                        const uint8_t* k) {
  uint64_t da[D / 16], db[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int p = kk / 4, cb = (kk % 4) * 32;
    da[kk] = sw128_desc(q + p * kTcRows * 128 + cb, 16);
    db[kk] = sw128_desc(k + p * kTcKeys * 128 + cb, 16);
  }
  wg_fence();
  if constexpr (D == 128)
    wgmma_ss_n128_x8(s, da, db);
  else
    wgmma_ss_n128_x4(s, da, db);
}

// Open a stage and issue O += P v: P (bf16 A fragments in registers, the
// accumulator layout of S) against the MN-major v tile, 16 keys a step.
template <int D>
__device__ __forceinline__ void pv_tile(float (&acc)[D / 2],
                                        const uint32_t (&pa)[kTcKeys / 16][4],
                                        const uint8_t* v) {
  uint64_t db[kTcKeys / 16];
#pragma unroll
  for (int kk = 0; kk < kTcKeys / 16; ++kk)
    db[kk] = sw128_desc(v + kk * 16 * 128, kTcKeys * 128);
  wg_fence();
  if constexpr (D == 128)
    wgmma_rs_n128_x8(acc, pa, db);
  else
    wgmma_rs_n64_x8(acc, pa, db);
}

template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2], float corr0,
                                        float corr1) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[4 * j] *= corr0;
    acc[4 * j + 1] *= corr0;
    acc[4 * j + 2] *= corr1;
    acc[4 * j + 3] *= corr1;
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one score tile, on the accumulator registers:
// this thread holds rows row0 (s[4i], s[4i+1]) and row1 (s[4i+2],
// s[4i+3]) at key columns k0 + 8i + 2t (+1); a row's other columns sit in
// the other 3 threads of its quad.  Scores are kept in log2 units (scaled
// by log2 e, so p = 2^(x - m)); the running max m is in the same units.
// Replaces s by p, updates m and this thread's partial sums l (of the
// unrounded p) and returns the factors the output rows must be rescaled
// by.  `masked`: some key of the tile is invisible to some row of the
// warp (a diagonal tile, or keys past Skv); other tiles skip the mask.
__device__ __forceinline__ void softmax_tile(
    float (&s)[64], float& m0, float& m1,
    float& l0, float& l1, float& corr0, float& corr1, int k0, int row0,
    int row1, int off, const TcArgs& a, int t, bool masked) {
  float mx0 = kNegInf, mx1 = kNegInf;
  const float sl2 = a.scale * kLog2e;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x0, x1;
      if (a.softcap > 0.0f) {
        const float inv = 1.0f / a.softcap, cl2 = a.softcap * kLog2e;
        x0 = tanhf(s[4 * i + e] * a.scale * inv) * cl2;
        x1 = tanhf(s[4 * i + 2 + e] * a.scale * inv) * cl2;
      } else {
        x0 = s[4 * i + e] * sl2;
        x1 = s[4 * i + 2 + e] * sl2;
      }
      if (masked) {
        const int col = k0 + 8 * i + 2 * t + e;
        const bool in = col < a.Skv;
        if (!(in && (!a.causal || col <= row0 + off))) x0 = minus_inf();
        if (!(in && (!a.causal || col <= row1 + off))) x1 = minus_inf();
      }
      s[4 * i + e] = x0;
      s[4 * i + 2 + e] = x1;
      mx0 = fmaxf(mx0, x0);
      mx1 = fmaxf(mx1, x1);
    }
  }
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  corr0 = ex2(m0 - mn0);
  corr1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * i + e] = ex2(s[4 * i + e] - mn0);
      s[4 * i + 2 + e] = ex2(s[4 * i + 2 + e] - mn1);
      rs0 += s[4 * i + e];
      rs1 += s[4 * i + 2 + e];
    }
  }
  l0 = l0 * corr0 + rs0;
  l1 = l1 * corr1 + rs1;
}

// p rounded to bf16 as the A fragments of P v: the accumulator layout of S
// (columns 16 kk + 2t (+1) in tile 2 kk, + 8 in tile 2 kk + 1) is the
// fragment layout of wgmma's register A.
__device__ __forceinline__ void pack_p(const float (&s)[64],
                                       uint32_t (&pa)[kTcKeys / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kTcKeys / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// One block per (bg, r, 128-row q block), heaviest causal blocks first.
// Warpgroup 0 is the producer: one thread loads the q tile once and the
// K/V tiles into the two-stage ring by TMA, each stage guarded by a full
// barrier (transaction bytes) and an empty barrier (one arrival per
// consumer warp).  Warpgroups 1 and 2 each own 64 query rows.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_tc_kernel(const __grid_constant__ TcMaps maps,
                    __nv_bfloat16* __restrict__ o, const TcArgs a) {
  using L = TcLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + kTcStages;
  uint64_t* empty = bars + 1 + 2 * kTcStages;

  int bid = blockIdx.x;
  const int qb = a.n_qb - 1 - bid % a.n_qb;
  bid /= a.n_qb;
  const int r = bid % a.R, bg = bid / a.R;
  const int q0 = qb * kTcRows;
  const int off = a.off;
  const int q_last = min(q0 + kTcRows, a.Sq) - 1;
  // keys [0, kv_end) may be visible to some row of the block
  const int kv_end = a.causal ? min(a.Skv, q_last + off + 1) : a.Skv;
  const int n_tiles = kv_end > 0 ? (kv_end + kTcKeys - 1) / kTcKeys : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);    // the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    // a block none of whose rows sees a key (a negative offset) loads
    // nothing: its consumers wait for no barrier
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p)
        tma_load_4d(sm + L::kQ + p * kTcRows * 128, &maps.q, q_full,
                    p * kPanel, q0, r, bg);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kTcStages, ph = (it / kTcStages) & 1;
        mbar_wait(&empty[st], ph ^ 1);
        uint8_t* sk = sm + L::kK + st * L::kTileBytes;
        uint8_t* sv = sm + L::kV + st * L::kTileBytes;
        mbar_expect_tx(&k_full[st], L::kTileBytes);
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p)
          tma_load_3d(sk + p * kTcKeys * 128, &maps.k, &k_full[st],
                      p * kPanel, it * kTcKeys, bg);
        mbar_expect_tx(&v_full[st], L::kTileBytes);
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p)
          tma_load_3d(sv + p * kTcKeys * 128, &maps.v, &v_full[st],
                      p * kPanel, it * kTcKeys, bg);
      }
    }
  } else {
    // ---- consumers ---------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    // the consumer index, made warp-uniform for the compiler (it enters
    // the q tile's wgmma descriptors)
    const int c = __shfl_sync(0xffffffffu, wg, 0) - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int row0 = q0 + c * 64 + warp * 16 + g, row1 = row0 + 8;
    const int wg_last = min(q0 + c * 64 + 63, a.Sq - 1);
    const int wg_kv_end = a.causal ? min(a.Skv, wg_last + off + 1) : a.Skv;
    constexpr int NO = D / 2;    // D / 8 column tiles x 4 registers
    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

    // Keys [0, wg_kv_end) reach this warpgroup's rows: its live tiles are
    // the first n_live; the rest (at most one, on the diagonal) it only
    // waits for and releases.  Software pipeline over the live tiles:
    // S_j = q k_j^T is issued, then O += P_{j-1} v_{j-1}; the softmax of
    // S_j runs while the second product is in flight, and O is rescaled
    // once it has landed.
    const int n_live =
        wg_kv_end > 0 ? min(n_tiles, (wg_kv_end + kTcKeys - 1) / kTcKeys) : 0;
    // the first row of this warp: a tile needs the mask when one of its
    // keys lies past Skv or past that row's last visible key
    const int warp_row = q0 + c * 64 + warp * 16;
    auto needs_mask = [&](int k0) {
      return k0 + kTcKeys > a.Skv ||
             (a.causal && k0 + kTcKeys - 1 > warp_row + off);
    };
    float s[64];
    uint32_t pa[kTcKeys / 16][4];
    float corr0, corr1;
    if (n_live > 0) {
      mbar_wait(q_full, 0);
      mbar_wait(&k_full[0], 0);
      qk_tile<D>(s, sm + L::kQ + c * 64 * 128, sm + L::kK);
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      softmax_tile(s, m0, m1, l0, l1, corr0, corr1, 0, row0, row1, off, a,
                   t, needs_mask(0));
      pack_p(s, pa);
    }
    for (int it = 1; it < n_live; ++it) {
      const int st = it % kTcStages, ph = (it / kTcStages) & 1;
      const int pst = (it - 1) % kTcStages, pph = ((it - 1) / kTcStages) & 1;
      mbar_wait(&k_full[st], ph);
      fence_regs(s);
      qk_tile<D>(s, sm + L::kQ + c * 64 * 128, sm + L::kK + st * L::kTileBytes);
      wg_commit();
      mbar_wait(&v_full[pst], pph);
      fence_regs(acc);
      fence_frag(pa);     // every A register defined before the stage opens
      pv_tile<D>(acc, pa, sm + L::kV + pst * L::kTileBytes);
      wg_commit();
      wg_wait<1>();                 // S_j has landed; O may still be in flight
      fence_regs(s);
      softmax_tile(s, m0, m1, l0, l1, corr0, corr1, it * kTcKeys, row0, row1,
                   off, a, t, needs_mask(it * kTcKeys));
      wg_wait<0>();
      fence_regs(acc);
      fence_frag(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[pst]);
      rescale<D>(acc, corr0, corr1);
      pack_p(s, pa);
    }
    if (n_live > 0) {
      const int st = (n_live - 1) % kTcStages;
      const int ph = ((n_live - 1) / kTcStages) & 1;
      mbar_wait(&v_full[st], ph);
      fence_regs(acc);
      fence_frag(pa);
      pv_tile<D>(acc, pa, sm + L::kV + st * L::kTileBytes);
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
      fence_frag(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    for (int it = n_live; it < n_tiles; ++it) {
      const int st = it % kTcStages, ph = (it / kTcStages) & 1;
      mbar_wait(&k_full[st], ph);   // not read, but it must have landed
      mbar_wait(&v_full[st], ph);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, w);
      l1 += __shfl_xor_sync(0xffffffffu, l1, w);
    }
    const float d0 = l0 == 0.0f ? 1.0f : l0, d1 = l1 == 0.0f ? 1.0f : l1;
    const long long row_base = (static_cast<long long>(bg) * a.R + r) * a.Sq;
    if (a.m_out != nullptr && t == 0) {   // m in log2 units -> natural
      if (row0 < a.Sq) {
        a.m_out[row_base + row0] = l0 == 0.0f ? kNegInf : m0 * kLn2;
        a.l_out[row_base + row0] = l0;
      }
      if (row1 < a.Sq) {
        a.m_out[row_base + row1] = l1 == 0.0f ? kNegInf : m1 * kLn2;
        a.l_out[row_base + row1] = l1;
      }
    }
    __nv_bfloat16* op = o + row_base * D;
    auto* o0 = reinterpret_cast<__nv_bfloat162*>(op + 1LL * row0 * D);
    auto* o1 = reinterpret_cast<__nv_bfloat162*>(op + 1LL * row1 * D);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c2 = 4 * j + t;    // column 8j + 2t, in bf16 pairs
      if (row0 < a.Sq)
        o0[c2] = __floats2bfloat162_rn(acc[4 * j] / d0, acc[4 * j + 1] / d0);
      if (row1 < a.Sq)
        o1[c2] = __floats2bfloat162_rn(acc[4 * j + 2] / d1,
                                       acc[4 * j + 3] / d1);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (so the
// library needs no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dimensions (innermost first; the innermost
// has unit stride, `strides` are the byte strides of the others) read in
// boxes of (64, box_rows, 1, ...) with the 128-byte swizzle; boxes past
// the ends are zero-filled.
bool make_map(CUtensorMap* m, const void* base, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides,
              int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t box[4] = {kPanel, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t es[4] = {1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
            dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t tc_launch(const void* q, const void* k, const void* v, void* o,
                      int BG, int R, int Sq, int Skv, long long q_bg,
                      long long q_r, long long q_s, long long k_bg,
                      long long k_s, long long v_bg, long long v_s,
                      float scale, int causal, float softcap, int off,
                      float* m_out, float* l_out, cudaStream_t stream) {
  using L = TcLayout<D>;
  TcMaps maps;
  const cuuint64_t qd[4] = {D, static_cast<cuuint64_t>(Sq),
                            static_cast<cuuint64_t>(R),
                            static_cast<cuuint64_t>(BG)};
  const cuuint64_t qs[3] = {2ull * q_s, 2ull * q_r, 2ull * q_bg};
  const cuuint64_t kd[3] = {D, static_cast<cuuint64_t>(Skv),
                            static_cast<cuuint64_t>(BG)};
  const cuuint64_t ks[2] = {2ull * k_s, 2ull * k_bg};
  const cuuint64_t vs[2] = {2ull * v_s, 2ull * v_bg};
  if (!make_map(&maps.q, q, 4, qd, qs, kTcRows) ||
      !make_map(&maps.k, k, 3, kd, ks, kTcKeys) ||
      !make_map(&maps.v, v, 3, kd, vs, kTcKeys))
    return cudaErrorInvalidValue;
  const TcArgs a{R, Sq, Skv, (Sq + kTcRows - 1) / kTcRows, scale, softcap,
                 causal, off, m_out, l_out};
  const long long blocks = static_cast<long long>(a.n_qb) * R * BG;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kAlloc);
  if (err != cudaSuccess) return err;
  flash_tc_kernel<D><<<static_cast<unsigned>(blocks), kTcThreads, L::kAlloc,
                       stream>>>(maps, static_cast<__nv_bfloat16*>(o), a);
  return cudaGetLastError();
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
// float32 and 8-byte aligned for bfloat16.  softcap <= 0 means none.  Key j
// is visible to row i iff j <= i + off (causal).  m_out and l_out, both
// null or both (BG, R, Sq) float32, contiguous: the rows' statistics.
// Returns the cudaError_t of the launch (0 on success); shapes it does not
// take (D not in {16, 32, 64, 128}, an empty tensor, more than 2^31 - 1
// blocks) are refused with cudaErrorInvalidValue, so 0 always means a
// launch.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int bf16, int BG, int R, int Sq, int Skv,
                           int D, long long q_bg, long long q_r, long long q_s,
                           long long k_bg, long long k_s, long long v_bg,
                           long long v_s, float scale, int causal,
                           float softcap, int off, float* m_out,
                           float* l_out, void* stream) {
  if (BG <= 0 || R <= 0 || Sq <= 0 || Skv <= 0 ||
      flash_attention_smem_bytes(D) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((m_out == nullptr) != (l_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{R, Sq, Skv, (Sq + kBq - 1) / kBq, q_bg, q_r, q_s, k_bg, k_s,
         v_bg, v_s, scale, softcap, causal, off, m_out, l_out};
  if (static_cast<long long>(a.n_qb) * R * BG > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return static_cast<int>(dispatch<__nv_bfloat16>(D, q, k, v, o, BG, a, st));
  return static_cast<int>(dispatch<float>(D, q, k, v, o, BG, a, st));
}

// The tensor-core route: bf16 q, k, v with head_dim 64 or 128; shapes and
// strides as flash_attention_launch takes them, but every stride a
// multiple of 8 elements and every base 16-byte aligned (TMA's rule).
// Returns the cudaError_t of the launch (0 on success); what it does not
// take (another head_dim, an empty tensor, a tensor map the driver
// refuses) is cudaErrorInvalidValue.
int flash_attention_tc_launch(const void* q, const void* k, const void* v,
                              void* o, int BG, int R, int Sq, int Skv, int D,
                              long long q_bg, long long q_r, long long q_s,
                              long long k_bg, long long k_s, long long v_bg,
                              long long v_s, float scale, int causal,
                              float softcap, int off, float* m_out,
                              float* l_out, void* stream) {
  if (BG <= 0 || R <= 0 || Sq <= 0 || Skv <= 0 ||
      (m_out == nullptr) != (l_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return static_cast<int>(tc_launch<128>(q, k, v, o, BG, R, Sq, Skv, q_bg,
                                           q_r, q_s, k_bg, k_s, v_bg, v_s,
                                           scale, causal, softcap, off,
                                           m_out, l_out, st));
  if (D == 64)
    return static_cast<int>(tc_launch<64>(q, k, v, o, BG, R, Sq, Skv, q_bg,
                                          q_r, q_s, k_bg, k_s, v_bg, v_s,
                                          scale, causal, softcap, off,
                                          m_out, l_out, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
