// Flash attention at head dims past 256 for Hopper (sm_90a): the forward
// and both backward kernels of the wide-head route, bound to Python through
// a plain C interface (ctypes; see ops/_build.py and ops/flash_attention.py).
//
// Replaces, for D > 256, the same Pallas TPU kernels as flash_fwd.cu and
// flash_bwd.cu: deeplearning4j_tpu/ops/flash_attention.py `_kernel` (the
// forward, `pl.pallas_call` at :181), `_bwd_dq_kernel` (:359) and
// `_bwd_dkv_kernel` (:385). The TPU kernels take any head dim; kernels
// #1-#3 of this port hold D <= 256 in registers (wgmma) or in one shared
// tile (f32), so a wider head needs another layout, not a larger constant.
//
// Design: D is a run-time loop over chunks of DC = 64 columns, so one
// instantiation per operand type (float32, bfloat16, float16) takes every
// D that is a multiple of 64 (the wrapper zero-pads the rest, which adds
// exact zeros to every product). The only array that grows with D is the
// block's f32 accumulator in shared memory: the forward's O and dq's dQ
// [16 rows][G], dk/dv's dK and dV [8 rows][G], for a column group of G
// output columns. Where the whole of D fits one block (D up to 2880 for
// dq's layout, 2944 for dk/dv's, 3200 for the forward's), G = D and the
// grid has one group; past that the grid's z axis runs ceil(D / Gmax)
// groups of G = D / groups columns (rounded up to 64; Gmax the widest
// multiple of 64 that fits), and each block sums the scores (and dq's and
// dk/dv's dp = do . v^T) over ALL of D again before accumulating its own
// columns: recomputation, in the same order in every group, so every group
// sees the same p bit for bit. The forward's lse is written by group 0
// only. At D = 2048 the largest layout (dq) takes 177,216 bytes of the
// 232,448 a block may use (flash_wide_smem_bytes reports each, grouped).
// Everything else streams through shared memory in [rows][64] f32 chunks
// read with plain scalar loads through the [B, T, H, D] strides, so no
// alignment is asked of the rows.
// - forward: a block owns 16 query rows of one (batch, head) and walks
//   64-key tiles (tiles strictly above the causal diagonal skipped). Scores
//   are summed over the D chunks in registers (a thread: one key, 8 rows),
//   masked to -1e30 (causal, keys past T, the key mask) as the TPU kernel
//   does, then one warp's online softmax per row; p is rounded to the
//   operand type before p . v, as kernel #1 does; O is rescaled and summed
//   chunk by chunk (a thread: one column, 8 rows). out = O / l in the
//   operand type, lse = m + log l in f32.
// - dq: a block owns 16 query rows; per 64-key tile the scores and
//   dp = do . v^T are summed over the D chunks together, p = exp(s - lse)
//   where the pair is valid and exactly 0 elsewhere, ds = p (dp - delta)
//   rounded to the operand type, then dQ += ds . k chunk by chunk.
// - dk/dv: a block owns 8 key rows and walks 64-query tiles (those strictly
//   below the causal diagonal skipped): p^T and ds^T as above, rounded to
//   the operand type, then dV += p^T . do and dK += ds^T . q chunk by chunk.
// Every product is plain f32 FMAs (no TF32) in a fixed order and no
// atomics are used, so a run repeats bit for bit.
// Queries and keys may differ in length (Tq, Tk) and sit at absolute
// offsets, as in flash_fwd.cu and flash_bwd.cu: the causal rule is
// k_off + k <= q_off + q, a key k allowed for a query q when k <= q + shift
// (shift = q_off - k_off), and the skipped tiles are those wholly above the
// shifted diagonal.
//
// Bound (B=2, T=512, H=4, D=512, bf16, causal, one of the smoke's cases):
// the forward's two products are 2 * 2 * B*H*T*T*D / 2 = 2.1 GFLOP, 2.2 us
// at 989 TFLOP/s, against 16.8 MB of q, k, v and out, 5.0 us at 3.35 TB/s:
// bound by bytes. The kernel runs its FMAs on the f32 units (67 TFLOP/s)
// and reads each K/V tile once per 16 query rows: a simple, correct route,
// whose speed is a later PR's work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr float NEG_BIG = -1e30f;      // the TPU kernel's masked-score value
constexpr int THREADS = 128;           // four warps
constexpr int DC = 64;                 // head-dim columns of a chunk
constexpr int LDC = DC + 1;            // chunk row pitch (floats): rows one bank apart
constexpr int QR = 16;                 // forward, dq: query rows a block owns
constexpr int KT = 64;                 // forward, dq: keys of a tile
constexpr int KR = 8;                  // dk/dv: key rows a block owns
constexpr int QT = 64;                 // dk/dv: queries of a tile
constexpr int RPT = 8;                 // forward, dq: rows a thread sums (QR / 2)
constexpr int KPT = 4;                 // dk/dv: key rows a thread sums (KR / 2)
constexpr size_t SMEM_LIMIT = 232448;  // the opt-in shared memory of one block
constexpr int ERR_UNSUPPORTED = -1;

static_assert(THREADS == 2 * KT && THREADS == 2 * DC && THREADS == 2 * QT,
              "a thread owns one key (or query, or column) of half the rows");
static_assert(QR == 2 * RPT && KR == 2 * KPT, "two row halves");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(f16 x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }
template <> __device__ __forceinline__ f16 from_f<f16>(float x) { return __float2half_rn(x); }
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;      // backward only
  const float* lse;      // backward: [B, H, Tq]
  const float* delta;    // backward: [B, H, Tq]
  const float* kmask;    // [B, Tk] key validity (>0 = real key) or nullptr
  void* o;               // forward: out; dq: dq ([B, Tq, H, D]); dk/dv: dk ([B, Tk, H, D])
  void* o2;              // dk/dv: dv
  float* lse_out;        // forward: [B, H, Tq]
  long long q_sb, q_st, q_sh;   // element strides over B, T, H
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;   // dout's
  int B, Tq, Tk, H, D;   // q, dout [B, Tq, H, D]; k, v [B, Tk, H, D]
  int G;                 // columns of a group: the accumulators' row pitch
  int causal;
  int shift;             // q_off - k_off: key k is allowed for query q iff k <= q + shift
  float scale;
};

// The shared-memory floats of each kernel's layout for a group of G columns.
__host__ __device__ constexpr size_t fwd_floats(int G) {
  return size_t(QR) * G + size_t(QR) * LDC + size_t(KT) * LDC + size_t(QR) * (KT + 1) + KT +
         3 * QR;
}
__host__ __device__ constexpr size_t dq_floats(int G) {
  return size_t(QR) * G + 2 * size_t(QR) * LDC + 2 * size_t(KT) * LDC + size_t(QR) * (KT + 1) +
         KT + 2 * QR;
}
__host__ __device__ constexpr size_t dkv_floats(int G) {
  return 2 * size_t(KR) * G + 2 * size_t(KR) * LDC + 2 * size_t(QT) * LDC +
         2 * size_t(KR) * (QT + 1) + 2 * QT + KR;
}

// Rows [t0, t0 + R) x columns [c0, c0 + DC) of one (batch, head) slice into
// dst (pitch LDC) as f32; rows at or past T are zeros. Neighbouring threads
// read neighbouring columns.
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst, const T* base, long long st, int t0,
                                           int R, int T_len, int c0, int tid) {
  for (int i = tid; i < R * DC; i += THREADS) {
    const int r = i / DC, c = i % DC, t = t0 + r;
    dst[r * LDC + c] = t < T_len ? to_f(base[(long long)t * st + c0 + c]) : 0.f;
  }
}

__device__ __forceinline__ bool key_ok(const Params& p, int b, int t) {
  return t < p.Tk && (p.kmask == nullptr || p.kmask[(long long)b * p.Tk + t] > 0.f);
}

// Key tiles of KT keys a block of query rows [q0, q0 + rows) walks: all of
// Tk's, or under a causal mask those up to its last row's last allowed key
// (none when that lies before key 0).
__device__ __forceinline__ int key_tiles(const Params& p, int q0, int rows) {
  const int n = (p.Tk + KT - 1) / KT;
  if (!p.causal) return n;
  const int last = min(q0 + rows, p.Tq) - 1 + p.shift;
  return last < 0 ? 0 : min(n, last / KT + 1);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ===========================================================================
// forward
// ===========================================================================

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_wide_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) float sm[];
  const int D = p.D, Tq = p.Tq, Tk = p.Tk, G = p.G;
  const int g0 = blockIdx.z * G, gw = min(G, D - g0);   // this block's columns
  float* Os = sm;                          // [QR][G] output accumulator
  float* Qc = Os + QR * G;                 // [QR][LDC]
  float* Kc = Qc + QR * LDC;               // [KT][LDC]: a K chunk, then a V chunk
  float* Ps = Kc + KT * LDC;               // [QR][KT + 1]: scores, then p
  float* kval = Ps + QR * (KT + 1);        // [KT]
  float* alpha_s = kval + KT;              // [QR]
  float* m_s = alpha_s + QR;               // [QR] running max
  float* l_s = m_s + QR;                   // [QR] running normaliser

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * QR;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  for (int i = tid; i < QR * G; i += THREADS) Os[i] = 0.f;
  if (tid < QR) {
    m_s[tid] = NEG_BIG;
    l_s[tid] = 0.f;
  }
  const int kk = tid % KT, rs0 = (tid / KT) * RPT;   // scores: one key, 8 rows
  const int cc = tid % DC, ro0 = (tid / DC) * RPT;   // output: one column, 8 rows
  const int n_kt = key_tiles(p, q0, QR);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * KT;
    float acc[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r] = 0.f;
    for (int c0 = 0; c0 < D; c0 += DC) {
      __syncthreads();   // every thread is done with the previous chunks
      load_chunk(Qc, qb, p.q_st, q0, QR, Tq, c0, tid);
      load_chunk(Kc, kb, p.k_st, k0, KT, Tk, c0, tid);
      if (c0 == 0 && tid < KT) kval[tid] = key_ok(p, b, k0 + tid) ? 1.f : 0.f;
      __syncthreads();
      const float* kr = Kc + kk * LDC;
#pragma unroll 8
      for (int d = 0; d < DC; ++d) {
        const float kv = kr[d];
#pragma unroll
        for (int r = 0; r < RPT; ++r) acc[r] = fmaf(Qc[(rs0 + r) * LDC + d], kv, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = rs0 + r;
      const bool ok = kval[kk] > 0.f && (!p.causal || k0 + kk <= q0 + row + p.shift);
      Ps[row * (KT + 1) + kk] = ok ? acc[r] * p.scale : NEG_BIG;
    }
    __syncthreads();
    // online softmax, one warp per row (QR / 4 rows a warp), f32 as on the TPU
    for (int rr = 0; rr < QR / 4; ++rr) {
      const int row = warp * (QR / 4) + rr;
      float* pr = Ps + row * (KT + 1);
      const float s0 = pr[lane], s1 = pr[lane + 32];
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float e0 = expf(s0 - m_new), e1 = expf(s1 - m_new);
      const float sum = warp_sum(e0 + e1);
      pr[lane] = round_to<T>(e0);   // p in the operand type before p . v
      pr[lane + 32] = round_to<T>(e1);
      __syncwarp();
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha_s[row] = a;
        l_s[row] = l_s[row] * a + sum;
        m_s[row] = m_new;
      }
    }
    // O = O * alpha + p . v, chunk by chunk of the group's columns
    for (int c0 = g0; c0 < g0 + gw; c0 += DC) {
      __syncthreads();   // p and alpha written; the previous V chunk read
      load_chunk(Kc, vb, p.v_st, k0, KT, Tk, c0, tid);
      __syncthreads();
      float* orow = Os + c0 - g0 + cc;
      float o[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) o[r] = orow[(ro0 + r) * G] * alpha_s[ro0 + r];
#pragma unroll 4
      for (int k = 0; k < KT; ++k) {
        const float vv = Kc[k * LDC + cc];
#pragma unroll
        for (int r = 0; r < RPT; ++r) o[r] = fmaf(Ps[(ro0 + r) * (KT + 1) + k], vv, o[r]);
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) orow[(ro0 + r) * G] = o[r];
    }
  }
  __syncthreads();
  T* ob = static_cast<T*>(p.o);
  for (int i = tid; i < QR * gw; i += THREADS) {
    const int r = i / gw, c = i % gw, t = q0 + r;
    if (t < Tq)
      ob[(((long long)b * Tq + t) * p.H + h) * D + g0 + c] =
          from_f<T>(Os[r * G + c] / fmaxf(l_s[r], 1e-30f));
  }
  if (blockIdx.z == 0 && tid < QR && q0 + tid < Tq)
    p.lse_out[(long long)bh * Tq + q0 + tid] = m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

// ===========================================================================
// backward: dq
// ===========================================================================

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_wide_dq_kernel(const Params p) {
  extern __shared__ __align__(16) float sm[];
  const int D = p.D, Tq = p.Tq, Tk = p.Tk, G = p.G;
  const int g0 = blockIdx.z * G, gw = min(G, D - g0);   // this block's columns
  float* dQ = sm;                          // [QR][G]
  float* Qc = dQ + QR * G;                 // [QR][LDC]
  float* Oc = Qc + QR * LDC;               // [QR][LDC] do
  float* Kc = Oc + QR * LDC;               // [KT][LDC]
  float* Vc = Kc + KT * LDC;               // [KT][LDC]
  float* DS = Vc + KT * LDC;               // [QR][KT + 1]
  float* kval = DS + QR * (KT + 1);        // [KT]
  float* lse_s = kval + KT;                // [QR]
  float* delta_s = lse_s + QR;             // [QR]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QR;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* ob = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < QR * G; i += THREADS) dQ[i] = 0.f;
  if (tid < QR) {
    const int t = q0 + tid;
    lse_s[tid] = t < Tq ? p.lse[(long long)bh * Tq + t] : 0.f;
    delta_s[tid] = t < Tq ? p.delta[(long long)bh * Tq + t] : 0.f;
  }
  const int kk = tid % KT, rs0 = (tid / KT) * RPT;
  const int cc = tid % DC, ro0 = (tid / DC) * RPT;
  const int n_kt = key_tiles(p, q0, QR);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * KT;
    float s[RPT], dp[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) s[r] = dp[r] = 0.f;
    for (int c0 = 0; c0 < D; c0 += DC) {
      __syncthreads();
      load_chunk(Qc, qb, p.q_st, q0, QR, Tq, c0, tid);
      load_chunk(Oc, ob, p.o_st, q0, QR, Tq, c0, tid);
      load_chunk(Kc, kb, p.k_st, k0, KT, Tk, c0, tid);
      load_chunk(Vc, vb, p.v_st, k0, KT, Tk, c0, tid);
      if (c0 == 0 && tid < KT) kval[tid] = key_ok(p, b, k0 + tid) ? 1.f : 0.f;
      __syncthreads();
      const float* kr = Kc + kk * LDC;
      const float* vr = Vc + kk * LDC;
#pragma unroll 4
      for (int d = 0; d < DC; ++d) {
        const float kv = kr[d], vv = vr[d];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          s[r] = fmaf(Qc[(rs0 + r) * LDC + d], kv, s[r]);
          dp[r] = fmaf(Oc[(rs0 + r) * LDC + d], vv, dp[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = rs0 + r, qpos = q0 + row;
      const bool ok = qpos < Tq && kval[kk] > 0.f && (!p.causal || k0 + kk <= qpos + p.shift);
      const float pv = ok ? expf(s[r] * p.scale - lse_s[row]) : 0.f;
      DS[row * (KT + 1) + kk] = round_to<T>(pv * (dp[r] - delta_s[row]));
    }
    // dQ += ds . k, chunk by chunk of the group's columns
    for (int c0 = g0; c0 < g0 + gw; c0 += DC) {
      __syncthreads();   // ds written; the previous K chunk read
      load_chunk(Kc, kb, p.k_st, k0, KT, Tk, c0, tid);
      __syncthreads();
      float* qrow = dQ + c0 - g0 + cc;
      float a[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) a[r] = qrow[(ro0 + r) * G];
#pragma unroll 4
      for (int k = 0; k < KT; ++k) {
        const float kv = Kc[k * LDC + cc];
#pragma unroll
        for (int r = 0; r < RPT; ++r) a[r] = fmaf(DS[(ro0 + r) * (KT + 1) + k], kv, a[r]);
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) qrow[(ro0 + r) * G] = a[r];
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(p.o);
  for (int i = tid; i < QR * gw; i += THREADS) {
    const int r = i / gw, c = i % gw, t = q0 + r;
    if (t < Tq)
      out[(((long long)b * Tq + t) * p.H + h) * D + g0 + c] = from_f<T>(dQ[r * G + c] * p.scale);
  }
}

// ===========================================================================
// backward: dk, dv
// ===========================================================================

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_wide_dkv_kernel(const Params p) {
  extern __shared__ __align__(16) float sm[];
  const int D = p.D, Tq = p.Tq, Tk = p.Tk, G = p.G;
  const int g0 = blockIdx.z * G, gw = min(G, D - g0);   // this block's columns
  float* dK = sm;                          // [KR][G]
  float* dV = dK + KR * G;                 // [KR][G]
  float* Kc = dV + KR * G;                 // [KR][LDC]
  float* Vc = Kc + KR * LDC;               // [KR][LDC]
  float* Qc = Vc + KR * LDC;               // [QT][LDC]
  float* Oc = Qc + QT * LDC;               // [QT][LDC] do
  float* PT = Oc + QT * LDC;               // [KR][QT + 1] p^T
  float* DST = PT + KR * (QT + 1);         // [KR][QT + 1] ds^T
  float* lse_s = DST + KR * (QT + 1);      // [QT]
  float* delta_s = lse_s + QT;             // [QT]
  float* kval = delta_s + QT;              // [KR]

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * KR;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* ob = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < 2 * KR * G; i += THREADS) dK[i] = 0.f;   // dK and dV
  if (tid < KR) kval[tid] = key_ok(p, b, k0 + tid) ? 1.f : 0.f;
  const int qq = tid % QT, ks0 = (tid / QT) * KPT;   // scores: one query, 4 keys
  const int cc = tid % DC, ko0 = (tid / DC) * KPT;   // sums: one column, 4 keys
  const int n_qt = (Tq + QT - 1) / QT;
  // query tiles wholly before k0 - shift (the first query that may see key
  // k0) see none of the keys
  const int qt0 = p.causal && k0 - p.shift > 0 ? (k0 - p.shift) / QT : 0;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int qs0 = qt * QT;
    float s[KPT], dp[KPT];
#pragma unroll
    for (int r = 0; r < KPT; ++r) s[r] = dp[r] = 0.f;
    for (int c0 = 0; c0 < D; c0 += DC) {
      __syncthreads();
      load_chunk(Qc, qb, p.q_st, qs0, QT, Tq, c0, tid);
      load_chunk(Oc, ob, p.o_st, qs0, QT, Tq, c0, tid);
      load_chunk(Kc, kb, p.k_st, k0, KR, Tk, c0, tid);
      load_chunk(Vc, vb, p.v_st, k0, KR, Tk, c0, tid);
      if (c0 == 0 && tid < QT) {
        const int t = qs0 + tid;
        lse_s[tid] = t < Tq ? p.lse[(long long)bh * Tq + t] : 0.f;
        delta_s[tid] = t < Tq ? p.delta[(long long)bh * Tq + t] : 0.f;
      }
      __syncthreads();
      const float* qr = Qc + qq * LDC;
      const float* orow = Oc + qq * LDC;
#pragma unroll 4
      for (int d = 0; d < DC; ++d) {
        const float qv = qr[d], ov = orow[d];
#pragma unroll
        for (int r = 0; r < KPT; ++r) {
          s[r] = fmaf(Kc[(ks0 + r) * LDC + d], qv, s[r]);
          dp[r] = fmaf(Vc[(ks0 + r) * LDC + d], ov, dp[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < KPT; ++r) {
      const int key = ks0 + r, qpos = qs0 + qq;
      const bool ok = qpos < Tq && kval[key] > 0.f && (!p.causal || k0 + key <= qpos + p.shift);
      const float pv = ok ? expf(s[r] * p.scale - lse_s[qq]) : 0.f;
      PT[key * (QT + 1) + qq] = round_to<T>(pv);
      DST[key * (QT + 1) + qq] = round_to<T>(pv * (dp[r] - delta_s[qq]));
    }
    // dV += p^T . do, dK += ds^T . q, chunk by chunk of the group's columns
    for (int c0 = g0; c0 < g0 + gw; c0 += DC) {
      __syncthreads();   // p^T and ds^T written; the previous chunks read
      load_chunk(Qc, qb, p.q_st, qs0, QT, Tq, c0, tid);
      load_chunk(Oc, ob, p.o_st, qs0, QT, Tq, c0, tid);
      __syncthreads();
      float* vrow = dV + c0 - g0 + cc;
      float* krow = dK + c0 - g0 + cc;
      float av[KPT], ak[KPT];
#pragma unroll
      for (int r = 0; r < KPT; ++r) {
        av[r] = vrow[(ko0 + r) * G];
        ak[r] = krow[(ko0 + r) * G];
      }
#pragma unroll 4
      for (int q = 0; q < QT; ++q) {
        const float ov = Oc[q * LDC + cc], qv = Qc[q * LDC + cc];
#pragma unroll
        for (int r = 0; r < KPT; ++r) {
          av[r] = fmaf(PT[(ko0 + r) * (QT + 1) + q], ov, av[r]);
          ak[r] = fmaf(DST[(ko0 + r) * (QT + 1) + q], qv, ak[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < KPT; ++r) {
        vrow[(ko0 + r) * G] = av[r];
        krow[(ko0 + r) * G] = ak[r];
      }
    }
  }
  __syncthreads();
  T* dk = static_cast<T*>(p.o);
  T* dv = static_cast<T*>(p.o2);
  for (int i = tid; i < KR * gw; i += THREADS) {
    const int r = i / gw, c = i % gw, t = k0 + r;
    if (t < Tk) {
      const long long at = (((long long)b * Tk + t) * p.H + h) * D + g0 + c;
      dk[at] = from_f<T>(dK[r * G + c] * p.scale);
      dv[at] = from_f<T>(dV[r * G + c]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// which: 0 = forward, 1 = dq, 2 = dk/dv; G the accumulators' columns
size_t smem_bytes(int which, int G) {
  const size_t f = which == 0 ? fwd_floats(G) : which == 1 ? dq_floats(G) : dkv_floats(G);
  return f * sizeof(float);
}

bool supported(int D) { return D >= DC && D % DC == 0; }

// The columns of a group at head dim D: D itself where its layout fits one
// block, else D split into the fewest groups whose layouts fit, as evenly as
// 64-column chunks allow (the last group may be narrower).
int group_width(int which, int D) {
  if (smem_bytes(which, D) <= SMEM_LIMIT) return D;
  int gmax = 0;   // the widest group that fits, in chunks
  while (smem_bytes(which, (gmax + 1) * DC) <= SMEM_LIMIT) ++gmax;
  const int chunks = D / DC, groups = (chunks + gmax - 1) / gmax;
  return (chunks + groups - 1) / groups * DC;
}

int n_groups(int which, int D) {
  const int G = group_width(which, D);
  return (D + G - 1) / G;
}

template <typename K>
int launch_kernel(K kernel, int which, Params p, cudaStream_t stream) {
  p.G = group_width(which, p.D);
  const size_t bytes = smem_bytes(which, p.G);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = which == 2 ? KR : QR;
  const int T_own = which == 2 ? p.Tk : p.Tq;   // the rows blocks own: keys or queries
  kernel<<<dim3((T_own + rows - 1) / rows, p.B * p.H, n_groups(which, p.D)), THREADS, bytes,
           stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(int which, const Params& p, cudaStream_t stream) {
  if (which == 0) return launch_kernel(flash_wide_fwd_kernel<T>, 0, p, stream);
  if (which == 1) return launch_kernel(flash_wide_dq_kernel<T>, 1, p, stream);
  return launch_kernel(flash_wide_dkv_kernel<T>, 2, p, stream);
}

int run(int which, const Params& p, int dtype, void* stream) {
  if (!supported(p.D) || p.B < 1 || p.Tq < 1 || p.Tk < 1 || p.H < 1) return ERR_UNSUPPORTED;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_typed<float>(which, p, s);
  if (dtype == 1) return launch_typed<bf16>(which, p, s);
  if (dtype == 2) return launch_typed<f16>(which, p, s);
  return ERR_UNSUPPORTED;
}

Params common(const void* q, const void* k, const void* v, const float* kmask, int B, int Tq,
              int Tk, int H, int D, int causal, int q_off, int k_off, float scale) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.kmask = kmask;
  p.B = B;
  p.Tq = Tq;
  p.Tk = Tk;
  p.H = H;
  p.D = D;
  p.causal = causal;
  p.shift = q_off - k_off;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// The forward, with flash_fwd's arguments: dtype 0 = float32, 1 = bfloat16,
// 2 = float16; D any multiple of 64 (past what one block holds, in column
// groups: flash_wide_groups); strides in elements; out [B, Tq, H, D] contiguous,
// lse [B, H, Tq]. Returns 0 on a clean launch, -1 for an unsupported dtype or
// head dim, else the cudaError_t code.
int flash_wide_fwd(const void* q, const void* k, const void* v, const float* kmask, void* out,
                   float* lse, int B, int Tq, int Tk, int H, int D, int dtype, int causal,
                   int q_off, int k_off, float scale, long long q_sb, long long q_st,
                   long long q_sh, long long k_sb, long long k_st, long long k_sh,
                   long long v_sb, long long v_st, long long v_sh, void* stream) {
  Params p = common(q, k, v, kmask, B, Tq, Tk, H, D, causal, q_off, k_off, scale);
  p.o = out;
  p.lse_out = lse;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  return run(0, p, dtype, stream);
}

// The backward kernels, with flash_bwd_dq's and flash_bwd_dkv's arguments:
// `strides` holds 12 element strides, the B, T, H strides of q, k, v and
// dout in that order; lse and delta are contiguous f32 [B, H, Tq].
int flash_wide_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, const float* kmask, void* dq,
                      int B, int Tq, int Tk, int H, int D, int dtype, int causal, int q_off,
                      int k_off, float scale, const long long* strides, void* stream) {
  Params p = common(q, k, v, kmask, B, Tq, Tk, H, D, causal, q_off, k_off, scale);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.o = dq;
  p.q_sb = strides[0]; p.q_st = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_st = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_st = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_st = strides[10]; p.o_sh = strides[11];
  return run(1, p, dtype, stream);
}

int flash_wide_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, const float* kmask, void* dk,
                       void* dv, int B, int Tq, int Tk, int H, int D, int dtype, int causal,
                       int q_off, int k_off, float scale, const long long* strides,
                       void* stream) {
  Params p = common(q, k, v, kmask, B, Tq, Tk, H, D, causal, q_off, k_off, scale);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.o = dk;
  p.o2 = dv;
  p.q_sb = strides[0]; p.q_st = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_st = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_st = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_st = strides[10]; p.o_sh = strides[11];
  return run(2, p, dtype, stream);
}

// Dynamic shared memory one block of kernel `which` (0 = forward, 1 = dq,
// 2 = dk/dv) takes at head dim D (its column group's layout), or -1 when D
// is unsupported.
long long flash_wide_smem_bytes(int which, int D) {
  if (which < 0 || which > 2 || !supported(D)) return -1;
  return static_cast<long long>(smem_bytes(which, group_width(which, D)));
}

// The column groups (the grid's z extent) of kernel `which` at head dim D,
// or -1 when D is unsupported.
int flash_wide_groups(int which, int D) {
  if (which < 0 || which > 2 || !supported(D)) return -1;
  return n_groups(which, D);
}

const char* flash_wide_error_string(int code) {
  if (code == ERR_UNSUPPORTED) return "unsupported dtype/head dim";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
