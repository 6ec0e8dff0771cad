// Flash-attention backward for Hopper (sm_90a): two kernels with a plain C
// interface (ctypes; see ops/_build.py and ops/flash_attention.py).
//
// Replaces the Pallas TPU kernels of deeplearning4j_tpu/ops/flash_attention.py:
// - `_bwd_dq_kernel`  -> flash_bwd_dq_kernel:
//     dq = scale * sum_k [p * (do . v^T - delta)] . k
// - `_bwd_dkv_kernel` -> flash_bwd_dkv_kernel:
//     dv = sum_q p^T . do ;  dk = scale * sum_q [p * (do . v^T - delta)]^T . q
// with p = exp(q . k^T * scale - lse) where the (query, key) pair is valid
// (key < T, query < T, causal, key mask) and exactly 0 elsewhere; lse is the
// forward kernel's row logsumexp and delta = rowsum(do * out), both f32.
// FlashAttention-2's backward: scores are rebuilt per tile and no [T, T]
// tensor reaches device memory.
//
// Design (what differs from the TPU kernels, and why):
// - Two kernels and no atomics, as on the TPU: the dq kernel owns one
//   64-row query tile per block and loops over key tiles up to the causal
//   diagonal; the dk/dv kernel owns one 64-key tile per block and loops over
//   query tiles from the diagonal on. Every gradient row is summed by one
//   block in one order, so a run repeats bit for bit.
// - Four warps per block, each owning 16 rows of the block's tile (query
//   rows for dq, key rows for dk/dv), so a warp's products and its
//   accumulator rows are its own and no reduction crosses warps.
// - The TPU kernels hold the whole [T, D] K/V (dq) or Q/dO (dk/dv) in VMEM;
//   here they stream through shared memory one tile at a time. The f32
//   accumulators (dq, or dk and dv) live in shared memory, rescaled by
//   nobody, loaded and stored around each tile's product.
// - Masks go into p, never into the scores: a query row with no valid key
//   has lse ~ -1e30 from the forward kernel and exp(s - lse) would not be 0,
//   so only the validity test makes its gradients exactly 0, as on the TPU.
// - Rounding follows the TPU kernels: scores, lse, delta and accumulators are
//   f32; p is cast to the operand type before p^T . do, ds before ds . k and
//   ds^T . q; the final * scale of dq and dk is applied in f32 before the
//   cast to the output type.
// - bf16 operands go through the tensor cores with nvcuda::wmma 16x16x16
//   (f32 accumulate); f32 operands use plain FMAs so f32 keeps f32 accuracy.
//   f32 at D=128 does not fit a 64-query tile of the dk/dv kernel in the
//   227 KB a block may use (K, V, Q, dO, two score tiles and the dk/dv
//   accumulators come to ~270 KB), so f32 streams 32-query tiles there.
//
// Bound at the flagship shape (B=16, H=16, T=2048, D=128, causal, bf16,
// 2,098,176 causal pairs per (batch, head)): dq does three products (S, dP,
// dQ), 6 * B*H*pairs*D = 412.5 GFLOP, 0.417 ms at 989 TFLOP/s; dk/dv does
// four (S, dP, dV, dK), 550 GFLOP, 0.556 ms. Both must move q, k, v, do, lse,
// delta and their gradients once (~1.1 GB over the pair, ~0.32 ms at
// 3.35 TB/s), so both are bound by operations. This first version issues
// wmma from shared memory without asynchronous copies and keeps the
// accumulators in shared memory, so it runs well below that bound; wgmma,
// TMA and register accumulators are the later steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int TILE = 64;             // rows of the block's own tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int WROWS = TILE / WARPS;  // rows per warp (16)

static_assert(WROWS == 16, "a warp's rows are one wmma fragment tall");

constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Row padding (elements) that keeps shared-memory rows off one bank and,
// for bf16, every wmma tile pointer 32-byte aligned.
template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int ROW = 1, P = 4; };
template <> struct Pad<bf16> { static constexpr int ROW = 8, P = 8; };

// Streamed tile height of the dk/dv kernel (query rows per loop step).
template <typename T> struct DkvQ;
template <> struct DkvQ<float> { static constexpr int N = 32; };
template <> struct DkvQ<bf16> { static constexpr int N = 64; };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;     // [B, H, T] contiguous
  const float* delta;   // [B, H, T] contiguous
  const float* kmask;   // [B, T] key validity (>0 = real key) or nullptr
  void* dq;             // [B, T, H, D] contiguous, input dtype
  void* dk;
  void* dv;
  long long q_sb, q_st, q_sh;   // element strides over B, T, H
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;   // of dout
  int B, T, H;
  int causal;
  float scale;
};

__device__ __forceinline__ void put(float* d, float x) { *d = x; }
__device__ __forceinline__ void put(bf16* d, float x) { *d = __float2bfloat16(x); }

__device__ __forceinline__ void store16(bf16* dst, uint4 v) {
  *reinterpret_cast<uint4*>(dst) = v;
}
__device__ __forceinline__ void store16(float* dst, uint4 v) {
  const float* f = reinterpret_cast<const float*>(&v);
  dst[0] = f[0];
  dst[1] = f[1];
  dst[2] = f[2];
  dst[3] = f[3];
}

// Copy `rows` rows [r0, r0 + rows) of one (batch, head) slice into shared
// memory (row pitch LD) in 16-byte chunks; rows at or past T are zero-filled.
template <typename T, int D, int LD>
__device__ void load_rows(T* dst, const T* base, long long stride_t, int r0,
                          int rows, int T_len, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;
  for (int i = tid; i < rows * CPR; i += THREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * VEC;
    const int t = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T_len) {
      val = *reinterpret_cast<const uint4*>(base + (long long)t * stride_t + c);
    }
    store16(dst + r * LD + c, val);
  }
}

// A warp's 16 rows of an A operand [16, D] (row major, pitch LD): wmma
// fragments for bf16, loaded once; for f32 only the shared-memory pointer.
template <typename T, int D, int LD> struct Rows16 {
  const float* p;
  __device__ void load(const float* src) { p = src; }
};
template <int D, int LD> struct Rows16<bf16, D, LD> {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> f[D / 16];
  __device__ void load(const bf16* src) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wmma::load_matrix_sync(f[kk], src + kk * 16, LD);
  }
};

// C[16, N] = A[16, D] . B[N, D]^T   (f32 out, pitch LDC). B: N rows, pitch LD.
template <int D, int LD, int N, int LDC>
__device__ void mm_abt(const Rows16<bf16, D, LD>& a, const bf16* B, float* C, int) {
#pragma unroll
  for (int n = 0; n < N / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // B^T as a column-major operand: element (d, n) at B[n * LD + d]
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
      wmma::load_matrix_sync(bfr, B + n * 16 * LD + kk * 16, LD);
      wmma::mma_sync(acc, a.f[kk], bfr, acc);
    }
    wmma::store_matrix_sync(C + n * 16, acc, LDC, wmma::mem_row_major);
  }
}

template <int D, int LD, int N, int LDC>
__device__ void mm_abt(const Rows16<float, D, LD>& a, const float* B, float* C,
                       int lane) {
  constexpr int NC = N / 32;           // columns lane + 32 * j
  float acc[WROWS][NC];
#pragma unroll
  for (int r = 0; r < WROWS; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float bv[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) bv[j] = B[(lane + 32 * j) * LD + d];
#pragma unroll
    for (int r = 0; r < WROWS; ++r) {
      const float av = a.p[r * LD + d];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[r][j] = fmaf(av, bv[j], acc[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < WROWS; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) C[r * LDC + lane + 32 * j] = acc[r][j];
}

// C[16, D] += A[16, K] . B[K, D]   (C f32, pitch LDC; A pitch LDA; B pitch LDB)
template <int D, int K, int LDA, int LDB, int LDC>
__device__ void mm_ab_acc(const bf16* A, const bf16* B, float* C, int) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[K / 16];
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) wmma::load_matrix_sync(af[kk], A + kk * 16, LDA);
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, C + n * 16, LDC, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
      wmma::load_matrix_sync(bfr, B + kk * 16 * LDB + n * 16, LDB);
      wmma::mma_sync(acc, af[kk], bfr, acc);
    }
    wmma::store_matrix_sync(C + n * 16, acc, LDC, wmma::mem_row_major);
  }
}

template <int D, int K, int LDA, int LDB, int LDC>
__device__ void mm_ab_acc(const float* A, const float* B, float* C, int lane) {
  constexpr int NC = D / 32;           // columns lane + 32 * i
  float acc[WROWS][NC];
#pragma unroll
  for (int r = 0; r < WROWS; ++r)
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = C[r * LDC + lane + 32 * i];
#pragma unroll 2
  for (int kk = 0; kk < K; ++kk) {
    float bv[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) bv[i] = B[kk * LDB + lane + 32 * i];
#pragma unroll
    for (int r = 0; r < WROWS; ++r) {
      const float av = A[r * LDA + kk];
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[r][i] = fmaf(av, bv[i], acc[r][i]);
    }
  }
#pragma unroll
  for (int r = 0; r < WROWS; ++r)
#pragma unroll
    for (int i = 0; i < NC; ++i) C[r * LDC + lane + 32 * i] = acc[r][i];
}

// Key validity of one 64-key tile: inside T and, with a key mask, real.
__device__ void load_kvalid(float* kvalid, const float* kmask, int b, int k0,
                            int T_len, int tid) {
  for (int i = tid; i < TILE; i += THREADS) {
    const int t = k0 + i;
    bool ok = t < T_len;
    if (ok && kmask != nullptr) ok = kmask[(long long)b * T_len + t] > 0.0f;
    kvalid[i] = ok ? 1.0f : 0.0f;
  }
}

// Per-row lse and delta of `rows` query rows from q0 (0 past T).
__device__ void load_rowstats(float* lse_s, float* delta_s, const Params& p,
                              long long bh_off, int q0, int rows, int tid) {
  for (int i = tid; i < rows; i += THREADS) {
    const int t = q0 + i;
    const bool in = t < p.T;
    lse_s[i] = in ? p.lse[bh_off + t] : 0.0f;
    delta_s[i] = in ? p.delta[bh_off + t] : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// dq: one block per (batch*head, 64-row query tile)
// ---------------------------------------------------------------------------

template <typename T, int D>
struct DqSmem {
  static constexpr int LD = D + Pad<T>::ROW;   // Q, dO, K, V rows
  static constexpr int LDS = TILE + 4;         // f32 S and dP
  static constexpr int LDP = TILE + Pad<T>::P; // dS (operand type)
  static constexpr int LDO = D + 4;            // f32 dq accumulator
  static constexpr size_t q = 0;
  static constexpr size_t o = align128(q + size_t(TILE) * LD * sizeof(T));
  static constexpr size_t k = align128(o + size_t(TILE) * LD * sizeof(T));
  static constexpr size_t v = align128(k + size_t(TILE) * LD * sizeof(T));
  static constexpr size_t s = align128(v + size_t(TILE) * LD * sizeof(T));
  static constexpr size_t dp = align128(s + size_t(TILE) * LDS * sizeof(float));
  static constexpr size_t ds = align128(dp + size_t(TILE) * LDS * sizeof(float));
  static constexpr size_t acc = align128(ds + size_t(TILE) * LDP * sizeof(T));
  static constexpr size_t kv = align128(acc + size_t(TILE) * LDO * sizeof(float));
  static constexpr size_t lse = align128(kv + size_t(TILE) * sizeof(float));
  static constexpr size_t delta = align128(lse + size_t(TILE) * sizeof(float));
  static constexpr size_t bytes = align128(delta + size_t(TILE) * sizeof(float));
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(Params p) {
  using L = DqSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::q);
  T* Os = reinterpret_cast<T*>(smem + L::o);
  T* Ks = reinterpret_cast<T*>(smem + L::k);
  T* Vs = reinterpret_cast<T*>(smem + L::v);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  float* DPs = reinterpret_cast<float*>(smem + L::dp);
  T* DSs = reinterpret_cast<T*>(smem + L::ds);
  float* Acc = reinterpret_cast<float*>(smem + L::acc);
  float* kvalid = reinterpret_cast<float*>(smem + L::kv);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = qt * TILE;
  const int T_len = p.T;
  const long long bh_off = ((long long)b * p.H + h) * T_len;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* ob = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;

  load_rows<T, D, L::LD>(Qs, qb, p.q_st, q0, TILE, T_len, tid);
  load_rows<T, D, L::LD>(Os, ob, p.o_st, q0, TILE, T_len, tid);
  load_rowstats(lse_s, delta_s, p, bh_off, q0, TILE, tid);
  for (int i = tid; i < TILE * L::LDO; i += THREADS) Acc[i] = 0.0f;
  __syncthreads();

  const int wr0 = warp * WROWS;            // the warp's first row in the tile
  Rows16<T, D, L::LD> qr, dor;
  qr.load(Qs + wr0 * L::LD);
  dor.load(Os + wr0 * L::LD);
  float* S_w = Ss + wr0 * L::LDS;
  float* DP_w = DPs + wr0 * L::LDS;
  T* DS_w = DSs + wr0 * L::LDP;
  float* Acc_w = Acc + wr0 * L::LDO;

  int n_kt = (T_len + TILE - 1) / TILE;
  if (p.causal) n_kt = min(n_kt, qt + 1);   // no key tile above the diagonal

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();   // every warp is done with the previous K/V tile
    load_rows<T, D, L::LD>(Ks, kb, p.k_st, k0, TILE, T_len, tid);
    load_rows<T, D, L::LD>(Vs, vb, p.v_st, k0, TILE, T_len, tid);
    load_kvalid(kvalid, p.kmask, b, k0, T_len, tid);
    __syncthreads();

    mm_abt<D, L::LD, TILE, L::LDS>(qr, Ks, S_w, lane);    // S  = Q . K^T
    mm_abt<D, L::LD, TILE, L::LDS>(dor, Vs, DP_w, lane);  // dP = dO . V^T
    __syncwarp();

    for (int i = lane; i < WROWS * TILE; i += 32) {
      const int r = i / TILE;
      const int c = i % TILE;
      const int qpos = q0 + wr0 + r;
      const int kpos = k0 + c;
      const bool ok = kvalid[c] > 0.0f && qpos < T_len && (!p.causal || kpos <= qpos);
      const float pr = ok ? expf(S_w[r * L::LDS + c] * p.scale - lse_s[wr0 + r]) : 0.0f;
      put(DS_w + r * L::LDP + c, pr * (DP_w[r * L::LDS + c] - delta_s[wr0 + r]));
    }
    __syncwarp();

    mm_ab_acc<D, TILE, L::LDP, L::LD, L::LDO>(DS_w, Ks, Acc_w, lane);  // dQ += dS . K
  }

  __syncwarp();
  T* out = static_cast<T*>(p.dq);
  for (int i = lane; i < WROWS * D; i += 32) {
    const int r = i / D;
    const int c = i % D;
    const int t = q0 + wr0 + r;
    if (t < T_len) {
      put(out + (((long long)b * T_len + t) * p.H + h) * D + c,
          Acc_w[r * L::LDO + c] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dk/dv: one block per (batch*head, 64-key tile)
// ---------------------------------------------------------------------------

template <typename T, int D>
struct DkvSmem {
  static constexpr int BQ = DkvQ<T>::N;        // streamed query rows
  static constexpr int LD = D + Pad<T>::ROW;   // K, V, Q, dO rows
  static constexpr int LDS = BQ + 4;           // f32 S^T and dP^T
  static constexpr int LDP = BQ + Pad<T>::P;   // P^T and dS^T (operand type)
  static constexpr int LDO = D + 4;            // f32 dk and dv accumulators
  static constexpr size_t k = 0;
  static constexpr size_t v = align128(k + size_t(TILE) * LD * sizeof(T));
  static constexpr size_t q = align128(v + size_t(TILE) * LD * sizeof(T));
  static constexpr size_t o = align128(q + size_t(BQ) * LD * sizeof(T));
  static constexpr size_t s = align128(o + size_t(BQ) * LD * sizeof(T));
  static constexpr size_t dp = align128(s + size_t(TILE) * LDS * sizeof(float));
  static constexpr size_t pt = align128(dp + size_t(TILE) * LDS * sizeof(float));
  static constexpr size_t ds = align128(pt + size_t(TILE) * LDP * sizeof(T));
  static constexpr size_t dk = align128(ds + size_t(TILE) * LDP * sizeof(T));
  static constexpr size_t dv = align128(dk + size_t(TILE) * LDO * sizeof(float));
  static constexpr size_t kv = align128(dv + size_t(TILE) * LDO * sizeof(float));
  static constexpr size_t lse = align128(kv + size_t(TILE) * sizeof(float));
  static constexpr size_t delta = align128(lse + size_t(BQ) * sizeof(float));
  static constexpr size_t bytes = align128(delta + size_t(BQ) * sizeof(float));
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(Params p) {
  using L = DkvSmem<T, D>;
  constexpr int BQ = L::BQ;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + L::k);
  T* Vs = reinterpret_cast<T*>(smem + L::v);
  T* Qs = reinterpret_cast<T*>(smem + L::q);
  T* Os = reinterpret_cast<T*>(smem + L::o);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  float* DPs = reinterpret_cast<float*>(smem + L::dp);
  T* Ps = reinterpret_cast<T*>(smem + L::pt);
  T* DSs = reinterpret_cast<T*>(smem + L::ds);
  float* dK = reinterpret_cast<float*>(smem + L::dk);
  float* dV = reinterpret_cast<float*>(smem + L::dv);
  float* kvalid = reinterpret_cast<float*>(smem + L::kv);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = kt * TILE;
  const int T_len = p.T;
  const long long bh_off = ((long long)b * p.H + h) * T_len;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* ob = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;

  load_rows<T, D, L::LD>(Ks, kb, p.k_st, k0, TILE, T_len, tid);
  load_rows<T, D, L::LD>(Vs, vb, p.v_st, k0, TILE, T_len, tid);
  load_kvalid(kvalid, p.kmask, b, k0, T_len, tid);
  for (int i = tid; i < TILE * L::LDO; i += THREADS) {
    dK[i] = 0.0f;
    dV[i] = 0.0f;
  }
  __syncthreads();

  const int wr0 = warp * WROWS;            // the warp's first key row
  Rows16<T, D, L::LD> kr, vr;
  kr.load(Ks + wr0 * L::LD);
  vr.load(Vs + wr0 * L::LD);
  float* S_w = Ss + wr0 * L::LDS;
  float* DP_w = DPs + wr0 * L::LDS;
  T* P_w = Ps + wr0 * L::LDP;
  T* DS_w = DSs + wr0 * L::LDP;
  float* dK_w = dK + wr0 * L::LDO;
  float* dV_w = dV + wr0 * L::LDO;

  const int n_qt = (T_len + BQ - 1) / BQ;
  // query tiles wholly above this key tile's first key see none of it
  const int qt0 = p.causal ? k0 / BQ : 0;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();   // every warp is done with the previous Q/dO tile
    load_rows<T, D, L::LD>(Qs, qb, p.q_st, q0, BQ, T_len, tid);
    load_rows<T, D, L::LD>(Os, ob, p.o_st, q0, BQ, T_len, tid);
    load_rowstats(lse_s, delta_s, p, bh_off, q0, BQ, tid);
    __syncthreads();

    mm_abt<D, L::LD, BQ, L::LDS>(kr, Qs, S_w, lane);    // S^T  = K . Q^T
    mm_abt<D, L::LD, BQ, L::LDS>(vr, Os, DP_w, lane);   // dP^T = V . dO^T
    __syncwarp();

    for (int i = lane; i < WROWS * BQ; i += 32) {
      const int r = i / BQ;              // key row of the warp
      const int c = i % BQ;              // query column
      const int kpos = k0 + wr0 + r;
      const int qpos = q0 + c;
      const bool ok = kvalid[wr0 + r] > 0.0f && qpos < T_len &&
                      (!p.causal || kpos <= qpos);
      const float pr = ok ? expf(S_w[r * L::LDS + c] * p.scale - lse_s[c]) : 0.0f;
      put(P_w + r * L::LDP + c, pr);
      put(DS_w + r * L::LDP + c, pr * (DP_w[r * L::LDS + c] - delta_s[c]));
    }
    __syncwarp();

    mm_ab_acc<D, BQ, L::LDP, L::LD, L::LDO>(P_w, Os, dV_w, lane);   // dV += P^T . dO
    mm_ab_acc<D, BQ, L::LDP, L::LD, L::LDO>(DS_w, Qs, dK_w, lane);  // dK += dS^T . Q
  }

  __syncwarp();
  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
  for (int i = lane; i < WROWS * D; i += 32) {
    const int r = i / D;
    const int c = i % D;
    const int t = k0 + wr0 + r;
    if (t < T_len) {
      const long long off = (((long long)b * T_len + t) * p.H + h) * D + c;
      put(dk_out + off, dK_w[r * L::LDO + c] * p.scale);
      put(dv_out + off, dV_w[r * L::LDO + c]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int D>
int launch_dq(const Params& p, cudaStream_t stream) {
  using L = DqSmem<T, D>;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L::bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.T + TILE - 1) / TILE, p.B * p.H);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, L::bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const Params& p, cudaStream_t stream) {
  using L = DkvSmem<T, D>;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L::bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.T + TILE - 1) / TILE, p.B * p.H);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, L::bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int which, const Params& p, int D, cudaStream_t s) {
  switch (D) {
    case 32: return which == 0 ? launch_dq<T, 32>(p, s) : launch_dkv<T, 32>(p, s);
    case 64: return which == 0 ? launch_dq<T, 64>(p, s) : launch_dkv<T, 64>(p, s);
    case 128: return which == 0 ? launch_dq<T, 128>(p, s) : launch_dkv<T, 128>(p, s);
    default: return -1;
  }
}

template <typename T>
long long smem_d(int which, int D) {
  switch (D) {
    case 32: return which == 0 ? DqSmem<T, 32>::bytes : DkvSmem<T, 32>::bytes;
    case 64: return which == 0 ? DqSmem<T, 64>::bytes : DkvSmem<T, 64>::bytes;
    case 128: return which == 0 ? DqSmem<T, 128>::bytes : DkvSmem<T, 128>::bytes;
    default: return -1;
  }
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, const float* kmask,
                   int B, int T, int H, int causal, float scale,
                   const long long* strides) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.kmask = kmask;
  p.dq = nullptr;
  p.dk = nullptr;
  p.dv = nullptr;
  p.q_sb = strides[0]; p.q_st = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_st = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_st = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_st = strides[10]; p.o_sh = strides[11];
  p.B = B;
  p.T = T;
  p.H = H;
  p.causal = causal;
  p.scale = scale;
  return p;
}

int run(int which, Params& p, int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(which, p, D, s);
  if (dtype == 1) return dispatch<bf16>(which, p, D, s);
  return -1;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. `strides` holds 12 element strides: the
// B, T, H strides of q, k, v and dout, in that order. Returns 0 on a clean
// launch, -1 for an unsupported dtype/D, else the cudaError_t code.
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, const float* kmask,
                 void* dq, int B, int T, int H, int D, int dtype, int causal,
                 float scale, const long long* strides, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, kmask, B, T, H, causal, scale,
                         strides);
  p.dq = dq;
  return run(0, p, D, dtype, stream);
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, const float* kmask,
                  void* dk, void* dv, int B, int T, int H, int D, int dtype,
                  int causal, float scale, const long long* strides, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, kmask, B, T, H, causal, scale,
                         strides);
  p.dk = dk;
  p.dv = dv;
  return run(1, p, D, dtype, stream);
}

// Dynamic shared memory one block of kernel `which` (0 = dq, 1 = dk/dv)
// takes, or -1 when unsupported.
long long flash_bwd_smem_bytes(int which, int dtype, int D) {
  if (dtype == 0) return smem_d<float>(which, D);
  if (dtype == 1) return smem_d<bf16>(which, D);
  return -1;
}

const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
