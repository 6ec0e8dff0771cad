// Flash-attention backward for Hopper (sm_90a): two kernels with a plain C
// interface (ctypes; see ops/_build.py and ops/flash_attention.py).
//
// Replaces the Pallas TPU kernels of deeplearning4j_tpu/ops/flash_attention.py:
// - `_bwd_dq_kernel`  -> flash_bwd_dq_wgmma_kernel (bf16), flash_bwd_dq_kernel (f32):
//     dq = scale * sum_k [p * (do . v^T - delta)] . k
// - `_bwd_dkv_kernel` -> flash_bwd_dkv_wgmma_kernel (bf16), flash_bwd_dkv_kernel (f32):
//     dv = sum_q p^T . do ;  dk = scale * sum_q [p * (do . v^T - delta)]^T . q
// with p = exp(q . k^T * scale - lse) where the (query, key) pair is valid
// (key < Tk, query < Tq, causal, key mask) and exactly 0 elsewhere; lse is the
// forward kernel's row logsumexp and delta = rowsum(do * out), both f32.
// Queries and keys may differ in length and sit at absolute offsets (the
// chunk entries flash_attention_block_grad, ring attention's blocks): the
// causal rule is k_off + k <= q_off + q, a key k allowed for a query q when
// k <= q + shift (shift = q_off - k_off), and the early exits (dq's last key
// tile, dk/dv's first query tile, a warpgroup's skipped tile) are taken
// against that shifted diagonal, as flash_fwd.cu does. The chunk entries'
// lse cotangent dlse reaches these kernels folded into delta
// (delta = rowsum(do * out) - dlse, flash_attention.py:617-619), so they
// need no other change for it.
// FlashAttention-2's backward: scores are rebuilt per tile and no [T, T]
// tensor reaches device memory.
//
// Rules both dtypes keep:
// - Two kernels and no atomics, as on the TPU: the dq kernel owns query
//   rows and loops over key tiles up to the causal diagonal; the dk/dv
//   kernel owns key rows and loops over query tiles from the diagonal on.
//   Every gradient row is summed by one block in one order, so a run
//   repeats bit for bit. (FlashAttention-2's one-kernel backward does 5
//   products where these do 7, but needs atomic adds into dq.)
// - Masks go into p, never into the scores: a query row with no valid key
//   has lse ~ -1e30 from the forward kernel and exp(s - lse) would not be 0,
//   so only the validity test makes its gradients exactly 0, as on the TPU.
// - Rounding follows the TPU kernels: scores, lse, delta and accumulators are
//   f32; p is cast to the operand type before p^T . do, ds before ds . k and
//   ds^T . q; the final * scale of dq and dk is applied in f32 before the
//   cast to the output type.
//
// bf16 and f16: the Hopper design (f16 takes the same layouts and another
// type in the wgmma instruction and the tensor maps). Each block is three
// warpgroups: two consumer warpgroups of 64 rows each (128 query rows for
// dq, 128 key rows for dk/dv) and one producer warpgroup whose first warp
// feeds them. At D=256 (sm90_common.cuh Cfg) a block owns 64 rows, which
// both consumer warpgroups share: each computes the same scores and sums
// half of D's output columns, so its accumulators stay the size they have
// at D=128, and the ring has two slots.
// - The block's own 128 rows (Q and dO for dq; K and V for dk/dv) are
//   loaded once. The other side streams in 64-row tiles (K/V for dq; Q, dO,
//   lse and delta for dk/dv) through a ring of STAGES slots in shared
//   memory, with an mbarrier per slot for "full" and one for "empty".
// - Copies are TMA: one 4-D tensor map per operand over its strided
//   [B, T, H, D] view (the fused-qkv split views need no copy), boxes of
//   64 rows x 128 bytes (64 bytes at D=32) landing in the swizzled layout
//   that wgmma reads; rows at or past T arrive as zeros. The producer warp's
//   lanes fill the per-tile key validity (dq) or lse and delta (dk/dv) into
//   the same slot and arrive on its "full" barrier with the TMA bytes.
// - Products are wgmma with f32 accumulators in registers. dq: S = Q.K^T and
//   dP = dO.V^T (m64n64k16, both operands in shared memory, K-major), then
//   dQ += dS.K with dS as the register A operand and K as the MN-major B
//   operand. dk/dv: S^T = K.Q^T and dP^T = V.dO^T land already transposed,
//   so P^T and dS^T are register A operands of dV += P^T.dO and
//   dK += dS^T.Q with dO and Q as MN-major B operands: no transposed copy.
//   An f32 accumulator fragment of wgmma is, pair for pair, the bf16 A
//   fragment of the next wgmma, so p and ds never touch shared memory.
// - p and ds are built in registers: each thread's accumulator entries map
//   to known (row, column) pairs, the row's lse and delta sit in registers
//   (dq) or are read per column from the slot (dk/dv), and the validity
//   test covers causal, T and the key mask.
// - setmaxnreg gives each consumer thread 232 registers and the producer 40.
//   dk/dv holds 2 x D/2 f32 accumulators a thread (128 at D=128) and takes
//   each 64-query tile in two halves of 32 (m64n32 scores) so that S^T,
//   dP^T and their bf16 fragments fit beside them without spilling.
// - Blocks are numbered so that, under a causal mask, the tiles with the
//   most work start first and the short ones fill the tail.
// What this does about the first version's five costs: accumulators were in
// shared memory (now registers); S and dP went through shared memory as f32
// and back as bf16 (now registers only); copies were synchronous behind
// __syncthreads (now TMA into a ring, overlapped with the other slots' math
// and with the other consumer warpgroup); four warps per SM (now eight
// consumer warps and a producer); legacy mma.sync via wmma (now wgmma).
// Budget per instantiation: 168 registers a thread at launch
// (__launch_bounds__(384, 1)), then 232 a consumer and 40 a producer thread;
// no spills (nvcc 12.9). Dynamic shared memory, a ring of STAGES = 3 slots:
//   dq   D=32 / 64 / 128: 42,808 / 83,768 / 165,688 B (D=256, 2 slots: 198,184)
//   dkv  D=32 / 64 / 128: 43,576 / 84,536 / 166,456 B (D=256, 2 slots: 198,696)
// (DqLayout and DkvLayout; flash_bwd_smem_bytes reports them), so one block
// of 12 warps per SM.
//
// f32 keeps the first version's design: one block of four warps per 64-row
// tile (at D = 256 the tiles hold D in chunks of 64, Chunk below), tiles loaded synchronously into padded shared memory, plain FMAs so
// that f32 keeps f32 accuracy, accumulators in shared memory. f32 at D=128
// does not fit a 64-query tile of the dk/dv kernel in 227 KB, so f32
// streams 32-query tiles there.
//
// Bound at the flagship shape (B=16, H=16, T=2048, D=128, causal, bf16,
// 2,098,176 causal pairs per (batch, head)): dq does three products (S, dP,
// dQ), 6 * B*H*pairs*D = 412.5 GFLOP, 0.417 ms at 989 TFLOP/s; dk/dv does
// four (S, dP, dV, dK), 550 GFLOP, 0.556 ms. Both must move q, k, v, do, lse,
// delta and their gradients once (~1.1 GB over the pair, ~0.32 ms at
// 3.35 TB/s), so both are bound by operations.

#include "sm90_common.cuh"   // the Hopper helpers shared with flash_fwd.cu

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;     // [B, H, Tq] contiguous
  const float* delta;   // [B, H, Tq] contiguous
  const float* kmask;   // [B, Tk] key validity (>0 = real key) or nullptr
  void* dq;             // [B, Tq, H, D] contiguous, input dtype
  void* dk;             // [B, Tk, H, D]
  void* dv;
  long long q_sb, q_st, q_sh;   // element strides over B, T, H
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;   // of dout
  int B, Tq, Tk, H;     // q, dout [B, Tq, H, D]; k, v [B, Tk, H, D]
  int causal;
  int q_off, k_off;     // absolute positions of query 0 and key 0 (causal rule)
  float scale;
};

// ===========================================================================
// f32: FMA kernels, one block of four warps per 64-row tile
// ===========================================================================

constexpr int TILE = 64;             // rows of the block's own tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int WROWS = TILE / WARPS;  // rows per warp (16)
constexpr int LDPAD = 1;             // row padding (elements): rows off one bank
constexpr int PPAD = 4;
constexpr int DKV_BQ = 32;           // streamed query rows of the dk/dv kernel

// The head-dim columns of a tile the f32 kernels hold at once: all of D up
// to 128; at D = 256 chunks of 64, whose products are summed chunk by chunk
// (S, dP) or written chunk by chunk (dq, dk, dv), so that the tiles and the
// [64, D] accumulators fit 227 KB.
template <int D> struct Chunk {
  static constexpr int DC = D <= 128 ? D : 64;
  static constexpr int N = D / DC;
};

// Copy `rows` rows [r0, r0 + rows) of one (batch, head) slice into shared
// memory (row pitch LD) in 16-byte chunks; rows at or past T are zero-filled.
template <int D, int LD>
__device__ void load_rows(float* dst, const float* base, long long stride_t, int r0,
                          int rows, int T_len, int tid) {
  constexpr int CPR = D / 4;
  for (int i = tid; i < rows * CPR; i += THREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * 4;
    const int t = r0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < T_len) {
      val = *reinterpret_cast<const float4*>(base + (long long)t * stride_t + c);
    }
    float* d = dst + r * LD + c;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

// C[16, N] (+)= A[16, D] . B[N, D]^T (pitch LDC; ACC adds to C, as the
// chunks of D = 256 do). A: the warp's 16 rows, pitch LD; B: N rows, pitch LD.
template <int D, int LD, int N, int LDC, bool ACC = false>
__device__ void mm_abt(const float* A, const float* B, float* C, int lane) {
  constexpr int NC = N / 32;           // columns lane + 32 * j
  float acc[WROWS][NC];
#pragma unroll
  for (int r = 0; r < WROWS; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = ACC ? C[r * LDC + lane + 32 * j] : 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float bv[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) bv[j] = B[(lane + 32 * j) * LD + d];
#pragma unroll
    for (int r = 0; r < WROWS; ++r) {
      const float av = A[r * LD + d];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[r][j] = fmaf(av, bv[j], acc[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < WROWS; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) C[r * LDC + lane + 32 * j] = acc[r][j];
}

// C[16, D] += A[16, K] . B[K, D]   (C pitch LDC; A pitch LDA; B pitch LDB)
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

// Key validity of one 64-key tile: inside Tk and, with a key mask, real.
__device__ void load_kvalid(float* kvalid, const float* kmask, int b, int k0,
                            int T_len, int tid) {
  for (int i = tid; i < TILE; i += THREADS) {
    const int t = k0 + i;
    bool ok = t < T_len;
    if (ok && kmask != nullptr) ok = kmask[(long long)b * T_len + t] > 0.0f;
    kvalid[i] = ok ? 1.0f : 0.0f;
  }
}

// Per-row lse and delta of `rows` query rows from q0 (0 past Tq).
__device__ void load_rowstats(float* lse_s, float* delta_s, const Params& p,
                              long long bh_off, int q0, int rows, int tid) {
  for (int i = tid; i < rows; i += THREADS) {
    const int t = q0 + i;
    const bool in = t < p.Tq;
    lse_s[i] = in ? p.lse[bh_off + t] : 0.0f;
    delta_s[i] = in ? p.delta[bh_off + t] : 0.0f;
  }
}

// dq: one block per (batch*head, 64-row query tile)
template <typename T, int D>
struct DqSmem {
  static constexpr int LD = Chunk<D>::DC + LDPAD;   // Q, dO, K, V rows
  static constexpr int LDS = TILE + 4;         // S and dP
  static constexpr int LDP = TILE + PPAD;      // dS
  static constexpr int LDO = D + 4;            // dq accumulator
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
  const int Tq = p.Tq, Tk = p.Tk;
  const int shift = p.q_off - p.k_off;   // key k is allowed for query q iff k <= q + shift
  const long long bh_off = ((long long)b * p.H + h) * Tq;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* ob = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;

  constexpr int DC = Chunk<D>::DC, NCH = Chunk<D>::N;
  if constexpr (NCH == 1) {
    load_rows<D, L::LD>(Qs, qb, p.q_st, q0, TILE, Tq, tid);
    load_rows<D, L::LD>(Os, ob, p.o_st, q0, TILE, Tq, tid);
  }
  load_rowstats(lse_s, delta_s, p, bh_off, q0, TILE, tid);
  for (int i = tid; i < TILE * L::LDO; i += THREADS) Acc[i] = 0.0f;
  __syncthreads();

  const int wr0 = warp * WROWS;            // the warp's first row in the tile
  const T* Q_w = Qs + wr0 * L::LD;
  const T* O_w = Os + wr0 * L::LD;
  float* S_w = Ss + wr0 * L::LDS;
  float* DP_w = DPs + wr0 * L::LDS;
  T* DS_w = DSs + wr0 * L::LDP;
  float* Acc_w = Acc + wr0 * L::LDO;

  int n_kt = (Tk + TILE - 1) / TILE;
  if (p.causal) {   // no key tile above the (shifted) diagonal
    const int last = q0 + TILE - 1 + shift;   // the last key a row of the tile may see
    n_kt = last < 0 ? 0 : min(n_kt, last / TILE + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();   // every warp is done with the previous K/V tile
    load_kvalid(kvalid, p.kmask, b, k0, Tk, tid);
    if constexpr (NCH == 1) {
      load_rows<D, L::LD>(Ks, kb, p.k_st, k0, TILE, Tk, tid);
      load_rows<D, L::LD>(Vs, vb, p.v_st, k0, TILE, Tk, tid);
      __syncthreads();
      mm_abt<D, L::LD, TILE, L::LDS>(Q_w, Ks, S_w, lane);    // S  = Q . K^T
      mm_abt<D, L::LD, TILE, L::LDS>(O_w, Vs, DP_w, lane);   // dP = dO . V^T
    } else {   // S and dP summed over the chunks of D
      for (int c = 0; c < NCH; ++c) {
        if (c > 0) __syncthreads();   // every warp is done with the previous chunk
        load_rows<DC, L::LD>(Qs, qb + c * DC, p.q_st, q0, TILE, Tq, tid);
        load_rows<DC, L::LD>(Os, ob + c * DC, p.o_st, q0, TILE, Tq, tid);
        load_rows<DC, L::LD>(Ks, kb + c * DC, p.k_st, k0, TILE, Tk, tid);
        load_rows<DC, L::LD>(Vs, vb + c * DC, p.v_st, k0, TILE, Tk, tid);
        __syncthreads();
        if (c == 0) {
          mm_abt<DC, L::LD, TILE, L::LDS>(Q_w, Ks, S_w, lane);
          mm_abt<DC, L::LD, TILE, L::LDS>(O_w, Vs, DP_w, lane);
        } else {
          mm_abt<DC, L::LD, TILE, L::LDS, true>(Q_w, Ks, S_w, lane);
          mm_abt<DC, L::LD, TILE, L::LDS, true>(O_w, Vs, DP_w, lane);
        }
      }
    }
    __syncwarp();

    for (int i = lane; i < WROWS * TILE; i += 32) {
      const int r = i / TILE;
      const int c = i % TILE;
      const int qpos = q0 + wr0 + r;
      const int kpos = k0 + c;
      const bool ok = kvalid[c] > 0.0f && qpos < Tq && (!p.causal || kpos <= qpos + shift);
      const float pr = ok ? expf(S_w[r * L::LDS + c] * p.scale - lse_s[wr0 + r]) : 0.0f;
      DS_w[r * L::LDP + c] = pr * (DP_w[r * L::LDS + c] - delta_s[wr0 + r]);
    }
    __syncwarp();

    if constexpr (NCH == 1) {
      mm_ab_acc<D, TILE, L::LDP, L::LD, L::LDO>(DS_w, Ks, Acc_w, lane);  // dQ += dS . K
    } else {   // dQ written chunk by chunk of D
      for (int c = 0; c < NCH; ++c) {
        __syncthreads();   // every warp is done with the previous K chunk
        load_rows<DC, L::LD>(Ks, kb + c * DC, p.k_st, k0, TILE, Tk, tid);
        __syncthreads();
        mm_ab_acc<DC, TILE, L::LDP, L::LD, L::LDO>(DS_w, Ks, Acc_w + c * DC, lane);
      }
    }
  }

  __syncwarp();
  T* out = static_cast<T*>(p.dq);
  for (int i = lane; i < WROWS * D; i += 32) {
    const int r = i / D;
    const int c = i % D;
    const int t = q0 + wr0 + r;
    if (t < Tq) {
      out[(((long long)b * Tq + t) * p.H + h) * D + c] = Acc_w[r * L::LDO + c] * p.scale;
    }
  }
}

// dk/dv: one block per (batch*head, 64-key tile)
template <typename T, int D>
struct DkvSmem {
  static constexpr int BQ = DKV_BQ;            // streamed query rows
  static constexpr int LD = Chunk<D>::DC + LDPAD;   // K, V, Q, dO rows
  static constexpr int LDS = BQ + 4;           // S^T and dP^T
  static constexpr int LDP = BQ + PPAD;        // P^T and dS^T
  static constexpr int LDO = D + 4;            // dk and dv accumulators
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
  const int Tq = p.Tq, Tk = p.Tk;
  const int shift = p.q_off - p.k_off;   // key k is allowed for query q iff k <= q + shift
  const long long bh_off = ((long long)b * p.H + h) * Tq;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* ob = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;

  constexpr int DC = Chunk<D>::DC, NCH = Chunk<D>::N;
  if constexpr (NCH == 1) {
    load_rows<D, L::LD>(Ks, kb, p.k_st, k0, TILE, Tk, tid);
    load_rows<D, L::LD>(Vs, vb, p.v_st, k0, TILE, Tk, tid);
  }
  load_kvalid(kvalid, p.kmask, b, k0, Tk, tid);
  for (int i = tid; i < TILE * L::LDO; i += THREADS) {
    dK[i] = 0.0f;
    dV[i] = 0.0f;
  }
  __syncthreads();

  const int wr0 = warp * WROWS;            // the warp's first key row
  const T* K_w = Ks + wr0 * L::LD;
  const T* V_w = Vs + wr0 * L::LD;
  float* S_w = Ss + wr0 * L::LDS;
  float* DP_w = DPs + wr0 * L::LDS;
  T* P_w = Ps + wr0 * L::LDP;
  T* DS_w = DSs + wr0 * L::LDP;
  float* dK_w = dK + wr0 * L::LDO;
  float* dV_w = dV + wr0 * L::LDO;

  const int n_qt = (Tq + BQ - 1) / BQ;
  // query tiles wholly above this key tile's first key see none of it: the
  // first query that may see key k0 is k0 - shift
  const int qt0 = p.causal && k0 - shift > 0 ? (k0 - shift) / BQ : 0;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();   // every warp is done with the previous Q/dO tile
    load_rowstats(lse_s, delta_s, p, bh_off, q0, BQ, tid);
    if constexpr (NCH == 1) {
      load_rows<D, L::LD>(Qs, qb, p.q_st, q0, BQ, Tq, tid);
      load_rows<D, L::LD>(Os, ob, p.o_st, q0, BQ, Tq, tid);
      __syncthreads();
      mm_abt<D, L::LD, BQ, L::LDS>(K_w, Qs, S_w, lane);    // S^T  = K . Q^T
      mm_abt<D, L::LD, BQ, L::LDS>(V_w, Os, DP_w, lane);   // dP^T = V . dO^T
    } else {   // S^T and dP^T summed over the chunks of D
      for (int c = 0; c < NCH; ++c) {
        if (c > 0) __syncthreads();   // every warp is done with the previous chunk
        load_rows<DC, L::LD>(Ks, kb + c * DC, p.k_st, k0, TILE, Tk, tid);
        load_rows<DC, L::LD>(Vs, vb + c * DC, p.v_st, k0, TILE, Tk, tid);
        load_rows<DC, L::LD>(Qs, qb + c * DC, p.q_st, q0, BQ, Tq, tid);
        load_rows<DC, L::LD>(Os, ob + c * DC, p.o_st, q0, BQ, Tq, tid);
        __syncthreads();
        if (c == 0) {
          mm_abt<DC, L::LD, BQ, L::LDS>(K_w, Qs, S_w, lane);
          mm_abt<DC, L::LD, BQ, L::LDS>(V_w, Os, DP_w, lane);
        } else {
          mm_abt<DC, L::LD, BQ, L::LDS, true>(K_w, Qs, S_w, lane);
          mm_abt<DC, L::LD, BQ, L::LDS, true>(V_w, Os, DP_w, lane);
        }
      }
    }
    __syncwarp();

    for (int i = lane; i < WROWS * BQ; i += 32) {
      const int r = i / BQ;              // key row of the warp
      const int c = i % BQ;              // query column
      const int kpos = k0 + wr0 + r;
      const int qpos = q0 + c;
      const bool ok = kvalid[wr0 + r] > 0.0f && qpos < Tq &&
                      (!p.causal || kpos <= qpos + shift);
      const float pr = ok ? expf(S_w[r * L::LDS + c] * p.scale - lse_s[c]) : 0.0f;
      P_w[r * L::LDP + c] = pr;
      DS_w[r * L::LDP + c] = pr * (DP_w[r * L::LDS + c] - delta_s[c]);
    }
    __syncwarp();

    if constexpr (NCH == 1) {
      mm_ab_acc<D, BQ, L::LDP, L::LD, L::LDO>(P_w, Os, dV_w, lane);   // dV += P^T . dO
      mm_ab_acc<D, BQ, L::LDP, L::LD, L::LDO>(DS_w, Qs, dK_w, lane);  // dK += dS^T . Q
    } else {   // dV and dK written chunk by chunk of D
      for (int c = 0; c < NCH; ++c) {
        __syncthreads();   // every warp is done with the previous Q/dO chunk
        load_rows<DC, L::LD>(Qs, qb + c * DC, p.q_st, q0, BQ, Tq, tid);
        load_rows<DC, L::LD>(Os, ob + c * DC, p.o_st, q0, BQ, Tq, tid);
        __syncthreads();
        mm_ab_acc<DC, BQ, L::LDP, L::LD, L::LDO>(P_w, Os, dV_w + c * DC, lane);
        mm_ab_acc<DC, BQ, L::LDP, L::LD, L::LDO>(DS_w, Qs, dK_w + c * DC, lane);
      }
    }
  }

  __syncwarp();
  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
  for (int i = lane; i < WROWS * D; i += 32) {
    const int r = i / D;
    const int c = i % D;
    const int t = k0 + wr0 + r;
    if (t < Tk) {
      const long long off = (((long long)b * Tk + t) * p.H + h) * D + c;
      dk_out[off] = dK_w[r * L::LDO + c] * p.scale;
      dv_out[off] = dV_w[r * L::LDO + c];
    }
  }
}

// ===========================================================================
// bf16 and f16: wgmma kernels fed by TMA through an mbarrier ring
// ===========================================================================

struct Params90 {
  CUtensorMap q, k, v, o;   // q, do [B, Tq, H, D]; k, v [B, Tk, H, D]; boxes of 64 rows
  const float* lse;         // [B, H, Tq]
  const float* delta;
  const float* kmask;       // [B, Tk]
  void* g0;                 // dq, or dk (the operand type)
  void* g1;                 // dv
  int B, Tq, Tk, H, causal;
  int shift;                // q_off - k_off: key k is allowed for query q iff k <= q + shift
  float scale;
};

// S[64, N] = A . B^T over D for one warpgroup (N = 64 or 32): A the 64 rows
// from ra0 of an RA-row tile, B the N rows from rb0 of a 64-row tile, both
// K-major.
template <typename T, int D, int RA, int N>
__device__ __forceinline__ void scores(float (&s)[N / 2], uint32_t a_tile, int ra0,
                                       uint32_t b_tile, int rb0) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<T>(s, desc_k<D, RA>(a_tile, ra0, kk), desc_k<D, ROWS>(b_tile, rb0, kk), kk > 0);
}

// Store rows of a [64, CHUNK NC] f32 accumulator (column boxes c0 .. c0 +
// NC of D) times `mul` in the operand type T into a contiguous
// [B, T, H, D] tensor, rows at or past T skipped.
template <typename T, int D, int NC = Geo<D>::NCB>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[NC][Geo<D>::CHUNK / 2],
                                           float mul, int row0, int lane, int b, int h,
                                           int T_len, int H, int c0 = 0) {
  using G = Geo<D>;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int t = row0 + 8 * j;
    if (t >= T_len) continue;
    T* rowp = out + (((long long)b * T_len + t) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 2 * j; i < G::CHUNK / 2; i += 4) {
        const int col = (c0 + c) * G::CHUNK + frag_col(i, lane);
        *reinterpret_cast<uint32_t*>(rowp + col) =
            pack2<T>(acc[c][i] * mul, acc[c][i + 1] * mul);
      }
  }
}

template <int D>
struct DqLayout {
  using G = Geo<D>;
  static constexpr int STAGES = Cfg<D>::STAGES;
  static constexpr size_t OWN_TILE = size_t(Cfg<D>::OWN / ROWS) * G::TILE64;
  static constexpr size_t q = 0;                                 // own rows, resident
  static constexpr size_t o = q + OWN_TILE;
  static constexpr size_t k = o + OWN_TILE;                      // STAGES x 64 rows
  static constexpr size_t v = k + size_t(STAGES) * G::TILE64;
  static constexpr size_t kv = v + size_t(STAGES) * G::TILE64;   // STAGES x 64 f32
  static constexpr size_t bars = kv + size_t(STAGES) * ROWS * sizeof(float);
  static constexpr size_t bytes = bars + (1 + 2 * STAGES) * 8 + 1024;   // + alignment
};

template <int D>
struct DkvLayout {
  using G = Geo<D>;
  static constexpr int STAGES = Cfg<D>::STAGES;
  static constexpr size_t OWN_TILE = size_t(Cfg<D>::OWN / ROWS) * G::TILE64;
  static constexpr size_t k = 0;                                 // own rows, resident
  static constexpr size_t v = k + OWN_TILE;
  static constexpr size_t q = v + OWN_TILE;                      // STAGES x 64 rows
  static constexpr size_t o = q + size_t(STAGES) * G::TILE64;
  static constexpr size_t lse = o + size_t(STAGES) * G::TILE64;  // STAGES x 64 f32
  static constexpr size_t delta = lse + size_t(STAGES) * ROWS * sizeof(float);
  static constexpr size_t bars = delta + size_t(STAGES) * ROWS * sizeof(float);
  static constexpr size_t bytes = bars + (1 + 2 * STAGES) * 8 + 1024;
};

// ---------------------------------------------------------------------------
// dq: one block per (batch*head, 128 query rows; 64 at D = 256, shared by
// both consumer warpgroups, each summing half of dq's columns)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(THREADS90, 1)
    flash_bwd_dq_wgmma_kernel(__grid_constant__ const Params90 p) {
  static_assert(sizeof(T) == 2, "bf16 or f16 operands");
  using G = Geo<D>;
  using L = DqLayout<D>;
  constexpr int STAGES = L::STAGES, OWN = Cfg<D>::OWN, NC = Cfg<D>::NC;
  constexpr bool SPLIT = Cfg<D>::SPLIT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* own_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  float* kval = reinterpret_cast<float*>(smem + L::kv);

  const int Tq = p.Tq, Tk = p.Tk, shift = p.shift;
  const int BH = p.B * p.H;
  const int n_qb = (Tq + OWN - 1) / OWN;
  const int bh = blockIdx.x % BH;
  const int qb = p.causal ? n_qb - 1 - int(blockIdx.x / BH) : int(blockIdx.x / BH);
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = qb * OWN;
  const int n_k = (Tk + ROWS - 1) / ROWS;
  // under a causal mask the block's last query ends its key tiles at key
  // q0 + OWN - 1 + shift (none when that lies before key 0)
  const int last = q0 + OWN - 1 + shift;
  const int n_kt = p.causal ? (last < 0 ? 0 : min(n_k, last / ROWS + 1)) : n_k;

  const int tid = threadIdx.x;
  if (tid == 0) {
    bar_init(own_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 32);              // the producer warp's lanes
      bar_init(&empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = warpgroup();
  const int warp = (tid % WG) / 32;
  const int lane = tid % 32;
  if (wg == CONSUMERS) {
    // producer: Q and dO once, then K, V and key validity per slot
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 0) {
      if (lane == 0) {
        bar_arrive_tx(own_full, 2 * L::OWN_TILE);
        tma_tile<D, OWN>(base + L::q, &p.q, own_full, h, q0, b);
        tma_tile<D, OWN>(base + L::o, &p.o, own_full, h, q0, b);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        bar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        const int k0 = kt * ROWS;
        for (int i = lane; i < ROWS; i += 32) {
          const int t = k0 + i;
          bool ok = t < Tk;
          if (ok && p.kmask != nullptr) ok = p.kmask[(long long)b * Tk + t] > 0.0f;
          kval[s * ROWS + i] = ok ? 1.0f : 0.0f;
        }
        if (lane == 0) {
          bar_arrive_tx(&full[s], 2 * G::TILE64);
          tma_tile<D, ROWS>(base + L::k + s * G::TILE64, &p.k, &full[s], h, k0, b);
          tma_tile<D, ROWS>(base + L::v + s * G::TILE64, &p.v, &full[s], h, k0, b);
        } else {
          bar_arrive(&full[s]);
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wr = SPLIT ? 0 : wg * ROWS;      // the warpgroup's rows in the block's
    const int c0 = SPLIT ? wg * NC : 0;        // and its first output column box
    const int wq0 = q0 + wr;                   // the warpgroup's first query
    const int row0 = wq0 + warp * 16 + lane / 4;   // the thread's rows: row0, row0 + 8
    const long long bh_off = (long long)bh * Tq;
    float lse2[2], dlt[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = row0 + 8 * j;
      lse2[j] = t < Tq ? p.lse[bh_off + t] * LOG2E : 0.0f;
      dlt[j] = t < Tq ? p.delta[bh_off + t] : 0.0f;
    }
    const float sl2 = p.scale * LOG2E;
    float acc[NC][G::CHUNK / 2];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < G::CHUNK / 2; ++i) acc[c][i] = 0.0f;

    bar_wait(own_full, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % STAGES;
      const int k0 = kt * ROWS;
      const uint32_t kt_tile = base + L::k + s * G::TILE64;
      bar_wait(&full[s], (kt / STAGES) & 1);
      // under a causal mask the last key tile of the block lies wholly above
      // the first warpgroup's rows
      if (!(p.causal && k0 > wq0 + ROWS - 1 + shift)) {
        float sc[32], dp[32];
        wg_fence();
        scores<T, D, OWN, ROWS>(sc, base + L::q, wr, kt_tile, 0);   // S = Q.K^T
        wg_commit();
        scores<T, D, OWN, ROWS>(dp, base + L::o, wr,
                                base + L::v + s * G::TILE64, 0);     // dP = dO.V^T
        wg_commit();
        wg_wait<0>();
        pin(sc);
        pin(dp);
        const float* kv = kval + s * ROWS;
        uint32_t a[4][4];
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int j = (i >> 1) & 1;
          const int col = frag_col(i, lane);
          const int t = row0 + 8 * j;
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + col + e;
            const bool ok = kv[col + e] > 0.0f && t < Tq && (!p.causal || key <= t + shift);
            const float pr = ok ? exp2f(fmaf(sc[i + e], sl2, -lse2[j])) : 0.0f;
            ds[e] = pr * (dp[i + e] - dlt[j]);
          }
          a[i >> 3][(i >> 1) & 3] = pack2<T>(ds[0], ds[1]);
        }
        wg_fence();
        accumulate<T, D, 4, ROWS, NC>(acc, a, kt_tile, 0, c0);         // dQ += dS . K
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int c = 0; c < NC; ++c) pin(acc[c]);
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[s]);
    }
    store_rows<T, D, NC>(static_cast<T*>(p.g0), acc, p.scale, row0, lane, b, h, Tq, p.H,
                         c0);
  }
}

// ---------------------------------------------------------------------------
// dk/dv: one block per (batch*head, 128 key rows; 64 at D = 256, shared by
// both consumer warpgroups, each summing half of dk's and dv's columns)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(THREADS90, 1)
    flash_bwd_dkv_wgmma_kernel(__grid_constant__ const Params90 p) {
  static_assert(sizeof(T) == 2, "bf16 or f16 operands");
  using G = Geo<D>;
  using L = DkvLayout<D>;
  constexpr int STAGES = L::STAGES, OWN = Cfg<D>::OWN, NC = Cfg<D>::NC;
  constexpr bool SPLIT = Cfg<D>::SPLIT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* own_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  float* lse_s = reinterpret_cast<float*>(smem + L::lse);
  float* dlt_s = reinterpret_cast<float*>(smem + L::delta);

  const int Tq = p.Tq, Tk = p.Tk, shift = p.shift;
  const int BH = p.B * p.H;
  const int bh = blockIdx.x % BH;
  const int kb = blockIdx.x / BH;   // under a causal mask the first key rows have the most queries
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = kb * OWN;
  const int n_q = (Tq + ROWS - 1) / ROWS;
  // query tiles wholly above k0 - shift (the first query that may see key k0)
  // see no key here
  const int qt0 = p.causal && k0 - shift > 0 ? (k0 - shift) / ROWS : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    bar_init(own_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 32);
      bar_init(&empty[s], CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = warpgroup();
  const int warp = (tid % WG) / 32;
  const int lane = tid % 32;
  const long long bh_off = (long long)bh * Tq;
  if (wg == CONSUMERS) {
    // producer: K and V once, then Q, dO, lse and delta per slot
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 0) {
      if (lane == 0) {
        bar_arrive_tx(own_full, 2 * L::OWN_TILE);
        tma_tile<D, OWN>(base + L::k, &p.k, own_full, h, k0, b);
        tma_tile<D, OWN>(base + L::v, &p.v, own_full, h, k0, b);
      }
      for (int qt = qt0; qt < n_q; ++qt) {
        const int it = qt - qt0;
        const int s = it % STAGES;
        bar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        const int q0 = qt * ROWS;
        for (int i = lane; i < ROWS; i += 32) {
          const int t = q0 + i;
          const bool in = t < Tq;
          lse_s[s * ROWS + i] = in ? p.lse[bh_off + t] * LOG2E : 0.0f;
          dlt_s[s * ROWS + i] = in ? p.delta[bh_off + t] : 0.0f;
        }
        if (lane == 0) {
          bar_arrive_tx(&full[s], 2 * G::TILE64);
          tma_tile<D, ROWS>(base + L::q + s * G::TILE64, &p.q, &full[s], h, q0, b);
          tma_tile<D, ROWS>(base + L::o + s * G::TILE64, &p.o, &full[s], h, q0, b);
        } else {
          bar_arrive(&full[s]);
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wr = SPLIT ? 0 : wg * ROWS;           // the warpgroup's rows in the block's
    const int c0 = SPLIT ? wg * NC : 0;             // and its first output column box
    const int wk0 = k0 + wr;                        // the warpgroup's first key
    const int row0 = wk0 + warp * 16 + lane / 4;    // the thread's keys: row0, row0 + 8
    bool kok[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = row0 + 8 * j;
      kok[j] = t < Tk && (p.kmask == nullptr || p.kmask[(long long)b * Tk + t] > 0.0f);
    }
    const float sl2 = p.scale * LOG2E;
    float dk[NC][G::CHUNK / 2], dv[NC][G::CHUNK / 2];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < G::CHUNK / 2; ++i) {
        dk[c][i] = 0.0f;
        dv[c][i] = 0.0f;
      }

    bar_wait(own_full, 0);
    for (int qt = qt0; qt < n_q; ++qt) {
      const int it = qt - qt0;
      const int s = it % STAGES;
      const int q0 = qt * ROWS;
      const uint32_t q_tile = base + L::q + s * G::TILE64;
      const uint32_t o_tile = base + L::o + s * G::TILE64;
      bar_wait(&full[s], (it / STAGES) & 1);
      // under a causal mask the first query tile lies wholly above the
      // second warpgroup's keys
      if (!(p.causal && q0 + ROWS - 1 + shift < wk0)) {
        const float* ls = lse_s + s * ROWS;
        const float* dl = dlt_s + s * ROWS;
        // two halves of 32 queries, one after the other, so that S^T, dP^T
        // and the bf16 fragments fit beside the 2 x D/2 accumulator registers
#pragma unroll 1
        for (int hf = 0; hf < 2; ++hf) {
          float sc[16], dp[16];
          wg_fence();
          scores<T, D, OWN, 32>(sc, base + L::k, wr, q_tile, 32 * hf);  // S^T
          wg_commit();
          scores<T, D, OWN, 32>(dp, base + L::v, wr, o_tile, 32 * hf);  // dP^T
          wg_commit();
          wg_wait<0>();
          pin(sc);
          pin(dp);
          uint32_t pa[2][4], sa[2][4];
#pragma unroll
          for (int i = 0; i < 16; i += 2) {
            const int j = (i >> 1) & 1;
            const int col = 32 * hf + frag_col(i, lane);   // query column in the tile
            const int key = row0 + 8 * j;
            float pr[2], ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int t = q0 + col + e;
              const bool ok = kok[j] && t < Tq && (!p.causal || key <= t + shift);
              pr[e] = ok ? exp2f(fmaf(sc[i + e], sl2, -ls[col + e])) : 0.0f;
              ds[e] = pr[e] * (dp[i + e] - dl[col + e]);
            }
            pa[i >> 3][(i >> 1) & 3] = pack2<T>(pr[0], pr[1]);
            sa[i >> 3][(i >> 1) & 3] = pack2<T>(ds[0], ds[1]);
          }
          wg_fence();
          accumulate<T, D, 2, ROWS, NC>(dv, pa, o_tile, 2 * hf, c0);   // dV += P^T . dO
          accumulate<T, D, 2, ROWS, NC>(dk, sa, q_tile, 2 * hf, c0);   // dK += dS^T . Q
          wg_commit();
        }
        wg_wait<0>();
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          pin(dv[c]);
          pin(dk[c]);
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[s]);
    }
    store_rows<T, D, NC>(static_cast<T*>(p.g0), dk, p.scale, row0, lane, b, h, Tk, p.H, c0);
    store_rows<T, D, NC>(static_cast<T*>(p.g1), dv, 1.0f, row0, lane, b, h, Tk, p.H, c0);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int D>
int make_params90(Params90* q, const Params& p) {
  int rc = encode_map<T, D>(&q->q, p.q, p.B, p.Tq, p.H, p.q_sb, p.q_st, p.q_sh);
  if (rc == 0) rc = encode_map<T, D>(&q->k, p.k, p.B, p.Tk, p.H, p.k_sb, p.k_st, p.k_sh);
  if (rc == 0) rc = encode_map<T, D>(&q->v, p.v, p.B, p.Tk, p.H, p.v_sb, p.v_st, p.v_sh);
  if (rc == 0) rc = encode_map<T, D>(&q->o, p.dout, p.B, p.Tq, p.H, p.o_sb, p.o_st, p.o_sh);
  q->lse = p.lse;
  q->delta = p.delta;
  q->kmask = p.kmask;
  q->B = p.B;
  q->Tq = p.Tq;
  q->Tk = p.Tk;
  q->H = p.H;
  q->causal = p.causal;
  q->shift = p.q_off - p.k_off;
  q->scale = p.scale;
  return rc;
}

template <int D>
struct F32 {
  static int dq(const Params& p, cudaStream_t stream) {
    using L = DqSmem<float, D>;
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<float, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((p.Tq + TILE - 1) / TILE, p.B * p.H);
    flash_bwd_dq_kernel<float, D><<<grid, THREADS, L::bytes, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  static int dkv(const Params& p, cudaStream_t stream) {
    using L = DkvSmem<float, D>;
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<float, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((p.Tk + TILE - 1) / TILE, p.B * p.H);
    flash_bwd_dkv_kernel<float, D><<<grid, THREADS, L::bytes, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, int D>
struct Wgmma {
  static int dq(const Params& p, cudaStream_t stream) {
    using L = DqLayout<D>;
    Params90 q;
    int rc = make_params90<T, D>(&q, p);
    if (rc != 0) return rc;
    q.g0 = p.dq;
    q.g1 = nullptr;
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    const int blocks = (p.Tq + Cfg<D>::OWN - 1) / Cfg<D>::OWN * (p.B * p.H);
    flash_bwd_dq_wgmma_kernel<T, D><<<blocks, THREADS90, L::bytes, stream>>>(q);
    return static_cast<int>(cudaGetLastError());
  }
  static int dkv(const Params& p, cudaStream_t stream) {
    using L = DkvLayout<D>;
    Params90 q;
    int rc = make_params90<T, D>(&q, p);
    if (rc != 0) return rc;
    q.g0 = p.dk;
    q.g1 = p.dv;
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    const int blocks = (p.Tk + Cfg<D>::OWN - 1) / Cfg<D>::OWN * (p.B * p.H);
    flash_bwd_dkv_wgmma_kernel<T, D><<<blocks, THREADS90, L::bytes, stream>>>(q);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int D> struct Bf16 : Wgmma<bf16, D> {};
template <int D> struct F16 : Wgmma<f16, D> {};

template <template <int> class K>
int dispatch(int which, const Params& p, int D, cudaStream_t s) {
  switch (D) {
    case 32: return which == 0 ? K<32>::dq(p, s) : K<32>::dkv(p, s);
    case 64: return which == 0 ? K<64>::dq(p, s) : K<64>::dkv(p, s);
    case 128: return which == 0 ? K<128>::dq(p, s) : K<128>::dkv(p, s);
    case 256: return which == 0 ? K<256>::dq(p, s) : K<256>::dkv(p, s);
    default: return ERR_UNSUPPORTED;
  }
}

long long smem_f32(int which, int D) {
  switch (D) {
    case 32: return which == 0 ? DqSmem<float, 32>::bytes : DkvSmem<float, 32>::bytes;
    case 64: return which == 0 ? DqSmem<float, 64>::bytes : DkvSmem<float, 64>::bytes;
    case 128: return which == 0 ? DqSmem<float, 128>::bytes : DkvSmem<float, 128>::bytes;
    case 256: return which == 0 ? DqSmem<float, 256>::bytes : DkvSmem<float, 256>::bytes;
    default: return -1;
  }
}

long long smem_16(int which, int D) {
  switch (D) {
    case 32: return which == 0 ? DqLayout<32>::bytes : DkvLayout<32>::bytes;
    case 64: return which == 0 ? DqLayout<64>::bytes : DkvLayout<64>::bytes;
    case 128: return which == 0 ? DqLayout<128>::bytes : DkvLayout<128>::bytes;
    case 256: return which == 0 ? DqLayout<256>::bytes : DkvLayout<256>::bytes;
    default: return -1;
  }
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, const float* kmask,
                   int B, int Tq, int Tk, int H, int causal, int q_off, int k_off,
                   float scale, const long long* strides) {
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
  p.Tq = Tq;
  p.Tk = Tk;
  p.H = H;
  p.causal = causal;
  p.q_off = q_off;
  p.k_off = k_off;
  p.scale = scale;
  return p;
}

int run(int which, Params& p, int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<F32>(which, p, D, s);
  if (dtype == 1) return dispatch<Bf16>(which, p, D, s);
  if (dtype == 2) return dispatch<F16>(which, p, D, s);
  return ERR_UNSUPPORTED;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; D in 32, 64, 128, 256. q, dout
// and dq [B, Tq, H, D], k, v, dk and dv [B, Tk, H, D], lse and delta [B, H, Tq],
// kmask [B, Tk]; q_off and k_off the absolute positions of query 0 and key 0.
// `strides` holds 12 element strides: the
// B, T, H strides of q, k, v and dout, in that order. Returns 0 on a clean
// launch, a negative code of our own (flash_bwd_error_string) or the
// cudaError_t code.
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, const float* kmask,
                 void* dq, int B, int Tq, int Tk, int H, int D, int dtype, int causal,
                 int q_off, int k_off, float scale, const long long* strides,
                 void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, kmask, B, Tq, Tk, H, causal, q_off,
                         k_off, scale, strides);
  p.dq = dq;
  return run(0, p, D, dtype, stream);
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, const float* kmask,
                  void* dk, void* dv, int B, int Tq, int Tk, int H, int D, int dtype,
                  int causal, int q_off, int k_off, float scale, const long long* strides,
                  void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, kmask, B, Tq, Tk, H, causal, q_off,
                         k_off, scale, strides);
  p.dk = dk;
  p.dv = dv;
  return run(1, p, D, dtype, stream);
}

// Dynamic shared memory one block of kernel `which` (0 = dq, 1 = dk/dv)
// takes, or -1 when unsupported.
long long flash_bwd_smem_bytes(int which, int dtype, int D) {
  if (dtype == 0) return smem_f32(which, D);
  if (dtype == 1 || dtype == 2) return smem_16(which, D);
  return -1;
}

const char* flash_bwd_error_string(int code) {
  switch (code) {
    case ERR_UNSUPPORTED: return "unsupported dtype/head dim";
    case ERR_NO_ENCODER: return "cuTensorMapEncodeTiled not found in libcuda.so.1";
    case ERR_TENSOR_MAP: return "cuTensorMapEncodeTiled refused a [B, T, H, D] view";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
