// Flash-attention forward for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes; see ops/_build.py and ops/flash_attention.py).
//
// Replaces the Pallas TPU kernel deeplearning4j_tpu/ops/flash_attention.py
// `_kernel` (launched by `_fwd_pallas_call`): blockwise online-softmax
// attention with a causal mask, a length mask (keys past T) and an optional
// per-batch key mask [B, T] shared by the H heads of a batch. It writes
// `out` [B, T, H, D] in the input dtype and the per-row logsumexp
// `lse` [B, H, T] in f32 (natural log).
//
// Rules both dtypes keep:
// - q, k and v are read in their [B, T, H, D] layout through their strides
//   (the fused qkv projection's split views need no copy), and keys at or
//   past T are masked in the kernel; the TPU wrapper instead padded and
//   transposed to [B*H, t_pad, D]. The TPU kernel holds the whole [T, D] K
//   and V per program (1 MB at T=2048, D=128 bf16); a Hopper block has 227
//   KB of shared memory, so K/V stream through it tile by tile.
// - Scores, the running max m, the normaliser l and the output accumulator
//   are f32. Masked scores take the finite NEG_BIG (-1e30), never -inf, as
//   on the TPU (flash_attention.py:103): a query row with no valid key stays
//   finite and its lse stays near -1e30 (the backward kernels mask such rows
//   by validity, flash_bwd.cu). p is rounded to the operand type before
//   p . v (flash_attention.py:108). Key tiles strictly above the causal
//   diagonal are skipped.
// - Queries and keys may differ in length (Tq, Tk) and sit at absolute
//   offsets (q_off, k_off): the chunk entries flash_attention_block(_grad)
//   attend one query chunk over one key chunk of a longer sequence (the
//   TPU kernel's t_real_q / t_real_k and q_off / k_off). The causal rule
//   compares absolute positions, k_off + k <= q_off + q, so in local
//   indices a key k is allowed for a query q when k <= q + shift, shift =
//   q_off - k_off; flash_attention passes Tq = Tk and offsets 0. Key
//   validity is k < Tk (and the [B, Tk] key mask); rows q >= Tq are never
//   written. A row with no valid key (a chunk wholly in its future, or a
//   kmask of zeros) gets lse <= -1e29 and a finite output, so its merge
//   weight exp(lse - logsumexp) is exactly 0. Every early exit (the key
//   loop's end, a warpgroup's skipped tile, the validity test) is taken
//   against the shifted diagonal, which the causal mask makes monotone:
//   once a tile lies wholly above it for a row range, so does every later
//   tile, and the longest-first block order stays the longest first.
//
// bf16 and f16: flash_fwd_wgmma_kernel<T, D>, FlashAttention-3's forward
// shape without its intra-warpgroup overlap (f16 takes the same layouts and
// another type in the wgmma instruction and the tensor maps). Each block is three warpgroups: two consumer
// warpgroups of 64 query rows each (128 rows a block) and one producer
// warpgroup whose first warp starts the copies (sm90_common.cuh holds the
// pieces it shares with the backward kernels).
// - The block's 128 Q rows are loaded once by TMA. K and V stream in tiles
//   of BKW = 128 keys through a ring of STAGES = 3 slots, with a "full" and
//   an "empty" mbarrier per slot; one 4-D tensor map per operand over its
//   strided [B, T, H, D] view, boxes of 64 rows x 128 bytes (64 at D=32) in
//   the swizzled layout wgmma reads; rows at or past T arrive as zeros. The
//   producer warp's lanes write each slot's key validity (T and the key
//   mask) and a flag that says whether any key of the slot is invalid.
// - S = Q.K^T is wgmma m64n128k16 with both operands K-major in shared
//   memory and an f32 accumulator in registers (64 a thread). The online
//   softmax runs on that fragment in registers: the row max by quad
//   shuffles, scale * log2(e) folded into one FFMA before ex2.approx, the row sum
//   kept per thread until the end. P rounded to bf16 is, pair for pair, the
//   register A operand of O += P.V (wgmma RS, V the MN-major B operand), and
//   O (D/2 f32 a thread) stays in registers for the whole key loop; it is
//   rescaled by alpha after the previous P.V has retired. No shared memory
//   holds S, P or O.
// - Only the tiles that cross the causal diagonal, T or a masked key pay for
//   the validity test.
// - Epilogue: O / l rounded to bf16; the four lanes of a quad transpose
//   their 32-bit pairs by shuffles so that each lane writes 8 consecutive
//   columns with one 16-byte store (rows at or past T skipped); lse =
//   (m2 + log2 l) * ln 2 with m2 the row max in log2 units.
// - Blocks are numbered head group by head group (HEAD_GROUP (batch, head)
//   pairs a group), so that the ~132 blocks in flight share the K/V of a few
//   heads in L2 (numbered head-fastest, each would stream its own head's
//   K/V from device memory: 2.3 GB of tile loads at the flagship shape);
//   inside a group, under a causal mask, the query blocks with the most key
//   tiles start first and the short ones fill the tail.
// Key tiles of 128 halve the softmax passes and barrier round trips of
// 64-key tiles, and the 128-wide S product reads Q once per 128 keys.
// Budget per instantiation: 168 registers a thread at launch
// (__launch_bounds__(384, 1)), then 232 a consumer and 40 a producer thread
// (S 64 + O D/2 + P 32 f32 registers a consumer thread at D=128). Dynamic
// shared memory (FwdLayout; flash_fwd_smem_bytes reports it): Q 128 rows +
// 3 x (K + V) 128-key tiles + validity + barriers + 1024 B of alignment,
//   D=32 / 64 / 128: 59,976 / 117,320 / 232,008 B,
// so one block of 12 warps per SM (232,448 B is the opt-in limit). At
// D=256 (sm90_common.cuh Cfg) the key tiles are 64 and the ring has two
// slots: S 32 + O 128 + P 16 f32 registers a consumer thread; Q 64 KB and
// 2 x (K + V) of 32 KB, 198,200 B.
// Not here yet: overlapping S_{j+1} with the softmax of tile j inside a
// warpgroup, ping-pong of the two consumer warpgroups on named barriers, a
// persistent grid, FP8.
//
// f32 keeps the first version's design: one block of four warps per 64-row
// query tile (at D = 256 the tiles hold D in chunks of 64, Chunk below), 64-key K/V tiles loaded synchronously into padded shared
// memory, plain FMAs so that f32 keeps f32 accuracy (TF32 would not), the
// accumulator in shared memory.
//
// Bound at the flagship shape (B=16, H=16, T=2048, D=128, causal, bf16):
// the two products take 2 * 2 * B*H*T*T*D / 2 ~= 275 GFLOP and the kernel
// must move q, k, v and out once (4 * 134 MB) plus lse, ~0.54 GB. On an
// H100 SXM that is 0.28 ms at 989 TFLOP/s against 0.16 ms at 3.35 TB/s:
// the kernel is bound by operations.

#include "sm90_common.cuh"

namespace {

constexpr float NEG_BIG = -1e30f;    // the TPU kernel's masked-score value

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* kmask;   // [B, T] key validity (>0 = real key) or nullptr
  void* o;              // [B, T, H, D] contiguous, input dtype
  float* lse;           // [B, H, Tq] contiguous
  long long q_sb, q_st, q_sh;   // element strides of q over B, T, H
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  int B, Tq, Tk, H;     // q and out [B, Tq, H, D]; k, v [B, Tk, H, D]; kmask [B, Tk]
  int causal;
  int q_off, k_off;     // absolute positions of query 0 and key 0 (causal rule)
  float scale;
};

// ===========================================================================
// f32: FMA kernel, one block of four warps per 64-row query tile
// ===========================================================================

constexpr int BQ = 64;               // query rows per block
constexpr int BK = 64;               // keys per streamed K/V tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int WROWS = BQ / WARPS;    // query rows per warp (16)

static_assert(BQ == BK, "the causal tile count assumes square tiles");

// The head-dim columns of a Q, K or V tile the f32 kernel holds at once:
// all of D up to 128; at D = 256 chunks of 64, whose products are summed
// chunk by chunk (the scores) or written chunk by chunk (the output), so
// that the tiles and the [64, D] accumulator fit 227 KB.
template <int D> struct Chunk {
  static constexpr int DC = D <= 128 ? D : 64;
  static constexpr int N = D / DC;
};

template <int D>
struct Smem {
  static constexpr int LD = Chunk<D>::DC + 1;  // Q, K, V rows: off one bank
  static constexpr int LDS = BK + 4;           // scores
  static constexpr int LDP = BK + 4;           // probabilities
  static constexpr int LDO = D + 4;            // output accumulator
  static constexpr size_t q = 0;
  static constexpr size_t k = align128(q + size_t(BQ) * LD * sizeof(float));
  static constexpr size_t v = align128(k + size_t(BK) * LD * sizeof(float));
  static constexpr size_t s = align128(v + size_t(BK) * LD * sizeof(float));
  static constexpr size_t p = align128(s + size_t(BQ) * LDS * sizeof(float));
  static constexpr size_t o = align128(p + size_t(BQ) * LDP * sizeof(float));
  static constexpr size_t kv = align128(o + size_t(BQ) * LDO * sizeof(float));
  static constexpr size_t alpha = align128(kv + size_t(BK) * sizeof(float));
  static constexpr size_t l = align128(alpha + size_t(BQ) * sizeof(float));
  static constexpr size_t bytes = align128(l + size_t(BQ) * sizeof(float));
};

// Copy W columns of rows [r0, r0 + 64) of one (batch, head) slice into
// shared memory (row pitch LD) in 16-byte chunks; rows at or past T are
// zero-filled so masked keys never multiply garbage.
template <int W, int LD>
__device__ void load_rows(float* dst, const float* base, long long stride_t, int r0,
                          int T_len, int tid) {
  constexpr int CPR = W / 4;
  for (int i = tid; i < 64 * CPR; i += THREADS) {
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

// S[warp rows, 0:BK] (+)= Q[warp rows] . K[tile]^T over W head-dim columns
// (unscaled; ACC adds to S, as the chunks of D = 256 do)
template <int D, int W, bool ACC>
__device__ void scores(const float* Q_warp, const float* Ks, float* S_warp, int lane) {
  using L = Smem<D>;
  float a0[WROWS], a1[WROWS];
#pragma unroll
  for (int r = 0; r < WROWS; ++r) {
    a0[r] = ACC ? S_warp[r * L::LDS + lane] : 0.0f;
    a1[r] = ACC ? S_warp[r * L::LDS + lane + 32] : 0.0f;
  }
  const float* k0 = Ks + lane * L::LD;          // keys lane and lane + 32
  const float* k1 = Ks + (lane + 32) * L::LD;
#pragma unroll 4
  for (int d = 0; d < W; ++d) {
    const float x0 = k0[d], x1 = k1[d];
#pragma unroll
    for (int r = 0; r < WROWS; ++r) {
      const float qv = Q_warp[r * L::LD + d];
      a0[r] = fmaf(qv, x0, a0[r]);
      a1[r] = fmaf(qv, x1, a1[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < WROWS; ++r) {
    S_warp[r * L::LDS + lane] = a0[r];
    S_warp[r * L::LDS + lane + 32] = a1[r];
  }
}

// O[warp rows, W columns] += P[warp rows, 0:BK] . V[tile, W columns]
template <int D, int W>
__device__ void accumulate(const float* P_warp, const float* Vs, float* O_warp, int lane) {
  using L = Smem<D>;
  constexpr int NC = W / 32;                    // columns lane + 32 * i
  float acc[WROWS][NC];
#pragma unroll
  for (int r = 0; r < WROWS; ++r)
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = O_warp[r * L::LDO + lane + 32 * i];
#pragma unroll 2
  for (int kk = 0; kk < BK; ++kk) {
    float vv[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) vv[i] = Vs[kk * L::LD + lane + 32 * i];
#pragma unroll
    for (int r = 0; r < WROWS; ++r) {
      const float pv = P_warp[r * L::LDP + kk];
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[r][i] = fmaf(pv, vv[i], acc[r][i]);
    }
  }
#pragma unroll
  for (int r = 0; r < WROWS; ++r)
#pragma unroll
    for (int i = 0; i < NC; ++i) O_warp[r * L::LDO + lane + 32 * i] = acc[r][i];
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  static_assert(sizeof(T) == 4, "T names the operand type in the symbol; f32 only");
  using L = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::q);
  float* Ks = reinterpret_cast<float*>(smem + L::k);
  float* Vs = reinterpret_cast<float*>(smem + L::v);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  float* Ps = reinterpret_cast<float*>(smem + L::p);
  float* Os = reinterpret_cast<float*>(smem + L::o);
  float* kvalid = reinterpret_cast<float*>(smem + L::kv);
  float* alpha_s = reinterpret_cast<float*>(smem + L::alpha);
  float* l_s = reinterpret_cast<float*>(smem + L::l);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = qt * BQ;
  const int Tq = p.Tq, Tk = p.Tk;
  const int shift = p.q_off - p.k_off;   // key k is allowed for query q iff k <= q + shift

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  constexpr int DC = Chunk<D>::DC, NCH = Chunk<D>::N;
  if constexpr (NCH == 1) load_rows<D, L::LD>(Qs, qb, p.q_st, q0, Tq, tid);
  for (int i = tid; i < BQ * L::LDO; i += THREADS) Os[i] = 0.0f;
  __syncthreads();

  const float* Q_warp = Qs + warp * WROWS * L::LD;
  float* S_warp = Ss + warp * WROWS * L::LDS;
  float* P_warp = Ps + warp * WROWS * L::LDP;
  float* O_warp = Os + warp * WROWS * L::LDO;

  // the lane pair (2r, 2r+1) owns warp row r; each lane half of its columns
  const int r = lane >> 1;
  const int half = lane & 1;
  const int row = warp * WROWS + r;
  const int qpos = q0 + row;
  float m_run = NEG_BIG;
  float l_run = 0.0f;

  int n_kt = (Tk + BK - 1) / BK;
  if (p.causal) {   // skip tiles above the (shifted) diagonal
    const int last = q0 + BQ - 1 + shift;   // the last key a row of the block may see
    n_kt = last < 0 ? 0 : min(n_kt, last / BK + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // every warp is done with the previous K/V tile
    for (int i = tid; i < BK; i += THREADS) {
      const int t = k0 + i;
      bool ok = t < Tk;
      if (ok && p.kmask != nullptr) ok = p.kmask[(long long)b * Tk + t] > 0.0f;
      kvalid[i] = ok ? 1.0f : 0.0f;
    }
    if constexpr (NCH == 1) {
      load_rows<D, L::LD>(Ks, kb, p.k_st, k0, Tk, tid);
      load_rows<D, L::LD>(Vs, vb, p.v_st, k0, Tk, tid);
      __syncthreads();
      scores<D, D, false>(Q_warp, Ks, S_warp, lane);
    } else {   // the scores summed over the chunks of D
      for (int c = 0; c < NCH; ++c) {
        if (c > 0) __syncthreads();   // every warp is done with the previous chunk
        load_rows<DC, L::LD>(Qs, qb + c * DC, p.q_st, q0, Tq, tid);
        load_rows<DC, L::LD>(Ks, kb + c * DC, p.k_st, k0, Tk, tid);
        __syncthreads();
        if (c == 0) scores<D, DC, false>(Q_warp, Ks, S_warp, lane);
        else scores<D, DC, true>(Q_warp, Ks, S_warp, lane);
      }
    }
    __syncwarp();

    // online softmax over this tile (f32), as in the TPU kernel: masked
    // scores become NEG_BIG, the running max and normaliser are rescaled
    float sv[32];
    float mx = NEG_BIG;
    const float* srow = S_warp + r * L::LDS + half * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      float s = srow[j] * p.scale;
      const bool ok = kvalid[c] > 0.0f && (!p.causal || k0 + c <= qpos + shift);
      s = ok ? s : NEG_BIG;
      sv[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.0f;
    float* prow = P_warp + r * L::LDP + half * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float e = expf(sv[j] - m_new);
      sum += e;
      prow[j] = e;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    if (half == 0) alpha_s[row] = alpha;
    __syncwarp();

    for (int i = lane; i < WROWS * D; i += 32) {
      const int rr = i / D;
      O_warp[rr * L::LDO + (i % D)] *= alpha_s[warp * WROWS + rr];
    }
    __syncwarp();

    if constexpr (NCH == 1) {
      accumulate<D, D>(P_warp, Vs, O_warp, lane);
    } else {   // the output written chunk by chunk of D
      for (int c = 0; c < NCH; ++c) {
        __syncthreads();   // every warp is done with the previous V chunk
        load_rows<DC, L::LD>(Vs, vb + c * DC, p.v_st, k0, Tk, tid);
        __syncthreads();
        accumulate<D, DC>(P_warp, Vs, O_warp + c * DC, lane);
      }
    }
  }

  __syncwarp();
  if (half == 0) {
    l_s[row] = l_run;
    if (qpos < Tq) {
      p.lse[((long long)b * p.H + h) * Tq + qpos] = m_run + logf(fmaxf(l_run, 1e-30f));
    }
  }
  __syncwarp();
  float* ob = static_cast<float*>(p.o);
  for (int i = lane; i < WROWS * D; i += 32) {
    const int rr = i / D;
    const int c = i % D;
    const int rw = warp * WROWS + rr;
    const int t = q0 + rw;
    if (t < Tq) {
      ob[(((long long)b * Tq + t) * p.H + h) * D + c] =
          O_warp[rr * L::LDO + c] / fmaxf(l_s[rw], 1e-30f);
    }
  }
}

// ===========================================================================
// bf16 and f16: wgmma kernel fed by TMA through an mbarrier ring
// ===========================================================================

constexpr float NEG_BIG2 = NEG_BIG * LOG2E;     // NEG_BIG in the log2 units of the softmax
constexpr float LN2 = 0.6931471805599453f;

struct Params90 {
  CUtensorMap q, k, v;   // [B, Tq, H, D] and [B, Tk, H, D] views, boxes of 64 rows
  const float* kmask;    // [B, Tk]
  void* o;               // [B, Tq, H, D] contiguous, the operand type
  float* lse;            // [B, H, Tq] contiguous
  int B, Tq, Tk, H, causal;
  int shift;             // q_off - k_off: key k is allowed for query q iff k <= q + shift
  float scale;
};

template <int D>
struct FwdLayout {
  using G = Geo<D>;
  static constexpr int BKW = Cfg<D>::FWD_KEYS;                    // keys of a K/V tile
  static constexpr int STAGES = Cfg<D>::STAGES;
  static constexpr int TILE = (BKW / ROWS) * G::TILE64;           // one K or V tile
  static constexpr size_t q = 0;                                  // 128 rows, resident
  static constexpr size_t k = q + G::TILE128;                     // STAGES x BKW rows
  static constexpr size_t v = k + size_t(STAGES) * TILE;
  static constexpr size_t kv = v + size_t(STAGES) * TILE;         // STAGES x BKW f32
  static constexpr size_t flag = kv + size_t(STAGES) * BKW * sizeof(float);   // STAGES int
  static constexpr size_t bars = flag + 16;
  static constexpr size_t bytes = bars + (1 + 2 * STAGES) * 8 + 1024;   // + alignment
  static_assert(STAGES * sizeof(int) <= 16, "slot flags overrun the barriers");
  static_assert(bytes <= 232448, "over the 227 KB a block may use");
};

// Rows row0 and row0 + 8 of a [64, D] f32 accumulator times inv_l[j] in
// the operand type T into a contiguous [B, T, H, D] tensor, rows at or past T skipped.
// Entry 4 n + 2 j + e of a column box holds column 8 n + 2 (lane % 4) + e of
// row j, so a quad holds 8-column group n of a row as one word a lane; the
// quad transposes its words of groups 4 m .. 4 m + 3 so that lane q writes
// group 4 m + q, 8 columns, with one 16-byte store.
template <typename T, int D>
__device__ __forceinline__ void store_out(T* out,
                                          const float (&o)[Geo<D>::NCB][Geo<D>::CHUNK / 2],
                                          const float (&inv_l)[2], int row0, int lane, int b,
                                          int h, int T_len, int H) {
  using G = Geo<D>;
  constexpr int GROUPS = G::CHUNK / 8;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int t = row0 + 8 * j;
#pragma unroll
    for (int c = 0; c < G::NCB; ++c)
#pragma unroll
      for (int m = 0; m < GROUPS / 4; ++m) {
        uint32_t w[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * (4 * m + r) + 2 * j;
          w[r] = pack2<T>(o[c][i] * inv_l[j], o[c][i + 1] * inv_l[j]);
        }
        const uint4 v = quad_transpose(w, lane);   // every lane: the shuffles need the quad
        if (t < T_len) {
          T* dst = out + (((long long)b * T_len + t) * H + h) * D + c * G::CHUNK + 32 * m +
                      8 * (lane & 3);
          *reinterpret_cast<uint4*>(dst) = v;
        }
      }
  }
}

// One block per (batch*head, 128 query rows)
template <typename T, int D>
__global__ void __launch_bounds__(THREADS90, 1)
    flash_fwd_wgmma_kernel(__grid_constant__ const Params90 p) {
  static_assert(sizeof(T) == 2, "bf16 or f16 operands");
  using G = Geo<D>;
  using L = FwdLayout<D>;
  constexpr int BKW = L::BKW;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  float* kval = reinterpret_cast<float*>(smem + L::kv);
  int* kflag = reinterpret_cast<int*>(smem + L::flag);

  const int Tq = p.Tq, Tk = p.Tk, shift = p.shift;
  const int BH = p.B * p.H;
  const int n_qb = (Tq + BLOCK_ROWS - 1) / BLOCK_ROWS;
  int bh, qb;
  block_coords(blockIdx.x, BH, n_qb, p.causal, bh, qb);
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = qb * BLOCK_ROWS;
  const int n_k = (Tk + BKW - 1) / BKW;
  // under a causal mask the block's last query, q0 + 127, ends its key tiles
  // at key q0 + 127 + shift (none when that lies before key 0)
  const int last = q0 + BLOCK_ROWS - 1 + shift;
  const int n_kt = p.causal ? (last < 0 ? 0 : min(n_k, last / BKW + 1)) : n_k;

  const int tid = threadIdx.x;
  if (tid == 0) {
    bar_init(q_full, 1);
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
    // producer: Q once, then K, V, key validity and the slot's flag per slot
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 0) {
      if (lane == 0) {
        bar_arrive_tx(q_full, G::TILE128);
        tma_tile<D, BLOCK_ROWS>(base + L::q, &p.q, q_full, h, q0, b);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        bar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        const int k0 = kt * BKW;
        bool all_ok = true;
        for (int i = lane; i < BKW; i += 32) {
          const int t = k0 + i;
          bool ok = t < Tk;
          if (ok && p.kmask != nullptr) ok = p.kmask[(long long)b * Tk + t] > 0.0f;
          kval[s * BKW + i] = ok ? 1.0f : 0.0f;
          all_ok = all_ok && ok;
        }
        const int any_masked = !__all_sync(0xffffffffu, all_ok);
        if (lane == 0) {
          kflag[s] = any_masked;
          bar_arrive_tx(&full[s], 2 * L::TILE);
          tma_tile<D, BKW>(base + L::k + s * L::TILE, &p.k, &full[s], h, k0, b);
          tma_tile<D, BKW>(base + L::v + s * L::TILE, &p.v, &full[s], h, k0, b);
        } else {
          bar_arrive(&full[s]);
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wq0 = q0 + wg * ROWS;                // the warpgroup's first query
    const int row0 = wq0 + warp * 16 + lane / 4;   // the thread's rows: row0, row0 + 8
    const float sl2 = p.scale * LOG2E;
    float o[G::NCB][G::CHUNK / 2];
#pragma unroll
    for (int c = 0; c < G::NCB; ++c)
#pragma unroll
      for (int i = 0; i < G::CHUNK / 2; ++i) o[c][i] = 0.0f;
    float m2[2] = {NEG_BIG2, NEG_BIG2};   // running row max, log2 units
    float l[2] = {0.0f, 0.0f};            // the thread's share of the row sum

    bar_wait(q_full, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % STAGES;
      const int k0 = kt * BKW;
      const uint32_t k_tile = base + L::k + s * L::TILE;
      bar_wait(&full[s], (kt / STAGES) & 1);
      // under a causal mask a key tile may lie wholly above this warpgroup's rows
      if (!(p.causal && k0 > wq0 + ROWS - 1 + shift)) {
        float sc[BKW / 2];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)                              // S = Q.K^T
          wgmma_ss<T>(sc, desc_k<D, BLOCK_ROWS>(base + L::q, wg * ROWS, kk),
                   desc_k<D, BKW>(k_tile, 0, kk), kk > 0);
        wg_commit();
        wg_wait<0>();
        pin(sc);
        // x = s * scale * log2(e), or NEG_BIG2 where the pair is masked; only
        // a tile that crosses the diagonal, T or a masked key tests validity
        float mul = sl2;
        if (kflag[s] || (p.causal && k0 + BKW - 1 > wq0 + shift)) {
          const float* kv = kval + s * BKW;
#pragma unroll
          for (int i = 0; i < BKW / 2; ++i) {
            const int col = frag_col(i, lane);
            const int t = row0 + 8 * ((i >> 1) & 1);
            const bool ok = kv[col] > 0.0f && (!p.causal || k0 + col <= t + shift);
            sc[i] = ok ? sc[i] * sl2 : NEG_BIG2;
          }
          mul = 1.0f;
        }
        float alpha[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float mx = sc[2 * j];
#pragma unroll
          for (int i = 0; i < BKW / 2; i += 4) mx = fmaxf(mx, fmaxf(sc[i + 2 * j], sc[i + 2 * j + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m2[j], mx * mul);
          alpha[j] = exp2_approx(m2[j] - m_new);
          m2[j] = m_new;
        }
        float rs[2] = {0.0f, 0.0f};
        uint32_t a[BKW / 16][4];
#pragma unroll
        for (int i = 0; i < BKW / 2; i += 2) {
          const int j = (i >> 1) & 1;
          const float p0 = exp2_approx(fmaf(sc[i], mul, -m2[j]));
          const float p1 = exp2_approx(fmaf(sc[i + 1], mul, -m2[j]));
          rs[j] += p0 + p1;
          a[i >> 3][(i >> 1) & 3] = pack2<T>(p0, p1);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + rs[j];
#pragma unroll
        for (int c = 0; c < G::NCB; ++c)
#pragma unroll
          for (int i = 0; i < G::CHUNK / 2; ++i) o[c][i] *= alpha[(i >> 1) & 1];
        wg_fence();
        accumulate<T, D, BKW / 16, BKW>(o, a, base + L::v + s * L::TILE, 0);   // O += P.V
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int c = 0; c < G::NCB; ++c) pin(o[c]);
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[s]);
    }

    float inv_l[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
      const float lc = fmaxf(l[j], 1e-30f);
      inv_l[j] = 1.0f / lc;
      const int t = row0 + 8 * j;
      if ((lane & 3) == 0 && t < Tq) p.lse[(long long)bh * Tq + t] = (m2[j] + log2f(lc)) * LN2;
    }
    store_out<T, D>(static_cast<T*>(p.o), o, inv_l, row0, lane, b, h, Tq, p.H);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
int launch_f32(const Params& p, cudaStream_t stream) {
  using L = Smem<D>;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<float, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L::bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.Tq + BQ - 1) / BQ, p.B * p.H);
  flash_fwd_kernel<float, D><<<grid, THREADS, L::bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch16(const Params& p, cudaStream_t stream) {
  using L = FwdLayout<D>;
  Params90 q;
  int rc = encode_map<T, D>(&q.q, p.q, p.B, p.Tq, p.H, p.q_sb, p.q_st, p.q_sh);
  if (rc == 0) rc = encode_map<T, D>(&q.k, p.k, p.B, p.Tk, p.H, p.k_sb, p.k_st, p.k_sh);
  if (rc == 0) rc = encode_map<T, D>(&q.v, p.v, p.B, p.Tk, p.H, p.v_sb, p.v_st, p.v_sh);
  if (rc != 0) return rc;
  q.kmask = p.kmask;
  q.o = p.o;
  q.lse = p.lse;
  q.B = p.B;
  q.Tq = p.Tq;
  q.Tk = p.Tk;
  q.H = p.H;
  q.causal = p.causal;
  q.shift = p.q_off - p.k_off;
  q.scale = p.scale;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L::bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (p.Tq + BLOCK_ROWS - 1) / BLOCK_ROWS * (p.B * p.H);
  flash_fwd_wgmma_kernel<T, D><<<blocks, THREADS90, L::bytes, stream>>>(q);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<D>(p, stream);
  if (dtype == 1) return launch16<bf16, D>(p, stream);
  if (dtype == 2) return launch16<f16, D>(p, stream);
  return ERR_UNSUPPORTED;
}

template <int D>
long long smem_bytes(int dtype) {
  if (dtype == 0) return static_cast<long long>(Smem<D>::bytes);
  if (dtype == 1 || dtype == 2) return static_cast<long long>(FwdLayout<D>::bytes);
  return -1;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; D in 32, 64, 128, 256. q and out
// [B, Tq, H, D], k and v [B, Tk, H, D], kmask [B, Tk], lse [B, H, Tq]; q_off and
// k_off the absolute positions of query 0 and key 0 (the causal rule compares
// k_off + k <= q_off + q). Strides are in elements. Returns 0 on a clean launch, a
// negative code of our own (flash_fwd_error_string) or the cudaError_t code.
int flash_fwd(const void* q, const void* k, const void* v, const float* kmask,
              void* out, float* lse, int B, int Tq, int Tk, int H, int D, int dtype,
              int causal, int q_off, int k_off, float scale, long long q_sb, long long q_st,
              long long q_sh, long long k_sb, long long k_st, long long k_sh,
              long long v_sb, long long v_st, long long v_sh, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kmask = kmask;
  p.o = out;
  p.lse = lse;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.B = B;
  p.Tq = Tq;
  p.Tk = Tk;
  p.H = H;
  p.causal = causal;
  p.q_off = q_off;
  p.k_off = k_off;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(p, dtype, s);
    case 64: return launch<64>(p, dtype, s);
    case 128: return launch<128>(p, dtype, s);
    case 256: return launch<256>(p, dtype, s);
    default: return ERR_UNSUPPORTED;
  }
}

// Dynamic shared memory one block takes, or -1 when unsupported.
long long flash_fwd_smem_bytes(int dtype, int D) {
  switch (D) {
    case 32: return smem_bytes<32>(dtype);
    case 64: return smem_bytes<64>(dtype);
    case 128: return smem_bytes<128>(dtype);
    case 256: return smem_bytes<256>(dtype);
    default: return -1;
  }
}

const char* flash_fwd_error_string(int code) {
  switch (code) {
    case ERR_UNSUPPORTED: return "unsupported dtype/head dim";
    case ERR_NO_ENCODER: return "cuTensorMapEncodeTiled not found in libcuda.so.1";
    case ERR_TENSOR_MAP: return "cuTensorMapEncodeTiled refused a [B, T, H, D] view";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
