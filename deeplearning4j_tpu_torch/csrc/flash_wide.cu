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
// One instantiation per operand type takes every D that is a multiple of
// 64 (the wrapper zero-pads the rest, which adds exact zeros to every
// product). The launch plan (rows a block, column groups, ring slots,
// what stays resident, shared-memory bytes) is computed in Python
// (ops/flash_attention.py `wide_plan`) and passed to each launch, which
// checks it; flash_wide_smem_bytes and flash_wide_groups report the
// shared memory and column groups the launch takes under a plan, from the
// layouts the kernels use, and chip_smoke.py holds them to wide_plan's.
//
// bf16 and f16, forward, dq and dk/dv: wgmma kernels fed by TMA (the
// design of kernels #1-#3 carried past 256 columns; sm90_common.cuh holds
// the shared pieces). Each block is three warpgroups: two consumers and a
// producer whose one thread keeps a ring of 8 KB slots full, one slot a
// 64-row x 64-column box of a [B, T, H, D] view through a 4-D tensor map,
// in the 128-byte swizzle wgmma reads (rows past T arrive as zeros). A
// slot is filled again once both consumer warpgroups have released it.
// A consumer finds a step's box addresses first (ring positions kept by
// increments, Pos: a division by the run-time slot count costs a few
// dozen instructions an address) and then issues the step's products
// straight-line: a branch between two wgmmas splits a batch in the SASS
// (WARPGROUP.ARRIVE ... gsb0 around every chunk), and at D = 512 that alone
// took the forward from 0.97 to 1.72 ms. A branch around code that reads
// the scores while the previous step's batch is in flight made ptxas
// serialize every wgmma (C7514), so the mask is applied without one.
// - forward (flash_wide_fwd_wgmma_kernel): kernel #1's shape. A block owns
//   128 query rows of one (batch, head), 64 a consumer warpgroup, and one
//   column group of up to 256 output columns, which each warpgroup sums
//   for its own rows (4 boxes, 128 f32 registers a thread). Both read the
//   same K and V boxes. S = Q.K^T (m64n64k16, both operands K-major in
//   shared memory) is summed over all of D, FWD_CHUNKS 64-column chunks a
//   step with one step's batch in flight behind the next; the online
//   softmax runs on that fragment in registers (kernel #1's: the -1e30
//   masking of the causal rule, of keys past Tk and of the key mask,
//   scale * log2(e) folded into the exponent, p rounded to the operand
//   type as the register A operand of P.V); O += P.V over the group's V
//   boxes (MN-major) is one batch. Q stays resident (loaded once) up to
//   D = 512, else it streams beside K: at B16 T2048 H4 D512 resident
//   0.97 ms, streamed 1.25. Past 256 columns the grid runs ceil(D / 256)
//   column groups side by side, each recomputing the scores in the same
//   order, so every group sees the same p bit for bit: at D = 512 the
//   scores twice and P.V once, 1.5x the forward's two products. A
//   warpgroup skips (and releases) the key tiles wholly above its rows;
//   the block loads none wholly above its last row. (A first design gave
//   a block 64 rows and both warpgroups the same scores, each summing half
//   of 512 columns: 1.75 ms, bound by its duplicated products.)
// - dq (flash_wide_dq_wgmma_kernel): kernel #2's products in the forward's
//   shape. A block owns 128 query rows, 64 a consumer warpgroup, and one
//   column group of up to 256 dq columns (4 boxes, 128 f32 registers a
//   thread). Per 64-key tile each warpgroup sums S = Q.K^T over all of D
//   (m64n64k16, both K-major in shared memory, DQ_S_CHUNKS chunks a step,
//   the previous step's batch in flight behind it), builds p = exp2(s
//   scale log2(e) - lse log2(e)) where the pair is valid and exactly 0
//   elsewhere and parks it in f32 in the thread's own words of shared
//   memory, then sums dP = dO.V^T over all of D (one chunk a step) and
//   builds ds = p (dp - delta) rounded to the operand type as the register
//   A operand of dQ += dS.K, with the group's K boxes as the MN-major B
//   operand (one batch); parking p costs 32 KB and no rounding. With dQ's
//   128 accumulators a consumer needs more than 232 registers: at 232 (and
//   the producer's 40) ptxas spilled and serialized the wgmmas (C7512),
//   with S and dP side by side and in these two passes alike; at 240 (the
//   producer 24), with the key mask read through the parameters, this one
//   compiles clean (a one-pass kernel at 240 is untried). delta carries
//   the chunk entries' lse cotangent (the wrapper folds it in). Q and dO
//   of 128 rows stream, Q beside K and dO beside V: both resident would not
//   fit at D = 512 (256 KB), and Q resident with dO streamed left 8 ring
//   slots and took 2.54-2.67 ms at B16 T2048 H4 D512 against 2.18 streamed
//   with 24 slots (on an H100, tools/wide_flash_bench.py --variants on
//   this kernel before its resident path went). The group's K boxes come
//   through the ring again for dQ. Past 256 columns the column groups
//   recompute S and dP in the same order: at D = 512, 2 (S + dP) + dQ,
//   1.67x the three products.
// - dk/dv (flash_wide_dkv_wgmma_kernel): a block owns 64 key rows and one
//   column group of up to 256 columns of dk and dv. Per 64-query tile each
//   consumer warpgroup computes S^T = K.Q^T and dP^T = V.dO^T over all of D
//   for its 32 queries (m64n32k16, DKV_CHUNKS chunks a step), builds p^T
//   (exactly 0 where the pair is masked) and ds^T = p^T (dp^T - delta)
//   rounded to the operand type as A fragments, and the two warpgroups
//   swap those fragments through 16 KB of shared memory (two named
//   barriers a tile); each then sums dV += P^T.dO and dK += dS^T.Q over
//   the tile's 64 queries for its own up to 128 columns (2 x 2 boxes, 128
//   f32 registers a thread) as one batch, with dO and Q MN-major from the
//   ring. K and V stay resident up to D = 512 (3.53 ms against 4.05
//   streamed), else they stream beside Q and dO. Past 256 columns the
//   grid runs ceil(D / 256) groups that each recompute S^T and dP^T: at
//   D = 512, 2 x (S + dP) + dV + dK, 1.5x the four products. Query tiles
//   wholly before the shifted diagonal are not loaded. It streams 192 KB
//   of boxes from L2 a (64 keys, 64 queries, group) at D = 512: Q and dO
//   over all of D for the scores, then the group's columns of both again;
//   ~13 GB at B16 T2048 H4. That stream does not bound it: built with the
//   producer skipping the score steps' boxes it takes 3.27-3.34 ms against
//   3.49-3.51 on an H100 (tools/wide_flash_bench.py --variants); the
//   consumers' work does. Keeping the group's boxes from the score steps
//   needs 4 more slots than fit beside resident K and V.
// Blocks are numbered head group by head group (HEAD_GROUP (batch, head)
// pairs a group) with the column groups of one row block side by side, so
// that blocks in flight share their K/V (Q/dO) in L2. Fixed order, no
// atomics: a run repeats bit for bit. setmaxnreg gives a consumer thread
// 232 registers and the producer's 40 (dq's: 240 and 24).
//
// float32 forward (flash_wide_fwd_tiles_kernel): f32 FMAs on register
// tiles (no TF32: f32 keeps f32 accuracy). A block of 256 threads owns 64
// query rows and one column group of up to 512 output columns, and walks
// 64-key tiles. An SM loads 32 words from shared memory a cycle and issues
// 128 FMAs, so a product keeps its FMAs busy only where a thread does 4 or
// more FMAs for each word it loads: an r x c register tile does r c FMAs
// a step for r + c words, and only 8 x 8 reaches 4. 64 x 64 scores over
// 256 threads are 4 x 4 a thread, so the threads split the columns
// instead: four groups of 64 each sum 16 columns of every 64-column chunk
// into an 8 x 8 tile (rows sy + 8 r, keys sx + 8 j), and the four
// partials meet in shared memory, summed in group order. For the softmax
// and P.V warp w holds rows w + 8 r and lane l keys l + 32 j, so a row's
// max and sum are warp shuffles, and O over columns 4 l + 128 c of the
// group (8 x 16 a thread, 128 f32 registers at 512 columns) stays in
// registers; the rows' running max and sum sit in shared memory. Operands
// stay f32 in shared memory in their natural layout, rows 4 banks apart
// (float2 score loads, float4 P.V loads, free of bank conflicts within
// each phase of a warp's access); K and Q chunks and V slabs (16 keys x
// the group's columns) come through a ring of 3 slots (tiles_slots) filled by
// cp.async two items ahead of the products, so loads overlap the math. Q
// streams with K (a resident 64 x 512 f32 Q would not fit beside the
// partials). Column groups (past 512 columns) recompute the scores in the
// same order, so every group sees the same p bit for bit; group 0 writes
// lse. Blocks are numbered head group by head group, as the wgmma kernels'.
// Design steps that did not hold: 4 x 4 score tiles (2 FMAs a word
// loaded), a per-lane column test inside P.V (now only where the group is
// narrower than 512), and 256-column groups (the scores twice at D = 512;
// tools/wide_flash_bench.py --variants times them against one group). O's
// 128 registers fit beside the 8 x 8 scores only with float2 score loads
// and the row statistics out of registers.
//
// float32 dq and dk/dv (flash_wide_dq_tiles_kernel,
// flash_wide_dkv_tiles_kernel): the forward's register tiles carried to the
// backward. Each block of 256 threads keeps its output tile in registers
// (128 f32 a thread at the widest group), streams its operands through a
// cp.async ring of 2 slots (tiles_slots), and
// computes its two score products one after the other on 8 x 8 tiles over
// split columns, so that one score tile is live beside the outputs; p and
// ds sit in shared memory. The ring sits last in shared memory, so that
// everything else has a fixed offset.
// - dq: 64 own query rows and a group of up to 512 dq columns. Per 64-key
//   tile: S = Q.K^T over all of D (a K and a Q chunk an item), p = exp(s
//   scale - lse) where the pair is valid and exactly 0 elsewhere, dP =
//   dO.V^T (a V and a dO chunk an item), ds = p (dp - delta), then dQ +=
//   dS.K over 16-key slabs of the group's K (tiles_acc, the forward's P.V).
//   Against 16-row blocks K and V are read from L2 a quarter as often.
// - dk/dv: 32 own key rows and a group of up to 512 columns of dk and dv
//   (64 key rows in groups of up to 256, which recompute the scores at D =
//   512, took 28.6 ms against 20.0 at B16 T2048 H4 D512 on an H100, and
//   went). Per 64-query tile (those wholly before the shifted diagonal not
//   loaded): S^T = K.Q^T and dP^T = V.dO^T over all of D, each chunk's
//   columns split over eight groups of 32 threads, two chunks an item (one
//   chunk's products are half of dq's, and the per-item barrier and copies
//   showed: 19.9 ms against 21.7 with one chunk an item at B16 T2048 H4
//   D512 on an H100, tools/wide_flash_bench.py --variants), p^T and ds^T
//   to shared memory, then dV += P^T.dO on warps 0-3 and dK += dS^T.Q on
//   warps 4-7 over slabs of 8 queries of the group's dO and Q (one output
//   a thread: 8 FMAs a loaded word where both outputs a thread gave 4).
// What bounds them: FMA issue, with only 8 warps an SM to hide latency; not
// the ring's depth (dq with a depth of 2-4 read at run time within 1%) nor
// what L2 holds (2 (batch, head) pairs a head group instead of 8: dq 14.7
// ms against 14.0, dk/dv 19.95 against 19.95; --variants). A slab copy that divided by the
// run-time group width in every address cost as many instructions as the
// slab's products (tiles_slab now maps threads to rows and boxes).
// Column groups recompute the scores in the same order, so every group
// sees the same p and ds bit for bit.
// Queries and keys may differ in length (Tq, Tk) and sit at absolute
// offsets, as in flash_fwd.cu and flash_bwd.cu: the causal rule is
// k_off + k <= q_off + q, a key k allowed for a query q when k <= q + shift
// (shift = q_off - k_off), and the skipped tiles are those wholly above the
// shifted diagonal.
//
// Bound (B=16, T=2048, H=4, D=512, bf16, causal: the products of kernel
// #1's flagship shape): the forward's two products are 2 * 2 * B*H*pairs*D
// = 275 GFLOP, 0.278 ms at 989 TFLOP/s, against 0.54 GB of q, k, v and
// out, 0.16 ms at 3.35 TB/s; dq's three products 0.417 ms, dk/dv's four
// 0.556 ms: all bound by operations. In f32 the forward's 275 GFLOP take
// 4.11 ms at 67 TFLOP/s of FMA, dq's three 6.16 ms and dk/dv's four 8.21
// ms. The kernels' own costs on top: the products the column groups
// recompute (the 16-bit kernels' at D = 512, the f32 kernels' past 512),
// and each K/V (Q/dO) box read from L2 once per block of own rows.

#include "sm90_common.cuh"

namespace {

constexpr float NEG_BIG = -1e30f;      // the TPU kernel's masked-score value
constexpr int DC = 64;                 // head-dim columns of a chunk
constexpr int KT = 64;                 // forward, dq: keys of a tile
constexpr size_t SMEM_LIMIT = 232448;  // the opt-in shared memory of one block
constexpr int ERR_PLAN = -4;           // a launch plan the kernel cannot run

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
  int G;                 // columns of a group
  int causal;
  int shift;             // q_off - k_off: key k is allowed for query q iff k <= q + shift
  float scale;
};

// Key tiles of KT keys a block of query rows [q0, q0 + rows) walks: all of
// Tk's, or under a causal mask those up to its last row's last allowed key
// (none when that lies before key 0).
__device__ __forceinline__ int key_tiles(const Params& p, int q0, int rows) {
  const int n = (p.Tk + KT - 1) / KT;
  if (!p.causal) return n;
  const int last = min(q0 + rows, p.Tq) - 1 + p.shift;
  return last < 0 ? 0 : min(n, last / KT + 1);
}

// ===========================================================================
// float32 forward: register tiles
// ===========================================================================

constexpr int RT_THREADS = 256;               // 8 warps
constexpr int RT_ROWS = 64;                   // query rows a block owns
constexpr int RT_LD = DC + 4;                 // 68 floats: a chunk row's pitch, 16-byte rows 4 banks apart
constexpr int RT_CHUNK = RT_ROWS * RT_LD * 4; // 17,408 bytes: a 64 x 64 chunk
constexpr int RT_SLOT = 2 * RT_CHUNK;         // a slot: two chunks, or a slab
constexpr int RT_CSL = 4;                     // 128-column slices of O a thread holds
constexpr int RT_BOXES = 2 * RT_CSL;          // 64-column chunks of a group (G <= 512)
constexpr int RT_VKEYS = 16;                  // keys of a V slab
constexpr int RT_VLD = RT_BOXES * DC + 4;     // 516 floats: a V (dq: K) slab row's pitch
constexpr int RT_SPLIT = 4;                   // 64-thread groups that split a chunk's columns
constexpr int RT_PLD = KT + 8;                // 72 floats: the partial scores' and p's pitch
constexpr int RT_PART = RT_ROWS * RT_PLD * 4; // 18,432 bytes: one group's partial scores, or p
constexpr int QT = 64;                        // dk/dv: queries of a tile
constexpr int RT_KROWS = 32;                  // dk/dv: key rows a block owns
// dk/dv takes two 64-column chunks of K (V) and Q (dO) a score item, so that
// an item holds as many products as dq's: 52,224 bytes a slot
constexpr int RT_DKV_CHUNKS = 2;
constexpr int RT_DKV_SLOT = RT_DKV_CHUNKS * (RT_KROWS + QT) * RT_LD * 4;
static_assert(RT_VKEYS * RT_VLD * 4 <= RT_SLOT, "a V slab fits a slot");
static_assert(RT_THREADS == RT_SPLIT * 64 && RT_ROWS == 64 && KT == 64 && DC == RT_SPLIT * 16,
              "8 x 8 score tiles of 64 threads, 16 columns of a chunk a group");

// Ring slots of register-tile kernel `which` (0 forward, 1 dq, 2 dk/dv):
// item n is computed from its slot while the next slots - 1 are in flight.
// dq took 13.8 ms with 2 slots against 15.6-15.7 with 3 or 4 at B16 T2048
// H4 D512 on an H100 (tools/wide_flash_bench.py --variants; a depth read
// at run time took 13.7 for 2 to 4); 2 of dk/dv's are all that fit beside
// the rest of its layout.
__host__ __device__ constexpr int tiles_slots(int which) { return which == 0 ? 3 : 2; }
// Shared memory of a register-tile layout: the ring (the backward kernels'
// last), the thread groups' partial scores (4 x 64 rows, or dk/dv's 8 x 32:
// the same bytes), p (the forward's and dq's 64 rows; dq's ds over it) or
// dk/dv's p^T and ds^T, and for the forward and dq two f32 a query row (the
// running max and sum; lse and delta).
__host__ __device__ constexpr size_t tiles_bytes(int which) {
  const size_t ps = which == 2 ? size_t(2 * RT_KROWS) * RT_PLD * 4
                                : size_t(RT_ROWS) * RT_PLD * 4 + 2 * RT_ROWS * 4;
  return size_t(tiles_slots(which)) * (which == 2 ? RT_DKV_SLOT : RT_SLOT) +
         size_t(RT_SPLIT) * RT_PART + ps;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  // src-size 0: the 16 bytes are zeros and nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [t0, t0 + ROWS) x columns [c0, c0 + 64) of one (batch, head) slice
// into the chunk at dst (pitch RT_LD), one 16-byte copy at a time; rows at
// or past T are zeros. Sixteen neighbouring threads copy one row.
template <int ROWS = RT_ROWS>
__device__ __forceinline__ void tiles_chunk(uint32_t dst, const float* base, long long st,
                                            int t0, int T_len, int c0, int tid) {
#pragma unroll
  for (int i = 0; i < ROWS * DC / 4 / RT_THREADS; ++i) {
    const int idx = tid + RT_THREADS * i;
    const int r = idx >> 4, c4 = (idx & 15) * 4, t = t0 + r;
    const bool ok = t < T_len;
    cp_async16(dst + (r * RT_LD + c4) * 4, base + (long long)(ok ? t : t0) * st + c0 + c4, ok);
  }
}

// Rows [t0, t0 + N) x columns [c0, c0 + w) (w a multiple of 64) of one
// (batch, head) slice into dst at a pitch of ld floats, one 16-byte copy
// at a time; rows at or past T are zeros. Sixteen neighbouring threads copy
// a row's 64 columns of a box, and with N < 16 rows the block covers 16 / N
// boxes a pass. (A division by the run-time width in each copy's address
// cost a slab as many instructions as its products.)
template <int N>
__device__ __forceinline__ void tiles_slab(uint32_t dst, int ld, const float* base, long long st,
                                           int t0, int T_len, int c0, int w, int tid) {
  static_assert(RT_THREADS == 256 && N <= 16 && 16 % N == 0, "16 / N boxes a pass");
  const int r = (tid >> 4) % N, t = t0 + r;
  const bool ok = t < T_len;
  const float* src = base + (long long)(ok ? t : 0) * st + c0;
  const uint32_t row = dst + r * ld * 4;
  for (int c = (tid >> 4) / N * DC + (tid & 15) * 4; c < w; c += 16 / N * DC)
    cp_async16(row + c * 4, src + c, ok);
}

// max and sum over the 32 lanes of a warp (a row's 64 keys)
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

// acc += P.X over one slab of N rows of X (pitch LD floats), from column
// p0 of P (pitch RT_PLD): the thread's rows r0 + RS r (r < R) of P and of
// acc, columns 4 lane + 128 c (c < C) of X (FULL: all of them, no per-lane
// test); P read PV columns at a time (float4, or float2 where 16 rows a
// thread would not fit 4 beside the accumulators). The forward's O += P.V,
// dq's dQ += dS.K, dk/dv's dV += P^T.dO and dK += dS^T.Q.
template <int R, int RS, int C, int N, int LD, int PV, bool FULL>
__device__ __forceinline__ void tiles_acc(float (&acc)[R][C][4], const float* P, const float* X,
                                          int p0, int r0, int lane, int gw) {
  static_assert((PV == 2 || PV == 4) && N % PV == 0, "float2 or float4 reads of P");
#pragma unroll 2
  for (int kk = 0; kk < N; kk += PV) {
    float pv[R][PV];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float* src = P + (r0 + RS * r) * RT_PLD + p0 + kk;
      if constexpr (PV == 4) {
        const float4 t = *reinterpret_cast<const float4*>(src);
        pv[r][0] = t.x;
        pv[r][1] = t.y;
        pv[r][2] = t.z;
        pv[r][3] = t.w;
      } else {
        const float2 t = *reinterpret_cast<const float2*>(src);
        pv[r][0] = t.x;
        pv[r][1] = t.y;
      }
    }
#pragma unroll
    for (int e = 0; e < PV; ++e) {
      const float* xrow = X + (kk + e) * LD + 4 * lane;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (FULL || 4 * lane + 128 * c < gw) {
          const float4 x = *reinterpret_cast<const float4*>(xrow + 128 * c);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[r][c][0] = fmaf(pv[r][e], x.x, acc[r][c][0]);
            acc[r][c][1] = fmaf(pv[r][e], x.y, acc[r][c][1]);
            acc[r][c][2] = fmaf(pv[r][e], x.z, acc[r][c][2]);
            acc[r][c][3] = fmaf(pv[r][e], x.w, acc[r][c][3]);
          }
        }
      }
    }
  }
}

// s += A.B^T over columns [d0, d0 + N) of one chunk (pitch RT_LD): the
// thread's 8 x 8 tile of A rows ay + AS r and B rows bx + 8 j, two columns
// a step (16 float2 loads for 128 FMAs: 4 FMAs a loaded word), two steps
// unrolled (against one: dk/dv 19.9 against 22.0 ms, dq 14.0 against 14.1,
// at B16 T2048 H4 D512 on an H100; --variants)
template <int AS, int N>
__device__ __forceinline__ void tiles_scores(float (&s)[8][8], const float* A, const float* Bm,
                                             int ay, int bx, int d0) {
#pragma unroll 2
  for (int d = d0; d < d0 + N; d += 2) {
    float2 bv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bv[j] = *reinterpret_cast<const float2*>(Bm + (bx + 8 * j) * RT_LD + d);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float2 av = *reinterpret_cast<const float2*>(A + (ay + AS * r) * RT_LD + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[r][j] = fmaf(av.x, bv[j].x, s[r][j]);
        s[r][j] = fmaf(av.y, bv[j].y, s[r][j]);
      }
    }
  }
}

// the thread's partial 8 x 8 tile into its group's partials (pitch RT_PLD)
template <int AS>
__device__ __forceinline__ void tiles_park(float* mine, const float (&s)[8][8], int ay, int bx) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) mine[(ay + AS * r) * RT_PLD + bx + 8 * j] = s[r][j];
}

// the (batch, head) slice of an operand, from the parameters at each use (a
// pointer held across the loops costs two registers beside the tiles)
__device__ __forceinline__ const float* slice(const void* x, long long sb, long long sh, int b,
                                              int h) {
  return static_cast<const float*>(x) + b * sb + h * sh;
}

// the NG groups' partials of one score, summed in group order
template <int NG>
__device__ __forceinline__ float tiles_sum(const float* part, int stride, int at) {
  float sum = part[at];
#pragma unroll
  for (int q = 1; q < NG; ++q) sum += part[q * stride + at];
  return sum;
}

// Zero a thread's output tile.
template <int R, int C>
__device__ __forceinline__ void tiles_zero(float (&a)[R][C][4]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[r][c][e] = 0.f;
}
__device__ __forceinline__ void tiles_zero(float (&s)[8][8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[r][j] = 0.f;
}

// A block owns 64 query rows of one (batch, head) and one column group.
// Its item stream, per 64-key tile: the score chunks of all of D (a K and
// a Q chunk), then the group's V in 4 slabs of 16 keys; item n is computed
// from slot n % SLOTS while items n + 1 and n + 2 are in flight.
// Scores: group g (threads 64 g ..) sums columns [16 g, 16 g + 16) of each
// chunk into an 8 x 8 tile a thread (rows sy + 8 r, keys sx + 8 j), the
// groups' partials summed in shared memory in group order. The softmax and
// P.V: warp w holds rows w + 8 r, lane l keys l + 32 j and the columns
// 4 l + 128 c of O (8 x 8 a thread).
template <typename T>
__global__ void __launch_bounds__(RT_THREADS, 1) flash_wide_fwd_tiles_kernel(const Params p) {
  static_assert(std::is_same<T, float>::value, "float32 operands");
  constexpr int SLOTS = tiles_slots(0);
  extern __shared__ __align__(16) float sm[];
  const int D = p.D, Tq = p.Tq, Tk = p.Tk, G = p.G, nbd = D / DC;
  const int n_qb = (Tq + RT_ROWS - 1) / RT_ROWS;
  const int n_groups = (D + G - 1) / G;
  const int z = blockIdx.x % n_groups;   // column groups of one row block run side by side
  int bh, qblk;
  block_coords(blockIdx.x / n_groups, p.B * p.H, n_qb, p.causal, bh, qblk);
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qblk * RT_ROWS;
  const int g0 = z * G, gw = min(G, D - g0);   // this block's columns
  float* ring = sm;                                        // SLOTS slots
  float* part = ring + SLOTS * (RT_SLOT / 4);              // [RT_SPLIT][64][RT_PLD]
  float* Ps = part + RT_SPLIT * (RT_PART / 4);             // p [64][RT_PLD]
  float* m_s = Ps + RT_PART / 4;                           // [64] running max of each row
  float* l_s = m_s + RT_ROWS;                              // [64] running sum
  const uint32_t ring_s = smem_u32(ring);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = tid >> 6, sy = (tid & 63) >> 3, sx = tid & 7;   // the score split
  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* kmask = p.kmask != nullptr ? p.kmask + (long long)b * Tk : nullptr;
  const int n_kt = key_tiles(p, q0, RT_ROWS);
  const int per_tile = nbd + KT / RT_VKEYS;
  const int n_items = n_kt * per_tile;

  // the next item to load: tile it_kt, entry it_e, into slot it_slot
  int it_kt = 0, it_e = 0, it_slot = 0;
  auto load_next = [&]() {
    if (it_kt < n_kt) {
      const int k0 = it_kt * KT;
      const uint32_t dst = ring_s + it_slot * RT_SLOT;
      if (it_e < nbd) {
        tiles_chunk(dst, kb, p.k_st, k0, Tk, it_e * DC, tid);
        tiles_chunk(dst + RT_CHUNK, qb, p.q_st, q0, Tq, it_e * DC, tid);
      } else {
        tiles_slab<RT_VKEYS>(dst, RT_VLD, vb, p.v_st, k0 + (it_e - nbd) * RT_VKEYS, Tk, g0, gw,
                             tid);
      }
      if (++it_e == per_tile) {
        it_e = 0;
        ++it_kt;
      }
      if (++it_slot == SLOTS) it_slot = 0;
    }
    cp_commit();   // an empty group past the last item keeps the count
  };
#pragma unroll
  for (int i = 0; i < SLOTS - 1; ++i) load_next();

  // O: rows w + 8 r, columns 4 lane + 128 c + e of the group; the rows'
  // running max and sum sit in shared memory (every lane of the row's warp
  // reads them, a tile at a time), so as not to take registers beside O
  float o[8][RT_CSL][4];
  if (tid < RT_ROWS) {
    m_s[tid] = NEG_BIG;
    l_s[tid] = 0.f;
  }
  tiles_zero(o);
  float s[8][8];      // the group's partial scores: rows sy + 8 r, keys sx + 8 j
  int kt = 0, e_i = 0, slot = 0;   // the item being computed
  for (int n = 0; n < n_items; ++n) {
    cp_wait<SLOTS - 2>();   // item n has landed (this thread's copies)
    __syncthreads();        // ... everyone's; and slot (n - 1) % SLOTS is read
    load_next();
    const float* sl = ring + slot * (RT_SLOT / 4);
    if (e_i < nbd) {
      // the group's 16 columns of the chunk (Q rows, K rows), 2 at a time
      // (float2 loads: a float4's operands would not fit beside O)
      if (e_i == 0) tiles_zero(s);
      tiles_scores<8, 16>(s, sl + RT_CHUNK / 4, sl, sy, sx, 16 * g);
      if (e_i == nbd - 1) {
        // the tile's scores: the groups' partials summed in group order,
        // masked to -1e30 (causal, keys past Tk, the key mask) as the TPU
        // kernel does, then the online softmax of the warp's rows; p goes
        // to shared memory for P.V
        tiles_park<8>(part + g * (RT_PART / 4), s, sy, sx);
        __syncthreads();
        const int k0 = kt * KT;
        bool kok[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = k0 + lane + 32 * j;
          kok[j] = key < Tk && (kmask == nullptr || kmask[key] > 0.f);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int row = w + 8 * r, qrow = q0 + row;
          float x[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float sum = tiles_sum<RT_SPLIT>(part, RT_PART / 4, row * RT_PLD + lane + 32 * j);
            const bool ok = kok[j] && (!p.causal || k0 + lane + 32 * j <= qrow + p.shift);
            x[j] = ok ? sum * p.scale : NEG_BIG;
          }
          const float m_old = m_s[row];
          const float m_new = fmaxf(m_old, warp_max(fmaxf(x[0], x[1])));
          const float alpha = expf(m_old - m_new);
          const float e0 = expf(x[0] - m_new), e1 = expf(x[1] - m_new);
          Ps[row * RT_PLD + lane] = e0;
          Ps[row * RT_PLD + lane + 32] = e1;
          const float l_new = l_s[row] * alpha + warp_sum(e0 + e1);
          __syncwarp();   // every lane has read the row's m and l
          if (lane == 0) {
            m_s[row] = m_new;
            l_s[row] = l_new;
          }
#pragma unroll
          for (int c = 0; c < RT_CSL; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[r][c][e] *= alpha;
        }
      }
    } else {
      // O += P.V over one slab of keys and the group's columns
      const int k_in = (e_i - nbd) * RT_VKEYS;   // the slab's first key in the tile
      if (gw == RT_BOXES * DC)
        tiles_acc<8, 8, RT_CSL, RT_VKEYS, RT_VLD, 4, true>(o, Ps, sl, k_in, w, lane, gw);
      else
        tiles_acc<8, 8, RT_CSL, RT_VKEYS, RT_VLD, 4, false>(o, Ps, sl, k_in, w, lane, gw);
    }
    if (++e_i == per_tile) {
      e_i = 0;
      ++kt;
    }
    if (++slot == SLOTS) slot = 0;
  }
  cp_wait<0>();

  __syncthreads();   // the rows' last m and l (with no key tile, their first) are visible
  float* out = static_cast<float*>(p.o);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int t = q0 + w + 8 * r;
    if (t >= Tq) continue;
    const float lc = fmaxf(l_s[w + 8 * r], 1e-30f);
    float* orow = out + (((long long)b * Tq + t) * p.H + h) * D + g0 + 4 * lane;
#pragma unroll
    for (int c = 0; c < RT_CSL; ++c)
      if (4 * lane + 128 * c < gw)
        *reinterpret_cast<float4*>(orow + 128 * c) =
            make_float4(o[r][c][0] / lc, o[r][c][1] / lc, o[r][c][2] / lc, o[r][c][3] / lc);
    if (z == 0 && lane == 0) p.lse_out[(long long)bh * Tq + t] = m_s[w + 8 * r] + logf(lc);
  }
}

// ===========================================================================
// float32 dq and dk/dv: register tiles
// ===========================================================================

// dq: a block of 256 threads owns 64 query rows of one (batch, head) and
// one column group of up to 512 dq columns; dQ stays in registers (rows
// w + 8 r, columns 4 lane + 128 c of the group: the forward's O). Its item
// stream, per 64-key tile: the S chunks of all of D (a K and a Q chunk),
// then the dP chunks (a V and a dO chunk), then the group's K in 4 slabs of
// 16 keys; item n is computed from its slot while the next is in flight. S, then dP (one 8 x 8 score tile live beside dQ): the
// forward's split, group g (threads 64 g ..) summing columns [16 g, 16 g +
// 16) of each chunk into rows sy + 8 r, keys sx + 8 j, the four partials
// summed in group order. After S, p = exp(s scale - lse) where the pair is
// valid and exactly 0 elsewhere goes to shared memory (warp w rows w + 8 r,
// lane l keys l + 32 j); after dP, ds = p (dp - delta) over it; then dQ +=
// dS.K over the slabs (tiles_acc, as the forward's P.V). Column groups (past
// 512 columns) recompute S and dP in the same order.
template <typename T>
__global__ void __launch_bounds__(RT_THREADS, 1) flash_wide_dq_tiles_kernel(const Params p) {
  static_assert(std::is_same<T, float>::value, "float32 operands");
  constexpr int SLOTS = tiles_slots(1);
  extern __shared__ __align__(16) float sm[];
  const int D = p.D, Tq = p.Tq, Tk = p.Tk, G = p.G, nbd = D / DC;
  const int n_qb = (Tq + RT_ROWS - 1) / RT_ROWS;
  const int n_groups = (D + G - 1) / G;
  const int z = blockIdx.x % n_groups;   // column groups of one row block run side by side
  int bh, qblk;
  block_coords(blockIdx.x / n_groups, p.B * p.H, n_qb, p.causal, bh, qblk);
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qblk * RT_ROWS;
  const int g0 = z * G, gw = min(G, D - g0);   // this block's columns
  // the ring last, so that everything else sits at a fixed offset
  float* part = sm;                                  // [RT_SPLIT][64][RT_PLD]
  float* Ps = part + RT_SPLIT * (RT_PART / 4);       // p, then ds: [64][RT_PLD]
  float* lse_s = Ps + RT_PART / 4;                   // [64]
  float* dl_s = lse_s + RT_ROWS;                     // [64] delta
  float* ring = dl_s + RT_ROWS;                      // SLOTS slots
  const uint32_t ring_s = smem_u32(ring);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = tid >> 6, sy = (tid & 63) >> 3, sx = tid & 7;   // the score split
  const int n_kt = key_tiles(p, q0, RT_ROWS);
  const int per_tile = 2 * nbd + KT / RT_VKEYS;

  // the next item to load: tile it_kt, entry it_e
  int it_kt = 0, it_e = 0;
  auto load_next = [&](int to_slot) {
    if (it_kt < n_kt) {
      const int k0 = it_kt * KT;
      const uint32_t dst = ring_s + to_slot * RT_SLOT;
      if (it_e < nbd) {            // S: a K and a Q chunk
        tiles_chunk(dst, slice(p.k, p.k_sb, p.k_sh, b, h), p.k_st, k0, Tk, it_e * DC, tid);
        tiles_chunk(dst + RT_CHUNK, slice(p.q, p.q_sb, p.q_sh, b, h), p.q_st, q0, Tq,
                    it_e * DC, tid);
      } else if (it_e < 2 * nbd) { // dP: a V and a dO chunk
        const int c0 = (it_e - nbd) * DC;
        tiles_chunk(dst, slice(p.v, p.v_sb, p.v_sh, b, h), p.v_st, k0, Tk, c0, tid);
        tiles_chunk(dst + RT_CHUNK, slice(p.dout, p.o_sb, p.o_sh, b, h), p.o_st, q0, Tq, c0,
                    tid);
      } else {                     // a slab of the group's K
        tiles_slab<RT_VKEYS>(dst, RT_VLD, slice(p.k, p.k_sb, p.k_sh, b, h), p.k_st,
                             k0 + (it_e - 2 * nbd) * RT_VKEYS, Tk, g0, gw, tid);
      }
      if (++it_e == per_tile) {
        it_e = 0;
        ++it_kt;
      }
    }
    cp_commit();   // an empty group past the last item keeps the count
  };
  for (int i = 0; i < SLOTS - 1; ++i) load_next(i);
  // the item being computed (in slot `slot`): wait for it, then load the
  // one slots - 1 ahead into the previous item's slot, which every thread
  // has finished with
  int slot = 0;
  auto next_item = [&]() {
    cp_wait<SLOTS - 2>();
    __syncthreads();
    load_next(slot == 0 ? SLOTS - 1 : slot - 1);
    const float* sl = ring + slot * (RT_SLOT / 4);
    if (++slot == SLOTS) slot = 0;
    return sl;
  };

  if (tid < RT_ROWS) {   // read after the first item's barrier
    const int t = q0 + tid;
    lse_s[tid] = t < Tq ? p.lse[(long long)bh * Tq + t] : 0.f;
    dl_s[tid] = t < Tq ? p.delta[(long long)bh * Tq + t] : 0.f;
  }
  float a[8][RT_CSL][4];
  tiles_zero(a);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * KT;
    float s[8][8];
    // S = Q.K^T over all of D
    tiles_zero(s);
    for (int c = 0; c < nbd; ++c) {
      const float* sl = next_item();
      tiles_scores<8, 16>(s, sl + RT_CHUNK / 4, sl, sy, sx, 16 * g);
    }
    tiles_park<8>(part + g * (RT_PART / 4), s, sy, sx);
    __syncthreads();
    bool kok[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int key = k0 + lane + 32 * j;
      kok[j] = key < Tk && (p.kmask == nullptr || p.kmask[(long long)b * Tk + key] > 0.f);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = w + 8 * r, qrow = q0 + row;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int at = row * RT_PLD + lane + 32 * j;
        const bool ok = kok[j] && qrow < Tq && (!p.causal || k0 + lane + 32 * j <= qrow + p.shift);
        const float sum = tiles_sum<RT_SPLIT>(part, RT_PART / 4, at);
        Ps[at] = ok ? expf(sum * p.scale - lse_s[row]) : 0.f;
      }
    }
    // dP = dO.V^T over all of D (the partials rewritten after nbd barriers)
    tiles_zero(s);
    for (int c = 0; c < nbd; ++c) {
      const float* sl = next_item();
      tiles_scores<8, 16>(s, sl + RT_CHUNK / 4, sl, sy, sx, 16 * g);
    }
    tiles_park<8>(part + g * (RT_PART / 4), s, sy, sx);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = w + 8 * r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {   // the thread's own p: no barrier
        const int at = row * RT_PLD + lane + 32 * j;
        Ps[at] = Ps[at] * (tiles_sum<RT_SPLIT>(part, RT_PART / 4, at) - dl_s[row]);
      }
    }
    // dQ += dS.K over the group's columns, a slab of 16 keys at a time
    for (int e = 0; e < KT / RT_VKEYS; ++e) {
      const float* sl = next_item();
      if (gw == RT_BOXES * DC)
        tiles_acc<8, 8, RT_CSL, RT_VKEYS, RT_VLD, 4, true>(a, Ps, sl, e * RT_VKEYS, w, lane, gw);
      else
        tiles_acc<8, 8, RT_CSL, RT_VKEYS, RT_VLD, 4, false>(a, Ps, sl, e * RT_VKEYS, w, lane,
                                                            gw);
    }
  }
  cp_wait<0>();

  float* out = static_cast<float*>(p.o);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int t = q0 + w + 8 * r;
    if (t >= Tq) continue;
    float* orow = out + (((long long)b * Tq + t) * p.H + h) * D + g0 + 4 * lane;
#pragma unroll
    for (int c = 0; c < RT_CSL; ++c)
      if (4 * lane + 128 * c < gw)
        *reinterpret_cast<float4*>(orow + 128 * c) =
            make_float4(a[r][c][0] * p.scale, a[r][c][1] * p.scale, a[r][c][2] * p.scale,
                        a[r][c][3] * p.scale);
  }
}

// dk/dv: a block of 256 threads owns 32 key rows of one (batch, head) and
// one column group of up to 512 columns of dk and dv; dV stays in the
// registers of warps 0-3, dK in those of warps 4-7 (keys w % 4 + 4 r,
// columns 4 lane + 128 c of the group: G / 4 f32 a thread, each loaded word
// of dO or Q used for 8 FMAs where one thread holding both dK and dV gets
// 4). It walks 64-query tiles, those wholly before the shifted diagonal not
// loaded. Its item stream, per query tile: the S^T chunks of all of D (two
// K chunks of the block's keys and two Q chunks an item), then the dP^T
// chunks (V and dO), then the group's dO and Q in slabs of 8 queries; item
// n is computed from its slot while the next is in flight. S^T = K.Q^T,
// then dP^T = V.dO^T: each 64-column chunk split over eight groups of 32
// threads, group gi summing columns [8 gi, 8 gi + 8) into an 8 x 8 tile
// (keys sy + 4 r, queries sx + 8 j), the partials summed in group order; p^T = exp(s scale - lse)
// where the pair is valid and exactly 0 elsewhere and ds^T = p^T (dp^T -
// delta) go to shared memory (warp w keys w + 8 r, lane l queries l + 32
// j); then dV += P^T.dO (warps 0-3) and dK += dS^T.Q (warps 4-7) over the
// slabs. Column groups recompute S^T and dP^T in the same order.
template <typename T>
__global__ void __launch_bounds__(RT_THREADS, 1) flash_wide_dkv_tiles_kernel(const Params p) {
  static_assert(std::is_same<T, float>::value, "float32 operands");
  constexpr int KROWS = RT_KROWS;
  constexpr int NG = RT_THREADS / KROWS;   // groups splitting a chunk's columns
  constexpr int NCOL = DC / NG;            // columns of a chunk a group sums
  constexpr int AS = KROWS / 8;            // key stride of a thread's score tile
  constexpr int KP = KROWS / 8;            // keys a thread holds in p^T and ds^T: w + 8 r
  constexpr int KW = KROWS / 4;            // keys a thread holds in dV or dK: w % 4 + 4 r
  constexpr int CSL = 128 / KROWS;         // 128-column slices of dV or dK a thread holds
  constexpr int SQ = 8;                    // queries of a slab
  constexpr int SLD = 128 * CSL + 4;       // a slab row's pitch (floats)
  constexpr int PV = 4;                    // p^T (ds^T) columns read at a time
  constexpr int CH = RT_DKV_CHUNKS;        // 64-column chunks of a score item
  constexpr int KS = CH * KROWS * RT_LD;   // floats of a score item's K (V) chunks
  constexpr int SLOT = RT_DKV_SLOT;
  constexpr int SLOTS = tiles_slots(2);
  static_assert(NG * KROWS * RT_PLD * 4 == RT_SPLIT * RT_PART, "the forward's partial bytes");
  static_assert(2 * SQ * SLD * 4 <= SLOT && QT % SQ == 0 && SQ % 4 == 0,
                "a dO and a Q slab fit a slot");
  static_assert(KROWS * DC / 4 % RT_THREADS == 0, "whole copies of a key chunk");
  extern __shared__ __align__(16) float sm[];
  const int D = p.D, Tq = p.Tq, Tk = p.Tk, G = p.G, nbd = D / DC;
  const int n_si = (nbd + CH - 1) / CH;   // score items of a pass over D
  const int n_kb = (Tk + KROWS - 1) / KROWS;
  const int n_groups = (D + G - 1) / G;
  const int z = blockIdx.x % n_groups;
  int bh, kblk;
  // key blocks in order: under a causal mask the first see the most queries
  block_coords(blockIdx.x / n_groups, p.B * p.H, n_kb, 0, bh, kblk);
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = kblk * KROWS;
  const int g0 = z * G, gw = min(G, D - g0);
  // the ring last, so that everything else sits at a fixed offset
  float* part = sm;                                 // [NG][KROWS][RT_PLD]
  float* PT = part + RT_SPLIT * (RT_PART / 4);      // p^T [KROWS][RT_PLD]
  float* DST = PT + KROWS * RT_PLD;                 // ds^T [KROWS][RT_PLD]
  float* ring = DST + KROWS * RT_PLD;               // SLOTS slots
  const uint32_t ring_s = smem_u32(ring);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int gi = tid / KROWS, sy = (tid % KROWS) >> 3, sx = tid & 7;   // the score split
  const int dk_half = w >> 2, w4 = w & 3;   // warps 4-7 sum dK, warps 0-3 dV
  // query tiles wholly before k0 - shift (the first query that may see key
  // k0) see none of the block's keys: the first tile walked starts at qs_first
  const int qs_first = p.causal && k0 - p.shift > 0 ? (k0 - p.shift) / QT * QT : 0;

  int it_qs = qs_first, it_e = 0;   // the next item to load: tile it_qs, entry it_e
  auto load_next = [&](int to_slot) {
    if (it_qs < Tq) {
      const int qs0 = it_qs;
      const uint32_t dst = ring_s + to_slot * SLOT;
      if (it_e < 2 * n_si) {   // S^T: CH K and Q chunks; dP^T: CH V and dO chunks
        const bool s_step = it_e < n_si;
        const int c0 = (s_step ? it_e : it_e - n_si) * CH;
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          if (c0 + u < nbd) {
            const int col = (c0 + u) * DC;
            if (s_step) {
              tiles_chunk<KROWS>(dst + u * KROWS * RT_LD * 4, slice(p.k, p.k_sb, p.k_sh, b, h),
                                 p.k_st, k0, Tk, col, tid);
              tiles_chunk(dst + (KS + u * QT * RT_LD) * 4, slice(p.q, p.q_sb, p.q_sh, b, h),
                          p.q_st, qs0, Tq, col, tid);
            } else {
              tiles_chunk<KROWS>(dst + u * KROWS * RT_LD * 4, slice(p.v, p.v_sb, p.v_sh, b, h),
                                 p.v_st, k0, Tk, col, tid);
              tiles_chunk(dst + (KS + u * QT * RT_LD) * 4,
                          slice(p.dout, p.o_sb, p.o_sh, b, h), p.o_st, qs0, Tq, col, tid);
            }
          }
        }
      } else {                 // a slab of the group's dO, then of its Q
        const int t0 = qs0 + (it_e - 2 * n_si) * SQ;
        tiles_slab<SQ>(dst, SLD, slice(p.dout, p.o_sb, p.o_sh, b, h), p.o_st, t0, Tq, g0, gw,
                       tid);
        tiles_slab<SQ>(dst + SQ * SLD * 4, SLD, slice(p.q, p.q_sb, p.q_sh, b, h), p.q_st, t0,
                       Tq, g0, gw, tid);
      }
      if (++it_e == 2 * n_si + QT / SQ) {
        it_e = 0;
        it_qs += QT;
      }
    }
    cp_commit();
  };
  for (int i = 0; i < SLOTS - 1; ++i) load_next(i);
  int slot = 0;
  auto next_item = [&]() {
    cp_wait<SLOTS - 2>();
    __syncthreads();
    load_next(slot == 0 ? SLOTS - 1 : slot - 1);
    const float* sl = ring + slot * (SLOT / 4);
    if (++slot == SLOTS) slot = 0;
    return sl;
  };

  float acc[KW][CSL][4];   // dV (warps 0-3) or dK (warps 4-7)
  tiles_zero(acc);
  for (int qs0 = qs_first; qs0 < Tq; qs0 += QT) {
    float s[8][8];
    // S^T = K.Q^T over all of D, CH chunks an item (a loop: unrolled, the
    // 32-row kernel spilled and took 20.7 ms against 19.9 at B16 T2048 H4
    // D512; --variants)
    tiles_zero(s);
    for (int c = 0; c < nbd; c += CH) {
      const float* sl = next_item();
#pragma unroll 1
      for (int u = 0; u < CH; ++u)
        if (c + u < nbd)
          tiles_scores<AS, NCOL>(s, sl + u * KROWS * RT_LD, sl + KS + u * QT * RT_LD, sy, sx,
                                 NCOL * gi);
    }
    tiles_park<AS>(part + gi * (KROWS * RT_PLD), s, sy, sx);
    __syncthreads();
    float lse[2];   // of the lane's queries lane + 32 j
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int q = qs0 + lane + 32 * j;
      lse[j] = q < Tq ? p.lse[(long long)bh * Tq + q] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < KP; ++r) {
      const int key = w + 8 * r;   // its validity against Tk and the key mask, read here
      const bool kok = k0 + key < Tk &&
                       (p.kmask == nullptr || p.kmask[(long long)b * Tk + k0 + key] > 0.f);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int q = lane + 32 * j, qpos = qs0 + q, at = key * RT_PLD + q;
        const bool ok = kok && qpos < Tq && (!p.causal || k0 + key <= qpos + p.shift);
        const float sum = tiles_sum<NG>(part, KROWS * RT_PLD, at);
        PT[at] = ok ? expf(sum * p.scale - lse[j]) : 0.f;
      }
    }
    // dP^T = V.dO^T over all of D
    tiles_zero(s);
    for (int c = 0; c < nbd; c += CH) {
      const float* sl = next_item();
#pragma unroll 1
      for (int u = 0; u < CH; ++u)
        if (c + u < nbd)
          tiles_scores<AS, NCOL>(s, sl + u * KROWS * RT_LD, sl + KS + u * QT * RT_LD, sy, sx,
                                 NCOL * gi);
    }
    tiles_park<AS>(part + gi * (KROWS * RT_PLD), s, sy, sx);
    __syncthreads();
    float delta[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int q = qs0 + lane + 32 * j;
      delta[j] = q < Tq ? p.delta[(long long)bh * Tq + q] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < KP; ++r) {
      const int key = w + 8 * r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {   // the thread's own p^T: no barrier
        const int at = key * RT_PLD + lane + 32 * j;
        DST[at] = PT[at] * (tiles_sum<NG>(part, KROWS * RT_PLD, at) - delta[j]);
      }
    }
    // dV += P^T.dO, dK += dS^T.Q over the group's columns, a slab at a time
    const float* Pm = dk_half ? DST : PT;
    for (int e = 0; e < QT / SQ; ++e) {
      const float* X = next_item() + dk_half * (SQ * SLD);   // the slab's dO, or its Q
      if (gw == 128 * CSL)
        tiles_acc<KW, 4, CSL, SQ, SLD, PV, true>(acc, Pm, X, e * SQ, w4, lane, gw);
      else
        tiles_acc<KW, 4, CSL, SQ, SLD, PV, false>(acc, Pm, X, e * SQ, w4, lane, gw);
    }
  }
  cp_wait<0>();

  // dk = scale * dS^T.Q, dv = P^T.dO
  float* out = static_cast<float*>(dk_half ? p.o : p.o2);
  const float mul = dk_half ? p.scale : 1.f;
#pragma unroll
  for (int r = 0; r < KW; ++r) {
    const int t = k0 + w4 + 4 * r;
    if (t >= Tk) continue;
    float* orow = out + (((long long)b * Tk + t) * p.H + h) * D + g0 + 4 * lane;
#pragma unroll
    for (int c = 0; c < CSL; ++c)
      if (4 * lane + 128 * c < gw)
        *reinterpret_cast<float4*>(orow + 128 * c) =
            make_float4(acc[r][c][0] * mul, acc[r][c][1] * mul, acc[r][c][2] * mul,
                        acc[r][c][3] * mul);
  }
}

// ===========================================================================
// bf16 and f16, forward and dk/dv: wgmma kernels fed by TMA
// ===========================================================================

constexpr int BOX = 64;                         // rows and head-dim columns of a TMA box
constexpr int BOX_BYTES = BOX * BOX * 2;        // 8 KB: one 128-byte-swizzled 64 x 64 tile
constexpr int FWD_WG_BOXES = 4;                 // output boxes a forward warpgroup sums (256 columns)
constexpr int DQ_WG_BOXES = 4;                  // dq boxes a dq warpgroup sums (256 columns)
constexpr int DKV_WG_BOXES = 2;                 // dk and dv boxes a dk/dv warpgroup sums (128 columns)
constexpr int FWD_CHUNKS = 4;                   // 64-column chunks of D a forward score step sums
constexpr int DKV_CHUNKS = 2;                   // and a dk/dv score step
constexpr int DQ_S_CHUNKS = 2;                  // and a dq S step (a dP step: one)
constexpr int DQ_P_BYTES = CONSUMERS * WG * 32 * 4;   // dq: a tile's p, 32 f32 a consumer thread
// dq's consumers hold dQ (128 f32) beside S or dP (32): they take 240
// registers a thread and leave the producer 24 (at 232 and 40 they spilled)
constexpr int DQ_PRODUCER_REGS = 24;
constexpr int DQ_CONSUMER_REGS = 240;
static_assert(LAUNCH_REGS - DQ_PRODUCER_REGS == CONSUMERS * (DQ_CONSUMER_REGS - LAUNCH_REGS),
              "setmaxnreg must balance");
constexpr int MAX_SLOTS = 32;
constexpr int XCH_BYTES = CONSUMERS * WG * 16 * 4;   // dk/dv: 16 fragment words a consumer thread
constexpr float NEG_BIG2 = NEG_BIG * LOG2E;     // NEG_BIG in the log2 units of the softmax
constexpr float LN2 = 0.6931471805599453f;

struct Wide90 {
  CUtensorMap q, k, v, o;   // q, do [B, Tq, H, D]; k, v [B, Tk, H, D]; boxes of 64 x 64
  const float* kmask;       // [B, Tk] or nullptr
  const float* lse;         // dq, dk/dv: [B, H, Tq]
  const float* delta;       // dq, dk/dv: [B, H, Tq]
  float* lse_out;           // forward: [B, H, Tq]
  void* g0;                 // forward: out; dq: dq; dk/dv: dk ([B, T, H, D] contiguous)
  void* g1;                 // dk/dv: dv
  int B, Tq, Tk, H, D, causal;
  int shift;                // q_off - k_off: key k is allowed for query q iff k <= q + shift
  int G;                    // columns of a column group (a multiple of 64)
  int slots;                // 8 KB slots of the ring
  int resident;             // forward: Q resident; dk/dv: K and V resident
  float scale;
};

// Shared-memory layout of a plan: the resident boxes, dk/dv's fragment
// exchange or dq's p, the ring, the barriers (own_full, full[slots],
// empty[slots]), and 1024 bytes to align the 128-byte swizzle.
struct WideLayout {
  size_t res, xch, ring, bars, bytes;
};

__host__ __device__ inline WideLayout wide_layout(int which, int D, int slots, int resident) {
  WideLayout L;
  const size_t nb = size_t(D / BOX);
  L.res = 0;   // forward: Q's boxes (both row halves); dk/dv: K's, then V's
  L.xch = resident ? 2 * nb * BOX_BYTES : 0;
  L.ring = L.xch + (which == 2 ? XCH_BYTES : which == 1 ? DQ_P_BYTES : 0);
  L.bars = L.ring + size_t(slots) * BOX_BYTES;
  L.bytes = L.bars + size_t(1 + 2 * slots) * 8 + 1024;
  return L;
}

__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(CONSUMERS * WG) : "memory");
}

// A place in the ring: item n's slot (n % slots) and the parity of that
// slot's use ((n / slots) % 2), kept by increments: a division by the run-
// time slot count in every address costs a few dozen instructions.
struct Pos {
  int slot;
  uint32_t phase;
};

// The ring as producer and consumers walk it, item by item.
struct Ring {
  uint32_t base;   // the first slot's shared address
  uint64_t* full;
  uint64_t* empty;
  int slots;
  // the place e items on (e <= slots)
  __device__ __forceinline__ Pos plus(Pos p, int e) const {
    p.slot += e;
    if (p.slot >= slots) {
      p.slot -= slots;
      p.phase ^= 1u;
    }
    return p;
  }
  __device__ __forceinline__ uint32_t at(Pos p, int e) const {
    return base + plus(p, e).slot * BOX_BYTES;
  }
  // producer: load one box into item p's slot once both consumer warpgroups
  // have released its last use, and step on
  __device__ __forceinline__ void put(Pos& p, const CUtensorMap* map, int col, int h, int row,
                                      int b) const {
    bar_wait(&empty[p.slot], p.phase ^ 1u);
    bar_arrive_tx(&full[p.slot], BOX_BYTES);
    tma_box(base + p.slot * BOX_BYTES, map, &full[p.slot], col, h, row, b);
    p = plus(p, 1);
  }
  __device__ __forceinline__ void wait(Pos p, int count) const {
    for (int e = 0; e < count; ++e) {
      bar_wait(&full[p.slot], p.phase);
      p = plus(p, 1);
    }
  }
  // consumer warp: the count items from p are read (one arrival a warp)
  __device__ __forceinline__ void release(Pos p, int count, int lane) const {
    __syncwarp();
    if (lane == 0)
      for (int e = 0; e < count; ++e) {
        bar_arrive(&empty[p.slot]);
        p = plus(p, 1);
      }
  }
};

// One forward score step: NC chunks of D from item `pos` (a chunk: the Q
// boxes of both row halves unless Q is resident, then K), the box
// addresses found first and the products issued straight-line, so that
// they stay one wgmma batch (a branch between them splits it).
template <typename T, int NC>
__device__ __forceinline__ void fwd_score_step(float (&sc)[32], const Ring& ring, Pos pos,
                                               int per_chunk, int resident, uint32_t res_q,
                                               int c0, int wg) {
  uint32_t qa[NC], kb[NC];
#pragma unroll
  for (int cc = 0; cc < NC; ++cc) {
    qa[cc] = resident ? res_q + (2 * (c0 + cc) + wg) * BOX_BYTES
                      : ring.at(pos, cc * per_chunk + wg);
    kb[cc] = ring.at(pos, cc * per_chunk + per_chunk - 1);
  }
  ring.wait(pos, NC * per_chunk);
  wg_fence();
#pragma unroll
  for (int cc = 0; cc < NC; ++cc)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<T>(sc, desc_k<64, 64>(qa[cc], 0, kk), desc_k<64, 64>(kb[cc], 0, kk),
                  c0 + cc > 0 || kk > 0);
  wg_commit();
}

// O += P.V over NB boxes of V, straight-line.
template <typename T, int NB>
__device__ __forceinline__ void fwd_pv(float (&o)[FWD_WG_BOXES][32], const uint32_t (&a)[4][4],
                                       const uint32_t (&vb)[FWD_WG_BOXES]) {
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<T>(o[c], a[kk], desc_mn<64, 64>(vb[c], 0, kk));
}

// dV += P^T.dO and dK += dS^T.Q over NB boxes of dO and Q, straight-line.
template <typename T, int NB>
__device__ __forceinline__ void dkv_accumulate(float (&dk)[DKV_WG_BOXES][32],
                                               float (&dv)[DKV_WG_BOXES][32],
                                               const uint32_t (&pf)[4][4],
                                               const uint32_t (&sf)[4][4],
                                               const uint32_t (&qb)[DKV_WG_BOXES],
                                               const uint32_t (&ob)[DKV_WG_BOXES]) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<T>(dv[j], pf[kk], desc_mn<64, 64>(ob[j], 0, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<T>(dk[j], sf[kk], desc_mn<64, 64>(qb[j], 0, kk));
  }
}

// One dk/dv score step: NC chunks of D from item `pos` (a chunk: K and V
// unless resident, then Q and dO), S^T and dP^T for the warpgroup's 32
// queries (rows `half` of the Q and dO boxes) as one wgmma batch.
template <typename T, int NC>
__device__ __forceinline__ void dkv_score_step(float (&sc)[16], float (&dp)[16], const Ring& ring,
                                               Pos pos, int per_chunk, int resident,
                                               uint32_t res_k, uint32_t res_v, int c0,
                                               int half) {
  uint32_t ka[NC], va[NC], qb[NC], ob[NC];
#pragma unroll
  for (int cc = 0; cc < NC; ++cc) {
    const int m = cc * per_chunk;
    ka[cc] = resident ? res_k + (c0 + cc) * BOX_BYTES : ring.at(pos, m);
    va[cc] = resident ? res_v + (c0 + cc) * BOX_BYTES : ring.at(pos, m + 1);
    qb[cc] = ring.at(pos, m + per_chunk - 2);
    ob[cc] = ring.at(pos, m + per_chunk - 1);
  }
  ring.wait(pos, NC * per_chunk);
  wg_fence();
#pragma unroll
  for (int cc = 0; cc < NC; ++cc) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<T>(sc, desc_k<64, 64>(ka[cc], 0, kk), desc_k<64, 64>(qb[cc], half, kk),
                  c0 + cc > 0 || kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<T>(dp, desc_k<64, 64>(va[cc], 0, kk), desc_k<64, 64>(ob[cc], half, kk),
                  c0 + cc > 0 || kk > 0);
  }
  wg_commit();
}

// One dq S step: NC chunks of D from item `pos` (a chunk: Q of both row
// halves, K), S = Q.K^T for the warpgroup's 64 rows as one wgmma batch,
// straight-line.
template <typename T, int NC>
__device__ __forceinline__ void dq_s_step(float (&sc)[32], const Ring& ring, Pos pos, int c0,
                                          int wg) {
  uint32_t qa[NC], kb[NC];
#pragma unroll
  for (int cc = 0; cc < NC; ++cc) {
    qa[cc] = ring.at(pos, 3 * cc + wg);
    kb[cc] = ring.at(pos, 3 * cc + 2);
  }
  ring.wait(pos, 3 * NC);
  wg_fence();
#pragma unroll
  for (int cc = 0; cc < NC; ++cc)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<T>(sc, desc_k<64, 64>(qa[cc], 0, kk), desc_k<64, 64>(kb[cc], 0, kk),
                  c0 + cc > 0 || kk > 0);
  wg_commit();
}

// One dq dP step: one chunk of D from item `pos` (dO of both row halves, V),
// dP = dO.V^T for the warpgroup's 64 rows as one wgmma batch.
template <typename T>
__device__ __forceinline__ void dq_dp_step(float (&dp)[32], const Ring& ring, Pos pos, int c,
                                           int wg) {
  const uint32_t oa = ring.at(pos, wg);
  const uint32_t vb = ring.at(pos, 2);
  ring.wait(pos, 3);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<T>(dp, desc_k<64, 64>(oa, 0, kk), desc_k<64, 64>(vb, 0, kk), c > 0 || kk > 0);
  wg_commit();
}

// dQ += dS.K over NB boxes of K, straight-line.
template <typename T, int NB>
__device__ __forceinline__ void dq_accumulate(float (&acc)[DQ_WG_BOXES][32],
                                              const uint32_t (&a)[4][4],
                                              const uint32_t (&kb)[DQ_WG_BOXES]) {
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<T>(acc[c], a[kk], desc_mn<64, 64>(kb[c], 0, kk));
}

// A 4-D map over a 16-bit [B, T, H, D] view (D a multiple of 64, contiguous)
// with element strides (sb, st, sh): boxes of 64 columns x 64 rows of one
// (b, h) in the 128-byte swizzle wgmma reads; reads past T fill zeros.
template <typename E>
int encode_boxes(CUtensorMap* map, const void* ptr, int B, int T, int H, int D, long long sb,
                 long long st, long long sh) {
  EncodeTiledFn enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(T), cuuint64_t(B)};
  long long el[4] = {1, sh, st, sb};
  for (int i = 1; i < 4; ++i)   // a dim of size 1 is never stepped over
    if (dims[i] == 1) el[i] = el[i - 1] * (long long)dims[i - 1];
  const cuuint64_t strides[3] = {cuuint64_t(el[1] * 2), cuuint64_t(el[2] * 2),
                                 cuuint64_t(el[3] * 2)};
  const cuuint32_t box[4] = {cuuint32_t(BOX), 1, cuuint32_t(BOX), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = std::is_same<E, bf16>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const CUresult r = enc(map, type, 4, const_cast<void*>(ptr), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

// The warpgroups' share of a column group of nbg boxes: the first takes
// ceil(nbg / 2) boxes from the group's first, the second the rest.
__device__ __forceinline__ void wg_boxes(int wg, int gb, int nbg, int& first, int& count) {
  const int nb0 = (nbg + 1) / 2;
  first = wg == 0 ? gb : gb + nb0;
  count = wg == 0 ? nb0 : nbg - nb0;
}

// Rows row0 and row0 + 8 of a [64, 64] f32 accumulator box times inv_l[j]
// in the operand type T into columns [col0, col0 + 64) of a contiguous
// [B, T, H, D] tensor, rows at or past T skipped: the quad transposes its
// 32-bit pairs so that each lane writes 8 consecutive columns at once
// (flash_fwd.cu store_out, one box).
template <typename T>
__device__ __forceinline__ void store_box16(T* out, const float (&o)[32], const float (&inv_l)[2],
                                            int row0, int lane, int b, int h, int T_len, int H,
                                            int D, int col0) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int t = row0 + 8 * j;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      uint32_t w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * (4 * m + r) + 2 * j;
        w[r] = pack2<T>(o[i] * inv_l[j], o[i + 1] * inv_l[j]);
      }
      const uint4 v = quad_transpose(w, lane);   // every lane: the shuffles need the quad
      if (t < T_len) {
        T* dst = out + (((long long)b * T_len + t) * H + h) * D + col0 + 32 * m + 8 * (lane & 3);
        *reinterpret_cast<uint4*>(dst) = v;
      }
    }
  }
}

// Rows row0 and row0 + 8 of a [64, 64] f32 accumulator box times `mul` in
// T into columns [col0, col0 + 64) of a contiguous [B, T, H, D] tensor, one
// 32-bit pair at a time, rows at or past T skipped.
template <typename T>
__device__ __forceinline__ void store_pairs(T* out, const float (&acc)[32], float mul, int row0,
                                            int lane, int b, int h, int T_len, int H, int D,
                                            int col0) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int t = row0 + 8 * j;
    if (t >= T_len) continue;
    T* rowp = out + (((long long)b * T_len + t) * H + h) * D + col0;
#pragma unroll
    for (int i = 2 * j; i < 32; i += 4)
      *reinterpret_cast<uint32_t*>(rowp + frag_col(i, lane)) =
          pack2<T>(acc[i] * mul, acc[i + 1] * mul);
  }
}

// ---------------------------------------------------------------------------
// forward: a block owns 128 query rows of one (batch, head), 64 a consumer
// warpgroup, and one column group of up to 256 output columns; both
// warpgroups read the same K and V boxes, each computes the scores of its
// own rows over all of D and sums its rows' P.V over the group's columns
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS90, 1)
    flash_wide_fwd_wgmma_kernel(__grid_constant__ const Wide90 p) {
  static_assert(sizeof(T) == 2, "bf16 or f16 operands");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const WideLayout L = wide_layout(0, p.D, p.slots, p.resident);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* own_full = bars;
  const Ring ring{base + uint32_t(L.ring), bars + 1, bars + 1 + p.slots, p.slots};
  const uint32_t res_q = base + uint32_t(L.res);   // Q box (chunk c, rows 64 w): 2 c + w

  const int Tq = p.Tq, Tk = p.Tk, shift = p.shift, D = p.D, nbd = D / BOX;
  const int BH = p.B * p.H;
  const int n_qb = (Tq + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const int n_groups = (D + p.G - 1) / p.G;
  const int z = blockIdx.x % n_groups;   // column groups of one row block run side by side
  int bh, qb;
  block_coords(blockIdx.x / n_groups, BH, n_qb, p.causal, bh, qb);
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = qb * BLOCK_ROWS;
  const int gb = z * p.G / BOX;                        // the group's first box
  const int nbg = (min(p.G, D - z * p.G)) / BOX;       // and its boxes
  const int n_k = (Tk + BOX - 1) / BOX;
  // under a causal mask the block's last query ends its key tiles at key
  // q0 + 127 + shift (none when that lies before key 0)
  const int last = q0 + BLOCK_ROWS - 1 + shift;
  const int n_kt = p.causal ? (last < 0 ? 0 : min(n_k, last / BOX + 1)) : n_k;
  // ring items of one key tile: (Q of both row halves and) K per chunk, then V
  const int per_chunk = p.resident ? 1 : 3;
  const int per_tile = nbd * per_chunk + nbg;

  const int tid = threadIdx.x;
  if (tid == 0) {
    bar_init(own_full, 1);
    for (int s = 0; s < p.slots; ++s) {
      bar_init(&ring.full[s], 1);                // the producer's arrival with the bytes
      bar_init(&ring.empty[s], CONSUMERS * 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = warpgroup();
  const int warp = (tid % WG) / 32;
  const int lane = tid % 32;
  if (wg == CONSUMERS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 0 && lane == 0) {
      // resident Q once; then per key tile the score steps ((Q of both row
      // halves and) K box by box over all of D), then the group's V boxes
      if (p.resident) {
        bar_arrive_tx(own_full, 2 * nbd * BOX_BYTES);
        for (int c = 0; c < nbd; ++c)
          for (int w = 0; w < CONSUMERS; ++w)
            tma_box(res_q + (2 * c + w) * BOX_BYTES, &p.q, own_full, c * BOX, h, q0 + w * BOX, b);
      }
      Pos pos{0, 0u};
      for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BOX;
        for (int c = 0; c < nbd; ++c) {
          if (!p.resident) {
            ring.put(pos, &p.q, c * BOX, h, q0, b);
            ring.put(pos, &p.q, c * BOX, h, q0 + BOX, b);
          }
          ring.put(pos, &p.k, c * BOX, h, k0, b);
        }
        for (int j = 0; j < nbg; ++j) ring.put(pos, &p.v, (gb + j) * BOX, h, k0, b);
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wq0 = q0 + wg * BOX;                 // the warpgroup's first query
    const int row0 = wq0 + warp * 16 + lane / 4;   // the thread's rows: row0, row0 + 8
    const float sl2 = p.scale * LOG2E;
    const float* kmask = p.kmask != nullptr ? p.kmask + (long long)b * Tk : nullptr;
    float o[FWD_WG_BOXES][32];
#pragma unroll
    for (int c = 0; c < FWD_WG_BOXES; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.0f;
    float m2[2] = {NEG_BIG2, NEG_BIG2};   // running row max, log2 units
    float l[2] = {0.0f, 0.0f};            // the thread's share of the row sum

    if (p.resident) bar_wait(own_full, 0);
    Pos pos{0, 0u};
    for (int kt = 0; kt < n_kt; ++kt) {
      const int k0 = kt * BOX;
      if (p.causal && k0 > wq0 + BOX - 1 + shift) {
        // the tile lies wholly above this warpgroup's rows: release its
        // boxes one by one as they arrive (a tile may hold more boxes than
        // the ring has slots)
        for (int e = 0; e < per_tile; ++e) {
          ring.wait(pos, 1);
          ring.release(pos, 1, lane);
          pos = ring.plus(pos, 1);
        }
        continue;
      }
      // the validity of the thread's 16 key columns (8 (i >> 2) + 2 (lane % 4)
      // + (i & 1)) against Tk and the key mask, read before the score steps
      // where the tile reaches past Tk or a key mask is given
      uint32_t kbits = 0xffffu;
      if (kmask != nullptr || k0 + BOX > Tk) {
        kbits = 0;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int t = k0 + 8 * (e >> 1) + 2 * (lane & 3) + (e & 1);
          const bool ok = t < Tk && (kmask == nullptr || kmask[t] > 0.0f);
          kbits |= uint32_t(ok) << e;
        }
      }
      // S = Q.K^T over all of D, FWD_CHUNKS 64-column chunks a step (the
      // chunks left over one a step); a step's slots are released once the
      // next step's products are issued and its own have retired
      float sc[32];
      Pos prev = pos;
      int prev_count = 0, c0 = 0;
      for (; c0 < nbd; ) {
        const int nc = nbd - c0 >= FWD_CHUNKS ? FWD_CHUNKS : 1;
        if (nc == FWD_CHUNKS)
          fwd_score_step<T, FWD_CHUNKS>(sc, ring, pos, per_chunk, p.resident, res_q, c0, wg);
        else
          fwd_score_step<T, 1>(sc, ring, pos, per_chunk, p.resident, res_q, c0, wg);
        wg_wait<1>();
        ring.release(prev, prev_count, lane);
        prev = pos;
        prev_count = nc * per_chunk;
        pos = ring.plus(pos, prev_count);
        c0 += nc;
      }
      wg_wait<0>();
      ring.release(prev, prev_count, lane);
      pin(sc);
      // x = s * scale * log2(e), or NEG_BIG2 where the pair is masked, on
      // every tile: a branch around the test for tiles that need none made
      // ptxas serialize the wgmmas (C7514)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = frag_col(i, lane);
        const int t = row0 + 8 * ((i >> 1) & 1);
        const bool ok = ((kbits >> (2 * (i >> 2) + (i & 1))) & 1u) &&
                        (!p.causal || k0 + col <= t + shift);
        sc[i] = ok ? sc[i] * sl2 : NEG_BIG2;
      }
      float alpha[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float mx = sc[2 * j];
#pragma unroll
        for (int i = 0; i < 32; i += 4) mx = fmaxf(mx, fmaxf(sc[i + 2 * j], sc[i + 2 * j + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m2[j], mx);
        alpha[j] = exp2_approx(m2[j] - m_new);
        m2[j] = m_new;
      }
      float rs[2] = {0.0f, 0.0f};
      uint32_t a[4][4];   // P rounded to T: the A fragments of the 4 key k-steps
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int j = (i >> 1) & 1;
        const float p0 = exp2_approx(sc[i] - m2[j]);
        const float p1 = exp2_approx(sc[i + 1] - m2[j]);
        rs[j] += p0 + p1;
        a[i >> 3][(i >> 1) & 3] = pack2<T>(p0, p1);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + rs[j];
#pragma unroll
      for (int c = 0; c < FWD_WG_BOXES; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];
      // O += P.V over the group's V boxes, one commit group as in kernel #1
      uint32_t vb[FWD_WG_BOXES];
#pragma unroll
      for (int c = 0; c < FWD_WG_BOXES; ++c) vb[c] = ring.at(pos, c);
      ring.wait(pos, nbg);
      wg_fence();
      if (nbg == 4) {
        fwd_pv<T, 4>(o, a, vb);
      } else if (nbg == 3) {
        fwd_pv<T, 3>(o, a, vb);
      } else if (nbg == 2) {
        fwd_pv<T, 2>(o, a, vb);
      } else {
        fwd_pv<T, 1>(o, a, vb);
      }
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int c = 0; c < FWD_WG_BOXES; ++c) pin(o[c]);
      ring.release(pos, nbg, lane);
      pos = ring.plus(pos, nbg);
    }

    float inv_l[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
      const float lc = fmaxf(l[j], 1e-30f);
      inv_l[j] = 1.0f / lc;
      const int t = row0 + 8 * j;
      // every column group holds the same row statistics
      if (z == 0 && (lane & 3) == 0 && t < Tq)
        p.lse_out[(long long)bh * Tq + t] = (m2[j] + log2f(lc)) * LN2;
    }
#pragma unroll
    for (int c = 0; c < FWD_WG_BOXES; ++c)
      if (c < nbg)
        store_box16<T>(static_cast<T*>(p.g0), o[c], inv_l, row0, lane, b, h, Tq, p.H, D,
                       (gb + c) * BOX);
  }
}

// ---------------------------------------------------------------------------
// dk/dv: a block owns 64 key rows of one (batch, head) and one column group
// of up to 256 columns of dk and dv. Per 64-query tile each consumer
// warpgroup computes S^T and dP^T over all of D for its half of the
// queries (m64n32), builds p^T and ds^T for them, and the two swap those
// A fragments through shared memory; each then sums its own up to 128
// columns of dV += P^T.dO and dK += dS^T.Q over all 64 queries.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS90, 1)
    flash_wide_dkv_wgmma_kernel(__grid_constant__ const Wide90 p) {
  static_assert(sizeof(T) == 2, "bf16 or f16 operands");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const WideLayout L = wide_layout(2, p.D, p.slots, p.resident);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* own_full = bars;
  const Ring ring{base + uint32_t(L.ring), bars + 1, bars + 1 + p.slots, p.slots};
  uint32_t* xch = reinterpret_cast<uint32_t*>(smem + L.xch);

  const int Tq = p.Tq, Tk = p.Tk, shift = p.shift, D = p.D, nbd = D / BOX;
  const int BH = p.B * p.H;
  const int n_kb = (Tk + BOX - 1) / BOX;
  const int n_groups = (D + p.G - 1) / p.G;
  const int z = blockIdx.x % n_groups;
  int bh, kb;   // key block 0 first: under a causal mask it sees the most queries
  block_coords(blockIdx.x / n_groups, BH, n_kb, 0, bh, kb);
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = kb * BOX;
  const int gb = z * p.G / BOX;
  const int nbg = (min(p.G, D - z * p.G)) / BOX;
  const int n_q = (Tq + BOX - 1) / BOX;
  // query tiles wholly above k0 - shift (the first query that may see key
  // k0) see no key here
  const int qt0 = p.causal && k0 - shift > 0 ? (k0 - shift) / BOX : 0;
  const uint32_t res_k = base + uint32_t(L.res);
  const uint32_t res_v = res_k + nbd * BOX_BYTES;

  const int tid = threadIdx.x;
  if (tid == 0) {
    bar_init(own_full, 1);
    for (int s = 0; s < p.slots; ++s) {
      bar_init(&ring.full[s], 1);
      bar_init(&ring.empty[s], CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = warpgroup();
  const int warp = (tid % WG) / 32;
  const int lane = tid % 32;
  const int per_chunk = p.resident ? 2 : 4;   // boxes of a score step: Q, dO (K, V first if streamed)
  if (wg == CONSUMERS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 0 && lane == 0) {
      if (p.resident) {
        bar_arrive_tx(own_full, 2 * nbd * BOX_BYTES);
        for (int c = 0; c < nbd; ++c) {
          tma_box(res_k + c * BOX_BYTES, &p.k, own_full, c * BOX, h, k0, b);
          tma_box(res_v + c * BOX_BYTES, &p.v, own_full, c * BOX, h, k0, b);
        }
      }
      Pos pos{0, 0u};
      for (int qt = qt0; qt < n_q; ++qt) {
        const int q0 = qt * BOX;
        for (int c = 0; c < nbd; ++c) {
          if (!p.resident) {
            ring.put(pos, &p.k, c * BOX, h, k0, b);
            ring.put(pos, &p.v, c * BOX, h, k0, b);
          }
          ring.put(pos, &p.q, c * BOX, h, q0, b);
          ring.put(pos, &p.o, c * BOX, h, q0, b);
        }
        for (int j = 0; j < nbg; ++j) {   // the first warpgroup's boxes, then the second's
          ring.put(pos, &p.q, (gb + j) * BOX, h, q0, b);
          ring.put(pos, &p.o, (gb + j) * BOX, h, q0, b);
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    int cb, ncb;   // this warpgroup's dk/dv boxes
    wg_boxes(wg, gb, nbg, cb, ncb);
    const int row0 = k0 + warp * 16 + lane / 4;   // the thread's keys: row0, row0 + 8
    const int half = 32 * wg;                     // this warpgroup's queries of a tile
    bool kok[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = row0 + 8 * j;
      kok[j] = t < Tk && (p.kmask == nullptr || p.kmask[(long long)b * Tk + t] > 0.0f);
    }
    const float sl2 = p.scale * LOG2E;
    const long long bh_off = (long long)bh * Tq;
    float dk[DKV_WG_BOXES][32], dv[DKV_WG_BOXES][32];
#pragma unroll
    for (int c = 0; c < DKV_WG_BOXES; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        dk[c][i] = 0.0f;
        dv[c][i] = 0.0f;
      }

    if (p.resident) bar_wait(own_full, 0);
    Pos pos{0, 0u};
    for (int qt = qt0; qt < n_q; ++qt) {
      const int q0 = qt * BOX;
      // lse (log2 units) and delta of the thread's 8 query columns of the
      // half: 8 (e >> 1) + 2 (lane % 4) + (e & 1)
      float lse2[8], dl[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int t = q0 + half + 8 * (e >> 1) + 2 * (lane & 3) + (e & 1);
        lse2[e] = t < Tq ? p.lse[bh_off + t] * LOG2E : 0.0f;
        dl[e] = t < Tq ? p.delta[bh_off + t] : 0.0f;
      }
      // S^T = K.Q^T and dP^T = V.dO^T over all of D for the half's 32 queries
      float sc[16], dp[16];
      Pos prev = pos;
      int prev_count = 0, c0 = 0;
      for (; c0 < nbd; ) {
        const int nc = nbd - c0 >= DKV_CHUNKS ? DKV_CHUNKS : 1;
        if (nc == DKV_CHUNKS)
          dkv_score_step<T, DKV_CHUNKS>(sc, dp, ring, pos, per_chunk, p.resident, res_k, res_v,
                                        c0, half);
        else
          dkv_score_step<T, 1>(sc, dp, ring, pos, per_chunk, p.resident, res_k, res_v, c0,
                               half);
        wg_wait<1>();
        ring.release(prev, prev_count, lane);
        prev = pos;
        prev_count = nc * per_chunk;
        pos = ring.plus(pos, prev_count);
        c0 += nc;
      }
      wg_wait<0>();
      ring.release(prev, prev_count, lane);
      pin(sc);
      pin(dp);
      // p^T where the pair is valid, else exactly 0; ds^T = p^T (dp^T - delta);
      // both rounded to T: the A fragments of the half's two query k-steps
      uint32_t own_p[2][4], own_s[2][4];
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int j = (i >> 1) & 1;
        const int key = row0 + 8 * j;
        float pr[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = frag_col(i + e, lane);   // the query column in the half
          const int ci = 2 * ((i + e) >> 2) + ((i + e) & 1);   // its lse2 / dl entry
          const int t = q0 + half + col;
          const bool ok = kok[j] && t < Tq && (!p.causal || key <= t + shift);
          pr[e] = ok ? exp2f(fmaf(sc[i + e], sl2, -lse2[ci])) : 0.0f;
          ds[e] = pr[e] * (dp[i + e] - dl[ci]);
        }
        own_p[i >> 3][(i >> 1) & 3] = pack2<T>(pr[0], pr[1]);
        own_s[i >> 3][(i >> 1) & 3] = pack2<T>(ds[0], ds[1]);
      }
      // swap the fragments with the other warpgroup: word w of thread t at
      // xch[(wg * 16 + w) * 128 + t]; the first barrier keeps this tile's
      // writes after the other warpgroup's reads of the last tile
      const int t_in = tid % WG;
      consumers_sync(2);
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        xch[(wg * 16 + w) * WG + t_in] = own_p[w >> 2][w & 3];
        xch[(wg * 16 + 8 + w) * WG + t_in] = own_s[w >> 2][w & 3];
      }
      consumers_sync(1);
      uint32_t pf[4][4], sf[4][4];   // k-steps 0, 1: queries 0-31; 2, 3: queries 32-63
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const uint32_t op = xch[((1 - wg) * 16 + w) * WG + t_in];
        const uint32_t os = xch[((1 - wg) * 16 + 8 + w) * WG + t_in];
        const int kk = w >> 2, r = w & 3;
        pf[kk][r] = wg == 0 ? own_p[kk][r] : op;
        sf[kk][r] = wg == 0 ? own_s[kk][r] : os;
        pf[2 + kk][r] = wg == 0 ? op : own_p[kk][r];
        sf[2 + kk][r] = wg == 0 ? os : own_s[kk][r];
      }
      // dV += P^T.dO and dK += dS^T.Q over the group's Q and dO boxes (the
      // first warpgroup's, then the second's), one commit group
      uint32_t qb[DKV_WG_BOXES], ob[DKV_WG_BOXES];
#pragma unroll
      for (int j = 0; j < DKV_WG_BOXES; ++j) {
        qb[j] = ring.at(pos, 2 * (cb - gb + j));
        ob[j] = ring.at(pos, 2 * (cb - gb + j) + 1);
      }
      ring.wait(pos, 2 * nbg);
      wg_fence();
      if (ncb == 2) {
        dkv_accumulate<T, 2>(dk, dv, pf, sf, qb, ob);
      } else if (ncb == 1) {
        dkv_accumulate<T, 1>(dk, dv, pf, sf, qb, ob);
      }
      wg_commit();
      wg_wait<0>();
      ring.release(pos, 2 * nbg, lane);
      pos = ring.plus(pos, 2 * nbg);
#pragma unroll
      for (int c = 0; c < DKV_WG_BOXES; ++c) {
        pin(dv[c]);
        pin(dk[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < DKV_WG_BOXES; ++c)
      if (c < ncb) {
        store_pairs<T>(static_cast<T*>(p.g0), dk[c], p.scale, row0, lane, b, h, Tk, p.H, D,
                       (cb + c) * BOX);
        store_pairs<T>(static_cast<T*>(p.g1), dv[c], 1.0f, row0, lane, b, h, Tk, p.H, D,
                       (cb + c) * BOX);
      }
  }
}
// ---------------------------------------------------------------------------
// dq: a block owns 128 query rows of one (batch, head), 64 a consumer
// warpgroup, and one column group of up to 256 dq columns; both warpgroups
// read the same K and V boxes. Per key tile each computes S of its own rows
// over all of D, parks p in shared memory (f32), computes dP over all of D,
// and sums its rows' dS.K over the group's columns
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS90, 1)
    flash_wide_dq_wgmma_kernel(__grid_constant__ const Wide90 p) {
  static_assert(sizeof(T) == 2, "bf16 or f16 operands");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const WideLayout L = wide_layout(1, p.D, p.slots, 0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* own_full = bars;
  const Ring ring{base + uint32_t(L.ring), bars + 1, bars + 1 + p.slots, p.slots};

  const int Tq = p.Tq, Tk = p.Tk, shift = p.shift, D = p.D, nbd = D / BOX;
  const int BH = p.B * p.H;
  const int n_qb = (Tq + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const int n_groups = (D + p.G - 1) / p.G;
  const int z = blockIdx.x % n_groups;   // column groups of one row block run side by side
  int bh, qb;
  block_coords(blockIdx.x / n_groups, BH, n_qb, p.causal, bh, qb);
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = qb * BLOCK_ROWS;
  const int gb = z * p.G / BOX;                        // the group's first box
  const int nbg = (min(p.G, D - z * p.G)) / BOX;       // and its boxes
  const int n_k = (Tk + BOX - 1) / BOX;
  // under a causal mask the block's last query ends its key tiles at key
  // q0 + 127 + shift (none when that lies before key 0)
  const int last = q0 + BLOCK_ROWS - 1 + shift;
  const int n_kt = p.causal ? (last < 0 ? 0 : min(n_k, last / BOX + 1)) : n_k;
  // ring items of one key tile: the S pass's chunks (Q of both row halves
  // and K), the dP pass's chunks (dO of both row halves and V), then the
  // group's K boxes
  const int per_tile = nbd * 6 + nbg;

  const int tid = threadIdx.x;
  if (tid == 0) {
    bar_init(own_full, 1);
    for (int s = 0; s < p.slots; ++s) {
      bar_init(&ring.full[s], 1);                // the producer's arrival with the bytes
      bar_init(&ring.empty[s], CONSUMERS * 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = warpgroup();
  const int warp = (tid % WG) / 32;
  const int lane = tid % 32;
  if (wg == CONSUMERS) {
    setmaxnreg_dec<DQ_PRODUCER_REGS>();
    if (warp == 0 && lane == 0) {
      Pos pos{0, 0u};
      for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BOX;
        for (int c = 0; c < nbd; ++c) {
          ring.put(pos, &p.q, c * BOX, h, q0, b);
          ring.put(pos, &p.q, c * BOX, h, q0 + BOX, b);
          ring.put(pos, &p.k, c * BOX, h, k0, b);
        }
        for (int c = 0; c < nbd; ++c) {
          ring.put(pos, &p.o, c * BOX, h, q0, b);
          ring.put(pos, &p.o, c * BOX, h, q0 + BOX, b);
          ring.put(pos, &p.v, c * BOX, h, k0, b);
        }
        for (int j = 0; j < nbg; ++j) ring.put(pos, &p.k, (gb + j) * BOX, h, k0, b);
      }
    }
  } else {
    setmaxnreg_inc<DQ_CONSUMER_REGS>();
    const int wq0 = q0 + wg * BOX;                 // the warpgroup's first query
    const int row0 = wq0 + warp * 16 + lane / 4;   // the thread's rows: row0, row0 + 8
    const float sl2 = p.scale * LOG2E;
    const long long bh_off = (long long)bh * Tq;
    // the thread's 32 words of p: word i at pbuf[i * WG]
    float* pbuf = reinterpret_cast<float*>(smem + L.xch) + wg * 32 * WG + tid % WG;
    float lse2[2], dlt[2];   // the rows' lse (log2 units) and delta
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = row0 + 8 * j;
      lse2[j] = t < Tq ? p.lse[bh_off + t] * LOG2E : 0.0f;
      dlt[j] = t < Tq ? p.delta[bh_off + t] : 0.0f;
    }
    float acc[DQ_WG_BOXES][32];
#pragma unroll
    for (int c = 0; c < DQ_WG_BOXES; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;

    Pos pos{0, 0u};
    for (int kt = 0; kt < n_kt; ++kt) {
      const int k0 = kt * BOX;
      if (p.causal && k0 > wq0 + BOX - 1 + shift) {
        // the tile lies wholly above this warpgroup's rows: release its
        // boxes one by one as they arrive
        for (int e = 0; e < per_tile; ++e) {
          ring.wait(pos, 1);
          ring.release(pos, 1, lane);
          pos = ring.plus(pos, 1);
        }
        continue;
      }
      // the validity of the thread's 16 key columns against Tk and the key
      // mask, read before the score steps (as the forward's)
      uint32_t kbits = 0xffffu;
      if (p.kmask != nullptr || k0 + BOX > Tk) {
        kbits = 0;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int t = k0 + 8 * (e >> 1) + 2 * (lane & 3) + (e & 1);
          const bool ok = t < Tk && (p.kmask == nullptr || p.kmask[(long long)b * Tk + t] > 0.0f);
          kbits |= uint32_t(ok) << e;
        }
      }
      // S = Q.K^T over all of D, DQ_S_CHUNKS chunks a step (the chunks
      // left over one a step); a step's slots are released once the next
      // step's products are issued and its own have retired
      float sc[32];
      Pos prev = pos;
      int prev_count = 0;
      for (int c = 0; c < nbd;) {
        const int nc = nbd - c >= DQ_S_CHUNKS ? DQ_S_CHUNKS : 1;
        if (nc == DQ_S_CHUNKS)
          dq_s_step<T, DQ_S_CHUNKS>(sc, ring, pos, c, wg);
        else
          dq_s_step<T, 1>(sc, ring, pos, c, wg);
        wg_wait<1>();
        ring.release(prev, prev_count, lane);
        prev = pos;
        prev_count = 3 * nc;
        pos = ring.plus(pos, prev_count);
        c += nc;
      }
      wg_wait<0>();
      ring.release(prev, prev_count, lane);
      pin(sc);
      // p where the pair is valid, else exactly 0, in f32 into the thread's
      // own words of shared memory (S and dP together beside dQ's 128
      // accumulators would not fit a thread's registers); no branch
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int t = row0 + 8 * ((i >> 1) & 1);
        const bool ok = ((kbits >> (2 * (i >> 2) + (i & 1))) & 1u) && t < Tq &&
                        (!p.causal || k0 + frag_col(i, lane) <= t + shift);
        pbuf[i * WG] = ok ? exp2f(fmaf(sc[i], sl2, -lse2[(i >> 1) & 1])) : 0.0f;
      }
      // dP = dO.V^T over all of D, one chunk a step
      float dp[32];
      prev = pos;
      prev_count = 0;
      for (int c = 0; c < nbd; ++c) {
        dq_dp_step<T>(dp, ring, pos, c, wg);
        wg_wait<1>();
        ring.release(prev, prev_count, lane);
        prev = pos;
        prev_count = 3;
        pos = ring.plus(pos, 3);
      }
      wg_wait<0>();
      ring.release(prev, prev_count, lane);
      pin(dp);
      // ds = p (dp - delta) rounded to T: the A fragments of the tile's 4
      // key k-steps
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int j = (i >> 1) & 1;
        a[i >> 3][(i >> 1) & 3] = pack2<T>(pbuf[i * WG] * (dp[i] - dlt[j]),
                                           pbuf[(i + 1) * WG] * (dp[i + 1] - dlt[j]));
      }
      // dQ += dS.K over the group's K boxes, one commit group
      uint32_t kb[DQ_WG_BOXES];
#pragma unroll
      for (int c = 0; c < DQ_WG_BOXES; ++c) kb[c] = ring.at(pos, c);
      ring.wait(pos, nbg);
      wg_fence();
      if (nbg == 4) {
        dq_accumulate<T, 4>(acc, a, kb);
      } else if (nbg == 3) {
        dq_accumulate<T, 3>(acc, a, kb);
      } else if (nbg == 2) {
        dq_accumulate<T, 2>(acc, a, kb);
      } else {
        dq_accumulate<T, 1>(acc, a, kb);
      }
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int c = 0; c < DQ_WG_BOXES; ++c) pin(acc[c]);
      ring.release(pos, nbg, lane);
      pos = ring.plus(pos, nbg);
    }
    const float mul[2] = {p.scale, p.scale};   // dq = scale * dS.K, in f32
#pragma unroll
    for (int c = 0; c < DQ_WG_BOXES; ++c)
      if (c < nbg)
        store_box16<T>(static_cast<T*>(p.g0), acc[c], mul, row0, lane, b, h, Tq, p.H, D,
                       (gb + c) * BOX);
  }
}

// ---------------------------------------------------------------------------
// launch plans
// ---------------------------------------------------------------------------

// which: 0 = forward, 1 = dq, 2 = dk/dv. The wgmma kernels run bf16 and
// f16, the register-tile kernels float32.
enum Route { WGMMA, TILES };
Route route(int dtype) { return dtype != 0 ? WGMMA : TILES; }

bool supported(int D) { return D >= DC && D % DC == 0; }

// wgmma: the widest column group (the forward's and dq's warpgroups each
// sum all of its boxes, dk/dv's split them)
int wide_max_group(int which) {
  return BOX * (which == 0 ? FWD_WG_BOXES : which == 1 ? DQ_WG_BOXES : 2 * DKV_WG_BOXES);
}
// The fewest ring slots: the most items a consumer holds at once, a score
// step's and the previous step's (a forward step: FWD_CHUNKS x (Q of both
// row halves and) K; dq's S step: DQ_S_CHUNKS x Q of both row halves and
// K, its dP step: dO of both row halves and V; dk/dv: DKV_CHUNKS x (K, V
// and) Q, dO), the forward's P.V and dq's dS.K: the group's V (K) boxes, an
// accumulation step of dk/dv and the previous one: 8.
int wide_min_slots(int which, int D, int resident) {
  const int chunks = which == 0 ? FWD_CHUNKS : which == 1 ? DQ_S_CHUNKS : DKV_CHUNKS;
  const int per_chunk = which == 0 ? (resident ? 1 : 3) : which == 1 ? 3 : (resident ? 2 : 4);
  const int step = min(chunks, D / BOX) * per_chunk;
  const int score = D / BOX > chunks ? 2 * step : step;
  if (which == 1) return max(max(score, 2 * 3), DQ_WG_BOXES);
  return max(score, which == 0 ? FWD_WG_BOXES : 8);
}

struct Plan {
  int G, slots, resident;
};

size_t plan_bytes(int which, int dtype, int D, const Plan& pl) {
  if (route(dtype) == WGMMA) return wide_layout(which, D, pl.slots, pl.resident).bytes;
  return tiles_bytes(which);
}

// Can kernel `which` run D with this plan?
bool plan_ok(int which, int dtype, int D, const Plan& pl) {
  if (pl.G < BOX || pl.G % BOX != 0 || pl.G > D) return false;
  if (pl.resident != 0 && pl.resident != 1) return false;
  if (plan_bytes(which, dtype, D, pl) > SMEM_LIMIT) return false;
  // tiles: groups of up to 512 columns (the output tile within 128
  // registers a thread), the kernel's own ring, every operand streamed
  if (route(dtype) == TILES)
    return pl.G <= RT_BOXES * DC && pl.slots == tiles_slots(which) && pl.resident == 0;
  // wgmma: dq streams Q
  return pl.G <= wide_max_group(which) && pl.slots >= wide_min_slots(which, D, pl.resident) &&
         pl.slots <= MAX_SLOTS && (which != 1 || pl.resident == 0);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// a register-tile kernel: 64 own query rows a block (dk/dv: 32 key rows),
// the column groups of a row block side by side
template <typename K>
int launch_tiles(K kernel, int which, const Params& p, cudaStream_t stream) {
  const size_t bytes = tiles_bytes(which);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int T_own = which == 2 ? p.Tk : p.Tq, rows = which == 2 ? RT_KROWS : RT_ROWS;
  const int blocks = (T_own + rows - 1) / rows * (p.B * p.H) * ((p.D + p.G - 1) / p.G);
  kernel<<<blocks, RT_THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(int which, const Params& p, cudaStream_t stream) {
  if (which == 0) return launch_tiles(flash_wide_fwd_tiles_kernel<float>, 0, p, stream);
  if (which == 1) return launch_tiles(flash_wide_dq_tiles_kernel<float>, 1, p, stream);
  return launch_tiles(flash_wide_dkv_tiles_kernel<float>, 2, p, stream);
}

template <typename T>
int launch_wgmma(int which, const Params& p, const Plan& pl, cudaStream_t stream) {
  Wide90 w;
  int rc = encode_boxes<T>(&w.q, p.q, p.B, p.Tq, p.H, p.D, p.q_sb, p.q_st, p.q_sh);
  if (rc == 0) rc = encode_boxes<T>(&w.k, p.k, p.B, p.Tk, p.H, p.D, p.k_sb, p.k_st, p.k_sh);
  if (rc == 0) rc = encode_boxes<T>(&w.v, p.v, p.B, p.Tk, p.H, p.D, p.v_sb, p.v_st, p.v_sh);
  if (rc == 0 && which != 0)
    rc = encode_boxes<T>(&w.o, p.dout, p.B, p.Tq, p.H, p.D, p.o_sb, p.o_st, p.o_sh);
  else
    w.o = w.q;   // the forward reads no dout
  if (rc != 0) return rc;
  w.kmask = p.kmask;
  w.lse = p.lse;
  w.delta = p.delta;
  w.lse_out = p.lse_out;
  w.g0 = p.o;
  w.g1 = p.o2;
  w.B = p.B;
  w.Tq = p.Tq;
  w.Tk = p.Tk;
  w.H = p.H;
  w.D = p.D;
  w.causal = p.causal;
  w.shift = p.shift;
  w.G = pl.G;
  w.slots = pl.slots;
  w.resident = pl.resident;
  w.scale = p.scale;
  const size_t bytes = wide_layout(which, p.D, pl.slots, pl.resident).bytes;
  auto kernel = which == 0   ? flash_wide_fwd_wgmma_kernel<T>
                : which == 1 ? flash_wide_dq_wgmma_kernel<T>
                             : flash_wide_dkv_wgmma_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  // 128 query rows a forward or dq block, 64 key rows a dk/dv block
  const int rows = which == 2 ? BOX : BLOCK_ROWS;
  const int T_own = which == 2 ? p.Tk : p.Tq;
  const int blocks = (T_own + rows - 1) / rows * (p.B * p.H) * ((p.D + pl.G - 1) / pl.G);
  kernel<<<blocks, THREADS90, bytes, stream>>>(w);
  return static_cast<int>(cudaGetLastError());
}

// plan: {G, slots, resident} (wide_plan in ops/flash_attention.py)
int run(int which, Params p, int dtype, const int* plan, void* stream) {
  if (!supported(p.D) || p.B < 1 || p.Tq < 1 || p.Tk < 1 || p.H < 1 || dtype < 0 || dtype > 2)
    return ERR_UNSUPPORTED;
  const Plan pl{plan[0], plan[1], plan[2]};
  if (!plan_ok(which, dtype, p.D, pl)) return ERR_PLAN;
  p.G = pl.G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route(dtype) == TILES) return launch_f32(which, p, s);
  return dtype == 1 ? launch_wgmma<bf16>(which, p, pl, s) : launch_wgmma<f16>(which, p, pl, s);
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

// The forward, with flash_fwd's arguments and the launch plan: dtype 0 =
// float32, 1 = bfloat16, 2 = float16; D any multiple of 64; strides in
// elements; out [B, Tq, H, D] contiguous, lse [B, H, Tq]; plan {G, slots,
// resident}. Returns 0 on a clean launch, a negative code of our own
// (flash_wide_error_string) or the cudaError_t code.
int flash_wide_fwd(const void* q, const void* k, const void* v, const float* kmask, void* out,
                   float* lse, int B, int Tq, int Tk, int H, int D, int dtype, int causal,
                   int q_off, int k_off, float scale, long long q_sb, long long q_st,
                   long long q_sh, long long k_sb, long long k_st, long long k_sh,
                   long long v_sb, long long v_st, long long v_sh, const int* plan,
                   void* stream) {
  Params p = common(q, k, v, kmask, B, Tq, Tk, H, D, causal, q_off, k_off, scale);
  p.o = out;
  p.lse_out = lse;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  return run(0, p, dtype, plan, stream);
}

// The backward kernels, with flash_bwd_dq's and flash_bwd_dkv's arguments
// and the launch plan: `strides` holds 12 element strides, the B, T, H
// strides of q, k, v and dout in that order; lse and delta are contiguous
// f32 [B, H, Tq].
int flash_wide_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, const float* kmask, void* dq,
                      int B, int Tq, int Tk, int H, int D, int dtype, int causal, int q_off,
                      int k_off, float scale, const long long* strides, const int* plan,
                      void* stream) {
  Params p = common(q, k, v, kmask, B, Tq, Tk, H, D, causal, q_off, k_off, scale);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.o = dq;
  p.q_sb = strides[0]; p.q_st = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_st = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_st = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_st = strides[10]; p.o_sh = strides[11];
  return run(1, p, dtype, plan, stream);
}

int flash_wide_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, const float* kmask, void* dk,
                       void* dv, int B, int Tq, int Tk, int H, int D, int dtype, int causal,
                       int q_off, int k_off, float scale, const long long* strides,
                       const int* plan, void* stream) {
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
  return run(2, p, dtype, plan, stream);
}

// Dynamic shared memory one block of kernel `which` (0 = forward, 1 = dq,
// 2 = dk/dv) takes in dtype `dtype` at head dim D under `plan` ({G, slots,
// resident}, as the launch takes it), or -1 when the launch would refuse
// them (ERR_UNSUPPORTED, ERR_PLAN).
long long flash_wide_smem_bytes(int which, int dtype, int D, const int* plan) {
  if (which < 0 || which > 2 || dtype < 0 || dtype > 2 || !supported(D)) return -1;
  const Plan pl{plan[0], plan[1], plan[2]};
  if (!plan_ok(which, dtype, D, pl)) return -1;
  return static_cast<long long>(plan_bytes(which, dtype, D, pl));
}

// The column groups the launch runs under that plan (a factor of the
// grid), or -1.
int flash_wide_groups(int which, int dtype, int D, const int* plan) {
  if (flash_wide_smem_bytes(which, dtype, D, plan) < 0) return -1;
  return (D + plan[0] - 1) / plan[0];
}

const char* flash_wide_error_string(int code) {
  switch (code) {
    case ERR_UNSUPPORTED: return "unsupported dtype/head dim";
    case ERR_NO_ENCODER: return "cuTensorMapEncodeTiled not found in libcuda.so.1";
    case ERR_TENSOR_MAP: return "cuTensorMapEncodeTiled refused a [B, T, H, D] view";
    case ERR_PLAN: return "the launch plan does not fit the kernel (wide_plan)";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
