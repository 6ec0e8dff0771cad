// Fused LSTM / GravesLSTM backward (the reverse-time sweep) for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes; see
// ops/_build.py and ops/fused_lstm.py).
//
// Replaces the Pallas TPU kernel deeplearning4j_tpu/ops/fused_lstm.py
// `_bwd_kernel` (launched by `_bwd_call`): from the forward's residuals
// (gates [B, T, 4H] and cells cs [B, T, H] in zx's dtype), the shifted carries
// cprev (f32) and hprev (zx's dtype) [B, T, H], Wh [H, 4H], the f32 mask
// [B, T], the f32 output cotangent dhs [B, T, H] (already times the mask, with
// dh_T folded into step T-1) and dc_T, it walks t = T-1 .. 0 and writes
// dzx [B, T, 4H], dWh [H, 4H], dh0, dc0 [B, H] and the peephole gradient
// [3H], all in f32. Masked steps route the carry cotangents around the gate
// path, as `_bwd_kernel` does.
//
// One call is three launches on the stream: the sweep (T + 1 on the step
// route), the dWh product and a fixed-order sum of the partials.
//
// The sweep carries only dh and dc. Three routes, as for the forward kernel
// (lstm_common.cuh; ops/fused_lstm.py `lstm_route`):
// - cluster (fused_lstm_bwd_cluster_kernel; H <= 256 in f32 and <= 512 in
//   16-bit types, the char-RNN's H=256 in every dtype): a cluster of C CTAs
//   owns R batch rows
//   (8, or 9 so that all clusters run at once, as in the forward kernel) and walks all T steps with no grid-wide synchronisation; CTA k
//   keeps the Wh rows of its U = H / C units, Wh[units, 0:4H], in shared
//   memory. Step t: one thread per (row, unit) computes dz_t for its unit's
//   4 gate columns from its dh and dc (registers), writes dzx, and pushes
//   dz_t rounded to Wh's dtype into every peer's double-buffered dz buffer
//   (16-byte stores into distributed shared memory); one split cluster
//   barrier, with the next step's residuals loaded between its arrive and
//   its wait; then dh_{t-1} for its units = dz_t . Wh[units, :]^T, each
//   thread two units, the R rows and a sixteenth of the 4H columns, the
//   sixteenths added in a fixed order. (Sending each CTA only the partial
//   products of its units instead moves a quarter of the bytes, but the
//   exchange is bound by latency, not bytes, and the product over the CTA's
//   4U columns blocks worse: it ran slower.)
// - wide (fused_lstm_bwd_kernel; f32 H >= 384, 16-bit H >= 640, up to
//   1024): the grid kernel of the first design, each block owning HB = 8
//   units of a 32-row batch tile, dz exchanged through dzx in device memory
//   and a grid barrier of a cooperative launch per step.
// - step (fused_lstm_bwd_step_kernel; H > 1024, where the wide route's grid
//   cannot be co-resident): the wide route's blocks with one launch a
//   reverse step in place of its grid barrier. Launch t (t = T .. 0) first
//   adds dz_t . Wh[units, :]^T into dh for the block's (row, unit) pairs
//   (phase B of step t, Wh rows streamed from device memory), then computes
//   dz_{t-1} from that dh and dc (phase A of step t - 1): T + 1 launches.
//   Its peephole partials accumulate per (row, unit) in the workspace over
//   the reverse steps and are summed over the rows in order.
// dWh is no longer summed inside the recurrence (the first design added
// hprev_t^T . dz_t into an [H][32] f32 shared accumulator at every step: on
// the critical path, and what capped H at 512). It is one product after the
// sweep, dWh = hprev^T [H, B*T] . dz [B*T, 4H], from the dz of the sweep
// rounded to Wh's dtype as the TPU kernel casts it: for f32 dwh_gemm_kernel,
// 128 x 128 output tiles of 8 x 8 FMA sums a thread; for bf16 and f16
// dwh_wgmma_kernel on the tensor cores (wgmma fed by TMA, from a 16-bit copy
// of dz the sweep writes). Both split B*T so that the card fills; the
// splits are added in split order. The peephole gradient comes from
// per-thread partials, summed over a CTA's rows in row order and over
// clusters (or batch groups) in order by the last launch. No atomics: a run
// repeats bit for bit.
//
// Bound at the char-RNN shape (B=128, T=50, H=256, f32, one layer): two
// products, hprev^T . dz and dz . Wh^T, 6.71 GFLOP, 0.100 ms at 67 TFLOP/s of
// f32 FMA; it reads gates, cs, cprev, hprev, dhs (~52 MB) and writes dzx
// (26.2 MB), ~80 MB, 0.024 ms at 3.35 TB/s: bound by operations.

#include <algorithm>
#include <cooperative_groups.h>

#include "lstm_common.cuh"
#include "sm90_common.cuh"   // the 16-bit dWh product: TMA, mbarriers, wgmma

namespace cg = cooperative_groups;

namespace {

struct Params {
  const void* gates;    // [B, T, 4H]
  const void* cs;       // [B, T, H]
  const float* cprev;   // [B, T, H]
  const void* hprev;    // [B, T, H]
  const void* wh;       // [H, 4H]
  const float* mask;    // [B, T]
  const float* dhs;     // [B, T, H]
  const float* peep;    // [3H] or null
  float* dzx;           // [B, T, 4H]
  void* dzr;            // [B, T, 4H] dz rounded to T for the 16-bit dWh product, or null
  float* dwh;           // [H, 4H]
  float* dh;            // [B, H]: dh0 out (wide: zeros in)
  float* dc;            // [B, H]: dc_T in, dc0 out
  float* dpeep;         // [3H] or null
  float* ppart;         // [parts, 3H]: the peephole partials (peep only)
  float* wpart;         // [splits, H, 4H]: the dWh partials (splits > 1 only)
  int B, T, H;
  int cluster;          // CTAs of a cluster (cluster route), 0 wide, -1 step
};

// unit j's 4 gate cotangents of one row, rounded to T, into a [4H] row
template <typename T>
__device__ __forceinline__ void store_dz(T* row, int H, int j, float d_i, float d_f, float d_g,
                                         float d_o) {
  row[j] = from_f<T>(d_i);
  row[H + j] = from_f<T>(d_f);
  row[2 * H + j] = from_f<T>(d_g);
  row[3 * H + j] = from_f<T>(d_o);
}

// ===========================================================================
// cluster route
// ===========================================================================

// Shared memory of one CTA with U units and R rows: the Wh rows
// [U][4H + PADW] and the double-buffered dz [2][R][4H] (both in T), the
// product's partial sums [KS_BWD][R][U] f32 and the CTA's dz slice
// [R][4][U] in T.
constexpr int KS_BWD = 2 * ROWS_C;         // k parts of the product (over 4H)

template <typename T>
struct BwdCluster {
  __host__ __device__ static size_t ldw(int H) { return size_t(4) * H + PADW; }
  __host__ __device__ static size_t dzb(int H, int U) {
    return align16(size_t(U) * ldw(H) * sizeof(T));
  }
  __host__ __device__ static size_t part(int H, int U, int R) {
    return dzb(H, U) + align16(size_t(2) * R * 4 * H * sizeof(T));
  }
  __host__ __device__ static size_t dzs(int H, int U, int R) {
    return part(H, U, R) + size_t(KS_BWD) * R * U * sizeof(float);
  }
  __host__ __device__ static size_t bytes(int H, int U, int R) {
    return dzs(H, U, R) + align16(size_t(R) * 4 * U * sizeof(T));
  }
};

constexpr int MAX_CLUSTER_THREADS = ROWS_C * 32;
static_assert(KS_BWD == 2 * ROWS_C, "8U threads: one per (unit pair, k part)");

// The residuals of step t for the thread's rows (those that are real).
template <typename T>
__device__ __forceinline__ void load_residuals(const Params& p, int t, int row0, int j,
                                               const int (&r)[2], const bool (&real)[2],
                                               float (&g4)[2][4], float (&c_t)[2],
                                               float (&c_prev)[2], float (&m)[2],
                                               float (&dhs)[2]) {
  const int H = p.H, Z = 4 * H;
  const T* gates = static_cast<const T*>(p.gates);
  const T* cs = static_cast<const T*>(p.cs);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (real[e]) {
      const size_t row = size_t(row0 + r[e]) * p.T + t;
#pragma unroll
      for (int q = 0; q < 4; ++q) g4[e][q] = to_f(gates[row * Z + q * H + j]);
      c_t[e] = to_f(cs[row * H + j]);
      c_prev[e] = p.cprev[row * H + j];
      m[e] = p.mask[row];
      dhs[e] = p.dhs[row * H + j];
    }
  }
}

// 8U threads: one per (unit pair, k part) for dz . Wh^T over the cluster's
// rows (2 R f32 sums a thread, each dz load feeding 8 FMAs), and one per
// (row, unit u) for the gate cotangents: rows tid / U and tid / U + 8 when
// the cluster owns more than 8.
template <typename T, int R>
__global__ void __launch_bounds__(MAX_CLUSTER_THREADS, 1)
fused_lstm_bwd_cluster_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  using L = BwdCluster<T>;
  const int B = p.B, n_t = p.T, H = p.H, Z = 4 * H;
  const int C = p.cluster, U = H / C;
  const int rank = int(cluster_rank());
  const int cl = int(cluster_id());
  const int row0 = cl * R;
  const int j0 = rank * U;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int LW = int(L::ldw(H));
  T* whr = reinterpret_cast<T*>(smem);                              // [U][LW]
  T* dzb = reinterpret_cast<T*>(smem + L::dzb(H, U));               // [2][R][Z]
  float* part = reinterpret_cast<float*>(smem + L::part(H, U, R));  // [KS_BWD][R][U]
  T* dzs = reinterpret_cast<T*>(smem + L::dzs(H, U, R));            // [R][4][U]

  const T* wh = static_cast<const T*>(p.wh);
#pragma unroll 4   // independent loads in flight: the rows are read once, from L2
  for (int idx = tid; idx < U * Z; idx += nthr) {
    const int uu = idx / Z, z = idx % Z;
    whr[uu * LW + z] = wh[size_t(j0 + uu) * Z + z];
  }

  const int u = tid % U, j = j0 + u;
  // the product's unit pair (up, up + U/2) and k part: 4-column chunks
  // kp, kp + KS_BWD, ... so that a warp's two k parts read adjacent chunks
  const int up = tid % (U / 2), kp = tid / (U / 2);
  const bool peep = p.peep != nullptr;
  const float p_i = peep ? p.peep[j] : 0.f;
  const float p_f = peep ? p.peep[H + j] : 0.f;
  const float p_o = peep ? p.peep[2 * H + j] : 0.f;

  // the thread's rows r[e] = tid / U + 8 e: owned when below R, real when the
  // batch row exists too; dh and dc carried in f32 registers with the
  // thread's dpeep shares; the step's residuals loaded one step ahead
  int r[2];
  bool own[2], real[2];
  float dh[2], dc[2], sp[2][3], g4[2][4], c_t[2], c_prev[2], m[2], dhs[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    r[e] = tid / U + ROWS_C * e;
    own[e] = r[e] < R;
    const int b = row0 + r[e];
    real[e] = own[e] && b < B;
    dh[e] = 0.f;
    dc[e] = real[e] ? p.dc[size_t(b) * H + j] : 0.f;
    sp[e][0] = sp[e][1] = sp[e][2] = 0.f;
    c_t[e] = c_prev[e] = m[e] = dhs[e] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) g4[e][q] = 0.f;
  }
  load_residuals<T>(p, n_t - 1, row0, j, r, real, g4, c_t, c_prev, m, dhs);
  cluster_sync();   // every CTA of the cluster runs before any pushes

  for (int t = n_t - 1; t >= 0; --t) {
    // ---- dz_t for (row r[e], unit u) ----
    LSTM_PHASE(t, 0);
    float carry[2];   // dh_{t-1} = dz_t . Wh^T + carry
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      carry[e] = 0.f;
      if (!own[e]) continue;
      const CellGrad cg = cell_backward(g4[e][0], g4[e][1], g4[e][2], g4[e][3], c_t[e],
                                        c_prev[e], dh[e] + dhs[e], dc[e], m[e], peep, p_i,
                                        p_f, p_o);
      const float d_i = cg.d_i, d_f = cg.d_f, d_g = cg.d_g, d_o = cg.d_o;
      carry[e] = cg.carry;
      if (peep) {
        sp[e][0] += d_i * c_prev[e];
        sp[e][1] += d_f * c_prev[e];
        sp[e][2] += d_o * c_t[e];
      }
      dc[e] = cg.dc;
      if (real[e]) {
        const size_t row = size_t(row0 + r[e]) * n_t + t;
        float* dr = p.dzx + row * Z;
        dr[j] = d_i;
        dr[H + j] = d_f;
        dr[2 * H + j] = d_g;
        dr[3 * H + j] = d_o;
        if (p.dzr != nullptr) store_dz(static_cast<T*>(p.dzr) + row * Z, H, j, d_i, d_f, d_g, d_o);
      }
      T* ds = dzs + r[e] * 4 * U + u;
      ds[0] = from_f<T>(real[e] ? d_i : 0.f);
      ds[U] = from_f<T>(real[e] ? d_f : 0.f);
      ds[2 * U] = from_f<T>(real[e] ? d_g : 0.f);
      ds[3 * U] = from_f<T>(real[e] ? d_o : 0.f);
    }
    __syncthreads();

    // ---- dz_t into every CTA's buffer t&1 (row (r, q) at r*4H + q*H + j0),
    // then one cluster barrier ----
    LSTM_PHASE(t, 1);   // the gate cotangents
    T* cur = dzb + (t & 1) * R * Z;
    push_rows(reinterpret_cast<const unsigned char*>(dzs), size_t(U) * sizeof(T),
              reinterpret_cast<unsigned char*>(cur + j0), size_t(H) * sizeof(T), R * 4,
              int(U * sizeof(T) / 16), C, tid, nthr);
    LSTM_PHASE(t, 2);   // pushing dz
    cluster_arrive();
    if (t > 0) load_residuals<T>(p, t - 1, row0, j, r, real, g4, c_t, c_prev, m, dhs);
    cluster_wait();
    LSTM_PHASE(t, 3);   // the barrier, with the next step's residual loads

    // ---- dh_{t-1}[rows, units up and up + U/2] over k part kp ----
    const T* wa = whr + up * LW + 4 * kp;
    const T* wb = wa + (U / 2) * LW;
    const T* dzc = cur + 4 * kp;
    float acc_a[R], acc_b[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) acc_a[rr] = acc_b[rr] = 0.f;
#pragma unroll 2   // two steps of loads in flight
    for (int k = 0; k < Z; k += 4 * KS_BWD) {
      const float4 w4a = load4(wa + k), w4b = load4(wb + k);
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const float4 d4 = load4(dzc + rr * Z + k);
        acc_a[rr] = dot4(w4a, d4, acc_a[rr]);
        acc_b[rr] = dot4(w4b, d4, acc_b[rr]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      part[(kp * R + rr) * U + up] = acc_a[rr];
      part[(kp * R + rr) * U + up + U / 2] = acc_b[rr];
    }
    __syncthreads();
    LSTM_PHASE(t, 4);   // dz . Wh^T
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (!own[e]) continue;
      float s = 0.f;   // the k parts in order
#pragma unroll
      for (int kk = 0; kk < KS_BWD; ++kk) s += part[(kk * R + r[e]) * U + u];
      dh[e] = s + carry[e];
    }
    LSTM_PHASE(t, 5);   // the sum of its parts
  }
#pragma unroll
  for (int e = 0; e < 2; ++e)
    if (real[e]) {
      const size_t b = size_t(row0 + r[e]);
      p.dh[b * H + j] = dh[e];
      p.dc[b * H + j] = dc[e];
    }
  if (peep) {   // the CTA's rows in row order, into the cluster's partial
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (own[e])
#pragma unroll
        for (int q = 0; q < 3; ++q) part[(r[e] * 3 + q) * U + u] = sp[e][q];
    __syncthreads();
    if (tid < 3 * U) {
      const int q = tid / U, uu = tid % U;
      float sum = 0.f;
      for (int rr = 0; rr < R; ++rr) sum += part[(rr * 3 + q) * U + uu];
      p.ppart[size_t(cl) * 3 * H + q * H + j0 + uu] = sum;
    }
  }
}

// ===========================================================================
// wide route: the hidden-unit-sharded grid kernel
// ===========================================================================

constexpr int BB = 32;              // batch rows per tile
constexpr int HB = 8;               // hidden units per block
constexpr int THREADS = BB * HB;    // one thread per (row, unit): 256
constexpr int KC = 256;             // dz columns staged per chunk
constexpr int LDS = KC + 4;         // staged row stride (floats)

// Shared memory: Wh rows of the block's units [HB][4H + 4] (operand dtype)
// and a staging tile [BB][LDS] f32.
template <typename T>
struct Wide {
  __host__ __device__ static size_t ldw(int H) { return size_t(4) * H + 4; }
  __host__ __device__ static size_t stage(int H) { return align16(size_t(HB) * ldw(H) * sizeof(T)); }
  __host__ __device__ static size_t bytes(int H) { return stage(H) + size_t(BB) * LDS * sizeof(float); }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_lstm_bwd_kernel(const Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = p.B, n_t = p.T, H = p.H, Z = 4 * H;
  const int ldw = int(Wide<T>::ldw(H));
  T* whr = reinterpret_cast<T*>(smem);                                  // [HB][ldw]
  float* stg = reinterpret_cast<float*>(smem + Wide<T>::stage(H));      // [BB][LDS]

  const int n_slices = H / HB;
  const int slice = blockIdx.x % n_slices;
  const int group = blockIdx.x / n_slices;
  const int groups = gridDim.x / n_slices;
  const int j0 = slice * HB;
  const int tid = threadIdx.x;
  const int r = tid / HB, u = tid % HB;
  const int j = j0 + u;
  const int n_tiles = (B + BB - 1) / BB;

  const T* wh = static_cast<const T*>(p.wh);
  for (int idx = tid; idx < HB * Z; idx += THREADS) {
    const int uu = idx / Z, z = idx % Z;
    whr[uu * ldw + z] = wh[size_t(j0 + uu) * Z + z];
  }
  const bool peep = p.peep != nullptr;
  float p_i = 0.f, p_f = 0.f, p_o = 0.f;
  if (peep) {
    p_i = p.peep[j];
    p_f = p.peep[H + j];
    p_o = p.peep[2 * H + j];
  }
  float sp_i = 0.f, sp_f = 0.f, sp_o = 0.f;   // this thread's dpeep share
  const T* gates = static_cast<const T*>(p.gates);
  const T* cs = static_cast<const T*>(p.cs);
  __syncthreads();

  for (int t = n_t - 1; t >= 0; --t) {
    // ---- phase A: dz for the block's units ----
    for (int tile = group; tile < n_tiles; tile += groups) {
      const int b = tile * BB + r;
      if (b < B) {
        const size_t row = size_t(b) * n_t + t;
        const T* gr = gates + row * Z;
        const float c_t = to_f(cs[row * H + j]);
        const float c_prev = p.cprev[row * H + j];
        const size_t bh = size_t(b) * H + j;
        const CellGrad cg = cell_backward(
            to_f(gr[j]), to_f(gr[H + j]), to_f(gr[2 * H + j]), to_f(gr[3 * H + j]), c_t, c_prev,
            p.dh[bh] + p.dhs[row * H + j], p.dc[bh], p.mask[row], peep, p_i, p_f, p_o);
        float* dr = p.dzx + row * Z;
        dr[j] = cg.d_i;
        dr[H + j] = cg.d_f;
        dr[2 * H + j] = cg.d_g;
        dr[3 * H + j] = cg.d_o;
        if (p.dzr != nullptr)
          store_dz(static_cast<T*>(p.dzr) + row * Z, H, j, cg.d_i, cg.d_f, cg.d_g, cg.d_o);
        p.dh[bh] = cg.carry;           // phase B adds dz . Wh^T
        if (peep) {
          sp_i += cg.d_i * c_prev;
          sp_f += cg.d_f * c_prev;
          sp_o += cg.d_o * c_t;
        }
        p.dc[bh] = cg.dc;
      }
    }
    grid.sync();   // dz_t complete in dzx everywhere

    // ---- phase B: dh_{t-1} += dz_t . Wh[units, :]^T ----
    for (int tile = group; tile < n_tiles; tile += groups) {
      const int b = tile * BB + r;
      float s = 0.f;
      for (int zc = 0; zc < Z; zc += KC) {
        __syncthreads();
        for (int idx = tid; idx < BB * KC; idx += THREADS) {
          const int rr = idx / KC, zz = idx % KC;
          const int bb = tile * BB + rr;
          const float v = bb < B ? __ldcg(p.dzx + (size_t(bb) * n_t + t) * Z + zc + zz) : 0.f;
          stg[rr * LDS + zz] = round_to<T>(v);
        }
        __syncthreads();
        const float* dr = stg + r * LDS;
        const T* w = whr + u * ldw + zc;
#pragma unroll 4
        for (int z = 0; z < KC; z += 4)
          s = dot4(*reinterpret_cast<const float4*>(dr + z), load4(w + z), s);
      }
      if (b < B) p.dh[size_t(b) * H + j] += s;
    }
    // no barrier here: step t-1's phase A reads only this thread's dh/dc and
    // writes dzx[:, t-1], which no block reads until the next barrier
  }

  if (peep) {   // the block's rows in row order, into the group's partial
    __syncthreads();
    stg[r * LDS + u * 3 + 0] = sp_i;
    stg[r * LDS + u * 3 + 1] = sp_f;
    stg[r * LDS + u * 3 + 2] = sp_o;
    __syncthreads();
    if (tid < 3 * HB) {
      const int uu = tid / 3, q = tid % 3;
      float s = 0.f;
      for (int rr = 0; rr < BB; ++rr) s += stg[rr * LDS + uu * 3 + q];
      p.ppart[size_t(group) * 3 * H + q * H + j0 + uu] = s;
    }
  }
}

// ===========================================================================
// step route: one launch a reverse step
// ===========================================================================

constexpr int SZC = 64;             // dz columns staged per chunk

// Launch tb of the step route's sweep for the block's HB units of one
// BB-row tile: phase B of step tb (dh += round_T(dz_tb) . Wh[units, :]^T,
// when tb < T), then phase A of step tb - 1 (its dz into dzx, and dzr for
// the 16-bit types, from dh and dc, which only this thread touches; when
// tb >= 1). Peephole partials go to ppart [B, 3H], one row a batch row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_lstm_bwd_step_kernel(const Params p, int tb) {
  __shared__ __align__(16) float dzs[BB][SZC + 4];      // dz chunk, rounded to T
  __shared__ __align__(16) float whs[HB][SZC + 4];      // Wh rows of the units
  const int B = p.B, n_t = p.T, H = p.H, Z = 4 * H;
  const int j0 = blockIdx.x * HB, tile = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid / HB, u = tid % HB;
  const int j = j0 + u, b = tile * BB + r;
  const size_t bh = size_t(b) * H + j;
  const T* wh = static_cast<const T*>(p.wh);

  if (tb < n_t) {   // phase B of step tb
    float s = 0.f;
    for (int zc = 0; zc < Z; zc += SZC) {
      __syncthreads();   // the previous chunk has been read
      for (int idx = tid; idx < BB * SZC; idx += THREADS) {
        const int rr = idx / SZC, zz = idx % SZC;
        const int bb = tile * BB + rr;
        dzs[rr][zz] = bb < B ? round_to<T>(p.dzx[(size_t(bb) * n_t + tb) * Z + zc + zz]) : 0.f;
      }
      for (int idx = tid; idx < HB * SZC; idx += THREADS) {
        const int uu = idx / SZC, zz = idx % SZC;
        whs[uu][zz] = to_f(wh[size_t(j0 + uu) * Z + zc + zz]);
      }
      __syncthreads();
#pragma unroll 4
      for (int z = 0; z < SZC; z += 4)
        s = dot4(*reinterpret_cast<const float4*>(&dzs[r][z]),
                 *reinterpret_cast<const float4*>(&whs[u][z]), s);
    }
    if (b < B) p.dh[bh] += s;
  }
  const int t = tb - 1;
  if (t < 0 || b >= B) return;
  // phase A of step t, as the wide route's
  const bool peep = p.peep != nullptr;
  const T* gates = static_cast<const T*>(p.gates);
  const size_t row = size_t(b) * n_t + t;
  const T* gr = gates + row * Z;
  const float c_t = to_f(static_cast<const T*>(p.cs)[row * H + j]);
  const float c_prev = p.cprev[row * H + j];
  const CellGrad cg = cell_backward(
      to_f(gr[j]), to_f(gr[H + j]), to_f(gr[2 * H + j]), to_f(gr[3 * H + j]), c_t, c_prev,
      p.dh[bh] + p.dhs[row * H + j], p.dc[bh], p.mask[row], peep, peep ? p.peep[j] : 0.f,
      peep ? p.peep[H + j] : 0.f, peep ? p.peep[2 * H + j] : 0.f);
  float* dr = p.dzx + row * Z;
  dr[j] = cg.d_i;
  dr[H + j] = cg.d_f;
  dr[2 * H + j] = cg.d_g;
  dr[3 * H + j] = cg.d_o;
  if (p.dzr != nullptr)
    store_dz(static_cast<T*>(p.dzr) + row * Z, H, j, cg.d_i, cg.d_f, cg.d_g, cg.d_o);
  p.dh[bh] = cg.carry;           // the next launch adds dz_t . Wh^T
  if (peep) {
    float* pp = p.ppart + size_t(b) * 3 * H;
    const bool first = t == n_t - 1;
    pp[j] = (first ? 0.f : pp[j]) + cg.d_i * c_prev;
    pp[H + j] = (first ? 0.f : pp[H + j]) + cg.d_f * c_prev;
    pp[2 * H + j] = (first ? 0.f : pp[2 * H + j]) + cg.d_o * c_t;
  }
  p.dc[bh] = cg.dc;
}

// ===========================================================================
// dWh = hprev^T . dz after the sweep, and the fixed-order sums
// ===========================================================================

constexpr int GM = 128, GN = 128, GK = 8;   // output tile and k step
constexpr int GT = 256;                     // threads: 16 x 16, 8 x 8 sums each
constexpr int GEMM_BLOCKS = 264;            // the splits aim at two blocks per SM

// The splits of the B*T rows for an H: enough blocks to fill the card, each
// split at least 64 rows.
int gemm_splits(int N, int H) {
  const int tiles = (H / GM) * (4 * H / GN);
  const int by_rows = std::max(1, N / 64);
  return std::max(1, std::min(GEMM_BLOCKS / tiles, by_rows));
}

// out[s][m][n] = sum over rows k of split s of hprev[k][m] * round_T(dz[k][n]),
// k ascending. hprev [N, H] (T), dz [N, 4H] f32; out [S][H][4H] f32 (S = 1:
// dWh itself).
template <typename T>
__global__ void __launch_bounds__(GT)
dwh_gemm_kernel(const T* hprev, const float* dz, float* out, int N, int H, int rows_per_split) {
  __shared__ __align__(16) float As[2][GK][GM];
  __shared__ __align__(16) float Bs[2][GK][GN];
  const int Z = 4 * H;
  const int n0 = blockIdx.x * GN, m0 = blockIdx.y * GM, s = blockIdx.z;
  const int k_begin = s * rows_per_split, k_end = min(N, k_begin + rows_per_split);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lk = tid / 32, lc = (tid % 32) * 4;   // this thread's loads: row lk, columns lc..lc+3

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;

  auto fetch = [&](int k, float4& av, float4& bv) {
    av = make_float4(0.f, 0.f, 0.f, 0.f);
    bv = av;
    if (k < k_end) {
      av = load4(hprev + size_t(k) * H + m0 + lc);
      const float4 d = *reinterpret_cast<const float4*>(dz + size_t(k) * Z + n0 + lc);
      bv = make_float4(round_to<T>(d.x), round_to<T>(d.y), round_to<T>(d.z), round_to<T>(d.w));
    }
  };
  float4 av, bv;
  fetch(k_begin + lk, av, bv);
  *reinterpret_cast<float4*>(&As[0][lk][lc]) = av;
  *reinterpret_cast<float4*>(&Bs[0][lk][lc]) = bv;
  __syncthreads();
  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += GK) {
    const bool more = k0 + GK < k_end;
    if (more) fetch(k0 + GK + lk, av, bv);
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y) acc[x][y] = fmaf(a[x], bb[y], acc[x][y]);
    }
    if (more) {
      *reinterpret_cast<float4*>(&As[buf ^ 1][lk][lc]) = av;
      *reinterpret_cast<float4*>(&Bs[buf ^ 1][lk][lc]) = bv;
    }
    __syncthreads();
    buf ^= 1;
  }
  float* o = out + size_t(s) * H * Z;
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    const int m = m0 + (x < 4 ? ty * 4 + x : 64 + ty * 4 + x - 4);
    float* row = o + size_t(m) * Z + n0;
    *reinterpret_cast<float4*>(row + tx * 4) =
        make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
    *reinterpret_cast<float4*>(row + 64 + tx * 4) =
        make_float4(acc[x][4], acc[x][5], acc[x][6], acc[x][7]);
  }
}

// dwh[i] = sum over splits of wpart[s][i] (when splits > 1) and
// dpeep[i] = sum over parts of ppart[p][i] (when there are peepholes), each
// in index order.
__global__ void finish_kernel(const float* wpart, int splits, float* dwh, long long n_w,
                              const float* ppart, int parts, float* dpeep, int n_p) {
  const long long n = (splits > 1 ? n_w : 0) + (dpeep != nullptr ? n_p : 0);
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    if (splits > 1 && idx < n_w) {
      float s = 0.f;
      for (int k = 0; k < splits; ++k) s += wpart[k * n_w + idx];
      dwh[idx] = s;
    } else {
      const long long i = splits > 1 ? idx - n_w : idx;
      float s = 0.f;
      for (int k = 0; k < parts; ++k) s += ppart[k * (long long)n_p + i];
      dpeep[i] = s;
    }
  }
}

// The 16-bit types' dWh product on the tensor cores: one warpgroup a block,
// an output tile of 64 units x 128 gate columns in f32 registers, the rows
// of its split streamed in 64-row chunks through a ring of three slots, each
// chunk a 64 x 64 tile of hprev and a 64 x 128 tile of dz (rounded to T by
// the sweep) copied by TMA in the 128-byte swizzle. Both operands keep the
// rows along K as they lie in memory ([B*T, H] and [B*T, 4H]), so wgmma
// reads both MN-major (m64n64k16 with A and B transposed); no copy
// transposes them. out: [splits, H, 4H] partials (or dWh when one split).
constexpr int WM = 64, WN = 128, WK = 64, WSTAGES = 3;

struct WgmmaGemm {
  static constexpr uint32_t A_TILE = WK * WM * 2;   // [WK rows][64 cols]
  static constexpr uint32_t B_TILE = WK * WN * 2;   // two [WK rows][64 cols] boxes
  static constexpr size_t a = 0;
  static constexpr size_t b = a + size_t(WSTAGES) * A_TILE;
  static constexpr size_t bars = b + size_t(WSTAGES) * B_TILE;
  static constexpr size_t bytes = bars + WSTAGES * 8 + 1024;   // + alignment
};

int wgmma_splits(int N, int H) {
  const int tiles = (H / WM) * (4 * H / WN);
  const int by_rows = std::max(1, N / WK);
  return std::max(1, std::min(GEMM_BLOCKS / tiles, by_rows));
}

template <typename T>
__global__ void __launch_bounds__(WG, 1)
dwh_wgmma_kernel(const __grid_constant__ CUtensorMap hmap,
                 const __grid_constant__ CUtensorMap dmap, float* out, int N, int H,
                 int rows_per_split) {
  using L = WgmmaGemm;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  const int Z = 4 * H;
  const int n0 = blockIdx.x * WN, m0 = blockIdx.y * WM, s = blockIdx.z;
  const int k_begin = s * rows_per_split, k_end = min(N, k_begin + rows_per_split);
  const int chunks = k_end > k_begin ? (k_end - k_begin + WK - 1) / WK : 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int i = 0; i < WSTAGES; ++i) bar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // chunk c into slot c % WSTAGES (thread 0); rows past N arrive as zeros,
  // and a split's rows end on a chunk boundary
  auto issue = [&](int c) {
    const int slot = c % WSTAGES, k0 = k_begin + c * WK;
    const uint32_t at = base + L::a + slot * L::A_TILE, bt = base + L::b + slot * L::B_TILE;
    bar_arrive_tx(&full[slot], L::A_TILE + L::B_TILE);
    tma_box2d(at, &hmap, &full[slot], m0, k0);
    tma_box2d(bt, &dmap, &full[slot], n0, k0);
    tma_box2d(bt + WK * 128, &dmap, &full[slot], n0 + 64, k0);
  };
  if (tid == 0)
    for (int c = 0; c < min(WSTAGES, chunks); ++c) issue(c);
  float acc[2][32];
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const int slot = c % WSTAGES;
    bar_wait(&full[slot], (c / WSTAGES) & 1);
    const uint32_t at = base + L::a + slot * L::A_TILE, bt = base + L::b + slot * L::B_TILE;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
        wgmma_ss_tt<T>(acc[nb], desc_mn<64, WK>(at, 0, kk), desc_mn<128, WK>(bt, nb, kk), 1);
    wg_commit();
    wg_wait<0>();
    pin(acc[0]);
    pin(acc[1]);
    __syncthreads();   // every warp is done with the slot
    if (tid == 0 && c + WSTAGES < chunks) issue(c + WSTAGES);
  }
  float* o = out + size_t(s) * H * Z;
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = m0 + 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
      const int col = n0 + 64 * nb + frag_col(i, lane);
      *reinterpret_cast<float2*>(o + size_t(row) * Z + col) = make_float2(acc[nb][i], acc[nb][i + 1]);
    }
}

// The dWh product's splits over the B*T rows for T's product.
template <typename T>
int dwh_splits(int N, int H) {
  return sizeof(T) == 2 ? wgmma_splits(N, H) : gemm_splits(N, H);
}

// dWh (or its split partials) on the stream: the FMA kernel for f32, the
// wgmma kernel for the 16-bit types.
template <typename T>
int launch_dwh(const Params& p, int splits, cudaStream_t stream) {
  const int N = p.B * p.T, Z = 4 * p.H;
  float* out = splits > 1 ? p.wpart : p.dwh;
  if constexpr (sizeof(T) == 2) {
    static LaunchCache cache;
    int dev = 0;
    int rc = current_device(&dev);
    if (rc != 0) return rc;
    if (!cache.ready[dev]) {
      const cudaError_t e = cudaFuncSetAttribute(
          dwh_wgmma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(WgmmaGemm::bytes));
      if (e != cudaSuccess) return int(e);
      cache.ready[dev] = true;
    }
    CUtensorMap hmap, dmap;
    rc = encode_rows<T>(&hmap, p.hprev, N, p.H);
    if (rc == 0) rc = encode_rows<T>(&dmap, p.dzr, N, Z);
    if (rc != 0) return rc;
    const int rows = ((N + splits - 1) / splits + WK - 1) / WK * WK;
    dwh_wgmma_kernel<T><<<dim3(Z / WN, p.H / WM, splits), WG, WgmmaGemm::bytes, stream>>>(
        hmap, dmap, out, N, p.H, rows);
  } else {
    const int rows = ((N + splits - 1) / splits + GK - 1) / GK * GK;
    dwh_gemm_kernel<T><<<dim3(Z / GN, p.H / GM, splits), GT, 0, stream>>>(
        static_cast<const T*>(p.hprev), p.dzx, out, N, p.H, rows);
  }
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Every route takes H a multiple of 128; the cluster and wide routes only up
// to MAX_H (their launch caches are sized by it), the step route any.
bool h_supported(int H) { return H >= 128 && H % 128 == 0; }

template <typename T>
bool cluster_fits(int H, int C) {
  if (C != 4 && C != 8 && C != 16) return false;
  if (H % C) return false;
  const int U = H / C;
  return U <= 32 && U % 8 == 0 && BwdCluster<T>::bytes(H, U, ROWS_C) <= SMEM_LIMIT;
}

template <typename T, int R>
LaunchCache& cluster_cache() {
  static LaunchCache cache;
  return cache;
}

template <typename T, int R>
int launch_rows(const Params& p, cudaStream_t stream) {
  auto kernel = fused_lstm_bwd_cluster_kernel<T, R>;
  int rc = prepare_cluster_kernel(cluster_cache<T, R>(), kernel);
  if (rc != 0) return rc;
  const int C = p.cluster, U = p.H / C;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      attr, (p.B + R - 1) / R, C, ROWS_C * U, spread_smem(BwdCluster<T>::bytes(p.H, U, R)), stream);
  return int(cudaLaunchKernelEx(&cfg, kernel, p));
}

// Launches the sweep; sets *clusters, the rows of the peephole partials.
template <typename T>
int launch_cluster(const Params& p, int dtype, cudaStream_t stream, int* clusters) {
  const int C = p.cluster, U = p.H / C, H = p.H;
  int rows = 0;
  int rc = cluster_rows(cluster_cache<T, ROWS_C>(), fused_lstm_bwd_cluster_kernel<T, ROWS_C>,
                        [=](int R) { return BwdCluster<T>::bytes(H, U, R); }, p.B, H, C,
                        dtype, &rows);
  if (rc != 0) return rc;
  *clusters = (p.B + rows - 1) / rows;
  switch (rows) {
    case 8: return launch_rows<T, 8>(p, stream);
    case 9: return launch_rows<T, 9>(p, stream);
    default: return -1;
  }
}

// The wide route's batch groups for (B, H): cached occupancy per device,
// dtype and H. Sets *groups; returns 0, -2 when no grid is co-resident, or a
// cudaError_t.
template <typename T>
int wide_groups(int B, int H, int dtype, int* groups) {
  static LaunchCache cache;
  auto kernel = fused_lstm_bwd_kernel<T>;
  int dev = 0;
  int rc = current_device(&dev);
  if (rc != 0) return rc;
  if (!cache.ready[dev]) {
    int coop = 0;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(SMEM_LIMIT));
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&cache.sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return int(e);
    if (!coop) return -2;
    cache.ready[dev] = true;
  }
  int& per_sm = cache.answer[dev][dtype][H / 128];
  if (per_sm == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                                  Wide<T>::bytes(H));
    if (e != cudaSuccess) {
      per_sm = 0;
      return int(e);
    }
    if (per_sm == 0) per_sm = -1;
  }
  const int n_slices = H / HB;
  const int n_tiles = (B + BB - 1) / BB;
  *groups = per_sm < 0 ? 0 : std::min(n_tiles, per_sm * cache.sms[dev] / n_slices);
  return *groups < 1 ? -2 : 0;
}

template <typename T>
int launch(const Params& p, int dtype, cudaStream_t stream) {
  int parts = (p.B + ROWS_C - 1) / ROWS_C;
  if (p.cluster == -1) {   // T + 1 launches, then the dWh product as below
    parts = p.B;
    const dim3 grid(p.H / HB, (p.B + BB - 1) / BB);
    for (int tb = p.T; tb >= 0; --tb) {
      fused_lstm_bwd_step_kernel<T><<<grid, THREADS, 0, stream>>>(p, tb);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return int(e);
    }
  } else if (p.H > MAX_H) {
    return -1;
  } else if (p.cluster == 0) {
    int groups = 0;
    int rc = wide_groups<T>(p.B, p.H, dtype, &groups);
    if (rc != 0) return rc;
    parts = groups;
    Params args = p;
    void* kargs[] = {&args};
    cudaError_t e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(fused_lstm_bwd_kernel<T>),
        dim3((p.H / HB) * groups), dim3(THREADS), kargs, Wide<T>::bytes(p.H), stream);
    if (e != cudaSuccess) return int(e);
  } else {
    if (!cluster_fits<T>(p.H, p.cluster)) return -1;
    int rc = launch_cluster<T>(p, dtype, stream, &parts);
    if (rc != 0) return rc;
  }
  const int Z = 4 * p.H;
  const int splits = dwh_splits<T>(p.B * p.T, p.H);
  if (splits > 1 && p.wpart == nullptr) return -1;
  if (sizeof(T) == 2 && p.dzr == nullptr) return -1;
  const int rc = launch_dwh<T>(p, splits, stream);
  if (rc != 0) return rc;
  cudaError_t e = cudaSuccess;
  if (splits > 1 || p.peep != nullptr) {
    finish_kernel<<<264, 256, 0, stream>>>(p.wpart, splits, p.dwh, (long long)p.H * Z,
                                           p.ppart, parts, p.dpeep, 3 * p.H);
    e = cudaGetLastError();
  }
  return int(e);
}

template <typename T>
long long smem_bytes(int H, int cluster) {
  if (cluster == -1) return 0;   // static shared memory only
  if (H > MAX_H) return -1;
  if (cluster == 0) return (long long)Wide<T>::bytes(H);
  if (!cluster_fits<T>(H, cluster)) return -1;
  return (long long)BwdCluster<T>::bytes(H, H / cluster, ROWS_C);
}

}  // namespace

extern "C" {

int splits_for(int dtype, int N, int H) {
  return dtype == 0 ? dwh_splits<float>(N, H) : dwh_splits<bf16>(N, H);
}

// Floats of the f32 workspace a call needs: the dWh split partials
// [splits, H, 4H] when there is more than one split, then the peephole
// partials [parts, 3H], B parts at most (the step route's one a row; the
// cluster route's one a cluster, the wide route's one a batch group). -1
// when H is unsupported.
long long fused_lstm_bwd_workspace(int B, int T, int H, int dtype) {
  if (!h_supported(H) || B < 1 || T < 1) return -1;
  const int splits = splits_for(dtype, B * T, H);
  return (splits > 1 ? (long long)splits * H * 4 * H : 0) + (long long)B * 3 * H;
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (gates, cs, hprev, Wh).
// cluster: the cluster route's CTAs per cluster (4, 8 or 16), 0 for the
// wide route, -1 for the step route (H a multiple of 128, at most 1024 on the
// other two). dzr: [B, T, 4H] in the operand type for 16-bit types (the
// dWh product's copy of dz), null for f32. dh: zeros in (the wide route
// reads it), dh0 out; dc: dc_T in, dc0 out. work: fused_lstm_bwd_workspace
// floats. Returns 0 on clean launches, -1 for an unsupported dtype, H or
// cluster size, -2 when the wide route's grid cannot be co-resident, -3 for
// a tensor map libcuda refuses, else the cudaError_t code.
int fused_lstm_bwd(const void* gates, const void* cs, const float* cprev,
                   const void* hprev, const void* wh, const float* mask,
                   const float* dhs, const float* peep, float* dzx, void* dzr, float* dwh,
                   float* dh, float* dc, float* dpeep, float* work, int B, int T,
                   int H, int dtype, int cluster, void* stream) {
  if (!h_supported(H) || B < 1 || T < 1) return -1;
  if (peep != nullptr && dpeep == nullptr) return -1;
  const int splits = splits_for(dtype, B * T, H);
  float* wpart = splits > 1 ? work : nullptr;
  float* ppart = work + (splits > 1 ? (size_t)splits * H * 4 * H : 0);
  Params p{gates, cs,  cprev, hprev, wh,    mask, dhs,   peep, dzx, dzr,
           dwh,   dh,  dc,    dpeep, ppart, wpart, B,    T,    H,   cluster};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, dtype, s);
  if (dtype == 1) return launch<bf16>(p, dtype, s);
  if (dtype == 2) return launch<f16>(p, dtype, s);
  return -1;
}

// Dynamic shared memory one block of the route takes (0 for the step route,
// whose arrays are static), or -1 when unsupported.
long long fused_lstm_bwd_smem_bytes(int dtype, int H, int cluster) {
  if (!h_supported(H)) return -1;
  if (dtype == 0) return smem_bytes<float>(H, cluster);
  if (dtype == 1) return smem_bytes<bf16>(H, cluster);
  if (dtype == 2) return smem_bytes<f16>(H, cluster);
  return -1;
}

const char* fused_lstm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code <= -1000 ? -code - 1000 : code));
}

}  // extern "C"
