// Fused LSTM / GravesLSTM forward recurrence for Hopper (sm_90a), bound to
// Python through a plain C interface (ctypes; see ops/_build.py and
// ops/fused_lstm.py).
//
// Replaces the Pallas TPU kernel deeplearning4j_tpu/ops/fused_lstm.py
// `_fwd_kernel` (launched by `_fwd_call`): the whole recurrence over the
// precomputed input rows zx = x @ Wx + b [B, T, 4H] (gate order i, f, g, o)
// with the recurrent weights Wh [H, 4H] resident on chip, f32 h/c carries,
// the masked-step rule (a masked step carries h and c through unchanged) and
// the optional GravesLSTM peepholes [3H] (c_prev feeds i and f, c_new feeds
// o). It writes hs (post-mask carries) and cs (post-mask cells) [B, T, H],
// the pre-mask gates [B, T, 4H] and the final carries h_T, c_T [B, H], all in
// zx's dtype (float32, bfloat16 or float16).
//
// The TPU grid walks time chunks in order on one core and keeps all of Wh
// (1 MB at H=256 f32) in VMEM. A Hopper block has at most 227 KB of shared
// memory, so Wh is sharded over hidden units, and every step needs all of
// h_{t-1}: the shards exchange h once a step. Three routes (lstm_common.cuh;
// ops/fused_lstm.py `lstm_route` picks one from H and the dtype):
//
// cluster (fused_lstm_fwd_cluster_kernel; H <= 384 in f32 and <= 512 in
// 16-bit types, the char-RNN's H=256 in every dtype): a cluster of C CTAs owns
// R batch rows and walks all T steps with no grid-wide synchronisation, so
// clusters never wait for each other and any B runs (extra clusters queue).
// R is 8, or 9 when ceil(B / 8) clusters would not all run at once and
// ceil(B / 9) would: an H100 runs 15 clusters of 8 CTAs at once, so B=128
// takes 15 clusters of 9 rows instead of a second wave (lstm_common.cuh
// cluster_rows). Every CTA
// asks for at least half an SM's shared memory, so no two share an SM.
// CTA k holds Wh[:, 4 gates x its U = H / C units] in shared memory (128 KB
// at H=256 f32, C=8), laid out [column][k] with rows padded by 16 bytes so
// that a warp's 16-byte loads of 32 columns fall in distinct banks. A step:
// - the product h_{t-1} . Wh[:, its 4U columns]: each thread owns the 4
//   gate columns of one unit and the R rows (4 R f32 sums), an eighth of
//   the k range (the eighths added in a fixed order); h is read from shared
//   memory as a broadcast, each 16-byte load feeding 16 FMAs (with one
//   column a thread, 4 FMAs, the loads set most of a step's time);
// - the gates and the cell update, one thread per (row, unit), with h and
//   c carried in f32 registers; hs, cs, gates (and h_T, c_T) to memory;
// - the new h slice, rounded to Wh's dtype, goes into every peer's
//   double-buffered h buffer by 16-byte stores into distributed shared
//   memory, then one split cluster barrier: zx[t+1] and the mask are
//   loaded between its arrive and its wait.
// cudaLaunchKernelEx with the cluster dimension; C = 16 needs
// cudaFuncAttributeNonPortableClusterSizeAllowed.
//
// wide (fused_lstm_fwd_kernel; f32 H >= 512, 16-bit H >= 640, up to 1024):
// the first design, whose Wh slice is small enough for any H: each block owns
// HB = 8 units and their 4 gate columns, Wh[:, 32 columns], for all T steps;
// one thread per (batch row, unit) of a 32-row tile; h_{t-1} goes through a
// double-buffered f32 scratch in device memory, read through L2, and every
// step ends at the grid barrier of a cooperative launch, which refuses a
// grid that cannot be co-resident (H = 1024 f32: 128 blocks of 164 KB).
//
// step (fused_lstm_fwd_step_kernel; H > 1024, where the wide route's grid of
// H / 8 blocks, each holding its Wh columns for all T steps, no longer fits
// the card at once: at H = 2048 f32 Wh alone is 64 MB, more than the shared
// memory of all 132 SMs): one launch a time step, the kernel boundary in
// place of the grid barrier. A block owns HB = 8 units of a BB = 32-row
// batch tile, as in the wide route, and streams h_{t-1} and its Wh columns
// from device memory through shared memory in chunks of SKC = 64 k rows (Wh
// is read from L2 or device memory every step); then the same gate math,
// peepholes and mask, and h_t into the other half of the f32 double buffer.
// Any H that is a multiple of 128 runs.
//
// All: h is rounded to Wh's dtype before the recurrent product, as the TPU
// kernel casts it (`h.astype(wh.dtype)`); products accumulate in f32 with
// plain FMAs (no TF32), so f32 keeps f32 accuracy. Each launch's attributes
// (and the wide route's occupancy answer) are set or asked once per kernel,
// device and (dtype, H); a call repeats only the launch.
//
// Bound at the char-RNN shape (B=128, T=50, H=256, f32, one layer): the
// recurrent products are 2*B*T*H*4H = 3.36 GFLOP, 0.050 ms at the H100
// SXM's 67 TFLOP/s of f32 FMA; the kernel must read zx (26.2 MB) and Wh
// and write gates, hs and cs (39.3 MB), ~67 MB, 0.020 ms at 3.35 TB/s: bound
// by operations. The cluster route's floor is set by the 50 dependent steps:
// per step a CTA does 9 x 128 x 256 FMAs (~1.2 us on one SM's FMA units),
// then the exchange and a cluster barrier, which take longer than the
// product (tools/lstm_phase_profile.py splits a step).

#include <algorithm>
#include <cooperative_groups.h>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

namespace {

struct Params {
  const void* zx;       // [B, T, 4H]
  const void* wh;       // [H, 4H]
  const float* mask;    // [B, T] or null
  const float* peep;    // [3H] or null
  float* hbuf;          // wide: [2, B, H] with slot 0 = h0; cluster: h0 [B, H]
  float* cbuf;          // wide: [B, H] = c0, updated in place; cluster: c0 [B, H]
  void* hs;             // [B, T, H]
  void* gates;          // [B, T, 4H]
  void* cs;             // [B, T, H]
  void* hT;             // [B, H]
  void* cT;             // [B, H]
  int B, T, H;
  int cluster;          // CTAs of a cluster (cluster route), 0 wide, -1 step
};

// ===========================================================================
// cluster route
// ===========================================================================

// Shared memory of one CTA with U units and R rows: the Wh slice
// [4U][H + PADW] and the double-buffered h [2][R][H] (both in T), the
// product's partial sums [KS_FWD][R][4U] f32 and the CTA's new h slice
// [R][U] in T.
constexpr int KS_FWD = 8;                  // k parts of the product

template <typename T>
struct FwdCluster {
  __host__ __device__ static size_t ldw(int H) { return size_t(H) + PADW; }
  __host__ __device__ static size_t hb(int H, int U) {
    return align16(size_t(4) * U * ldw(H) * sizeof(T));
  }
  __host__ __device__ static size_t zp(int H, int U, int R) {
    return hb(H, U) + align16(size_t(2) * R * H * sizeof(T));
  }
  __host__ __device__ static size_t hst(int H, int U, int R) {
    return zp(H, U, R) + size_t(KS_FWD) * R * 4 * U * sizeof(float);
  }
  __host__ __device__ static size_t bytes(int H, int U, int R) {
    return hst(H, U, R) + align16(size_t(R) * U * sizeof(T));
  }
};

constexpr int MAX_CLUSTER_THREADS = ROWS_C * 32;
static_assert(KS_FWD == ROWS_C, "8U threads: one per (unit, k part)");

// 8U threads: one per (unit u, k part kp) for the product, which sums the 4
// gate columns of u over the cluster's rows (4 R f32 sums a thread), and
// one per (row, unit u) for the cell update: rows tid / U and tid / U + 8
// when the cluster owns more than 8.
template <typename T, int R>
__global__ void __launch_bounds__(MAX_CLUSTER_THREADS, 1)
fused_lstm_fwd_cluster_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  using L = FwdCluster<T>;
  const int B = p.B, n_t = p.T, H = p.H, Z = 4 * H;
  const int C = p.cluster, U = H / C, NCOL = 4 * U;
  const int rank = int(cluster_rank());
  const int row0 = int(cluster_id()) * R;
  const int j0 = rank * U;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int LW = int(L::ldw(H));
  T* whs = reinterpret_cast<T*>(smem);                              // [NCOL][LW]
  T* hb = reinterpret_cast<T*>(smem + L::hb(H, U));                 // [2][R][H]
  float* zp = reinterpret_cast<float*>(smem + L::zp(H, U, R));      // [KS_FWD][R][NCOL]
  T* hst = reinterpret_cast<T*>(smem + L::hst(H, U, R));            // [R][U]

  const T* wh = static_cast<const T*>(p.wh);
#pragma unroll 4   // independent loads in flight: the slice is read once, from L2
  for (int idx = tid; idx < H * NCOL; idx += nthr) {
    const int k = idx / NCOL, c = idx % NCOL;
    whs[c * LW + k] = wh[size_t(k) * Z + (c / U) * H + j0 + c % U];
  }
  for (int idx = tid; idx < R * H; idx += nthr) {
    const int b = row0 + idx / H;
    hb[idx] = from_f<T>(b < B ? p.hbuf[size_t(b) * H + idx % H] : 0.f);
  }

  const int u = tid % U, j = j0 + u;
  const int kp = tid / U, kseg = H / KS_FWD, k0 = kp * kseg;
  const bool peep = p.peep != nullptr;
  const float p_i = peep ? p.peep[j] : 0.f;
  const float p_f = peep ? p.peep[H + j] : 0.f;
  const float p_o = peep ? p.peep[2 * H + j] : 0.f;
  const T* zx = static_cast<const T*>(p.zx);
  T* hs = static_cast<T*>(p.hs);
  T* gates = static_cast<T*>(p.gates);
  T* cs = static_cast<T*>(p.cs);

  // the thread's rows r[e] = tid / U + 8 e: owned when below R, real when the
  // batch row exists too; h and c carried in f32 registers, zx and the mask
  // of the next step loaded ahead
  int r[2];
  bool own[2], real[2];
  float h[2], c[2], zn[2][4], mn[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    r[e] = tid / U + ROWS_C * e;
    own[e] = r[e] < R;
    const int b = row0 + r[e];
    real[e] = own[e] && b < B;
    h[e] = real[e] ? p.hbuf[size_t(b) * H + j] : 0.f;
    c[e] = real[e] ? p.cbuf[size_t(b) * H + j] : 0.f;
    mn[e] = 1.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) zn[e][q] = 0.f;
    if (real[e]) {
      const size_t row = size_t(b) * n_t;
#pragma unroll
      for (int q = 0; q < 4; ++q) zn[e][q] = to_f(zx[row * Z + q * H + j]);
      if (p.mask != nullptr) mn[e] = p.mask[row];
    }
  }
  cluster_sync();   // every CTA of the cluster runs and holds h0

  for (int t = 0; t < n_t; ++t) {
    // ---- the 4 gate sums of unit u over k part kp: h_{t-1} . Wh ----
    LSTM_PHASE(t, 0);
    const T* hcur = hb + (t & 1) * R * H + k0;
    const T* w = whs + u * LW + k0;
    float acc[R][4];
#pragma unroll
    for (int rr = 0; rr < R; ++rr)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[rr][q] = 0.f;
#pragma unroll 2   // two steps of loads in flight
    for (int k = 0; k < kseg; k += 4) {
      float4 w4[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) w4[q] = load4(w + q * U * LW + k);
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const float4 h4 = load4(hcur + rr * H + k);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[rr][q] = dot4(w4[q], h4, acc[rr][q]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < R; ++rr)
#pragma unroll
      for (int q = 0; q < 4; ++q) zp[(kp * R + rr) * NCOL + q * U + u] = acc[rr][q];
    __syncthreads();
    LSTM_PHASE(t, 1);   // the product

    // ---- gates and cell update for (row r[e], unit u) ----
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (!own[e]) continue;
      float z[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float sum = 0.f;   // the k parts in order
#pragma unroll
        for (int part = 0; part < KS_FWD; ++part) sum += zp[(part * R + r[e]) * NCOL + q * U + u];
        z[q] = zn[e][q] + sum;
      }
      const Cell cl = cell_forward(z[0], z[1], z[2], z[3], h[e], c[e], mn[e], peep, p_i, p_f,
                                   p_o);
      h[e] = cl.h;
      c[e] = cl.c;
      if (real[e]) {
        const size_t row = size_t(row0 + r[e]) * n_t + t;
        hs[row * H + j] = from_f<T>(h[e]);
        cs[row * H + j] = from_f<T>(c[e]);
        T* gr = gates + row * Z;
        gr[j] = from_f<T>(cl.i);
        gr[H + j] = from_f<T>(cl.f);
        gr[2 * H + j] = from_f<T>(cl.g);
        gr[3 * H + j] = from_f<T>(cl.o);
      }
      hst[r[e] * U + u] = from_f<T>(real[e] ? h[e] : 0.f);
    }
    if (t + 1 == n_t) break;
    LSTM_PHASE(t, 2);   // the cell update

    // ---- h_t into every CTA's buffer (t+1)&1, then one cluster barrier ----
    __syncthreads();
    push_rows(reinterpret_cast<const unsigned char*>(hst), size_t(U) * sizeof(T),
              reinterpret_cast<unsigned char*>(hb + ((t + 1) & 1) * R * H + j0),
              size_t(H) * sizeof(T), R, int(U * sizeof(T) / 16), C, tid, nthr);
    LSTM_PHASE(t, 3);   // pushing h
    cluster_arrive();
#pragma unroll
    for (int e = 0; e < 2; ++e) {   // zx and the mask of step t+1
      if (real[e]) {
        const size_t row = size_t(row0 + r[e]) * n_t + t + 1;
#pragma unroll
        for (int q = 0; q < 4; ++q) zn[e][q] = to_f(zx[row * Z + q * H + j]);
        if (p.mask != nullptr) mn[e] = p.mask[row];
      }
    }
    cluster_wait();
    LSTM_PHASE(t, 4);   // the barrier, with the next step's zx loads
  }
#pragma unroll
  for (int e = 0; e < 2; ++e)
    if (real[e]) {
      const size_t b = size_t(row0 + r[e]);
      static_cast<T*>(p.hT)[b * H + j] = from_f<T>(h[e]);
      static_cast<T*>(p.cT)[b * H + j] = from_f<T>(c[e]);
    }
}

// ===========================================================================
// wide route: the hidden-unit-sharded grid kernel
// ===========================================================================

constexpr int BB = 32;              // batch rows per tile
constexpr int HB = 8;               // hidden units per block
constexpr int THREADS = BB * HB;    // one thread per (row, unit): 256
constexpr int KC = 256;             // h columns staged per chunk
constexpr int LDH = KC + 4;         // staged row stride (floats): rows 4 banks apart

template <typename T>
size_t wide_smem_bytes(int H) {
  return size_t(H) * HB * 4 * sizeof(T) + size_t(BB) * LDH * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_lstm_fwd_kernel(const Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = p.B, n_t = p.T, H = p.H, Z = 4 * H;
  T* whs = reinterpret_cast<T*>(smem);                                    // [H][HB][4]
  float* hst = reinterpret_cast<float*>(smem + size_t(H) * HB * 4 * sizeof(T));  // [BB][LDH]

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
  for (int idx = tid; idx < H * HB * 4; idx += THREADS) {
    const int q = idx & 3, uu = (idx >> 2) % HB, k = idx / (HB * 4);
    whs[idx] = wh[size_t(k) * Z + q * H + j0 + uu];
  }
  float p_i = 0.f, p_f = 0.f, p_o = 0.f;
  if (p.peep != nullptr) {
    p_i = p.peep[j];
    p_f = p.peep[H + j];
    p_o = p.peep[2 * H + j];
  }
  const T* zx = static_cast<const T*>(p.zx);
  T* hs = static_cast<T*>(p.hs);
  T* gates = static_cast<T*>(p.gates);
  T* cs = static_cast<T*>(p.cs);
  __syncthreads();

  for (int t = 0; t < n_t; ++t) {
    const float* hin = p.hbuf + size_t(t & 1) * B * H;
    float* hout = p.hbuf + size_t((t + 1) & 1) * B * H;
    for (int tile = group; tile < n_tiles; tile += groups) {
      const int b = tile * BB + r;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int kc = 0; kc < H; kc += KC) {
        const int kn = min(KC, H - kc);
        __syncthreads();   // the previous chunk has been read
        for (int idx = tid; idx < BB * kn; idx += THREADS) {
          const int rr = idx / kn, kk = idx % kn;
          const int bb = tile * BB + rr;
          const float v = bb < B ? __ldcg(hin + size_t(bb) * H + kc + kk) : 0.f;
          hst[rr * LDH + kk] = round_to<T>(v);
        }
        __syncthreads();
        const float* hr = hst + r * LDH;
        const T* w = whs + (size_t(kc) * HB + u) * 4;
#pragma unroll 2
        for (int k = 0; k < kn; k += 4) {
          const float4 h4 = *reinterpret_cast<const float4*>(hr + k);
          const float4 w0 = load4(w + (k + 0) * HB * 4);
          const float4 w1 = load4(w + (k + 1) * HB * 4);
          const float4 w2 = load4(w + (k + 2) * HB * 4);
          const float4 w3 = load4(w + (k + 3) * HB * 4);
          a0 = fmaf(h4.x, w0.x, a0); a1 = fmaf(h4.x, w0.y, a1);
          a2 = fmaf(h4.x, w0.z, a2); a3 = fmaf(h4.x, w0.w, a3);
          a0 = fmaf(h4.y, w1.x, a0); a1 = fmaf(h4.y, w1.y, a1);
          a2 = fmaf(h4.y, w1.z, a2); a3 = fmaf(h4.y, w1.w, a3);
          a0 = fmaf(h4.z, w2.x, a0); a1 = fmaf(h4.z, w2.y, a1);
          a2 = fmaf(h4.z, w2.z, a2); a3 = fmaf(h4.z, w2.w, a3);
          a0 = fmaf(h4.w, w3.x, a0); a1 = fmaf(h4.w, w3.y, a1);
          a2 = fmaf(h4.w, w3.z, a2); a3 = fmaf(h4.w, w3.w, a3);
        }
      }
      if (b < B) {
        const size_t row = size_t(b) * n_t + t;
        const T* zr = zx + row * Z;
        const float m = p.mask != nullptr ? p.mask[row] : 1.f;
        const float h = __ldcg(hin + size_t(b) * H + j);
        const float c = p.cbuf[size_t(b) * H + j];
        const Cell cl = cell_forward(to_f(zr[j]) + a0, to_f(zr[H + j]) + a1,
                                     to_f(zr[2 * H + j]) + a2, to_f(zr[3 * H + j]) + a3, h, c,
                                     m, p.peep != nullptr, p_i, p_f, p_o);
        hout[size_t(b) * H + j] = cl.h;
        p.cbuf[size_t(b) * H + j] = cl.c;
        hs[row * H + j] = from_f<T>(cl.h);
        cs[row * H + j] = from_f<T>(cl.c);
        T* gr = gates + row * Z;
        gr[j] = from_f<T>(cl.i);
        gr[H + j] = from_f<T>(cl.f);
        gr[2 * H + j] = from_f<T>(cl.g);
        gr[3 * H + j] = from_f<T>(cl.o);
        if (t == n_t - 1) {
          static_cast<T*>(p.hT)[size_t(b) * H + j] = from_f<T>(cl.h);
          static_cast<T*>(p.cT)[size_t(b) * H + j] = from_f<T>(cl.c);
        }
      }
    }
    if (t + 1 < n_t) grid.sync();   // h_t complete everywhere before step t+1
  }
}

// ===========================================================================
// step route: one launch a time step
// ===========================================================================

constexpr int SKC = 64;             // k rows staged per chunk

// Step t of the recurrence for the block's HB units of one BB-row tile:
// h_{t-1} from hbuf slot t & 1, h_t into slot (t + 1) & 1, c in place.
template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_lstm_fwd_step_kernel(const Params p, int t) {
  __shared__ __align__(16) float hst[BB][SKC + 4];      // h chunk, rounded to T
  __shared__ __align__(16) float wst[SKC][HB * 4];      // Wh chunk [k][unit][gate]
  const int B = p.B, n_t = p.T, H = p.H, Z = 4 * H;
  const int j0 = blockIdx.x * HB, tile = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid / HB, u = tid % HB;
  const int j = j0 + u, b = tile * BB + r;
  const float* hin = p.hbuf + size_t(t & 1) * B * H;
  float* hout = p.hbuf + size_t((t + 1) & 1) * B * H;
  const T* wh = static_cast<const T*>(p.wh);

  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (int kc = 0; kc < H; kc += SKC) {
    __syncthreads();   // the previous chunk has been read
    for (int idx = tid; idx < BB * SKC; idx += THREADS) {
      const int rr = idx / SKC, kk = idx % SKC;
      const int bb = tile * BB + rr;
      hst[rr][kk] = bb < B ? round_to<T>(hin[size_t(bb) * H + kc + kk]) : 0.f;
    }
    for (int idx = tid; idx < SKC * HB * 4; idx += THREADS) {
      const int uu = idx % HB, q = (idx / HB) & 3, k = idx / (HB * 4);
      wst[k][uu * 4 + q] = to_f(wh[size_t(kc + k) * Z + q * H + j0 + uu]);
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < SKC; k += 4) {
      const float4 h4 = *reinterpret_cast<const float4*>(&hst[r][k]);
      const float4 w0 = *reinterpret_cast<const float4*>(&wst[k + 0][u * 4]);
      const float4 w1 = *reinterpret_cast<const float4*>(&wst[k + 1][u * 4]);
      const float4 w2 = *reinterpret_cast<const float4*>(&wst[k + 2][u * 4]);
      const float4 w3 = *reinterpret_cast<const float4*>(&wst[k + 3][u * 4]);
      a0 = fmaf(h4.x, w0.x, a0); a1 = fmaf(h4.x, w0.y, a1);
      a2 = fmaf(h4.x, w0.z, a2); a3 = fmaf(h4.x, w0.w, a3);
      a0 = fmaf(h4.y, w1.x, a0); a1 = fmaf(h4.y, w1.y, a1);
      a2 = fmaf(h4.y, w1.z, a2); a3 = fmaf(h4.y, w1.w, a3);
      a0 = fmaf(h4.z, w2.x, a0); a1 = fmaf(h4.z, w2.y, a1);
      a2 = fmaf(h4.z, w2.z, a2); a3 = fmaf(h4.z, w2.w, a3);
      a0 = fmaf(h4.w, w3.x, a0); a1 = fmaf(h4.w, w3.y, a1);
      a2 = fmaf(h4.w, w3.z, a2); a3 = fmaf(h4.w, w3.w, a3);
    }
  }
  if (b >= B) return;
  const size_t row = size_t(b) * n_t + t;
  const T* zr = static_cast<const T*>(p.zx) + row * Z;
  const float m = p.mask != nullptr ? p.mask[row] : 1.f;
  const float h = hin[size_t(b) * H + j];
  const float c = p.cbuf[size_t(b) * H + j];
  const bool peep = p.peep != nullptr;
  const Cell cl = cell_forward(to_f(zr[j]) + a0, to_f(zr[H + j]) + a1,
                               to_f(zr[2 * H + j]) + a2, to_f(zr[3 * H + j]) + a3, h, c, m,
                               peep, peep ? p.peep[j] : 0.f, peep ? p.peep[H + j] : 0.f,
                               peep ? p.peep[2 * H + j] : 0.f);
  hout[size_t(b) * H + j] = cl.h;
  p.cbuf[size_t(b) * H + j] = cl.c;
  static_cast<T*>(p.hs)[row * H + j] = from_f<T>(cl.h);
  static_cast<T*>(p.cs)[row * H + j] = from_f<T>(cl.c);
  T* gr = static_cast<T*>(p.gates) + row * Z;
  gr[j] = from_f<T>(cl.i);
  gr[H + j] = from_f<T>(cl.f);
  gr[2 * H + j] = from_f<T>(cl.g);
  gr[3 * H + j] = from_f<T>(cl.o);
  if (t == n_t - 1) {
    static_cast<T*>(p.hT)[size_t(b) * H + j] = from_f<T>(cl.h);
    static_cast<T*>(p.cT)[size_t(b) * H + j] = from_f<T>(cl.c);
  }
}

// T launches on the stream, step after step.
template <typename T>
int launch_step(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.H / HB, (p.B + BB - 1) / BB);
  for (int t = 0; t < p.T; ++t) {
    fused_lstm_fwd_step_kernel<T><<<grid, THREADS, 0, stream>>>(p, t);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return int(e);
  }
  return 0;
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
  return U <= 32 && U % 8 == 0 && FwdCluster<T>::bytes(H, U, ROWS_C) <= SMEM_LIMIT;
}

template <typename T, int R>
LaunchCache& cluster_cache() {
  static LaunchCache cache;
  return cache;
}

template <typename T>
int cluster_rows_for(int B, int H, int C, int dtype, int* rows) {
  const int U = H / C;
  return cluster_rows(cluster_cache<T, ROWS_C>(), fused_lstm_fwd_cluster_kernel<T, ROWS_C>,
                      [=](int R) { return FwdCluster<T>::bytes(H, U, R); }, B, H, C, dtype,
                      rows);
}

template <typename T, int R>
int launch_rows(const Params& p, cudaStream_t stream) {
  auto kernel = fused_lstm_fwd_cluster_kernel<T, R>;
  int rc = prepare_cluster_kernel(cluster_cache<T, R>(), kernel);
  if (rc != 0) return rc;
  const int C = p.cluster, U = p.H / C;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      attr, (p.B + R - 1) / R, C, ROWS_C * U, spread_smem(FwdCluster<T>::bytes(p.H, U, R)), stream);
  return int(cudaLaunchKernelEx(&cfg, kernel, p));
}

template <typename T>
int launch_cluster(const Params& p, int dtype, cudaStream_t stream) {
  int rows = 0;
  int rc = cluster_rows_for<T>(p.B, p.H, p.cluster, dtype, &rows);
  if (rc != 0) return rc;
  switch (rows) {
    case 8: return launch_rows<T, 8>(p, stream);
    case 9: return launch_rows<T, 9>(p, stream);
    default: return -1;
  }
}

template <typename T>
int launch_wide(const Params& p, int dtype, cudaStream_t stream) {
  static LaunchCache cache;
  auto kernel = fused_lstm_fwd_kernel<T>;
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
  const size_t smem = wide_smem_bytes<T>(p.H);
  int& per_sm = cache.answer[dev][dtype][p.H / 128];
  if (per_sm == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (e != cudaSuccess) {
      per_sm = 0;
      return int(e);
    }
    if (per_sm == 0) per_sm = -1;
  }
  const int n_slices = p.H / HB;
  const int n_tiles = (p.B + BB - 1) / BB;
  const int groups = per_sm < 0 ? 0 : std::min(n_tiles, per_sm * cache.sms[dev] / n_slices);
  if (groups < 1) return -2;
  Params args = p;
  void* kargs[] = {&args};
  return int(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                         dim3(n_slices * groups), dim3(THREADS), kargs,
                                         smem, stream));
}

template <typename T>
int launch(const Params& p, int dtype, cudaStream_t stream) {
  if (p.cluster == -1) return launch_step<T>(p, stream);
  if (p.H > MAX_H) return -1;
  if (p.cluster == 0) return launch_wide<T>(p, dtype, stream);
  if (!cluster_fits<T>(p.H, p.cluster)) return -1;
  return launch_cluster<T>(p, dtype, stream);
}

// The cluster route's rows per cluster for B, or negative (-1 unsupported,
// -(1000 + e) for a cudaError_t e).
template <typename T>
int rows_for(int B, int H, int cluster, int dtype) {
  if (H > MAX_H || !cluster_fits<T>(H, cluster)) return -1;
  int rows = 0;
  const int rc = cluster_rows_for<T>(B, H, cluster, dtype, &rows);
  return rc != 0 ? -(1000 + rc) : rows;
}

template <typename T>
long long smem_bytes(int H, int cluster) {
  if (cluster == -1) return 0;   // static shared memory only
  if (H > MAX_H) return -1;
  if (cluster == 0) return (long long)wide_smem_bytes<T>(H);
  if (!cluster_fits<T>(H, cluster)) return -1;
  return (long long)FwdCluster<T>::bytes(H, H / cluster, ROWS_C);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (zx, Wh, and every output).
// cluster: the cluster route's CTAs per cluster (4, 8 or 16), 0 for the
// wide route, -1 for the step route. h0 and c0 are f32; the wide and step
// routes need hbuf [2, B, H] with h0 in slot 0 and cbuf = c0 [B, H] (updated
// in place), the cluster route reads h0 and c0 [B, H] through the same two
// pointers. H is a multiple of 128, at most 1024 on the cluster and wide
// routes. Returns 0 on clean launches, -1 for an unsupported dtype, H or
// cluster size, -2 when the wide route's grid cannot be co-resident, else
// the cudaError_t code.
int fused_lstm_fwd(const void* zx, const void* wh, const float* mask,
                   const float* peep, float* hbuf, float* cbuf, void* hs,
                   void* gates, void* cs, void* hT, void* cT, int B, int T,
                   int H, int dtype, int cluster, void* stream) {
  if (!h_supported(H) || B < 1 || T < 1) return -1;
  Params p{zx, wh, mask, peep, hbuf, cbuf, hs, gates, cs, hT, cT, B, T, H, cluster};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, dtype, s);
  if (dtype == 1) return launch<bf16>(p, dtype, s);
  if (dtype == 2) return launch<f16>(p, dtype, s);
  return -1;
}

// Dynamic shared memory one block of the route takes (0 for the step route,
// whose arrays are static), or -1 when unsupported.
long long fused_lstm_fwd_smem_bytes(int dtype, int H, int cluster) {
  if (!h_supported(H)) return -1;
  if (dtype == 0) return smem_bytes<float>(H, cluster);
  if (dtype == 1) return smem_bytes<bf16>(H, cluster);
  if (dtype == 2) return smem_bytes<f16>(H, cluster);
  return -1;
}

// The cluster route's rows per cluster for a batch of B on the current
// device (8, or more when ceil(B / 8) clusters would not all run at once),
// or negative (-1 unsupported, -(1000 + e) for a cudaError_t e).
int fused_lstm_fwd_cluster_rows(int dtype, int B, int H, int cluster) {
  if (!h_supported(H) || B < 1) return -1;
  if (dtype == 0) return rows_for<float>(B, H, cluster, 0);
  if (dtype == 1) return rows_for<bf16>(B, H, cluster, 1);
  if (dtype == 2) return rows_for<f16>(B, H, cluster, 2);
  return -1;
}

const char* fused_lstm_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code <= -1000 ? -code - 1000 : code));
}

}  // extern "C"
