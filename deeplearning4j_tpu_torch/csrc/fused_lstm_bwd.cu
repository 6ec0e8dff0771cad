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
// Design (what differs from the TPU kernel, and why):
// - As in the forward kernel, each block owns HB = 8 hidden units and a set
//   of 32-row batch tiles, and one thread owns one (batch row, unit) pair.
//   Its dh and dc carries live in the dh0/dc0 outputs, read and written only
//   by that thread, so they need no exchange.
// - Step t, phase A: each thread computes dz for its unit's 4 gate columns
//   from its own dh and dc, writes it into dzx, and stores the carry-through
//   share dh * (1 - m) as the start of dh_{t-1}. The block then adds
//   hprev_tᵀ · dz for its 4·HB columns of dWh into an f32 accumulator
//   [H, 4·HB] in shared memory (the TPU kernel's dWh scratch), over its
//   batch rows.
// - One grid-wide barrier (a cooperative launch, as in the forward kernel),
//   then phase B: dh_{t-1} for its units is dz[:, all 4H] · Wh[units, :]ᵀ,
//   with the Wh rows of its units resident in shared memory and the batch
//   tile's dz staged from dzx through L2 in 256-column chunks. Both products
//   take dz rounded to Wh's dtype, as the TPU kernel casts it.
// - No atomics: every sum has one owner and a fixed order. When the batch is
//   split over several block groups, each group writes its partial dWh and
//   dpeep to a scratch buffer, and after a last grid barrier the blocks add
//   the partials in group order, so a run repeats bit for bit.
//
// Bound at the char-RNN shape (B=128, T=50, H=256, f32, one layer): two
// products, hprevᵀ·dz and dz·Whᵀ, 6.71 GFLOP, 0.100 ms at 67 TFLOP/s of f32
// FMA; it reads gates, cs, cprev, hprev, dhs (~52 MB) and writes dzx
// (26.2 MB), ~80 MB, 0.024 ms at 3.35 TB/s: bound by operations. Like the
// forward kernel, this first version is set by its T dependent steps, each
// ending at a grid barrier, and sits far above that bound.

#include <algorithm>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int BB = 32;              // batch rows per tile
constexpr int HB = 8;               // hidden units per block
constexpr int NC = 4 * HB;          // dWh columns a block owns (4 gates x units)
constexpr int THREADS = BB * HB;    // one thread per (row, unit): 256
constexpr int KC = 256;             // columns staged per chunk (hprev or dz)
constexpr int LDS = KC + 4;         // staged row stride (floats)

static_assert(THREADS == NC * 8, "the dWh update maps a warp onto the NC columns");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

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
  float* dwh;           // [H, 4H]
  float* dh;            // [B, H]: zeros in, dh0 out
  float* dc;            // [B, H]: dc_T in, dc0 out
  float* dpeep;         // [3H] or null
  float* part;          // [groups, H*4H + 3H] when groups > 1, else null
  int B, T, H;
};

// Shared memory: Wh rows of the block's units [HB][4H + 4] (operand dtype),
// the dWh accumulator [H][NC] f32, a staging tile [BB][LDS] f32 and the
// block's dz [BB][NC] f32.
template <typename T>
struct Smem {
  __host__ __device__ static size_t ldw(int H) { return size_t(4) * H + 4; }
  __host__ __device__ static size_t acc(int H) { return (size_t(HB) * ldw(H) * sizeof(T) + 15) & ~size_t(15); }
  __host__ __device__ static size_t stage(int H) { return acc(H) + size_t(H) * NC * sizeof(float); }
  __host__ __device__ static size_t dz(int H) { return stage(H) + size_t(BB) * LDS * sizeof(float); }
  __host__ __device__ static size_t bytes(int H) { return dz(H) + size_t(BB) * NC * sizeof(float); }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_lstm_bwd_kernel(const Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = p.B, n_t = p.T, H = p.H, Z = 4 * H;
  const int ldw = int(Smem<T>::ldw(H));
  T* whr = reinterpret_cast<T*>(smem);                                  // [HB][ldw]
  float* acc = reinterpret_cast<float*>(smem + Smem<T>::acc(H));        // [H][NC]
  float* stg = reinterpret_cast<float*>(smem + Smem<T>::stage(H));      // [BB][LDS]
  float* dzl = reinterpret_cast<float*>(smem + Smem<T>::dz(H));         // [BB][NC]

  const int n_slices = H / HB;
  const int slice = blockIdx.x % n_slices;
  const int group = blockIdx.x / n_slices;
  const int groups = gridDim.x / n_slices;
  const int j0 = slice * HB;
  const int tid = threadIdx.x;
  const int r = tid / HB, u = tid % HB;
  const int j = j0 + u;
  const int n_tiles = (B + BB - 1) / BB;
  // the dWh update's mapping: column c of the block's NC, rows kq*4 + 32*i
  const int c_col = tid % NC, kq = tid / NC;

  const T* wh = static_cast<const T*>(p.wh);
  for (int idx = tid; idx < HB * Z; idx += THREADS) {
    const int uu = idx / Z, z = idx % Z;
    whr[uu * ldw + z] = wh[size_t(j0 + uu) * Z + z];
  }
  for (int idx = tid; idx < H * NC; idx += THREADS) acc[idx] = 0.f;
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
  const T* hprev = static_cast<const T*>(p.hprev);
  __syncthreads();

  for (int t = n_t - 1; t >= 0; --t) {
    // ---- phase A: dz for the block's units, dWh += hprevᵀ · dz ----
    for (int tile = group; tile < n_tiles; tile += groups) {
      const int b = tile * BB + r;
      float dzq[4] = {0.f, 0.f, 0.f, 0.f};
      if (b < B) {
        const size_t row = size_t(b) * n_t + t;
        const T* gr = gates + row * Z;
        const float i = to_f(gr[j]), f = to_f(gr[H + j]);
        const float g = to_f(gr[2 * H + j]), o = to_f(gr[3 * H + j]);
        const float c_t = to_f(cs[row * H + j]);
        const float c_prev = p.cprev[row * H + j];
        const float m = p.mask[row];
        const size_t bh = size_t(b) * H + j;
        const float A = p.dh[bh] + p.dhs[row * H + j];
        const float C = p.dc[bh];
        const float tanh_c = tanhf(c_t);
        const float dh_g = A * m;
        const float d_o = dh_g * tanh_c * o * (1.f - o);
        float dcg = C * m + dh_g * o * (1.f - tanh_c * tanh_c);
        if (peep) dcg = dcg + d_o * p_o;
        const float d_i = dcg * g * i * (1.f - i);
        const float d_g = dcg * i * (1.f - g * g);
        const float d_f = dcg * c_prev * f * (1.f - f);
        float* dr = p.dzx + row * Z;
        dr[j] = d_i;
        dr[H + j] = d_f;
        dr[2 * H + j] = d_g;
        dr[3 * H + j] = d_o;
        p.dh[bh] = A * (1.f - m);           // phase B adds dz · Whᵀ
        float dc_new = dcg * f + C * (1.f - m);
        if (peep) {
          dc_new = dc_new + d_i * p_i + d_f * p_f;
          sp_i += d_i * c_prev;
          sp_f += d_f * c_prev;
          sp_o += d_o * c_t;
        }
        p.dc[bh] = dc_new;
        dzq[0] = round_to<T>(d_i);
        dzq[1] = round_to<T>(d_f);
        dzq[2] = round_to<T>(d_g);
        dzq[3] = round_to<T>(d_o);
      }
      __syncthreads();   // dzl and stg free
#pragma unroll
      for (int q = 0; q < 4; ++q) dzl[r * NC + q * HB + u] = dzq[q];
      __syncthreads();
      float dzc[BB];     // this thread's dWh column over the tile's rows
#pragma unroll
      for (int rr = 0; rr < BB; ++rr) dzc[rr] = dzl[rr * NC + c_col];
      for (int kc = 0; kc < H; kc += KC) {
        const int kn = min(KC, H - kc);
        __syncthreads();
        for (int idx = tid; idx < BB * kn; idx += THREADS) {
          const int rr = idx / kn, kk = idx % kn;
          const int bb = tile * BB + rr;
          stg[rr * LDS + kk] =
              bb < B ? to_f(hprev[(size_t(bb) * n_t + t) * H + kc + kk]) : 0.f;
        }
        __syncthreads();
        for (int k = kq * 4; k < kn; k += 4 * (THREADS / NC)) {
          float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
          for (int rr = 0; rr < BB; ++rr) {
            const float4 h4 = *reinterpret_cast<const float4*>(stg + rr * LDS + k);
            s0 = fmaf(h4.x, dzc[rr], s0);
            s1 = fmaf(h4.y, dzc[rr], s1);
            s2 = fmaf(h4.z, dzc[rr], s2);
            s3 = fmaf(h4.w, dzc[rr], s3);
          }
          float* a = acc + size_t(kc + k) * NC + c_col;
          a[0] += s0;
          a[NC] += s1;
          a[2 * NC] += s2;
          a[3 * NC] += s3;
        }
      }
    }
    grid.sync();   // dz_t complete in dzx everywhere

    // ---- phase B: dh_{t-1} += dz_t · Wh[units, :]ᵀ ----
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
        for (int z = 0; z < KC; z += 4) {
          const float4 d4 = *reinterpret_cast<const float4*>(dr + z);
          const float4 w4 = load4(w + z);
          s = fmaf(d4.x, w4.x, s);
          s = fmaf(d4.y, w4.y, s);
          s = fmaf(d4.z, w4.z, s);
          s = fmaf(d4.w, w4.w, s);
        }
      }
      if (b < B) p.dh[size_t(b) * H + j] += s;
    }
    // no barrier here: step t-1's phase A reads only this thread's dh/dc and
    // writes dzx[:, t-1], which no block reads until the next barrier
  }

  // ---- dWh and dpeep: this block's sums, then the groups' in fixed order ----
  __syncthreads();
  float* out_w = groups > 1 ? p.part + size_t(group) * (size_t(H) * Z + 3 * H) : p.dwh;
  for (int idx = tid; idx < H * NC; idx += THREADS) {
    const int k = idx / NC, c = idx % NC;
    out_w[size_t(k) * Z + (c / HB) * H + j0 + c % HB] = acc[idx];
  }
  if (peep) {
    stg[r * LDS + u * 3 + 0] = sp_i;
    stg[r * LDS + u * 3 + 1] = sp_f;
    stg[r * LDS + u * 3 + 2] = sp_o;
    __syncthreads();
    if (tid < 3 * HB) {
      const int uu = tid / 3, q = tid % 3;
      float s = 0.f;
      for (int rr = 0; rr < BB; ++rr) s += stg[rr * LDS + uu * 3 + q];
      float* out_p = groups > 1 ? out_w + size_t(H) * Z : p.dpeep;
      out_p[q * H + j0 + uu] = s;
    }
  }
  if (groups > 1) {
    grid.sync();
    const size_t n = size_t(H) * Z + (peep ? 3 * H : 0);
    const size_t stride = size_t(H) * Z + 3 * H;
    for (size_t idx = size_t(blockIdx.x) * THREADS + tid; idx < n;
         idx += size_t(gridDim.x) * THREADS) {
      float s = 0.f;
      for (int gi = 0; gi < groups; ++gi) s += __ldcg(p.part + gi * stride + idx);
      if (idx < size_t(H) * Z) p.dwh[idx] = s;
      else p.dpeep[idx - size_t(H) * Z] = s;
    }
  }
}

int grid_groups(int B, int H, size_t smem, const void* kernel, int* groups) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return -2;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (e != cudaSuccess) return int(e);
  const int n_slices = H / HB;
  const int n_tiles = (B + BB - 1) / BB;
  *groups = std::min(n_tiles, per_sm * sms / n_slices);
  return *groups < 1 ? -2 : 0;
}

template <typename T>
int prepare(int B, int H, int* groups) {
  const size_t smem = Smem<T>::bytes(H);
  auto kernel = fused_lstm_bwd_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  return grid_groups(B, H, smem, reinterpret_cast<const void*>(kernel), groups);
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  int groups = 0;
  const int rc = prepare<T>(p.B, p.H, &groups);
  if (rc != 0) return rc;
  if (groups > 1 && p.part == nullptr) return -2;
  Params args = p;
  void* kargs[] = {&args};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_lstm_bwd_kernel<T>),
      dim3((p.H / HB) * groups), dim3(THREADS), kargs, Smem<T>::bytes(p.H), stream);
  return int(e);
}

bool supported(int H) { return H >= 128 && H <= 512 && H % 128 == 0; }

}  // namespace

extern "C" {

// The number of batch-tile groups the launch will use for (B, H, dtype): the
// first dimension of the partial-sum scratch `part` when it is above 1.
// Negative: -1 unsupported, -2 no co-resident grid, -(1000 + e) for the
// cudaError_t e.
int fused_lstm_bwd_groups(int B, int H, int dtype) {
  if (!supported(H) || B < 1) return -1;
  int groups = 0;
  int rc = -1;
  if (dtype == 0) rc = prepare<float>(B, H, &groups);
  if (dtype == 1) rc = prepare<bf16>(B, H, &groups);
  if (rc > 0) return -(1000 + rc);
  return rc != 0 ? rc : groups;
}

// dtype: 0 = float32, 1 = bfloat16 (gates, cs, hprev, Wh). Returns 0 on a
// clean launch, -1 for an unsupported dtype or H, -2 when the grid cannot be
// co-resident (or `part` is missing), else the cudaError_t code.
int fused_lstm_bwd(const void* gates, const void* cs, const float* cprev,
                   const void* hprev, const void* wh, const float* mask,
                   const float* dhs, const float* peep, float* dzx, float* dwh,
                   float* dh, float* dc, float* dpeep, float* part, int B, int T,
                   int H, int dtype, void* stream) {
  if (!supported(H) || B < 1 || T < 1) return -1;
  if (peep != nullptr && dpeep == nullptr) return -1;
  Params p{gates, cs, cprev, hprev, wh, mask, dhs, peep, dzx, dwh,
           dh, dc, dpeep, part, B, T, H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<bf16>(p, s);
  return -1;
}

// Dynamic shared memory one block takes, or -1 when unsupported.
long long fused_lstm_bwd_smem_bytes(int dtype, int H) {
  if (!supported(H)) return -1;
  if (dtype == 0) return (long long)Smem<float>::bytes(H);
  if (dtype == 1) return (long long)Smem<bf16>::bytes(H);
  return -1;
}

const char* fused_lstm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code <= -1000 ? -code - 1000 : code));
}

}  // extern "C"
