// Pieces shared by the fused-LSTM kernels of fused_lstm_fwd.cu (#4) and
// fused_lstm_bwd.cu (#5): the operand types and their conversions, the
// geometry of the cluster route, thread-block-cluster helpers (rank,
// distributed shared memory, the split cluster barrier) and the cache of
// per-kernel launch attributes. ops/_build.py keys each library on its .cu
// and every csrc/*.cuh, so an edit here rebuilds every kernel.
//
// The three routes (ops/fused_lstm.py `lstm_route` computes the same choice):
// - cluster: a thread-block cluster of C CTAs (C in 4, 8, 16) owns R batch
//   rows and walks all T steps on its own; CTA k of the cluster owns
//   U = H / C hidden units (U <= 32, a multiple of 8) and keeps its slice of
//   Wh in shared memory. h_t (forward) or dz_t (backward) is pushed into
//   every peer's shared memory and each step ends at one cluster barrier.
//   Taken when the slice and the exchange buffers of 8 rows fit one CTA's
//   227 KB. R is 8, or 9 (`cluster_rows`) when ceil(B / 8) clusters would
//   not all run at once and ceil(B / 9) would: an H100 runs 15 clusters of
//   8 CTAs of one SM each, so the char-RNN's B = 128 takes 15 clusters of 9
//   rows rather than a second wave of clusters.
// - wide: the hidden-unit-sharded grid kernels (one cooperative launch, a
//   grid barrier per step) for the widths whose Wh slice does not fit a
//   cluster, up to H = MAX_H = 1024.
// - step: past MAX_H, the same blocks as the wide route with one launch a
//   time step (the backward: a step's dh product fused with the previous
//   step's gate cotangents), Wh streamed from device memory each step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int ROWS_C = 8;              // batch rows a cluster owns at least
constexpr int PADW = 4;                // row padding (elements) of the Wh slices
constexpr size_t SMEM_LIMIT = 232448;  // the opt-in shared memory of one block
constexpr int MAX_H = 1024;                // the cluster and wide routes' widest H

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(f16 x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }
template <> __device__ __forceinline__ f16 from_f<f16>(float x) { return __float2half_rn(x); }
// x rounded to T's precision, kept as a float
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// four consecutive elements as floats (16-byte / 8-byte aligned)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const f16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&v.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// -- the per-unit math every route shares ----------------------------------------

// One unit's gates and cell update at one step from its four pre-activations
// z = zx + h_{t-1} . Wh: i, f, o sigmoid and g tanh, the GravesLSTM
// peepholes (c_{t-1} feeds i and f, c_t feeds o) and the masked blend (a
// masked step, m = 0, carries h and c through).
struct Cell {
  float i, f, g, o;   // the pre-mask gates
  float h, c;         // the post-mask carries
};

__device__ __forceinline__ Cell cell_forward(float zi, float zf, float zg, float zo, float h,
                                             float c, float m, bool peep, float p_i, float p_f,
                                             float p_o) {
  Cell r;
  float c_new;
  if (peep) {
    r.i = sigmoid(zi + c * p_i);
    r.f = sigmoid(zf + c * p_f);
    r.g = tanhf(zg);
    c_new = r.f * c + r.i * r.g;
    r.o = sigmoid(zo + c_new * p_o);
  } else {
    r.i = sigmoid(zi);
    r.f = sigmoid(zf);
    r.g = tanhf(zg);
    r.o = sigmoid(zo);
    c_new = r.f * c + r.i * r.g;
  }
  const float h_new = r.o * tanhf(c_new);
  r.h = m * h_new + (1.f - m) * h;
  r.c = m * c_new + (1.f - m) * c;
  return r;
}

// One unit's gate cotangents at one reverse step, from the step's gates,
// c_t, c_{t-1} and mask, A = the carried dh plus the output cotangent and
// C = the carried dc: dz = [d_i, d_f, d_g, d_o], dc_{t-1}, and the part of
// dh_{t-1} that skips the gates, A (1 - m) (the caller adds dz . Wh^T).
struct CellGrad {
  float d_i, d_f, d_g, d_o;
  float dc;      // dc_{t-1}
  float carry;   // A (1 - m)
};

__device__ __forceinline__ CellGrad cell_backward(float i, float f, float g, float o,
                                                  float c_t, float c_prev, float A, float C,
                                                  float m, bool peep, float p_i, float p_f,
                                                  float p_o) {
  CellGrad r;
  const float tanh_c = tanhf(c_t);
  const float dh_g = A * m;
  r.d_o = dh_g * tanh_c * o * (1.f - o);
  float dcg = C * m + dh_g * o * (1.f - tanh_c * tanh_c);
  if (peep) dcg = dcg + r.d_o * p_o;
  r.d_i = dcg * g * i * (1.f - i);
  r.d_g = dcg * i * (1.f - g * g);
  r.d_f = dcg * c_prev * f * (1.f - f);
  r.carry = A * (1.f - m);
  float dc_new = dcg * f + C * (1.f - m);
  if (peep) dc_new = dc_new + r.d_i * p_i + r.d_f * p_f;
  r.dc = dc_new;
  return r;
}

// Phase marks of the cluster kernels' steps, for tools/lstm_phase_profile.py:
// built with -DLSTM_PHASE_PROFILE, thread 0 of block 0 stores %globaltimer
// at LSTM_PHASE(t, mark) into g_phase[t][mark] (steps past the last slot
// share it), read back by lstm_phase_read; otherwise a mark is nothing.
#ifdef LSTM_PHASE_PROFILE
constexpr int PHASE_STEPS = 64, PHASE_MARKS = 8;
__device__ unsigned long long g_phase[PHASE_STEPS * PHASE_MARKS];
#define LSTM_PHASE(t, mark)                                                              \
  do {                                                                                   \
    if (threadIdx.x == 0 && blockIdx.x == 0) {                                           \
      unsigned long long ns_;                                                            \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns_));                            \
      g_phase[((t) < PHASE_STEPS - 1 ? (t) : PHASE_STEPS - 1) * PHASE_MARKS + (mark)] = ns_; \
    }                                                                                    \
  } while (0)
#else
#define LSTM_PHASE(t, mark) \
  do {                      \
  } while (0)
#endif

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// -- thread-block clusters ----------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

// The address of `p` (this CTA's shared memory) in the shared memory of
// cluster CTA `rank`, as a 32-bit shared::cluster address.
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

__device__ __forceinline__ void st_cluster16(uint32_t addr, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// The split cluster barrier: every thread of every CTA of the cluster
// arrives (release: its shared-memory writes, remote ones included, become
// visible), then waits (acquire). Work placed between the two overlaps the
// wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// Copy a row-sliced local buffer into every CTA of the cluster (this one
// included) with 16-byte stores into distributed shared memory: `rows` rows
// of `per_row` 16-byte chunks, row r from src + r * src_ld to each CTA's
// dst + r * dst_ld (byte strides).
__device__ __forceinline__ void push_rows(const unsigned char* src, size_t src_ld,
                                          unsigned char* dst, size_t dst_ld, int rows,
                                          int per_row, int ctas, int tid, int nthreads) {
  const int per_peer = rows * per_row;
  for (int i = tid; i < per_peer * ctas; i += nthreads) {
    const int peer = i / per_peer, rem = i % per_peer;
    const int r = rem / per_row, c = rem % per_row;
    const uint4 v = *reinterpret_cast<const uint4*>(src + r * src_ld + c * 16);
    st_cluster16(peer_addr(dst + r * dst_ld + c * 16, peer), v);
  }
}

// -- launch attributes, set once per kernel and device ---------------------------

// One entry per (kernel, device): whether the attributes are set, and the
// answer of an occupancy query (blocks per SM or active clusters) keyed by
// the caller's H and dtype.
struct LaunchCache {
  static constexpr int DEVICES = 16;
  bool ready[DEVICES] = {};
  int sms[DEVICES] = {};
  int answer[DEVICES][3][MAX_H / 128 + 1];   // dtype x H/128; 0 = not asked yet
};

inline int current_device(int* dev) {
  const cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return int(e);
  return *dev < LaunchCache::DEVICES ? 0 : int(cudaErrorInvalidDevice);
}

// The dynamic shared memory a cluster-route CTA asks for: what its layout
// needs, and at least half an SM's, so that no two CTAs share an SM and a
// cluster's C CTAs spread over C SMs (packed two to an SM, every step would
// take twice as long).
inline size_t spread_smem(size_t bytes) {
  return bytes > SMEM_LIMIT / 2 + 1024 ? bytes : SMEM_LIMIT / 2 + 1024;
}

inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int clusters, int C,
                                         int threads, size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Sets a cluster-route kernel's attributes (the opt-in shared memory, and
// clusters of 16) once per device. Returns 0 or a cudaError_t.
template <typename K>
int prepare_cluster_kernel(LaunchCache& cache, K kernel) {
  int dev = 0;
  int rc = current_device(&dev);
  if (rc != 0) return rc;
  if (!cache.ready[dev]) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(SMEM_LIMIT));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return int(e);
    cache.ready[dev] = true;
  }
  return 0;
}

// Rows per cluster for a cluster-route launch whose 8-row instantiation is
// `kernel8` (layout bytes `bytes(R)` for R rows, U = H / C units, 8U
// threads): 8, or 9 when that lets ceil(B / 9) clusters all run at once and
// fits (the char-RNN's B = 128; each row count is an instantiation of the
// cluster kernels, whose products unroll over the rows). The clusters that
// run at once are asked once per device, dtype and H. Returns 0 or a
// cudaError_t; sets *rows.
template <typename K, typename Bytes>
int cluster_rows(LaunchCache& cache, K kernel8, Bytes bytes, int B, int H, int C, int dtype,
                 int* rows) {
  int rc = prepare_cluster_kernel(cache, kernel8);
  if (rc != 0) return rc;
  int dev = 0;
  current_device(&dev);
  int& at_once = cache.answer[dev][dtype][H / 128];
  if (at_once == 0) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        cluster_config(attr, 1, C, ROWS_C * (H / C), spread_smem(bytes(ROWS_C)), nullptr);
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, kernel8, &cfg);
    if (e != cudaSuccess) return int(e);
    at_once = n > 0 ? n : -1;
  }
  int R = ROWS_C;
  if (at_once > 0 && (B + ROWS_C - 1) / ROWS_C > at_once) {
    if ((B + at_once - 1) / at_once <= ROWS_C + 1 && bytes(ROWS_C + 1) <= SMEM_LIMIT)
      R = ROWS_C + 1;
  }
  *rows = R;
  return 0;
}

}  // namespace

#ifdef LSTM_PHASE_PROFILE
extern "C" int lstm_phase_read(unsigned long long* host) {
  return int(cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase)));
}
#endif
