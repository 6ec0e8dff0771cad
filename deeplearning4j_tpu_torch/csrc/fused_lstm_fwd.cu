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
// zx's dtype.
//
// Design (what differs from the TPU kernel, and why):
// - The TPU grid walks time chunks in order on one core and keeps all of Wh
//   (1 MB at H=256 f32) in VMEM. A Hopper block has at most 227 KB of shared
//   memory, so Wh is sharded over hidden units: each block owns HB = 8 units
//   and keeps their 4 gate columns, Wh[:, {i,f,g,o} x units] ([H, 32]), in
//   shared memory for all T steps, laid out [k][unit][gate] so that one
//   thread reads its unit's 4 gate weights with one vector load.
// - Blocks also split the batch into tiles of BB = 32 rows (a block walks
//   several tiles when the batch is larger than the grid allows), so one
//   thread owns one (batch row, unit) pair: its 4 gate sums, its pointwise
//   cell update and its c carry.
// - Every step needs all of h_{t-1}. It is exchanged through a double-
//   buffered f32 scratch [2, B, H] in device memory (read through L2 with
//   ld.global.cg), and the step ends at one grid-wide barrier: the launch is
//   cooperative (cudaLaunchCooperativeKernel), so all blocks are resident
//   and cooperative_groups::this_grid().sync() cannot deadlock. The launch
//   refuses a grid that cannot be co-resident.
// - h is rounded to Wh's dtype before the recurrent product, as the TPU
//   kernel casts it (`h.astype(wh.dtype)`); products accumulate in f32 with
//   plain FMAs (no TF32), so f32 keeps f32 accuracy.
//
// Bound at the char-RNN shape (B=128, T=50, H=256, f32, one layer): the
// recurrent products are 2*B*T*H*4H = 3.36 GFLOP, 0.050 ms at the H100
// SXM's 67 TFLOP/s of f32 FMA; the kernel must read zx (26.2 MB) and Wh
// and write gates, hs and cs (39.3 MB), ~67 MB, 0.020 ms at 3.35 TB/s: bound
// by operations. In bf16 the bytes halve and the products would run on the
// tensor cores, so it is bound by bytes (~0.010 ms). This first version does
// its products on the FMA units from shared memory and ends every one of the
// T dependent steps at a grid barrier, so the barriers and the per-step
// latency set its time, far above that bound; a thread-block cluster
// exchanging h through distributed shared memory, and wgmma for bf16, are
// the later steps.

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
constexpr int THREADS = BB * HB;    // one thread per (row, unit): 256
constexpr int KC = 256;             // h columns staged per chunk
constexpr int LDH = KC + 4;         // staged row stride (floats): rows 4 banks apart

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}
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

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

struct Params {
  const void* zx;       // [B, T, 4H]
  const void* wh;       // [H, 4H]
  const float* mask;    // [B, T] or null
  const float* peep;    // [3H] or null
  float* hbuf;          // [2, B, H]: h_{t-1} in slot t&1, slot 0 seeded with h0
  float* cbuf;          // [B, H]: c, seeded with c0, read/written by its owner
  void* hs;             // [B, T, H]
  void* gates;          // [B, T, 4H]
  void* cs;             // [B, T, H]
  void* hT;             // [B, H]
  void* cT;             // [B, H]
  int B, T, H;
};

template <typename T>
size_t smem_bytes(int H) {
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
        const float zi = to_f(zr[j]) + a0;
        const float zf = to_f(zr[H + j]) + a1;
        const float zg = to_f(zr[2 * H + j]) + a2;
        const float zo = to_f(zr[3 * H + j]) + a3;
        float i, f, g, o, c_new;
        if (p.peep != nullptr) {
          i = sigmoid(zi + c * p_i);
          f = sigmoid(zf + c * p_f);
          g = tanhf(zg);
          c_new = f * c + i * g;
          o = sigmoid(zo + c_new * p_o);
        } else {
          i = sigmoid(zi);
          f = sigmoid(zf);
          g = tanhf(zg);
          o = sigmoid(zo);
          c_new = f * c + i * g;
        }
        const float h_new = o * tanhf(c_new);
        const float h_out = m * h_new + (1.f - m) * h;
        const float c_out = m * c_new + (1.f - m) * c;
        hout[size_t(b) * H + j] = h_out;
        p.cbuf[size_t(b) * H + j] = c_out;
        hs[row * H + j] = from_f<T>(h_out);
        cs[row * H + j] = from_f<T>(c_out);
        T* gr = gates + row * Z;
        gr[j] = from_f<T>(i);
        gr[H + j] = from_f<T>(f);
        gr[2 * H + j] = from_f<T>(g);
        gr[3 * H + j] = from_f<T>(o);
        if (t == n_t - 1) {
          static_cast<T*>(p.hT)[size_t(b) * H + j] = from_f<T>(h_out);
          static_cast<T*>(p.cT)[size_t(b) * H + j] = from_f<T>(c_out);
        }
      }
    }
    if (t + 1 < n_t) grid.sync();   // h_t complete everywhere before step t+1
  }
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(p.H);
  auto kernel = fused_lstm_fwd_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return int(e);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return -2;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (e != cudaSuccess) return int(e);
  const int n_slices = p.H / HB;
  const int n_tiles = (p.B + BB - 1) / BB;
  const int groups = std::min(n_tiles, per_sm * sms / n_slices);
  if (groups < 1) return -2;
  Params args = p;
  void* kargs[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(n_slices * groups), dim3(THREADS), kargs,
                                  smem, stream);
  return int(e);
}

bool supported(int H) { return H >= 128 && H <= 512 && H % 128 == 0; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (zx, Wh, and every output). Returns 0 on a
// clean launch, -1 for an unsupported dtype or H, -2 when the grid cannot be
// co-resident, else the cudaError_t code.
int fused_lstm_fwd(const void* zx, const void* wh, const float* mask,
                   const float* peep, float* hbuf, float* cbuf, void* hs,
                   void* gates, void* cs, void* hT, void* cT, int B, int T,
                   int H, int dtype, void* stream) {
  if (!supported(H) || B < 1 || T < 1) return -1;
  Params p{zx, wh, mask, peep, hbuf, cbuf, hs, gates, cs, hT, cT, B, T, H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<bf16>(p, s);
  return -1;
}

// Dynamic shared memory one block takes, or -1 when unsupported.
long long fused_lstm_fwd_smem_bytes(int dtype, int H) {
  if (!supported(H)) return -1;
  if (dtype == 0) return (long long)smem_bytes<float>(H);
  if (dtype == 1) return (long long)smem_bytes<bf16>(H);
  return -1;
}

const char* fused_lstm_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
