// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/attention/attention.py
// mha_pallas (body _kernel), as repro/kernels/attention/ops.py
// flash_attention calls it: q (B, Sq, Hq, D) against k, v (B, Skv, Hkv, D)
// in float32 or bfloat16, scores and the value product in float32, an
// online softmax (running max, denominator and accumulator in float32),
// causal and sliding-window masks, q_offset for decode and chunked prefill,
// masked logits at -1e30 (NEG_INF in the reference), a fully masked row
// giving 0 (the denominator is max(l, 1e-30)), and the output in q's dtype.
//
// What the TPU design did and this one does not: the wrapper there folds
// (B, S, H, D) into (B*H, S, D), repeats the KV heads for GQA and pads both
// sequences to block multiples.  Here the kernel reads the (B, S, H, D)
// tensors through their strides, maps query head h to KV head
// h / (Hq / Hkv), and bounds-checks the ragged tails.  The TPU's sequential
// kv grid axis, which carried the running statistics in VMEM scratch,
// becomes a loop inside the CTA with the statistics in registers.
//
// What bounds it on the H100: operations.  A causal prefill does
// 4 * D multiply-adds' worth of FLOPs per (query, key) pair and reads each
// input once; at S = 2048 that is hundreds of operations per byte.  The
// card's rate for this work is its bf16 tensor-core rate, 989 TFLOP/s, and
// this kernel does not reach it: it is a plain FMA design at the float32
// CUDA-core rate (67 TFLOP/s at best).  Tensor cores (wgmma), TMA and a
// pipelined K/V ring are later work.
//
// Design: one CTA of 128 threads per (batch * query head, 64-row query
// tile); the tiles run heaviest first (latest rows, the longest causal
// band).  The CTA stages its q tile once and each 64-key K/V tile in
// shared memory as float32 (q and k transposed, so a thread reads four
// rows or four keys as one float4).  Thread t owns rows 4*(t/8)..+3 of the
// tile; for the scores it owns 8 keys of each tile (two groups of 4), and
// for the output D/8 columns.  Row max and sum go across the 8 threads of
// a row group with warp shuffles; the probabilities pass through shared
// memory from the score layout to the output layout.  K/V tiles wholly
// outside the causal or window band are never loaded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per K/V tile
constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kLd = kBQ + 4;   // row length of the transposed tiles (floats)
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "the q and k tiles share one transposed layout");

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// the key of score slot c (0..7) of column group cg: two groups of four,
// so the 8 column groups of a row read 32 consecutive floats at a time
__device__ __forceinline__ int key_col(int cg, int c) {
  return (c >> 2) * 32 + cg * 4 + (c & 3);
}

// output column e (0..D/8-1) of column group cg
template <int D>
__device__ __forceinline__ int out_col(int cg, int e) {
  if constexpr (D >= 32) {
    return (e >> 2) * 32 + cg * 4 + (e & 3);
  } else {
    return cg * (D / 8) + e;
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Skv, Hq, Hkv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
  int causal, window, q_offset;  // window < 0: none
};

template <int D>
constexpr size_t smem_floats() {
  // q and k transposed [D][kLd], v [kBK][D + 4], p transposed [kBK][kLd]
  return 2 * D * kLd + kBK * (D + 4) + kBK * kLd;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Args a) {
  static_assert(D % 16 == 0 && D <= 128, "head size");
  constexpr int kLdV = D + 4;
  constexpr int NC = D / 8;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + D * kLd;
  float* vs = ks + D * kLd;
  float* ps = vs + kBK * kLdV;

  const T* __restrict__ qg = static_cast<const T*>(a.q);
  const T* __restrict__ kg = static_cast<const T*>(a.k);
  const T* __restrict__ vg = static_cast<const T*>(a.v);
  T* __restrict__ og = static_cast<T*>(a.o);

  const int bh = blockIdx.x;
  const int b = bh / a.Hq, h = bh % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int n_qt = (a.Sq + kBQ - 1) / kBQ;
  const int i0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * kBQ;
  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // rows 4*rg .. 4*rg+3 of the tile
  const int cg = tid & 7;   // column group; the 8 of a row group share a warp

  // stage the q tile, transposed; rows past Sq are zero and never stored
  const T* qb = qg + b * a.q_sb + h * a.q_sh;
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int i = i0 + r;
    qs[d * kLd + r] = i < a.Sq ? load_f32(qb + i * a.q_ss + d) : 0.0f;
  }

  // the K/V tiles that can hold an unmasked key for these rows
  const int q_lo = a.q_offset + i0;
  const int q_hi = a.q_offset + min(i0 + kBQ, a.Sq) - 1;
  const int kv_len = a.Skv;
  int kt_end = (kv_len + kBK - 1) / kBK;
  if (a.causal) kt_end = q_hi < 0 ? 0 : min(q_hi, kv_len - 1) / kBK + 1;
  const int kt_begin = a.window > 0 ? max(0, q_lo - (a.window - 1)) / kBK : 0;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < NC; ++e) acc[i][e] = 0.0f;
  }

  const T* kb = kg + b * a.k_sb + hk * a.k_sh;
  const T* vb = vg + b * a.v_sb + hk * a.v_sh;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int j0 = kt * kBK;
    __syncthreads();  // the previous tile's k, v and p are consumed
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const int j = j0 + r;
      const bool in = j < kv_len;
      ks[d * kLd + r] = in ? load_f32(kb + j * a.k_ss + d) : 0.0f;
      vs[r * kLdV + d] = in ? load_f32(vb + j * a.v_ss + d) : 0.0f;
    }
    __syncthreads();

    // scores: 4 rows x 8 keys a thread
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + d * kLd + rg * 4);
      const float4 k0 = *reinterpret_cast<const float4*>(ks + d * kLd + cg * 4);
      const float4 k1 =
          *reinterpret_cast<const float4*>(ks + d * kLd + 32 + cg * 4);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
      const float kc[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) s[i][c] = fmaf(qr[i], kc[c], s[i][c]);
    }

    // mask, online softmax
    unsigned live = 0;  // bit 8*i + c: (row i, key c) is unmasked
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_lo + rg * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int kpos = j0 + key_col(cg, c);
        bool ok = kpos < kv_len;
        if (a.causal) ok = ok && kpos <= qpos;
        if (a.window > 0) ok = ok && kpos > qpos - a.window;
        s[i][c] = ok ? s[i][c] * a.scale : kNegInf;
        live |= static_cast<unsigned>(ok) << (8 * i + c);
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        s[i][c] = (live >> (8 * i + c)) & 1u ? expf(s[i][c] - m_new) : 0.0f;
        sum += s[i][c];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < NC; ++e) acc[i][e] *= alpha;
    }

    // probabilities to shared memory, transposed: ps[key][row]
#pragma unroll
    for (int c = 0; c < 8; ++c)
      *reinterpret_cast<float4*>(ps + key_col(cg, c) * kLd + rg * 4) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

    // acc += p @ v
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(ps + j * kLd + rg * 4);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
      float vc[NC];
#pragma unroll
      for (int e = 0; e < NC; ++e) vc[e] = vs[j * kLdV + out_col<D>(cg, e)];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < NC; ++e) acc[i][e] = fmaf(pr[i], vc[e], acc[i][e]);
    }
  }

  // out = acc / max(l, 1e-30), (B, Sq, Hq, D) contiguous
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + rg * 4 + i;
    if (row >= a.Sq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    T* orow = og + ((static_cast<long long>(b) * a.Sq + row) * a.Hq + h) * D;
#pragma unroll
    for (int e = 0; e < NC; ++e) store_out(orow + out_col<D>(cg, e),
                                           acc[i][e] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * a.Hq, (a.Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const Args& a, int B, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(a, B, stream);
    case 32: return launch<T, 32>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), element strides of the
// batch, sequence and head axes (the D axis is dense) -> o (B, Sq, Hq, D)
// contiguous.  dtype 0: float32, 1: bfloat16.  window < 0: no window.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int D, int B, int Sq, int Skv, int Hq,
                        int Hkv, long long q_sb, long long q_ss,
                        long long q_sh, long long k_sb, long long k_ss,
                        long long k_sh, long long v_sb, long long v_ss,
                        long long v_sh, float scale, int causal, int window,
                        int q_offset, void* stream) {
  const Args a{q,    k,    v,    o,    Sq,   Skv,   Hq,     Hkv,    q_sb,
               q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,  v_ss,   v_sh,   scale,
               causal, window, q_offset};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? dispatch_d<float>(D, a, B, s)
                 : dtype == 1 ? dispatch_d<__nv_bfloat16>(D, a, B, s)
                              : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
