// The detector's norm-activation tail for Hopper (sm_90a):
//   out = [residual +] mish(groupnorm(y)),  mish(v) = v * tanh(softplus(v)).
//
// Replaces no TPU kernel.  The reference leaves this chain to XLA, which
// fuses it; on the card PyTorch runs it as five kernels (group-norm
// moments, group-norm apply, softplus, tanh, the multiply) and the CSP
// bottleneck adds its residual in a sixth.  It was added because each conv
// block of repro_torch/models/detector.py _conv_bn paid those passes over
// its whole float32 output.
//
// What bounds it on the H100: bytes.  The statistics need one read of the
// slab, the output one write, a residual one read; softplus, tanh and the
// rest are a few dozen float32 instructions an element, within what the SMs
// execute at the card's memory rate.
//
// Arithmetic, as the plain composition computes it on the card (the
// float32 rounding differs only in the order of the moments' sums):
// Welford moments in float32, the biased variance, rstd = rsqrtf(var +
// eps), the affine as y * a + b with a = rstd * scale[c] and b = bias[c] -
// mean * a (F.group_norm's fused parameters), softplus with PyTorch's
// threshold 20 (y > 20 ? y : log1pf(expf(y))), then tanhf, the multiply
// and the residual last.  No fast-math intrinsic.
//
// Design.  In NCHW each (image, group) slab is one contiguous run of
// (C / G) * H * W floats (12,800 to 819,200 across the ladder, fewer in
// the small rungs' groups).  One launch, grid (k, N * G): a thread-block
// cluster of k CTAs a slab (k = 1, 2, 4 or 8, from the slab's length:
// parts of at most 16,384 elements where k = 8 allows), each CTA taking
// one contiguous part.  A CTA reads its part once with float4 loads, four
// in flight a thread, and keeps per-thread Chan/Welford moments (a
// float4 at a time: its own mean and squared deviations, then one merge);
// warps merge by shuffles, the CTA through shared memory, and the cluster
// through distributed shared memory, every CTA merging the k partials in
// rank order so all parts of a slab use the same mean and rstd.  Then the
// CTA applies over its part again, walking it backwards: the lines it read
// last are the likeliest still in the 50 MB L2.  Output stores are
// evict-first, so they do not push the parts still to be re-read out of
// L2.  A slab whose spatial size is not a multiple of 4 (or a pointer not
// 16-byte aligned) takes the same code one float at a time.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace coop = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // loads in flight a thread
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr long long kPart = 16384;  // elements a CTA, where k allows
constexpr float kSoftplusThreshold = 20.0f;

struct Moments {
  float n, mean, m2;
};

// Chan et al.'s pairwise merge; an empty side leaves the other unchanged.
__device__ __forceinline__ Moments merge(const Moments& a, const Moments& b) {
  const float n = a.n + b.n;
  if (n == 0.0f) return a;
  const float delta = b.mean - a.mean;
  const float wb = b.n / n;
  return {n, fmaf(delta, wb, a.mean), a.m2 + b.m2 + delta * delta * a.n * wb};
}

__device__ __forceinline__ Moments moments_of(float4 v) {
  const float m = ((v.x + v.y) + (v.z + v.w)) * 0.25f;
  const float dx = v.x - m, dy = v.y - m, dz = v.z - m, dw = v.w - m;
  return {4.0f, m, (dx * dx + dy * dy) + (dz * dz + dw * dw)};
}

__device__ __forceinline__ Moments moments_of(float v) { return {1.0f, v, 0.0f}; }

__device__ __forceinline__ Moments shfl_down(const Moments& a, int off) {
  return {__shfl_down_sync(0xffffffffu, a.n, off),
          __shfl_down_sync(0xffffffffu, a.mean, off),
          __shfl_down_sync(0xffffffffu, a.m2, off)};
}

__device__ __forceinline__ Moments warp_merge(Moments a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a = merge(a, shfl_down(a, off));
  return a;  // lane 0's is the warp's
}

__device__ __forceinline__ float mish(float y) {
  const float sp = y > kSoftplusThreshold ? y : log1pf(expf(y));
  return y * tanhf(sp);
}

// One load unit: a float4 (the vector path) or a float.
template <bool kVec> struct Unit;
template <> struct Unit<true> {
  using T = float4;
  static constexpr int kElems = 4;
  static __device__ __forceinline__ T load(const float* p, int u) {
    return __ldcg(reinterpret_cast<const float4*>(p) + u);
  }
  static __device__ __forceinline__ T load_once(const float* p, int u) {
    return __ldcs(reinterpret_cast<const float4*>(p) + u);
  }
  static __device__ __forceinline__ void store(float* p, int u, T v) {
    __stcs(reinterpret_cast<float4*>(p) + u, v);
  }
  static __device__ __forceinline__ T apply(T v, float a, float b) {
    return make_float4(mish(fmaf(a, v.x, b)), mish(fmaf(a, v.y, b)),
                       mish(fmaf(a, v.z, b)), mish(fmaf(a, v.w, b)));
  }
  static __device__ __forceinline__ T add(T r, T m) {
    return make_float4(r.x + m.x, r.y + m.y, r.z + m.z, r.w + m.w);
  }
};
template <> struct Unit<false> {
  using T = float;
  static constexpr int kElems = 1;
  static __device__ __forceinline__ T load(const float* p, int u) {
    return __ldcg(p + u);
  }
  static __device__ __forceinline__ T load_once(const float* p, int u) {
    return __ldcs(p + u);
  }
  static __device__ __forceinline__ void store(float* p, int u, T v) {
    __stcs(p + u, v);
  }
  static __device__ __forceinline__ T apply(T v, float a, float b) {
    return mish(fmaf(a, v, b));
  }
  static __device__ __forceinline__ T add(T r, T m) { return r + m; }
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// grid (k, N * G), cluster (k, 1, 1) when k > 1; slab s = blockIdx.y is
// image s / G, group s % G: n = cpg * hw contiguous floats at s * n.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
groupnorm_mish_kernel(const float* __restrict__ x,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      const float* __restrict__ res, float* __restrict__ out,
                      int groups, int cpg, int hw, float eps) {
  using U = Unit<kVec>;
  using T = typename U::T;
  __shared__ Moments warp_part[kWarps];
  __shared__ Moments cta_part;
  __shared__ float stat[2];  // mean, rstd

  const int tid = threadIdx.x;
  const int k = gridDim.x;
  const int rank = blockIdx.x;
  const int slab = blockIdx.y;
  const int n = cpg * hw;
  const long long base = static_cast<long long>(slab) * n;
  const float* xs = x + base;
  const int units = n / U::kElems;
  const int per = (units + k - 1) / k;
  const int beg = min(units, rank * per);
  const int end = min(units, beg + per);

  // the part's moments, kUnroll loads in flight a thread
  Moments t = {0.0f, 0.0f, 0.0f};
  for (int u0 = beg + tid; u0 < end; u0 += kThreads * kUnroll) {
    T v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int u = u0 + j * kThreads;
      if (u < end) v[j] = U::load(xs, u);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (u0 + j * kThreads < end) t = merge(t, moments_of(v[j]));
  }
  t = warp_merge(t);
  if ((tid & 31) == 0) warp_part[tid >> 5] = t;
  __syncthreads();
  Moments m = {0.0f, 0.0f, 0.0f};
  if (tid < 32) {
    m = tid < kWarps ? warp_part[tid] : m;
    m = warp_merge(m);  // thread 0 holds the CTA's moments
    if (tid == 0) cta_part = m;
  }
  if (k > 1) {
    coop::cluster_group cluster = coop::this_cluster();
    cluster.sync();  // every CTA's part is in its shared memory
    if (tid == 0) {  // in rank order: the same bits in every CTA
      m = *cluster.map_shared_rank(&cta_part, 0);
      for (int r = 1; r < k; ++r)
        m = merge(m, *cluster.map_shared_rank(&cta_part, r));
    }
  }
  if (tid == 0) {
    stat[0] = m.mean;
    stat[1] = rsqrtf(fmaxf(m.m2 / m.n, 0.0f) + eps);
  }
  __syncthreads();
  if (k > 1) cluster_arrive();  // this CTA has read the others' parts
  const float mean = stat[0];
  const float rstd = stat[1];

  // the apply pass over the same part, last unit first; a unit lies in one
  // channel (the vector path needs hw % 4 == 0)
  const int c0 = (slab % groups) * cpg;
  const float* rs = res == nullptr ? nullptr : res + base;
  float* os = out + base;
  for (int u0 = end - 1 - tid; u0 >= beg; u0 -= kThreads * kUnroll) {
    T v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int u = u0 - j * kThreads;
      if (u >= beg) v[j] = U::load(xs, u);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int u = u0 - j * kThreads;
      if (u < beg) continue;
      const int c = c0 + (u * U::kElems) / hw;
      const float a = rstd * __ldg(scale + c);
      const float b = fmaf(-a, mean, __ldg(bias + c));
      T m = U::apply(v[j], a, b);
      if (rs != nullptr) m = U::add(U::load_once(rs, u), m);
      U::store(os, u, m);
    }
  }
  if (k > 1) cluster_wait();  // no CTA leaves while another reads its part
}

int cluster_size(long long n) {
  int k = 1;
  while (k < kMaxCluster && (n + k - 1) / k > kPart) k *= 2;
  return k;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool kVec>
cudaError_t launch(const float* x, const float* scale, const float* bias,
                   const float* res, float* out, int slabs, int groups,
                   int cpg, int hw, float eps, cudaStream_t stream) {
  const int k = cluster_size(static_cast<long long>(cpg) * hw);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(k), static_cast<unsigned>(slabs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = k > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, groupnorm_mish_kernel<kVec>, x, scale, bias, res, out, groups,
      cpg, hw, eps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, res (may be null) and out (N, C, H, W) contiguous float32; scale and
// bias (C,) float32; C divisible by groups; (C / groups) * hw below 2^31
// and N * groups at most 65535.
int groupnorm_mish_f32(const void* x, const void* scale, const void* bias,
                       const void* res, void* out, long long batch,
                       int channels, long long hw, int groups, float eps,
                       void* stream) {
  if (batch < 0 || channels <= 0 || hw < 0 || groups <= 0 ||
      channels % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long cpg = channels / groups;
  const long long slabs = batch * groups;
  if (cpg * hw >= (1LL << 31) || slabs > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (slabs == 0 || hw == 0) return static_cast<int>(cudaSuccess);
  const float* xf = static_cast<const float*>(x);
  const float* rf = static_cast<const float*>(res);
  float* of = static_cast<float*>(out);
  const bool vec = hw % 4 == 0 && aligned16(x) && aligned16(out) &&
                   (res == nullptr || aligned16(res));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const cudaError_t err =
      vec ? launch<true>(xf, sc, bi, rf, of, static_cast<int>(slabs), groups,
                         static_cast<int>(cpg), static_cast<int>(hw), eps, s)
          : launch<false>(xf, sc, bi, rf, of, static_cast<int>(slabs), groups,
                          static_cast<int>(cpg), static_cast<int>(hw), eps,
                          s);
  return static_cast<int>(err);
}

}  // extern "C"
