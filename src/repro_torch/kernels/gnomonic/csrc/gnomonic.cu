// Gnomonic ERP -> PI resampling kernels for Hopper (sm_90a).
//
// Replaces:
//   * gnomonic_sample  <- the Pallas kernel repro/kernels/gnomonic/gnomonic.py
//                         gnomonic_pallas (body _kernel, planner plan_strips);
//   * project_srois    <- the XLA program repro/kernels/gnomonic/ops.py
//                         _project_srois_jit (vmapped gnomonic_coords +
//                         sample_erp_bilinear over a tick's crops).
//
// What bounds them on the H100.  gnomonic_sample: bytes.  Each output
// pixel reads four source texels and writes C values; the source texels a
// PI touches form a compact footprint of the ERP, so after the first touch
// they come from L2 (50 MB): the traffic that must reach device memory is
// that footprint plus the output.  project_srois: instruction issue about
// as much as bytes.  Its gnomonic map is precise libm per pixel (atan2f,
// asinf, sqrtf and five IEEE divides), which the float64 rule near the
// poles needs, and that issue is of the same size as the byte bound.
//
// Design.  gnomonic_sample: one thread per output pixel, looping over the
// C channels, with the ERP read straight from global memory through the
// read-only cache.  Neighbouring threads take neighbouring output pixels,
// whose source texels are neighbours too.  The TPU kernel's strip plan (a
// VMEM band per strip of output rows, with a fallback to the jnp oracle
// when the band outgrows VMEM) has no counterpart: a pole-centred PI runs
// through the same code.  The horizontal wrap is done on the integer texel
// index, as the reference's jnp.mod (never negative), so no seam padding
// is needed.
// project_srois: one block per 32x8 tile of one crop's output.  The
// crop's constants (the two half-FoV tangents, sin and cos of its centre's
// theta and phi) are computed once a block, by four warps in parallel,
// with the same functions on the same float32 inputs as a per-pixel
// evaluation, so each pixel's (u, v) is the one the math of
// repro/core/projection.py gnomonic_coords gives per pixel, bit for bit.
// A 2-D tile keeps a warp's source texels in a compact footprint.  The
// tile's C channels go out through shared memory as 16-byte stores.
// Crops index the tick's distinct frames through a per-crop frame index
// instead of stacking one copy of a frame per crop.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr int kThreads = 256;
constexpr int kTileX = 32;  // project_srois: output pixels of a tile row
constexpr int kTileY = 8;   // and thread rows
constexpr int kRowsPerThread = 4;  // output rows a thread of it takes

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// Bilinear sample of erp (H, W, C) at (u, v), pixel-centre convention:
// u wraps, v clamps (repro/core/projection.py sample_erp_bilinear).
template <typename T>
__device__ __forceinline__ void bilinear(const T* __restrict__ erp, int H,
                                         int W, int C, float u, float v,
                                         T* __restrict__ out) {
  const float u0 = floorf(u);
  const float v0 = floorf(v);
  const float fu = u - u0;
  const float fv = v - v0;
  int u0i = static_cast<int>(u0);
  if (u0i < 0 || u0i >= W) u0i = ((u0i % W) + W) % W;
  const int u1i = u0i + 1 == W ? 0 : u0i + 1;
  const int v0i = min(max(static_cast<int>(v0), 0), H - 1);
  const int v1i = min(v0i + 1, H - 1);
  const T* r0 = erp + static_cast<size_t>(v0i) * W * C;
  const T* r1 = erp + static_cast<size_t>(v1i) * W * C;
  for (int c = 0; c < C; ++c) {
    const float p00 = to_f(__ldg(r0 + u0i * C + c));
    const float p01 = to_f(__ldg(r0 + u1i * C + c));
    const float p10 = to_f(__ldg(r1 + u0i * C + c));
    const float p11 = to_f(__ldg(r1 + u1i * C + c));
    const float top = __fmaf_rn(p00, 1.0f - fu, __fmul_rn(p01, fu));
    const float bot = __fmaf_rn(p10, 1.0f - fu, __fmul_rn(p11, fu));
    out[c] = from_f<T>(__fmaf_rn(top, 1.0f - fv, __fmul_rn(bot, fv)));
  }
}

// kC: the channel count when known at compile time (its loads unroll),
// else 0.
template <typename T, int kC>
__global__ void gnomonic_sample_kernel(const T* __restrict__ erp,
                                       const float* __restrict__ u,
                                       const float* __restrict__ v,
                                       T* __restrict__ out, int H, int W,
                                       int C, int n_pix) {
  const int nc = kC ? kC : C;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  bilinear(erp, H, W, nc, u[p], v[p], out + static_cast<size_t>(p) * nc);
}

template <typename T>
int launch_gnomonic_sample(const void* erp, const void* u, const void* v,
                           void* out, int H, int W, int C, int n_pix,
                           void* stream) {
  const int blocks = (n_pix + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* e = static_cast<const T*>(erp);
  const auto* uu = static_cast<const float*>(u);
  const auto* vv = static_cast<const float*>(v);
  auto* o = static_cast<T*>(out);
  if (C == 3) {
    gnomonic_sample_kernel<T, 3><<<blocks, kThreads, 0, s>>>(e, uu, vv, o, H,
                                                              W, C, n_pix);
  } else {
    gnomonic_sample_kernel<T, 0><<<blocks, kThreads, 0, s>>>(e, uu, vv, o, H,
                                                              W, C, n_pix);
  }
  return static_cast<int>(cudaGetLastError());
}

// Output pixel (x, y) of an S x S crop -> its ERP coordinates (u, v), by
// the math of repro/core/projection.py gnomonic_coords.  crop holds the
// crop's tan of half FoVs, then sin and cos of its theta and of its phi.
__device__ __forceinline__ void crop_map(const float* crop, int x, int y,
                                         int S, int H, int W, float& u,
                                         float& v) {
  const float half_x = crop[0], half_y = crop[1];
  const float st = crop[2], ct = crop[3];
  const float sp = crop[4], cp = crop[5];
  // Each rounding is spelled out with the _rn intrinsics, which the
  // compiler never fuses, so that (u, v) does not depend on how it would
  // contract the products into the sums; the roundings are those the
  // per-pixel version of this kernel was compiled to (ptxas fused its
  // rotation's products into the subtractions).
  // tangent-plane coords of the pixel centre
  const float xs = (static_cast<float>(x) + 0.5f) / static_cast<float>(S);
  const float ys = (static_cast<float>(y) + 0.5f) / static_cast<float>(S);
  const float tx = __fmul_rn((xs - 0.5f) * 2.0f, half_x);
  const float ty = __fmul_rn((0.5f - ys) * 2.0f, half_y);
  const float norm = sqrtf(__fmaf_rn(ty, ty, __fmaf_rn(tx, tx, 1.0f)));
  const float d0 = 1.0f / norm, d1 = tx / norm, d2 = ty / norm;

  // rotation_from_origin(theta, phi) = (Ry(phi) Rz(-theta))^T
  const float wx =
      __fmaf_rn(__fmul_rn(sp, ct), -d2,
                __fmaf_rn(__fmul_rn(cp, ct), d0, -__fmul_rn(st, d1)));
  const float wy =
      __fmaf_rn(__fmul_rn(sp, st), -d2,
                __fmaf_rn(ct, d1, __fmul_rn(__fmul_rn(cp, st), d0)));
  const float wz = __fmaf_rn(sp, d0, __fmul_rn(cp, d2));

  // cart_to_sph, then sph_to_erp
  const float theta = atan2f(wy, wx);
  const float phi = asinf(fminf(fmaxf(wz, -1.0f), 1.0f));
  u = (theta / kTwoPi + 0.5f) * static_cast<float>(W);
  v = (0.5f - phi / kPi) * static_cast<float>(H);
}

// One block per kTileX x (kTileY * kRows) tile of crop blockIdx.z's output;
// a thread takes kRows pixels of one column, kTileY rows apart.  kC: the
// channel count when known at compile time (its loads unroll), else 0.
template <int kC, int kRows>
__global__ void project_srois_kernel(const float* __restrict__ frames,
                                     const int32_t* __restrict__ frame_idx,
                                     const float* __restrict__ centers,
                                     const float* __restrict__ fovs,
                                     float* __restrict__ out, int H, int W,
                                     int C, int S) {
  extern __shared__ __align__(16) float s_tile[];  // rows x (kTileX * C)
  __shared__ float s_crop[6];
  const int nc = kC ? kC : C;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY * kRows;
  const int tid = threadIdx.y * kTileX + threadIdx.x;

  // the crop's constants, lane 0 of warps 0-3
  if (threadIdx.x == 0 && threadIdx.y < 4) {
    switch (threadIdx.y) {
      case 0: s_crop[0] = tanf(fovs[2 * b] / 2.0f); break;
      case 1: s_crop[1] = tanf(fovs[2 * b + 1] / 2.0f); break;
      case 2: sincosf(centers[2 * b], &s_crop[2], &s_crop[3]); break;
      default: sincosf(centers[2 * b + 1], &s_crop[4], &s_crop[5]); break;
    }
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  float u[kRows], v[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int y = y0 + threadIdx.y + k * kTileY;
    if (x < S && y < S) crop_map(s_crop, x, y, S, H, W, u[k], v[k]);
  }
  const float* erp = frames + static_cast<size_t>(frame_idx[b]) * H * W * nc;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int y = y0 + threadIdx.y + k * kTileY;
    if (x < S && y < S) {
      bilinear(erp, H, W, nc, u[k], v[k],
               s_tile + ((threadIdx.y + k * kTileY) * kTileX + threadIdx.x) *
                            nc);
    }
  }
  __syncthreads();

  // each tile row is nx * C consecutive floats of out
  const int nx = min(kTileX, S - x0);
  const int ny = min(kTileY * kRows, S - y0);
  const int row_len = nx * nc;
  float* dst = out + ((static_cast<size_t>(b) * S + y0) * S + x0) * nc;
  const size_t pitch = static_cast<size_t>(S) * nc;
  if (row_len % 4 == 0 && pitch % 4 == 0 &&
      reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
    const int q = row_len / 4;
    for (int e = tid; e < ny * q; e += kTileX * kTileY) {
      const int r = e / q;
      const int c = e - r * q;
      reinterpret_cast<float4*>(dst + r * pitch)[c] =
          reinterpret_cast<const float4*>(s_tile + r * kTileX * nc)[c];
    }
  } else {
    for (int e = tid; e < ny * row_len; e += kTileX * kTileY) {
      const int r = e / row_len;
      const int c = e - r * row_len;
      dst[r * pitch + c] = s_tile[r * kTileX * nc + c];
    }
  }
}

template <int kC, int kRows>
void launch_project_srois(const float* frames, const int32_t* frame_idx,
                          const float* centers, const float* fovs,
                          float* out, int B, int H, int W, int C, int S,
                          cudaStream_t stream) {
  const dim3 grid((S + kTileX - 1) / kTileX,
                  (S + kTileY * kRows - 1) / (kTileY * kRows), B);
  const size_t smem = static_cast<size_t>(kTileX) * kTileY * kRows * C * 4;
  project_srois_kernel<kC, kRows><<<grid, dim3(kTileX, kTileY), smem,
                                    stream>>>(frames, frame_idx, centers,
                                              fovs, out, H, W, C, S);
}

}  // namespace

extern "C" {

// erp (H, W, C) float32, u/v (n_pix,) float32 -> out (n_pix, C) float32.
int gnomonic_sample_f32(const void* erp, const void* u, const void* v,
                        void* out, int H, int W, int C, int n_pix,
                        void* stream) {
  return launch_gnomonic_sample<float>(erp, u, v, out, H, W, C, n_pix,
                                       stream);
}

// The same for a float16 frame: the blend runs in float32, the output is
// float16 like the frame.
int gnomonic_sample_f16(const void* erp, const void* u, const void* v,
                        void* out, int H, int W, int C, int n_pix,
                        void* stream) {
  return launch_gnomonic_sample<__half>(erp, u, v, out, H, W, C, n_pix,
                                        stream);
}

// frames (F, H, W, C) float32, frame_idx (B,) int32, centers/fovs (B, 2)
// float32 -> out (B, S, S, C) float32.
int project_srois_f32(const void* frames, const void* frame_idx,
                      const void* centers, const void* fovs, void* out,
                      int B, int H, int W, int C, int S, void* stream) {
  const auto* f = static_cast<const float*>(frames);
  const auto* fi = static_cast<const int32_t*>(frame_idx);
  const auto* ce = static_cast<const float*>(centers);
  const auto* fo = static_cast<const float*>(fovs);
  auto* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 3) {
    launch_project_srois<3, kRowsPerThread>(f, fi, ce, fo, o, B, H, W, C, S,
                                            s);
  } else {
    launch_project_srois<0, kRowsPerThread>(f, fi, ce, fo, o, B, H, W, C, S,
                                            s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
