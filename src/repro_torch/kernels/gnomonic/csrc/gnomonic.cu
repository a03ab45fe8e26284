// Gnomonic ERP -> PI resampling kernels for Hopper (sm_90a).
//
// Replaces:
//   * gnomonic_sample  <- the Pallas kernel repro/kernels/gnomonic/gnomonic.py
//                         gnomonic_pallas (body _kernel, planner plan_strips);
//   * project_srois    <- the XLA program repro/kernels/gnomonic/ops.py
//                         _project_srois_jit (vmapped gnomonic_coords +
//                         sample_erp_bilinear over a tick's crops).
//
// What bounds it on the H100: bytes.  Each output pixel reads four source
// texels and writes C values; the arithmetic (one bilinear blend, and for
// project_srois one gnomonic map: tan, two sincos, atan2, asin per pixel)
// is far below the card's float32 rate.  The source texels a PI touches
// form a compact footprint of the ERP, so after the first touch they come
// from L2 (50 MB): the traffic that must reach device memory is that
// footprint plus the output.
//
// Design: one thread per output pixel, looping over the C channels, with
// the ERP read straight from global memory through the read-only cache.
// Neighbouring threads take neighbouring output pixels, whose source
// texels are neighbours too, so the gathers coalesce within a row of the
// footprint.  The TPU kernel's strip plan (a VMEM band per strip of
// output rows, with a fallback to the jnp oracle when the band outgrows
// VMEM) has no counterpart: a pole-centred PI runs through the same code.
// The horizontal wrap is done on the integer texel index, as the
// reference's jnp.mod (never negative), so no seam padding is needed.
// project_srois computes each pixel's (u, v) in the thread with the math
// of repro/core/projection.py gnomonic_coords, and indexes the tick's
// distinct frames through a per-crop frame index instead of stacking one
// copy of a frame per crop.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr int kThreads = 256;

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
  u0i = ((u0i % W) + W) % W;
  const int u1i = (u0i + 1) % W;
  const int v0i = min(max(static_cast<int>(v0), 0), H - 1);
  const int v1i = min(v0i + 1, H - 1);
  const T* r0 = erp + static_cast<size_t>(v0i) * W * C;
  const T* r1 = erp + static_cast<size_t>(v1i) * W * C;
  for (int c = 0; c < C; ++c) {
    const float p00 = to_f(__ldg(r0 + u0i * C + c));
    const float p01 = to_f(__ldg(r0 + u1i * C + c));
    const float p10 = to_f(__ldg(r1 + u0i * C + c));
    const float p11 = to_f(__ldg(r1 + u1i * C + c));
    const float top = p00 * (1.0f - fu) + p01 * fu;
    const float bot = p10 * (1.0f - fu) + p11 * fu;
    out[c] = from_f<T>(top * (1.0f - fv) + bot * fv);
  }
}

template <typename T>
__global__ void gnomonic_sample_kernel(const T* __restrict__ erp,
                                       const float* __restrict__ u,
                                       const float* __restrict__ v,
                                       T* __restrict__ out, int H, int W,
                                       int C, int n_pix) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  bilinear(erp, H, W, C, u[p], v[p], out + static_cast<size_t>(p) * C);
}

__global__ void project_srois_kernel(const float* __restrict__ frames,
                                     const int32_t* __restrict__ frame_idx,
                                     const float* __restrict__ centers,
                                     const float* __restrict__ fovs,
                                     float* __restrict__ out, int H, int W,
                                     int C, int S) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (p >= S * S) return;
  const int y = p / S;
  const int x = p - y * S;

  // gnomonic_coords: tangent-plane coords of the pixel centre
  const float half_x = tanf(fovs[2 * b] / 2.0f);
  const float half_y = tanf(fovs[2 * b + 1] / 2.0f);
  const float xs = (static_cast<float>(x) + 0.5f) / static_cast<float>(S);
  const float ys = (static_cast<float>(y) + 0.5f) / static_cast<float>(S);
  const float tx = (xs - 0.5f) * 2.0f * half_x;
  const float ty = (0.5f - ys) * 2.0f * half_y;
  const float norm = sqrtf(1.0f + tx * tx + ty * ty);
  const float d0 = 1.0f / norm, d1 = tx / norm, d2 = ty / norm;

  // rotation_from_origin(theta, phi) = (Ry(phi) Rz(-theta))^T
  float st, ct, sp, cp;
  sincosf(centers[2 * b], &st, &ct);
  sincosf(centers[2 * b + 1], &sp, &cp);
  const float wx = cp * ct * d0 - st * d1 - sp * ct * d2;
  const float wy = cp * st * d0 + ct * d1 - sp * st * d2;
  const float wz = sp * d0 + cp * d2;

  // cart_to_sph, then sph_to_erp
  const float theta = atan2f(wy, wx);
  const float phi = asinf(fminf(fmaxf(wz, -1.0f), 1.0f));
  const float u = (theta / kTwoPi + 0.5f) * static_cast<float>(W);
  const float v = (0.5f - phi / kPi) * static_cast<float>(H);

  const float* erp = frames + static_cast<size_t>(frame_idx[b]) * H * W * C;
  bilinear(erp, H, W, C, u, v,
           out + (static_cast<size_t>(b) * S * S + p) * C);
}

}  // namespace

extern "C" {

// erp (H, W, C) float32, u/v (n_pix,) float32 -> out (n_pix, C) float32.
int gnomonic_sample_f32(const void* erp, const void* u, const void* v,
                        void* out, int H, int W, int C, int n_pix,
                        void* stream) {
  const int blocks = (n_pix + kThreads - 1) / kThreads;
  gnomonic_sample_kernel<float><<<blocks, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(erp), static_cast<const float*>(u),
      static_cast<const float*>(v), static_cast<float*>(out), H, W, C,
      n_pix);
  return static_cast<int>(cudaGetLastError());
}

// The same for a float16 frame: the blend runs in float32, the output is
// float16 like the frame.
int gnomonic_sample_f16(const void* erp, const void* u, const void* v,
                        void* out, int H, int W, int C, int n_pix,
                        void* stream) {
  const int blocks = (n_pix + kThreads - 1) / kThreads;
  gnomonic_sample_kernel<__half><<<blocks, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __half*>(erp), static_cast<const float*>(u),
      static_cast<const float*>(v), static_cast<__half*>(out), H, W, C,
      n_pix);
  return static_cast<int>(cudaGetLastError());
}

// frames (F, H, W, C) float32, frame_idx (B,) int32, centers/fovs (B, 2)
// float32 -> out (B, S, S, C) float32.
int project_srois_f32(const void* frames, const void* frame_idx,
                      const void* centers, const void* fovs, void* out,
                      int B, int H, int W, int C, int S, void* stream) {
  const dim3 grid((S * S + kThreads - 1) / kThreads, B);
  project_srois_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames),
      static_cast<const int32_t*>(frame_idx),
      static_cast<const float*>(centers), static_cast<const float*>(fovs),
      static_cast<float*>(out), H, W, C, S);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
