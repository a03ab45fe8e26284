// Batched SphIoU matrices for Hopper (sm_90a).
//
// Replaces the Pallas kernels repro/kernels/sphiou/sphiou.py
// sphiou_pallas_batch (body _kernel_batch -> _iou_tile -> _intersection)
// and sphiou_pallas (the same body at B=1).
//
// What it computes, per row b and pair (i, j): box j's centre rotated into
// box i's tangent frame (explicit scalar trig, no 3x3 products), the
// overlap of the longitude and latitude intervals, the intersection
// averaged over both directions, area 4 * h * sin(v) on half-FoVs, and
// IoU = inter / max(union, 1e-12).  Zero-FoV padding scores 0.
//
// What bounds it on the H100: operations.  The output write is 4 bytes a
// pair, but each pair takes about a dozen sincos/atan2/asin/sin calls, and
// the precise ones are software sequences of tens of instructions each, so
// the kernel runs well above the byte floor.  Precise libm calls are kept
// (no --use_fast_math): the IoU has to agree with the float32 reference
// within 5e-6.  Each direction's trig of a box (sincos of its latitude) is
// recomputed per pair; hoisting it into the staged tile is the first step
// of a faster version.
//
// Design: one thread per (b, i, j); a 32 x 8 block covers 32 columns and
// 8 rows of one row's matrix, so a warp writes 32 consecutive floats.  The
// block stages its 8 + 32 boxes in shared memory once.  The batch is the
// grid's z axis.
//
// The bf16 option (the reference's dtype=bfloat16, sphiou.py _iou_tile):
// inputs and outputs stay float32, the boxes are rounded to bf16, and every
// intermediate of _iou_tile/_intersection is rounded to bf16 after its
// operation, as a chain of bf16 elementwise ops rounds each result.  The
// arithmetic itself runs in float32 (the card has no bf16 transcendentals),
// so the option changes the numbers, not the speed: it exists to give the
// reference's keep decisions, and its flips against float32 are gated.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileJ = 32;
constexpr int kTileI = 8;

// Intersection with box A rotated to the origin (one direction).
__device__ __forceinline__ float intersection(float ta, float pa, float ha,
                                              float va, float tb, float pb,
                                              float hb, float vb) {
  const float dt = tb - ta;
  float spa, cpa, spb, cpb, sdt, cdt;
  sincosf(pa, &spa, &cpa);
  sincosf(pb, &spb, &cpb);
  sincosf(dt, &sdt, &cdt);
  // B's centre direction expressed in A's tangent frame
  const float x = cpa * cpb * cdt + spa * spb;
  const float y = cpb * sdt;
  const float z = -spa * cpb * cdt + cpa * spb;
  const float dlon = atan2f(y, x);
  const float dlat = asinf(fminf(fmaxf(z, -1.0f), 1.0f));
  const float lon_lo = fmaxf(-ha, dlon - hb);
  const float lon_hi = fminf(ha, dlon + hb);
  const float lat_lo = fmaxf(-va, dlat - vb);
  const float lat_hi = fminf(va, dlat + vb);
  const float lon_w = fmaxf(lon_hi - lon_lo, 0.0f);
  const float lat_w = lat_hi > lat_lo ? sinf(lat_hi) - sinf(lat_lo) : 0.0f;
  return lon_w * fmaxf(lat_w, 0.0f);
}

// round to bf16 and back: one bf16 elementwise result
__device__ __forceinline__ float r16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// intersection() with every intermediate rounded to bf16, in the order of
// the reference's expressions; the inputs are bf16 values already
__device__ __forceinline__ float intersection_bf16(float ta, float pa,
                                                   float ha, float va,
                                                   float tb, float pb,
                                                   float hb, float vb) {
  const float dt = r16(tb - ta);
  const float cpa = r16(cosf(pa)), spa = r16(sinf(pa));
  const float cpb = r16(cosf(pb)), spb = r16(sinf(pb));
  const float cdt = r16(cosf(dt));
  const float x = r16(r16(r16(cpa * cpb) * cdt) + r16(spa * spb));
  const float y = r16(cpb * r16(sinf(dt)));
  const float z = r16(r16(r16(-spa * cpb) * cdt) + r16(cpa * spb));
  const float dlon = r16(atan2f(y, x));
  const float dlat = r16(asinf(fminf(fmaxf(z, -1.0f), 1.0f)));
  const float lon_lo = fmaxf(-ha, r16(dlon - hb));
  const float lon_hi = fminf(ha, r16(dlon + hb));
  const float lat_lo = fmaxf(-va, r16(dlat - vb));
  const float lat_hi = fminf(va, r16(dlat + vb));
  const float lon_w = fmaxf(r16(lon_hi - lon_lo), 0.0f);
  const float lat_w =
      lat_hi > lat_lo ? r16(r16(sinf(lat_hi)) - r16(sinf(lat_lo))) : 0.0f;
  return r16(lon_w * fmaxf(lat_w, 0.0f));
}

template <bool kBf16>
__global__ void sphiou_batch_kernel(const float* __restrict__ a,
                                    const float* __restrict__ b,
                                    float* __restrict__ out, int N, int M) {
  __shared__ float sa[kTileI][4];
  __shared__ float sb[kTileJ][4];
  const int row = blockIdx.z;
  const int i0 = blockIdx.y * kTileI;
  const int j0 = blockIdx.x * kTileJ;
  const int tid = threadIdx.y * kTileJ + threadIdx.x;
  if (tid < kTileI * 4) {
    const int r = tid / 4, k = tid % 4;
    const int i = i0 + r;
    sa[r][k] = i < N ? a[(static_cast<size_t>(row) * N + i) * 4 + k] : 0.0f;
  }
  if (tid < kTileJ * 4) {
    const int r = tid / 4, k = tid % 4;
    const int j = j0 + r;
    sb[r][k] = j < M ? b[(static_cast<size_t>(row) * M + j) * 4 + k] : 0.0f;
  }
  __syncthreads();
  const int i = i0 + threadIdx.y;
  const int j = j0 + threadIdx.x;
  if (i >= N || j >= M) return;

  float* const o = out + (static_cast<size_t>(row) * N + i) * M + j;
  if constexpr (kBf16) {
    const float ta = r16(sa[threadIdx.y][0]), pa = r16(sa[threadIdx.y][1]);
    const float ha = r16(r16(sa[threadIdx.y][2]) * 0.5f);
    const float va = r16(r16(sa[threadIdx.y][3]) * 0.5f);
    const float tb = r16(sb[threadIdx.x][0]), pb = r16(sb[threadIdx.x][1]);
    const float hb = r16(r16(sb[threadIdx.x][2]) * 0.5f);
    const float vb = r16(r16(sb[threadIdx.x][3]) * 0.5f);
    const float inter =
        r16(0.5f * r16(intersection_bf16(ta, pa, ha, va, tb, pb, hb, vb) +
                       intersection_bf16(tb, pb, hb, vb, ta, pa, ha, va)));
    const float area_a = r16(r16(4.0f * ha) * r16(sinf(va)));
    const float area_b = r16(r16(4.0f * hb) * r16(sinf(vb)));
    const float uni = r16(r16(area_a + area_b) - inter);
    *o = r16(inter / fmaxf(uni, r16(1e-12f)));
    return;
  }
  const float ta = sa[threadIdx.y][0], pa = sa[threadIdx.y][1];
  const float ha = sa[threadIdx.y][2] * 0.5f, va = sa[threadIdx.y][3] * 0.5f;
  const float tb = sb[threadIdx.x][0], pb = sb[threadIdx.x][1];
  const float hb = sb[threadIdx.x][2] * 0.5f, vb = sb[threadIdx.x][3] * 0.5f;

  // symmetrised intersection (repro/core/sphere.py sph_iou)
  const float inter = 0.5f * (intersection(ta, pa, ha, va, tb, pb, hb, vb) +
                              intersection(tb, pb, hb, vb, ta, pa, ha, va));
  const float area_a = 4.0f * ha * sinf(va);  // 2 * dtheta * sin(dphi / 2)
  const float area_b = 4.0f * hb * sinf(vb);
  *o = inter / fmaxf(area_a + area_b - inter, 1e-12f);
}

template <bool kBf16>
int launch(const void* a, const void* b, void* out, int B, int N, int M,
           void* stream) {
  const dim3 block(kTileJ, kTileI);
  const dim3 grid((M + kTileJ - 1) / kTileJ, (N + kTileI - 1) / kTileI, B);
  sphiou_batch_kernel<kBf16>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(a), static_cast<const float*>(b),
          static_cast<float*>(out), N, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a (B, N, 4), b (B, M, 4) float32 -> out (B, N, M) float32.
int sphiou_batch_f32(const void* a, const void* b, void* out, int B, int N,
                     int M, void* stream) {
  return launch<false>(a, b, out, B, N, M, stream);
}

// The same with bf16 compute (float32 in and out).
int sphiou_batch_bf16(const void* a, const void* b, void* out, int B, int N,
                      int M, void* stream) {
  return launch<true>(a, b, out, B, N, M, stream);
}

}  // extern "C"
