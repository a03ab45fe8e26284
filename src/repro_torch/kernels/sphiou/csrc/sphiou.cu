// Batched SphIoU matrices for Hopper (sm_90a).
//
// Replaces the Pallas kernels repro/kernels/sphiou/sphiou.py:120
// sphiou_pallas_batch (body _kernel_batch -> _iou_tile -> _intersection)
// and sphiou.py:94 sphiou_pallas (the same body at B=1), in float32 and
// with their bf16 compute option.
//
// What it computes, per row b and pair (i, j): box j's centre rotated into
// box i's tangent frame (explicit scalar trig, no 3x3 products), the
// overlap of the longitude and latitude intervals, the intersection
// averaged over both directions, area 4 * h * sin(v) on half-FoVs, and
// IoU = inter / max(union, 1e-12).  Zero-FoV padding scores 0.
//
// What bounds it on the H100: operations, not bytes.  The output write is
// 4 bytes a pair, but a pair needs precise sincos/atan2/asin/sin calls,
// software sequences of tens of instructions each, so the kernel runs
// many times above the byte floor.  Precise libm stays (no
// --use_fast_math, no __sinf): the intrinsics' 2^-21 absolute error would
// move small boxes' IoUs past the 5e-6 the float32 reference allows.
//
// What the design does about it: it issues each transcendental once.
//  1. Per-box constants once a block: theta, cos and sin of the latitude,
//     the half-FoVs and the area, staged in shared memory for the block's
//     32 row boxes and 32 column boxes.  A pair no longer computes any
//     trig of one box alone.  The area is a loaded value, so ptxas cannot
//     contract area_a + area_b differently for (i, j) and (j, i).
//  2. Both directions of a pair from one sincos: the reverse angle is -dt,
//     whose sine is -sin(dt) and cosine cos(dt) (sinf is odd and cosf even
//     bit for bit, sphiou_trig_check), and x, the cosine of the angle
//     between the centres, is the same expression both ways.
//  3. The self path (a and b the same boxes, as NMS calls it): IoU is
//     symmetric, so a block takes a 32x32 tile of the upper triangle
//     (tile_i <= tile_j), or a slab of its rows (step 4), and writes it
//     and, through a shared tile padded by one column, its transpose, in
//     runs of 32 consecutive floats (8 on an 8-row slab).  A diagonal tile
//     computes its own upper triangle.  The output stays the full
//     (B, N, N) matrix, exactly symmetric.
//  4. A block is 32 x 8 threads.  Where a launch covers 1024 tiles or more
//     (32 x 512 rows: 4352), a thread takes 4 rows of one column, the
//     column box's constants in registers, so a block stages 64 boxes for
//     1024 pairs.  Below that (the tick's 4 x 128 rows: 40 tiles) a thread
//     takes one row and a block an 8-row slab: four times the blocks, each
//     a quarter of the serial work.
// Per pair after the redesign: 1 sincos, 2 atan2, 2 asin, up to 4 sin
// (none for a direction whose latitude intervals miss) and ~50 other
// operations, for an unordered pair on the self path; the general path
// computes that for each ordered pair.  Before: 6 sincos, 2 atan2, 2 asin
// and 6 sin for each ordered pair.  On the H100 the self path spends
// ~290 lane-cycles an ordered pair, the parent ~650 (PERF.md): the calls
// that stay set its time.
//
// The bf16 option (the reference's dtype=bfloat16, sphiou.py _iou_tile):
// inputs and outputs stay float32, the boxes are rounded to bf16, and every
// intermediate of _iou_tile/_intersection is rounded to bf16 after its
// operation, as a chain of bf16 elementwise ops rounds each result.  The
// arithmetic itself runs in float32 (the card has no bf16 transcendentals),
// so the option is no faster (its roundings cost ~1.3x): it exists to give
// the reference's keep decisions, and its flips against float32 are gated.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;     // a block's tile: 32 x 32 pairs
constexpr int kPass = 8;      // block rows
constexpr long kWideGrid = 1024;  // 32x32 tiles a launch, for 4 rows a thread
constexpr int kConsts = 6;    // theta, cos phi, sin phi, h/2, v/2, area

// round to bf16 and back: one bf16 elementwise result
__device__ __forceinline__ float r16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Box {
  float t, cp, sp, h, v, area;
};

// A box's constants, as the reference's expressions give them.
template <bool kBf16>
__device__ __forceinline__ Box box_consts(float t, float p, float w,
                                          float hgt) {
  Box c;
  if constexpr (kBf16) {
    c.t = r16(t);
    sincosf(r16(p), &c.sp, &c.cp);
    c.sp = r16(c.sp);
    c.cp = r16(c.cp);
    c.h = r16(r16(w) * 0.5f);
    c.v = r16(r16(hgt) * 0.5f);
    c.area = r16(r16(4.0f * c.h) * r16(sinf(c.v)));
  } else {
    c.t = t;
    sincosf(p, &c.sp, &c.cp);
    c.h = w * 0.5f;
    c.v = hgt * 0.5f;
    c.area = 4.0f * c.h * sinf(c.v);  // 2 * dtheta * sin(dphi / 2)
  }
  return c;
}

// One direction's intersection: B's centre at (atan2(y, x), asin(z)) in
// A's tangent frame, A's half-FoVs (ha, va), B's (hb, vb).
template <bool kBf16>
__device__ __forceinline__ float overlap(float y, float x, float z, float ha,
                                         float va, float hb, float vb) {
  if constexpr (kBf16) {
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
  } else {
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
}

// SphIoU of boxes a and b: the symmetrised intersection (repro/core/
// sphere.py sph_iou) from one sincos of dt = tb - ta.
template <bool kBf16>
__device__ __forceinline__ float pair_iou(const Box& a, const Box& b) {
  float sdt, cdt;
  if constexpr (kBf16) {
    sincosf(r16(b.t - a.t), &sdt, &cdt);
    sdt = r16(sdt);
    cdt = r16(cdt);
    const float x = r16(r16(r16(a.cp * b.cp) * cdt) + r16(a.sp * b.sp));
    const float ab = overlap<true>(
        r16(b.cp * sdt), x,
        r16(r16(r16(-a.sp * b.cp) * cdt) + r16(a.cp * b.sp)), a.h, a.v, b.h,
        b.v);
    const float ba = overlap<true>(
        r16(a.cp * -sdt), x,
        r16(r16(r16(-b.sp * a.cp) * cdt) + r16(b.cp * a.sp)), b.h, b.v, a.h,
        a.v);
    const float inter = r16(0.5f * r16(ab + ba));
    const float uni = r16(r16(a.area + b.area) - inter);
    return r16(inter / fmaxf(uni, r16(1e-12f)));
  } else {
    sincosf(b.t - a.t, &sdt, &cdt);
    const float x = a.cp * b.cp * cdt + a.sp * b.sp;
    const float ab = overlap<false>(b.cp * sdt, x,
                                    -a.sp * b.cp * cdt + a.cp * b.sp, a.h,
                                    a.v, b.h, b.v);
    const float ba = overlap<false>(a.cp * -sdt, x,
                                    -b.sp * a.cp * cdt + b.cp * a.sp, b.h,
                                    b.v, a.h, a.v);
    const float inter = 0.5f * (ab + ba);
    return inter / fmaxf(a.area + b.area - inter, 1e-12f);
  }
}

// Stage the constants of boxes[base + k] into s[.][k]; boxes past n are
// zero-FoV padding.
template <bool kBf16>
__device__ __forceinline__ void stage(float (*s)[kTile],
                                      const float* __restrict__ boxes,
                                      int base, int n, int k) {
  float q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (base + k < n)
    for (int d = 0; d < 4; ++d) q[d] = boxes[(base + k) * 4 + d];
  const Box c = box_consts<kBf16>(q[0], q[1], q[2], q[3]);
  s[0][k] = c.t;
  s[1][k] = c.cp;
  s[2][k] = c.sp;
  s[3][k] = c.h;
  s[4][k] = c.v;
  s[5][k] = c.area;
}

__device__ __forceinline__ Box load(const float (*s)[kTile], int k) {
  return Box{s[0][k], s[1][k], s[2][k], s[3][k], s[4][k], s[5][k]};
}

// General path: a (B, N, 4) x b (B, M, 4).  A block takes a slab of
// kPass * R rows and 32 columns, R rows a thread.  Grid (M tiles, N slabs,
// B).
template <bool kBf16, int R>
__global__ void __launch_bounds__(kTile* kPass)
    sphiou_cross_kernel(const float* __restrict__ a,
                        const float* __restrict__ b, float* __restrict__ out,
                        int N, int M) {
  constexpr int kH = kPass * R;
  __shared__ float sa[kConsts][kTile];
  __shared__ float sb[kConsts][kTile];
  const int row = blockIdx.z;
  const int i0 = blockIdx.y * kH, j0 = blockIdx.x * kTile;
  const int c = threadIdx.x;
  if (threadIdx.y == 0 && c < kH)
    stage<kBf16>(sa, a + static_cast<size_t>(row) * N * 4, i0, N, c);
  else if (threadIdx.y == 1)
    stage<kBf16>(sb, b + static_cast<size_t>(row) * M * 4, j0, M, c);
  __syncthreads();
  const int j = j0 + c;
  if (j >= M) return;
  const Box bj = load(sb, c);
  float* const o = out + static_cast<size_t>(row) * N * M + j;
  for (int r = threadIdx.y; r < kH && i0 + r < N; r += kPass)
    o[static_cast<size_t>(i0 + r) * M] = pair_iou<kBf16>(load(sa, r), bj);
}

// Self path: boxes (B, N, 4) against themselves.  The upper 32x32 tiles
// (ti <= tj) are numbered k = tj (tj + 1) / 2 + ti; a block takes slab s
// of tile k, kPass * R rows, R a thread: grid (tiles * 32 / (kPass * R),
// 1, B).  It writes the slab (rows i, columns j) and its transpose, both
// 32-byte runs or longer; on a diagonal tile, (i, j) with j >= i and
// their mirror (j, i) with j > i, which cover the tile once.
template <bool kBf16, int R>
__global__ void __launch_bounds__(kTile* kPass)
    sphiou_self_kernel(const float* __restrict__ boxes,
                       float* __restrict__ out, int N) {
  constexpr int kH = kPass * R;
  constexpr int kSlabs = kTile / kH;
  __shared__ float si[kConsts][kTile];
  __shared__ float sj[kConsts][kTile];
  __shared__ float tile[kTile][kH + 1];  // [column][row of the slab]
  const int k = blockIdx.x / kSlabs;
  int tj = static_cast<int>((sqrtf(8.0f * k + 1.0f) - 1.0f) * 0.5f);
  while (tj * (tj + 1) / 2 > k) --tj;
  while ((tj + 1) * (tj + 2) / 2 <= k) ++tj;
  const int ti = k - tj * (tj + 1) / 2;
  const bool diag = ti == tj;
  const int r0 = (blockIdx.x % kSlabs) * kH;  // the slab's first tile row
  const int i0 = ti * kTile + r0, j0 = tj * kTile;
  const int row = blockIdx.z;
  const float* const bx = boxes + static_cast<size_t>(row) * N * 4;
  const int c = threadIdx.x;
  if (threadIdx.y == 0 && c < kH)
    stage<kBf16>(si, bx, i0, N, c);
  else if (threadIdx.y == 1)
    stage<kBf16>(sj, bx, j0, N, c);
  __syncthreads();
  const Box bj = load(sj, c);
  float* const o = out + static_cast<size_t>(row) * N * N;
  for (int r = threadIdx.y; r < kH; r += kPass) {
    if (i0 + r >= N || (diag && c < r0 + r)) continue;
    const float v = pair_iou<kBf16>(load(si, r), bj);
    tile[c][r] = v;
    if (j0 + c < N) o[static_cast<size_t>(i0 + r) * N + j0 + c] = v;
  }
  __syncthreads();
  for (int e = threadIdx.y * kTile + c; e < kTile * kH;
       e += kTile * kPass) {
    const int cc = e / kH, r = e % kH;
    if (j0 + cc < N && i0 + r < N && (!diag || cc > r0 + r))
      o[static_cast<size_t>(j0 + cc) * N + i0 + r] = tile[cc][r];
  }
}

// The premises of step 2, for every finite x >= 0 with bit pattern in
// [lo, hi): sinf(-x) == -sinf(x), cosf(-x) == cosf(x), and sincosf gives
// sinf's and cosf's bits, at x and -x.  `zero` is 0 at run time; it keeps
// the compiler from sharing one evaluation between the calls compared.
__global__ void trig_check_kernel(unsigned lo, unsigned hi, unsigned zero,
                                  unsigned long long* __restrict__ bad) {
  unsigned long long n = 0;
  for (unsigned u = lo + blockIdx.x * blockDim.x + threadIdx.x; u < hi;
       u += gridDim.x * blockDim.x) {
    float s, c, sn, cn;
    sincosf(__uint_as_float(u), &s, &c);
    sincosf(__uint_as_float(u ^ 0x80000000u), &sn, &cn);
    const float x = __uint_as_float(u ^ zero);
    const float xn = __uint_as_float(u ^ 0x80000000u ^ zero);
    const unsigned bs = __float_as_uint(s), bc = __float_as_uint(c);
    n += __float_as_uint(sinf(x)) != bs || __float_as_uint(cosf(x)) != bc ||
         __float_as_uint(sn) != (bs ^ 0x80000000u) ||
         __float_as_uint(cn) != bc ||
         __float_as_uint(sinf(xn)) != (bs ^ 0x80000000u) ||
         __float_as_uint(cosf(xn)) != bc;
  }
  for (int d = 16; d > 0; d >>= 1) n += __shfl_down_sync(0xffffffffu, n, d);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(bad, n);
}

template <bool kBf16, int R>
int launch(const void* a, const void* b, void* out, int B, int N, int M,
           void* stream) {
  constexpr int kH = kPass * R;
  const dim3 block(kTile, kPass);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto pa = static_cast<const float*>(a);
  const auto po = static_cast<float*>(out);
  if (a == b && N == M) {
    const int nt = (N + kTile - 1) / kTile;
    sphiou_self_kernel<kBf16, R>
        <<<dim3(nt * (nt + 1) / 2 * (kTile / kH), 1, B), block, 0, st>>>(
            pa, po, N);
  } else {
    const dim3 grid((M + kTile - 1) / kTile, (N + kH - 1) / kH, B);
    sphiou_cross_kernel<kBf16, R><<<grid, block, 0, st>>>(
        pa, static_cast<const float*>(b), po, N, M);
  }
  return static_cast<int>(cudaGetLastError());
}

// 4 rows a thread where the grid of 4-row blocks fills the card at least
// once (each block stages its boxes for 4x the pairs), else 1 (4x the
// blocks, each a quarter of the serial work): the tick's short rows.
template <bool kBf16>
int launch(const void* a, const void* b, void* out, int B, int N, int M,
           void* stream) {
  const long nt = (N + kTile - 1) / kTile, mt = (M + kTile - 1) / kTile;
  const long tiles = (a == b && N == M ? nt * (nt + 1) / 2 : nt * mt) * B;
  return tiles >= kWideGrid
             ? launch<kBf16, 4>(a, b, out, B, N, M, stream)
             : launch<kBf16, 1>(a, b, out, B, N, M, stream);
}

}  // namespace

extern "C" {

// a (B, N, 4), b (B, M, 4) float32 -> out (B, N, M) float32.  a == b (the
// same pointer, N == M) takes the self path.
int sphiou_batch_f32(const void* a, const void* b, void* out, int B, int N,
                     int M, void* stream) {
  return launch<false>(a, b, out, B, N, M, stream);
}

// The same with bf16 compute (float32 in and out).
int sphiou_batch_bf16(const void* a, const void* b, void* out, int B, int N,
                      int M, void* stream) {
  return launch<true>(a, b, out, B, N, M, stream);
}

// Adds to *bad the count of finite x >= 0 with bit pattern in [lo, hi)
// where trig_check_kernel's premises fail.
int sphiou_trig_check(unsigned lo, unsigned hi, void* bad, void* stream) {
  trig_check_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      lo, hi, 0u, static_cast<unsigned long long*>(bad));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
