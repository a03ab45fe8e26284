// Flash attention forward for Hopper (sm_90a) on the CUDA cores.
//
// Replaces the Pallas kernel repro/kernels/attention/attention.py
// mha_pallas (body _kernel), as repro/kernels/attention/ops.py
// flash_attention calls it: q (B, Sq, Hq, D) against k, v (B, Skv, Hkv, D)
// in float32 (D 16/32/64/128) or bfloat16 (D 16/32; 64 and 128 go to
// attention_wgmma.cu), scores and the value product in float32, an online
// softmax (running max, denominator and accumulator in float32), causal
// and sliding-window masks, q_offset for decode and chunked prefill,
// masked logits at -1e30 (NEG_INF in the reference), a fully masked row
// giving 0 (the denominator is max(l, 1e-30)), and the output in q's dtype.
// The kernel reads the (B, S, H, D) tensors through their strides, maps
// query head h to KV head h / (Hq / Hkv), and masks the ragged tails; the
// TPU's sequential kv grid axis becomes a loop inside the CTA.
//
// What bounds it on the H100: operations.  A causal prefill needs 4 * D
// FLOPs a (query, key) pair and reads each input once, hundreds of
// operations a byte.  The float32 reference's tolerance (atol 2e-5, rtol
// 1e-4) rules out TF32, so the work runs as float32 FMAs on the CUDA cores,
// 67 TFLOP/s at most; the design aims every issue slot it can at an FMA.
//
// Design, one item per loss of a plain tiled kernel:
//  * Balance.  A CTA takes 64 query rows of one (batch, head) and walks
//    their band of 64-key K/V tiles; the grid runs the latest row tiles,
//    whose causal band is longest, first.  When the longest band is long
//    against an SM's mean load (a few heads at S = 2048), a thread-block
//    cluster of `split` CTAs (2, 4 or 8; the host picks it from the shape
//    and the SM count, so it is the same on every launch) shares each row
//    tile: CTA r takes tiles r, r + split, ... of the band and ends with a
//    partial (m, l, acc).  The partials meet in distributed shared memory;
//    CTA r combines rows [r * 64 / split, ...) from all of them in rank
//    order, each rescaled by exp2(m_r - m).  Nothing depends on timing, so
//    two launches give the same bits.
//  * Staging.  q, one K and one V tile in shared memory, filled with
//    16-byte cp.async (rows past the sequence zero-filled): V of tile t
//    loads while the scores of t are computed, K of tile t + 1 while the
//    values of t are summed; two __syncthreads a tile.  Single buffers keep
//    a CTA at 72 KB (float32, D = 64), so three CTAs, 12 warps, share an
//    SM.  Each row is padded by 16 bytes to an odd number of 16-byte
//    chunks, so eight rows at one chunk position fall in eight bank
//    groups.  bf16 is widened to float32 as it is read from shared memory.
//    The wrapper copies a view whose rows do not start on 16 bytes.
//  * Shared-memory traffic per FMA.  A warp owns 16 rows x 64 keys of the
//    scores: lane (rg, cg) holds rows rg + 4 i and keys cg + 8 i, a 4 x 8
//    tile, and for the value product the same 4 rows x D / 8 columns.  A
//    quarter-warp holds 4 row groups x 2 key groups: on the H100 a 16-byte
//    shared-memory read whose quarter-warps each touch at most 2 chunks is
//    served faster than one whose quarter-warps touch 3 to 8, so the K and
//    V reads (8 a chunk of d, 2 a key) are the cheap ones and only the q
//    and P reads (4 and 1) pay in full.  An 8 x 8 tile would read less per
//    FMA, but its 128 accumulators do not fit the registers of 12 warps an
//    SM, and with 4 warps an SM it ran slower.
//  * P passes from the score layout to the value layout through columns
//    of shared memory that only its warp touches (P^T, padded so a
//    quarter-warp's writes fall in distinct bank groups).
//  * The softmax runs in base 2: scores scaled by scale * log2(e), one
//    ex2.approx a probability.  Masks are computed only on tiles that cross
//    the band's edge or the sequence's end; a masked score is -inf, whose
//    exp2 is 0, and the running max starts at -1e30, so no row sees NaN.
//  * The shared-memory limit is raised once per instance and device, not on
//    every launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace coop = cooperative_groups;

namespace {

constexpr int kBQ = 64;         // query rows per CTA
constexpr int kBK = 64;         // keys per K/V tile (8 lanes x 8 keys)
constexpr int kWarps = kBQ / 16;  // a warp: 16 rows x 64 keys
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSplit = 8;    // CTAs sharing a row tile (portable cluster)
constexpr int kLdP = kBQ + 16;  // row length of P^T (floats; 20 chunks)
constexpr int kMaxDevices = 64;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// one element type: how a 32-bit word widens to float32, and the store
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kPerWord = 1;
  __device__ __forceinline__ static void widen(uint32_t w, float* f) {
    f[0] = __uint_as_float(w);
  }
  __device__ __forceinline__ static void store(float* p, float x) { *p = x; }
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  __device__ __forceinline__ static void widen(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);  // the element at the lower address
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};

// NW 32-bit words of shared memory at p, widened to float32
template <typename T, int NW>
__device__ __forceinline__ void load_widen(const unsigned char* p, float* f) {
  uint32_t w[NW];
  if constexpr (NW == 4) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else if constexpr (NW == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x, w[1] = u.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) Elem<T>::widen(w[i], f + i * Elem<T>::kPerWord);
}

// the shared-memory layout of one instance
template <typename T, int D>
struct Layout {
  static constexpr int kPerChunk = 16 / sizeof(T);  // elements a 16 B chunk
  static constexpr int kChunks = D / kPerChunk;     // chunks of a row
  static constexpr int kLd = D * sizeof(T) + 16;    // a row, padded (bytes)
  static constexpr int kQTile = kBQ * kLd;          // the q tile
  static constexpr int kTile = kBK * kLd;           // one K or V tile
  static constexpr int kNC = D / 8;                 // output columns a lane
  // the value product's columns: whole chunks cg + 8 j where a lane's
  // share is at least a chunk, else kNC contiguous columns from cg * kNC
  static constexpr bool kChunked = kNC * sizeof(T) >= 16;
  // q, K, V, P^T
  static constexpr size_t kPBytes = kBK * kLdP * sizeof(float);
  static constexpr size_t kBytes = kQTile + 2 * kTile + kPBytes;
  // CTAs an SM should hold: three in float32 at D <= 64 (72 KB each at
  // D = 64, so at most 168 registers a thread), else two (bf16's widened
  // chunks need more registers; float32 at D = 128 takes 122 KB)
  static constexpr int kMinBlocks = sizeof(T) == 4 && D <= 64 ? 3 : 2;
  // unrolling of the score loop over chunks of d and of the value loop
  // over keys: deep for float32; shallow for bf16, whose widened chunks
  // would otherwise be hoisted past the register file
  static constexpr int kUnrollD = sizeof(T) == 4 ? 8 : 2;
  static constexpr int kUnrollKeys = sizeof(T) == 4 ? 16 : 8;
  static_assert(kChunks * kPerChunk == D && kChunks % 2 == 0,
                "rows pad to an odd number of chunks");
  // the partials (m, l, acc[kBQ][D + 4]) reuse K, V and P^T
  static_assert((2 * kBQ + kBQ * (D + 4)) * sizeof(float) <=
                    2 * kTile + kPBytes,
                "the partials fit");
};

template <int D, typename T>
__device__ __forceinline__ int out_col(int cg, int e) {
  using L = Layout<T, D>;
  if constexpr (L::kChunked) {
    return (cg + 8 * (e / L::kPerChunk)) * L::kPerChunk + e % L::kPerChunk;
  } else {
    return cg * L::kNC + e;
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
  int split;  // CTAs a row tile (the cluster's size)
  int n_qt;   // 64-row tiles of q
};

// the K/V tiles [begin, end) that can hold an unmasked key for the query
// tile starting at row i0
__host__ __device__ inline void kv_band(const Args& a, int i0, int& begin,
                                        int& end) {
  const int q_lo = a.q_offset + i0;
  const int q_hi = a.q_offset + min(i0 + kBQ, a.Sq) - 1;
  const int n_kt = (a.Skv + kBK - 1) / kBK;
  end = n_kt;
  if (a.causal) end = q_hi < 0 ? 0 : min(min(q_hi, a.Skv - 1) / kBK + 1, n_kt);
  begin = a.window > 0 ? max(0, q_lo - (a.window - 1)) / kBK : 0;
  if (begin > end) begin = end;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool in) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows r0 .. r0 + R - 1 (those below `rows`, zero-filled past it) of a
// (S, D) slab with row stride ss into a padded tile, by 16-byte cp.async:
// thread t copies chunk t % kChunks of rows t / kChunks + n * kStep
template <typename T, int D, int R>
__device__ __forceinline__ void stage(unsigned char* tile, const T* src,
                                      long long ss, int r0, int rows) {
  using L = Layout<T, D>;
  constexpr int kStep = kThreads / L::kChunks;
  static_assert(kThreads % L::kChunks == 0, "copy shape");
  const int tr = threadIdx.x / L::kChunks, tc = threadIdx.x % L::kChunks;
  const int left = rows - r0 - tr;  // rows in range from this thread's
  const T* g = src + (r0 + tr) * ss + tc * L::kPerChunk;
  unsigned char* sm = tile + tr * L::kLd + tc * 16;
#pragma unroll
  for (int n = 0; n < (R + kStep - 1) / kStep; ++n) {
    if (R % kStep != 0 && tr + n * kStep >= R) break;
    const bool in = n * kStep < left;
    cp_async16(sm + n * kStep * L::kLd, in ? g : src, in);
    g += kStep * ss;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, Layout<T, D>::kMinBlocks)
    flash_fwd_kernel(const Args a) {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "head size");
  using L = Layout<T, D>;
  constexpr int NC = L::kNC;
  constexpr int PC = L::kPerChunk;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* qs = smem;
  unsigned char* kbuf = smem + L::kQTile;
  unsigned char* vbuf = kbuf + L::kTile;
  float* pt = reinterpret_cast<float*>(vbuf + L::kTile);

  const int split = a.split;
  const int rank = static_cast<int>(blockIdx.x) % split;
  const int item = static_cast<int>(blockIdx.x) / split;
  const int bhs = gridDim.x / split / a.n_qt;  // B * Hq
  const int bh = item % bhs;
  const int i0 = (a.n_qt - 1 - item / bhs) * kBQ;  // heaviest first
  const int b = bh / a.Hq, h = bh % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  // lane = 8 (cg >> 1) + 2 rg + (cg & 1): a quarter-warp holds 4 row
  // groups x 2 key groups, so each shared-memory read of a quarter-warp
  // touches at most 4 chunks of q or P and 2 of K or V
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = (lane >> 1) & 3;                // rows rows0 + 4 i
  const int cg = ((lane >> 3) << 1) | (lane & 1);  // keys cg + 8 i
  const int rows0 = warp * 16 + rg;
  const int slot = warp * 16 + 4 * rg;  // the lane's 4 columns of P^T

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  int kt_begin, kt_end;
  kv_band(a, i0, kt_begin, kt_end);
  const int q_lo = a.q_offset + i0;
  const int q_hi = a.q_offset + min(i0 + kBQ, a.Sq) - 1;
  const float c2 = a.scale * kLog2e;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < NC; ++e) acc[i][e] = 0.0f;
  }

  // one K and one V buffer: V of tile kt loads while the scores of kt
  // are computed, K of the next tile while its values are summed
  int kt = kt_begin + rank;
  if (kt < kt_end) {
    stage<T, D, kBQ>(qs, qb, a.q_ss, i0, a.Sq);
    stage<T, D, kBK>(kbuf, kb, a.k_ss, kt * kBK, a.Skv);
    cp_async_commit();
  }
  for (; kt < kt_end; kt += split) {
    cp_async_wait_all();
    __syncthreads();  // K of tile kt landed; every warp is done with V
    stage<T, D, kBK>(vbuf, vb, a.v_ss, kt * kBK, a.Skv);
    cp_async_commit();
    const int j0 = kt * kBK;

    // scores: 4 rows x 8 keys a lane, a chunk of d at a time
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.0f;
#pragma unroll(L::kUnrollD)
    for (int dc = 0; dc < L::kChunks; ++dc) {
      float qr[4][PC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        load_widen<T, 4>(qs + (rows0 + 4 * i) * L::kLd + dc * 16, qr[i]);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float kc[PC];
        load_widen<T, 4>(kbuf + (cg + 8 * c) * L::kLd + dc * 16, kc);
#pragma unroll
        for (int e = 0; e < PC; ++e)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[i][c] = fmaf(qr[i][e], kc[e], s[i][c]);
      }
    }

    // mask (only a tile that crosses an edge), online softmax in base 2
    const bool full = j0 + kBK <= a.Skv &&
                      (!a.causal || j0 + kBK - 1 <= q_lo) &&
                      (a.window <= 0 || j0 > q_hi - a.window);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] *= c2;
    if (!full) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = q_lo + rows0 + 4 * i;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int kpos = j0 + cg + 8 * c;
          bool ok = kpos < a.Skv;
          if (a.causal) ok = ok && kpos <= qpos;
          if (a.window > 0) ok = ok && kpos > qpos - a.window;
          if (!ok) s[i][c] = -INFINITY;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) mx = fmaxf(mx, s[i][c]);
#pragma unroll  // over the row group's lanes: xor 1, 8, 16
      for (int off = 1; off < 32; off = off == 1 ? 8 : 2 * off)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = ex2(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        s[i][c] = ex2(s[i][c] - m_new);
        sum += s[i][c];
      }
#pragma unroll
      for (int off = 1; off < 32; off = off == 1 ? 8 : 2 * off)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < NC; ++e) acc[i][e] *= alpha;
    }

    // P^T[key][slot], the warp's own 16 columns of it
#pragma unroll
    for (int c = 0; c < 8; ++c)
      *reinterpret_cast<float4*>(pt + (cg + 8 * c) * kLdP + slot) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    cp_async_wait_all();
    __syncthreads();  // V of tile kt landed; every warp is done with K
    if (kt + split < kt_end) {
      stage<T, D, kBK>(kbuf, kb, a.k_ss, (kt + split) * kBK, a.Skv);
      cp_async_commit();
    }

    // acc += P V: 4 rows x NC columns a lane
#pragma unroll(L::kUnrollKeys)
    for (int j = 0; j < kBK; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(pt + j * kLdP + slot);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
      const unsigned char* vrow = vbuf + j * L::kLd;
      float vc[NC];
      if constexpr (L::kChunked) {
#pragma unroll
        for (int h2 = 0; h2 < NC / PC; ++h2)
          load_widen<T, 4>(vrow + (cg + 8 * h2) * 16, vc + h2 * PC);
      } else {
        load_widen<T, NC * sizeof(T) / 4>(vrow + cg * NC * sizeof(T), vc);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < NC; ++e) acc[i][e] = fmaf(pr[i], vc[e], acc[i][e]);
    }
  }

  T* og = static_cast<T*>(a.o);
  if (split == 1) {  // out = acc / max(l, 1e-30), (B, Sq, Hq, D) contiguous
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i0 + rows0 + 4 * i;
      if (row >= a.Sq) continue;
      const float inv = 1.0f / fmaxf(l[i], 1e-30f);
      T* orow = og + ((static_cast<long long>(b) * a.Sq + row) * a.Hq + h) * D;
#pragma unroll
      for (int e = 0; e < NC; ++e)
        Elem<T>::store(orow + out_col<D, T>(cg, e), acc[i][e] * inv);
    }
    return;
  }

  // the cluster's partials meet in distributed shared memory
  __syncthreads();  // every warp is done with K, V and P^T
  float* pm = reinterpret_cast<float*>(kbuf);
  float* pl = pm + kBQ;
  float* pa = pl + kBQ;  // [kBQ][D + 4]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rows0 + 4 * i;
    if (cg == 0) pm[r] = m[i], pl[r] = l[i];
#pragma unroll
    for (int e = 0; e < NC; ++e) pa[r * (D + 4) + out_col<D, T>(cg, e)] =
        acc[i][e];
  }
  coop::cluster_group cluster = coop::this_cluster();
  cluster.sync();
  // rank r writes rows [r * rows, (r + 1) * rows), 4 columns a thread, from
  // every rank's partial (all loads first, then the sums in rank order: the
  // same bits every launch)
  const int rows = (kBQ + split - 1) / split;
  for (int e = tid; e < rows * D / 4; e += kThreads) {
    const int r = rank * rows + e / (D / 4), c = e % (D / 4) * 4;
    if (r >= kBQ || i0 + r >= a.Sq) continue;
    float mr[kMaxSplit], lr[kMaxSplit];
    float4 orr[kMaxSplit];
#pragma unroll
    for (int p = 0; p < kMaxSplit; ++p) {
      if (p < split) {
        mr[p] = cluster.map_shared_rank(pm, p)[r];
        lr[p] = cluster.map_shared_rank(pl, p)[r];
        orr[p] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(pa, p) + r * (D + 4) + c);
      }
    }
    float mx = kNegInf;
#pragma unroll
    for (int p = 0; p < kMaxSplit; ++p)
      if (p < split) mx = fmaxf(mx, mr[p]);
    float lsum = 0.0f;
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int p = 0; p < kMaxSplit; ++p) {
      if (p < split) {
        const float w = ex2(mr[p] - mx);
        lsum += lr[p] * w;
        o.x += orr[p].x * w, o.y += orr[p].y * w;
        o.z += orr[p].z * w, o.w += orr[p].w * w;
      }
    }
    const float inv = 1.0f / fmaxf(lsum, 1e-30f);
    T* orow =
        og + ((static_cast<long long>(b) * a.Sq + i0 + r) * a.Hq + h) * D;
    Elem<T>::store(orow + c, o.x * inv);
    Elem<T>::store(orow + c + 1, o.y * inv);
    Elem<T>::store(orow + c + 2, o.z * inv);
    Elem<T>::store(orow + c + 3, o.w * inv);
  }
  cluster.sync();  // no CTA leaves while another reads its partial
}

int sm_count(int dev) {
  static int cached[kMaxDevices];
  if (dev >= 0 && dev < kMaxDevices && cached[dev] > 0) return cached[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      n <= 0)
    n = 1;
  if (dev >= 0 && dev < kMaxDevices) cached[dev] = n;
  return n;
}

// CTAs a row tile: split the longest band until one CTA's share is at most
// half an SM's mean load (tile steps over the grid / SMs)
int choose_split(const Args& a, int B, int n_sm) {
  long long total = 0;
  int most = 0;
  for (int t = 0; t < a.n_qt; ++t) {
    int begin, end;
    kv_band(a, t * kBQ, begin, end);
    total += end - begin;
    most = max(most, end - begin);
  }
  total *= static_cast<long long>(B) * a.Hq;
  int split = 1;
  while (split < kMaxSplit && 2 * split <= most &&
         static_cast<long long>((most + split - 1) / split) * 2 * n_sm > total)
    split *= 2;
  return split;
}

// whether every row of a (B, S, H, D) view starts on 16 bytes (an axis of
// extent 1 is never stepped)
bool rows_aligned(const void* p, int B, int S, int H, long long sb,
                  long long ss, long long sh, int size) {
  const auto ok = [size](long long stride, int extent) {
    return extent <= 1 || stride * size % 16 == 0;
  };
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ok(sb, B) && ok(ss, S) &&
         ok(sh, H);
}

template <typename T, int D>
cudaError_t launch(Args a, int B, cudaStream_t stream) {
  const size_t bytes = Layout<T, D>::kBytes;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static bool raised[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices || !raised[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < kMaxDevices) raised[dev] = true;
  }
  const int sz = sizeof(T);  // the wrapper copies a view that fails this
  if (!rows_aligned(a.q, B, a.Sq, a.Hq, a.q_sb, a.q_ss, a.q_sh, sz) ||
      !rows_aligned(a.k, B, a.Skv, a.Hkv, a.k_sb, a.k_ss, a.k_sh, sz) ||
      !rows_aligned(a.v, B, a.Skv, a.Hkv, a.v_sb, a.v_ss, a.v_sh, sz))
    return cudaErrorInvalidValue;
  a.n_qt = (a.Sq + kBQ - 1) / kBQ;
  a.split = choose_split(a, B, sm_count(dev));
  const long long grid =
      static_cast<long long>(a.split) * a.n_qt * B * a.Hq;
  if (grid > INT_MAX) return cudaErrorInvalidValue;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, flash_fwd_kernel<T, D>, a);
  if (err != cudaSuccess) return err;
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
  const Args a{q,    k,    v,    o,    Sq,   Skv,  Hq,   Hkv,    q_sb,
               q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,   scale,
               causal, window, q_offset, 1, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? dispatch_d<float>(D, a, B, s)
                 : dtype == 1 ? dispatch_d<__nv_bfloat16>(D, a, B, s)
                              : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
