// Flash attention forward for Hopper (sm_90a) on the tensor cores: bf16
// q, k, v at a head size of 64 or 128, TMA loads, wgmma, and a
// warp-specialised producer that keeps a ring of K/V tiles in flight.
//
// Replaces the Pallas kernel repro/kernels/attention/attention.py
// mha_pallas (body _kernel), as repro/kernels/attention/ops.py
// flash_attention calls it, for bf16 inputs: q (B, Sq, Hq, D) against
// k, v (B, Skv, Hkv, D); scores in float32; masked logits at -1e30 for the
// causal, sliding-window, q_offset and kv_len (= Skv) masks; an online
// softmax with float32 running max, denominator and accumulator; the
// output acc / max(l, 1e-30) rounded once to bf16 into a contiguous
// (B, Sq, Hq, D) tensor; query head h reads KV head h / (Hq / Hkv).  The
// float32 path and the head sizes 16 and 32 stay on attention.cu.
//
// What bounds it on the H100: operations.  A causal prefill needs 4 * D
// FLOPs a (query, key) pair and reads each input once, hundreds of
// operations a byte at S = 2048; the card's rate for this work is the bf16
// tensor cores' 989 TFLOP/s.  This design does 6 * D a pair (below), and
// between its products the softmax runs on the CUDA cores: one exp2 a
// score, at 16 a clock on each SM, is the second limit.
//
// The value product keeps the reference's float32 numbers.  The reference
// multiplies float32 probabilities by V in float32.  Rounding P once to
// bf16 for the tensor cores misses the plain version by ~1e-3 past one
// bf16 ulp on rows that nearly cancel (ref.py's emulation shows it on the
// CPU); the check holds that excess to 2e-5.  So P is split into P_hi, p
// truncated to bf16, and P_lo = bf16(p - P_hi), and O += P_hi V + P_lo V,
// both on the tensor cores with float32 sums (p kept to ~2^-16 relative):
// 1.5x the tensor-core work of a single rounding.  l sums the unrounded p.
//
// Design: one CTA of three warpgroups per (batch * query head, 128-row
// query tile); the tiles run heaviest first (the latest rows, which have
// the longest causal band), as in attention.cu.
//  * Warpgroup 0, the producer, gives up registers (setmaxnreg.dec).  One
//    of its threads loads the q tile once and keeps 128-key K and V tiles
//    in flight in a ring of kStages stages, each with a full and an empty
//    mbarrier.  TMA maps each tensor as a 4-D box over (D, H, S, B) with
//    its element strides, so packed or strided views load without a copy;
//    rows past the tensor are zero-filled, and the 128-byte swizzle lays
//    each 64-column slab out as wgmma reads it.
//  * Warpgroups 1 and 2, the consumers, take the registers
//    (setmaxnreg.inc) and own 64 query rows each.  For each K/V tile:
//    S = Q K^T by wgmma m64n128k16, both operands in shared memory and
//    K-major (K's rows are keys with D contiguous); the mask, only on a
//    tile that straddles the diagonal, the window's edge or kv_len (TMA's
//    zero-filled keys score 0, so kpos < kv_len is masked explicitly);
//    the online softmax in registers, in the accumulator's layout, the row
//    max across the four threads of a row by shuffles, scale * log2(e)
//    folded into the exponent's FMA; then O += P_hi V + P_lo V by wgmma
//    m64n64k16 with P in register fragments and V in shared memory (V is
//    MN-major as operand B: the transpose bit).  A row with every key so
//    far masked keeps m = -1e30 and takes its exponents against 0, so its
//    masked p are 0 (the reference zeroes them by the mask).
//  * The consumers follow FA3's schedule: iteration i issues S_i and then
//    the value product of tile i - 1, and runs the softmax of S_i while
//    that product is on the tensor cores; named barriers take the two
//    consumers through their issues in turn (ping-pong), so one's softmax
//    runs under the other's products.  A consumer releases a stage once
//    both value products have read it, so it holds two stages at a time.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 128;       // query rows a CTA (two warpgroups of 64)
constexpr int kBK = 128;       // keys a K/V tile
constexpr int kThreads = 384;  // the producer and two consumer warpgroups
constexpr int kSlab = 64;      // columns of one 128-byte swizzled slab
constexpr int kConsumerWarps = 8;  // the arrivals that free a stage
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static_assert(D == 64 || D == 128, "head size");
  // a consumer holds two stages (the tile whose scores it takes and the
  // one whose value product runs); the rest load ahead.  3 at D=128 fill
  // 225 KB of shared memory.
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr int kSlabs = D / kSlab;
  static constexpr uint32_t kQBytes = kBQ * D * 2;
  static constexpr uint32_t kTileBytes = kBK * D * 2;  // one K or V tile
  static constexpr uint32_t kBarBytes = 8 * (1 + 2 * kStages);
  // 1 KB of slack to align the tiles to the swizzle's 1 KB repeat
  static constexpr uint32_t kSmem =
      1024 + kQBytes + 2 * kStages * kTileBytes + kBarBytes;
};

struct Params {
  __nv_bfloat16* o;
  int Sq, Skv, Hq, Hkv;
  float scale_log2;              // scale * log2(e): the softmax runs in base 2
  int causal, window, q_offset;  // window <= 0: none
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ----------------------------------------------------------------

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int h, int s,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(s),
      "r"(b)
      : "memory");
}

// ---- wgmma --------------------------------------------------------------

// The shared-memory matrix descriptor of a tile laid out by TMA's 128-byte
// swizzle: rows of 128 bytes, eight rows (1 KB) to a swizzle atom.  Start
// address >> 4 in bits 0-13; leading byte offset 1 in bits 16-29 (unused:
// every operand here is one slab wide in its contiguous dimension); stride
// byte offset, 1 KB between 8-row groups, >> 4 in bits 32-45; layout 1
// (128-byte swizzle) in bits 62-63.  For K-major Q and K the 8-row groups
// run along M or N; for MN-major V they run along K (the keys).  A k-step
// of 16 columns within a slab moves the start address by 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// until at most N committed groups of this warpgroup's products are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes to this point
// of the program, so the compiler neither moves their uses across the wait
// nor reuses them while a product is in flight.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 128, f32) (+)= A (64 x 16, bf16, K-major, shared) *
// B (16 x 128, bf16, K-major, shared)
__device__ __forceinline__ void wgmma_m64n128k16_ss(float* d, uint64_t a,
                                                    uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16, registers) *
// B (16 x 64, bf16, MN-major in shared memory: the transpose bit)
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float* d,
                                                      const uint32_t* a,
                                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// 2^x on the special-function unit (relative error ~2^-22; 2^-1e30 is 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// ---- the consumers' steps ----------------------------------------------

// named barriers 1 and 2: consumer 0's and consumer 1's turn to issue
constexpr int kBarTurn0 = 1;

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

// s (64 x 128 scores of one consumer) = Q K^T, issued, not committed
template <int D>
__device__ __forceinline__ void qk_product(float (&s)[64], uint32_t qa,
                                           uint32_t ks) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t qoff = (kk / 4) * (kBQ * 128) + (kk % 4) * 32;
    const uint32_t koff = (kk / 4) * (kBK * 128) + (kk % 4) * 32;
    wgmma_m64n128k16_ss(s, sw128_desc(qa + qoff), sw128_desc(ks + koff),
                        kk > 0);
  }
}

// o += P_hi V + P_lo V, issued, not committed
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2],
                                           const uint32_t (&p_hi)[32],
                                           const uint32_t (&p_lo)[32],
                                           uint32_t vs) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int sl = 0; sl < D / kSlab; ++sl)
      wgmma_m64n64k16_rs_tb(
          o + 32 * sl, p_hi + 4 * kk,
          sw128_desc(vs + sl * (kBK * 128) + kk * (16 * 128)));
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int sl = 0; sl < D / kSlab; ++sl)
      wgmma_m64n64k16_rs_tb(
          o + 32 * sl, p_lo + 4 * kk,
          sw128_desc(vs + sl * (kBK * 128) + kk * (16 * 128)));
}

// P (float32, the accumulator layout) split into bf16 hi and lo register
// fragments of the value product's A operand.  P_hi is p truncated to
// bf16 (its high half: a byte permute, where rounding would take one more
// conversion), so p - P_hi is exact in float32 and under 2^-7 p; P_lo is
// that rounded to bf16, within 2^-16 p of it.
__device__ __forceinline__ void split_p(const float (&s)[64],
                                        uint32_t (&p_hi)[32],
                                        uint32_t (&p_lo)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float a = s[2 * i], c = s[2 * i + 1];
    const uint32_t ab = __float_as_uint(a), cb = __float_as_uint(c);
    const float ha = __uint_as_float(ab & 0xFFFF0000u);
    const float hc = __uint_as_float(cb & 0xFFFF0000u);
    p_hi[i] = __byte_perm(ab, cb, 0x7632);  // the high halves: c, a
    p_lo[i] = bf16x2_bits(__floats2bfloat162_rn(a - ha, c - hc));
  }
}

// The online softmax of one consumer thread's two rows (r0 and r0 + 8).
struct Softmax {
  int qpos0, col, wg_lo;  // row r0's position, the thread's column, and
                          // the consumer's first row position
  float m0 = kNegInf, m1 = kNegInf;  // running max of the raw scores
  float l0 = 0.0f, l1 = 0.0f;        // this thread's columns' sums
  float alpha0 = 1.0f, alpha1 = 1.0f;  // the last tile's rescale of o

  // scores s of the tile at key j0 -> probabilities in place; m, l and
  // alpha updated
  __device__ __forceinline__ void online(float (&s)[64], int j0,
                                         const Params& p) {
    const int qpos1 = qpos0 + 8;
    const int wg_hi = wg_lo + 63;
    const bool need_mask = j0 + kBK > p.Skv ||
                           (p.causal && j0 + kBK - 1 > wg_lo) ||
                           (p.window > 0 && j0 <= wg_hi - p.window);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * k + e];  // raw: the scale folds into the exponent
        if (need_mask) {
          const int kpos = j0 + 8 * k + col + (e & 1);
          const int qpos = e < 2 ? qpos0 : qpos1;
          bool ok = kpos < p.Skv;
          if (p.causal) ok = ok && kpos <= qpos;
          if (p.window > 0) ok = ok && kpos > qpos - p.window;
          if (!ok) x = kNegInf;
        }
        s[4 * k + e] = x;
        if (e < 2)
          mx0 = fmaxf(mx0, x);
        else
          mx1 = fmaxf(mx1, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float sl = p.scale_log2;
    alpha0 = fast_exp2((m0 - mx0) * sl);
    alpha1 = fast_exp2((m1 - mx1) * sl);
    m0 = mx0;
    m1 = mx1;
    // a row with every key so far masked takes its exponents against 0,
    // so that its masked logits (-1e30) give p = 0
    const float nb0 = m0 == kNegInf ? 0.0f : -m0 * sl;
    const float nb1 = m1 == kNegInf ? 0.0f : -m1 * sl;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = fast_exp2(fmaf(s[4 * k + e], sl, e < 2 ? nb0 : nb1));
        s[4 * k + e] = pe;
        if (e < 2)
          sum0 += pe;
        else
          sum1 += pe;
      }
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
  }

  template <int D>
  __device__ __forceinline__ void rescale(float (&o)[D / 2]) const {
#pragma unroll
    for (int k = 0; k < D / 8; ++k) {
      o[4 * k + 0] *= alpha0;
      o[4 * k + 1] *= alpha0;
      o[4 * k + 2] *= alpha1;
      o[4 * k + 3] *= alpha1;
    }
  }
};

// ---- the kernel ---------------------------------------------------------

// The accumulator layout of wgmma m64nN (f32), for thread t of a
// warpgroup, warp w = t / 32, lane l: element 4k + e (n8 block k) holds row
// 16w + l/4 (e = 0, 1) or 16w + l/4 + 8 (e = 2, 3), column
// 8k + 2 (l % 4) + (e & 1).  The register A fragment of m64k16 bf16 has the
// same layout over 16 columns, two values to a register: so the
// probabilities of n8 blocks 2kk and 2kk + 1 of S, paired in order, are the
// A fragment of the value product's k-step kk.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const Params p) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + C::kQBytes;
  const uint32_t v_s = k_s + C::kStages * C::kTileBytes;
  const uint32_t bar_q = v_s + C::kStages * C::kTileBytes;
  const uint32_t bar_full = bar_q + 8;                   // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * C::kStages;  // + 8 * stage

  const int bh = blockIdx.x;
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int n_qt = (p.Sq + kBQ - 1) / kBQ;
  const int i0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * kBQ;

  // the K/V tiles that can hold an unmasked key for these rows
  const int kv_len = p.Skv;
  const int q_lo = p.q_offset + i0;
  const int q_hi = p.q_offset + min(i0 + kBQ, p.Sq) - 1;
  int kt_end = (kv_len + kBK - 1) / kBK;
  if (p.causal) kt_end = q_hi < 0 ? 0 : min(q_hi, kv_len - 1) / kBK + 1;
  const int kt_begin = p.window > 0 ? max(0, q_lo - (p.window - 1)) / kBK : 0;
  const int n_tiles = max(0, kt_end - kt_begin);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ================= the producer warpgroup =================
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, C::kQBytes);
#pragma unroll
      for (int sl = 0; sl < C::kSlabs; ++sl)
        tma_load(q_s + sl * (kBQ * 128), &tm_q, bar_q, sl * kSlab, h, i0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int stage = t % C::kStages, round = t / C::kStages;
        if (round > 0) mbar_wait(bar_empty + 8 * stage, (round - 1) & 1);
        const uint32_t full = bar_full + 8 * stage;
        mbar_expect_tx(full, 2 * C::kTileBytes);
        const int j0 = (kt_begin + t) * kBK;
        const uint32_t ks = k_s + stage * C::kTileBytes;
        const uint32_t vs = v_s + stage * C::kTileBytes;
#pragma unroll
        for (int sl = 0; sl < C::kSlabs; ++sl) {
          tma_load(ks + sl * (kBK * 128), &tm_k, full, sl * kSlab, hk, j0, b);
          tma_load(vs + sl * (kBK * 128), &tm_v, full, sl * kSlab, hk, j0, b);
        }
      }
    }
    return;
  }

  // ================= the consumer warpgroups =================
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128 - 1;  // 0 or 1: rows 64 wg .. 64 wg + 63
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = 64 * wg + 16 * (t / 32) + lane / 4;  // and r0 + 8
  const int col = 2 * (lane % 4);
  Softmax sm;
  sm.qpos0 = p.q_offset + i0 + r0;
  sm.col = col;
  sm.wg_lo = p.q_offset + i0 + 64 * wg;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float s[64];
  uint32_t p_hi[32], p_lo[32];
  const uint32_t qa = q_s + wg * (64 * 128);
  auto k_tile = [&](int it) {
    return k_s + (it % C::kStages) * C::kTileBytes;
  };
  auto v_tile = [&](int it) {
    return v_s + (it % C::kStages) * C::kTileBytes;
  };
  auto wait_full = [&](int it) {
    mbar_wait(bar_full + 8 * (it % C::kStages), (it / C::kStages) & 1);
  };
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * (it % C::kStages));
  };

  // The FA3 schedule.  Iteration it issues S_it = Q K_it and then the value
  // product of tile it - 1, whose P waits in registers; the softmax of S_it
  // runs while that product is on the tensor cores.  Named barriers take
  // the two consumers through their issues in turn (ping-pong), so one's
  // softmax runs under the other's products.
  mbar_wait(bar_q, 0);
  if (n_tiles > 0) {
    if (wg == 1) named_arrive(kBarTurn0);  // consumer 0 issues first
    wait_full(0);
    named_sync(kBarTurn0 + wg);
    wgmma_fence();
    qk_product<D>(s, qa, k_tile(0));
    wgmma_commit();
    named_arrive(kBarTurn0 + 1 - wg);
    wgmma_wait<0>();
    pin(s);
    sm.online(s, kt_begin * kBK, p);
    split_p(s, p_hi, p_lo);
    for (int it = 1; it < n_tiles; ++it) {
      wait_full(it);
      named_sync(kBarTurn0 + wg);
      wgmma_fence();
      qk_product<D>(s, qa, k_tile(it));
      wgmma_commit();
      sm.rescale<D>(o);
      pin(o);
      wgmma_fence();
      pv_product<D>(o, p_hi, p_lo, v_tile(it - 1));
      wgmma_commit();
      named_arrive(kBarTurn0 + 1 - wg);
      wgmma_wait<1>();  // S_it; the value product of it - 1 may still run
      pin(s);
      sm.online(s, (kt_begin + it) * kBK, p);
      wgmma_wait<0>();
      pin(o);
      pin(p_hi);
      pin(p_lo);
      release(it - 1);
      split_p(s, p_hi, p_lo);
    }
    named_sync(kBarTurn0 + wg);
    sm.rescale<D>(o);
    pin(o);
    wgmma_fence();
    pv_product<D>(o, p_hi, p_lo, v_tile(n_tiles - 1));
    wgmma_commit();
    // consumer 1 owes no turn: consumer 0 has issued its last product
    if (wg == 0) named_arrive(kBarTurn0 + 1);
    wgmma_wait<0>();
    pin(o);
    pin(p_hi);
    pin(p_lo);
    release(n_tiles - 1);
  }
  float l0 = sm.l0, l1 = sm.l1;

  // out = acc / max(l, 1e-30), (B, Sq, Hq, D) contiguous
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = i0 + r0 + 8 * half;
    if (row >= p.Sq) continue;
    const float inv = half ? inv1 : inv0;
    __nv_bfloat16* orow =
        p.o + ((static_cast<long long>(b) * p.Sq + row) * p.Hq + h) * D;
#pragma unroll
    for (int sl = 0; sl < C::kSlabs; ++sl)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = 32 * sl + 4 * k + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(orow + sl * kSlab + 8 * k + col) =
            __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
      }
  }
}

// ---- host side ----------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, reached through the runtime, so
// the library needs no -lcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// (B, S, H, D) bf16 with element strides (sb, ss, sh, 1) as a 4-D map over
// (D, H, S, B), in boxes of one 64-column slab by `rows` rows of one head.
// An axis of extent 1 is never stepped, so its stride only has to be valid.
bool make_map(CUtensorMap* map, const void* ptr, int D, int H, int S, int B,
              long long sh, long long ss, long long sb, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const long long unit = D;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
      static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(2 * (H > 1 ? sh : unit)),
      static_cast<cuuint64_t>(2 * (S > 1 ? ss : unit)),
      static_cast<cuuint64_t>(2 * (B > 1 ? sb : unit))};
  const cuuint32_t box[4] = {kSlab, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const Params& p, int B,
                   cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * p.Hq, (p.Sq + kBQ - 1) / kBQ);
  flash_wgmma_kernel<D><<<grid, kThreads, C::kSmem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), with the element
// strides of their batch, sequence and head axes (the D axis is dense; the
// base 16-byte aligned and every stepped stride a multiple of 8 elements,
// as TMA needs) -> o (B, Sq, Hq, D) contiguous bf16.  D is 64 or 128; Skv
// at least 1; window < 0: none.  Returns a cudaError_t, or -1 if a tensor
// map could not be encoded.
int flash_attention_wgmma_fwd(const void* q, const void* k, const void* v,
                              void* o, int D, int B, int Sq, int Skv, int Hq,
                              int Hkv, long long q_sb, long long q_ss,
                              long long q_sh, long long k_sb, long long k_ss,
                              long long k_sh, long long v_sb, long long v_ss,
                              long long v_sh, float scale, int causal,
                              int window, int q_offset, void* stream) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, Hq, Sq, B, q_sh, q_ss, q_sb, kBQ) ||
      !make_map(&tk, k, D, Hkv, Skv, B, k_sh, k_ss, k_sb, kBK) ||
      !make_map(&tv, v, D, Hkv, Skv, B, v_sh, v_ss, v_sb, kBK))
    return -1;
  const Params p{static_cast<__nv_bfloat16*>(o), Sq, Skv, Hq, Hkv,
                 scale * kLog2e, causal, window, q_offset};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = D == 64 ? launch<64>(tq, tk, tv, p, B, s)
                                  : launch<128>(tq, tk, tv, p, B, s);
  return static_cast<int>(err);
}

}  // extern "C"
