// Per-row greedy spherical-NMS suppression for Hopper (sm_90a).
//
// Replaces the XLA program repro/core/sphere.py _sph_nms_batch_device: its
// lax.while_loop (sphere.py:449-468) that keeps every row's best remaining
// box (jnp.argmax: NaN above every number, the lowest index on ties) and
// suppresses that box's overlaps, until no row has a candidate.  Walking a
// row's valid entries once in that order, keeping an entry unless a box
// kept before it overlaps it, gives the same keep mask.
//
// What bounds it on the H100: the scan's chain of dependent steps, one per
// valid entry of the longest row, plus the IoU matrix read once.  Every
// other step runs in parallel over all SMs.
//
// Design, two launches and no host synchronisation:
//  1. greedy_bits_kernel, grid (tiles of 8 rows i, B rows of the batch).
//     Each warp turns one IoU row i into a word row: bit (j & 31) of word
//     (j >> 5) is iou[b, i, j] > thr, one __ballot_sync over a coalesced
//     128-byte segment a word, 16 segments in flight, the first ones while
//     the scores are staged.  Masked rows are never read.  The block also
//     stages the row's scores and mask in shared memory and ranks its 8
//     entries by counting the valid entries that come before each one
//     (float comparisons, so -0.0 and 0.0 tie as in argmax); rank r's
//     index goes to order[b, r].
//  2. greedy_scan_kernel, one block per row, launched as the first
//     kernel's programmatic dependent, so that its launch and its count of
//     the valid entries overlap the first kernel's last blocks.  The block
//     stages the order and, for N <= 1024, the word rows in rank order in
//     shared memory (cp.async, at most 132 KB; above that the rows are
//     read from L2).  One warp then walks the ranks 32 at a time.  The
//     removed set lives in its registers (word w in lane w % 32, slot
//     w / 32).  For a chunk of 32 ranks: one shuffle drops the candidates
//     that earlier chunks removed; 32 ballots give the chunk's own 32x32
//     suppression matrix (lane l' reads bit c(l') of rank l's row, so the
//     32 lanes read one row, with no bank conflict); the chunk resolves in
//     registers, a predicated AND a rank; the kept ranks' word rows are
//     ORed into the removed set.  The other warps wait, then write the
//     keep mask.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = kWarps;  // rows i a block of the bits kernel takes
constexpr int kWordsInFlight = 16;  // of a word row, in the bits kernel
constexpr int kStagedMaxN = 1024;  // word rows staged in shared memory
constexpr int kMaxWords = 256;     // words a row, at the wrapper's MAX_N 8192
constexpr unsigned kFull = 0xffffffffu;

// Does entry (sj, j) come before (si, i) in argmax's order: NaN first (the
// lower index first among NaNs), then the higher score, then the lower
// index on equal scores.
__device__ __forceinline__ bool before(float sj, int j, float si, int i) {
  const bool nj = isnan(sj), ni = isnan(si);
  if (nj || ni) return nj && (!ni || j < i);
  return sj > si || (sj == si && j < i);
}

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

__global__ void greedy_bits_kernel(const float* __restrict__ iou,
                                   const float* __restrict__ scores,
                                   const uint8_t* __restrict__ mask,
                                   uint32_t* __restrict__ bits,
                                   int32_t* __restrict__ order, int N,
                                   int Wp, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_score = reinterpret_cast<float*>(smem);
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_score + N);
  __shared__ int s_count[32][kTileRows];

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kTileRows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t base = static_cast<size_t>(b) * N;
  const int row = i0 + warp;
  const bool row_valid = row < N && mask[base + row] != 0;  // warp-uniform
  const float* src = iou + (base + row) * N;
  uint32_t* dst = bits + (base + row) * Wp;
  // this warp's word row, kWordsInFlight words (128 bytes of the row each)
  // at a time; the first ones are read before the scores are staged, so
  // that the two reads overlap; words past N's last are zero
  float x[kWordsInFlight];
  const auto load = [&](int w0) {
#pragma unroll
    for (int k = 0; k < kWordsInFlight; ++k) {
      const int j = (w0 + k) * 32 + lane;
      x[k] = row_valid && j < N ? __ldg(src + j) : 0.0f;
    }
  };
  load(0);
  for (int j = threadIdx.x; j < N; j += kThreads) {
    s_score[j] = scores[base + j];
    s_valid[j] = mask[base + j] != 0;
  }
  for (int w0 = 0; row_valid && w0 < Wp; w0 += kWordsInFlight) {
    if (w0 > 0) load(w0);
    uint32_t mine = 0;
#pragma unroll
    for (int k = 0; k < kWordsInFlight; ++k) {
      const uint32_t word = __ballot_sync(kFull, x[k] > thr);
      if (lane == k) mine = word;
    }
    if (lane < kWordsInFlight && w0 + lane < Wp) dst[w0 + lane] = mine;
  }
  __syncthreads();

  // ranks of entries i0 .. i0+7: thread t counts entry i0 + t % 8 over
  // slice t / 8 of the j
  const int i = i0 + (threadIdx.x % kTileRows);
  const int slice = threadIdx.x / kTileRows;
  int cnt = 0;
  if (i < N) {
    const float si = s_score[i];
    const int per = (N + 31) / 32;
    const int j1 = min(N, (slice + 1) * per);
    for (int j = slice * per; j < j1; ++j) {
      cnt += s_valid[j] && before(s_score[j], j, si, i);
    }
  }
  s_count[slice][threadIdx.x % kTileRows] = cnt;
  __syncthreads();
  if (threadIdx.x < kTileRows && i < N && s_valid[i]) {
    int rank = 0;
#pragma unroll
    for (int t = 0; t < 32; ++t) rank += s_count[t][threadIdx.x];
    order[base + rank] = i;
  }
  // this block's outputs are written: the scan kernel may launch
  asm volatile("griddepcontrol.launch_dependents;");
}

// Word w of rank r's word row.
template <bool kStaged>
__device__ __forceinline__ uint32_t row_word(const uint32_t* __restrict__ bits,
                                             const uint32_t* s_bits,
                                             const int32_t* s_order,
                                             size_t base, int Wp, int r,
                                             int w) {
  return kStaged ? s_bits[static_cast<size_t>(r) * Wp + w]
                 : __ldg(bits + (base + s_order[r]) * Wp + w);
}

// K words a lane: N <= 32 * 32 * K.  kStaged: the word rows are staged in
// shared memory (N <= kStagedMaxN, K == 1).
template <int K, bool kStaged>
__global__ void greedy_scan_kernel(const uint32_t* __restrict__ bits,
                                   const int32_t* __restrict__ order,
                                   const uint8_t* __restrict__ mask,
                                   uint8_t* __restrict__ keep, int N,
                                   int Wp) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_order = reinterpret_cast<int32_t*>(smem);
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(smem + align16(N * 4));
  __shared__ uint32_t s_kept[kMaxWords];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t base = static_cast<size_t>(b) * N;

  int V = 0;  // valid entries of the row: ranks 0 .. V-1 are in order
  for (int j0 = 0; j0 < N; j0 += kThreads) {
    const int j = j0 + tid;
    V += __syncthreads_count(j < N && mask[base + j] != 0);
  }
  for (int w = tid; w < Wp; w += kThreads) s_kept[w] = 0u;
  // the order and the word rows are the bits kernel's: wait for it
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int r = tid; r < V; r += kThreads) s_order[r] = order[base + r];
  __syncthreads();
  if (kStaged) {
    const int q = Wp / 4;  // 16-byte pieces a word row
    for (int e = tid; e < V * q; e += kThreads) {
      const int r = e / q;
      const int c = 4 * (e - r * q);
      __pipeline_memcpy_async(s_bits + static_cast<size_t>(r) * Wp + c,
                              bits + (base + s_order[r]) * Wp + c, 16);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
  }

  if (tid < 32) {
    uint32_t removed[K];
#pragma unroll
    for (int k = 0; k < K; ++k) removed[k] = 0u;
    for (int r0 = 0; r0 < V; r0 += 32) {
      const int nr = min(32, V - r0);
      // this lane's candidate: rank r0 + lane
      const int c = lane < nr ? s_order[r0 + lane] : 0;
      const int wc = c >> 5;
      const uint32_t bc = 1u << (c & 31);
      uint32_t rw = 0u;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const uint32_t v = __shfl_sync(kFull, removed[k], wc & 31);
        if ((wc >> 5) == k) rw = v;
      }
      uint32_t alive = __ballot_sync(kFull, lane < nr && !(rw & bc));
      // sup[l]: the later ranks of the chunk that rank r0 + l overlaps
      uint32_t sup[32];
#pragma unroll
      for (int l = 0; l < 32; ++l) {
        const uint32_t word =
            l < nr ? row_word<kStaged>(bits, s_bits, s_order, base, Wp,
                                       r0 + l, wc)
                   : 0u;
        sup[l] = __ballot_sync(kFull, (word & bc) != 0u) &
                 (l == 31 ? 0u : ~0u << (l + 1));
      }
#pragma unroll
      for (int l = 0; l < 32; ++l) {
        if (alive & (1u << l)) alive &= ~sup[l];
      }
      // alive: the chunk's kept ranks
#pragma unroll
      for (int l = 0; l < 32; ++l) {
        if ((alive >> l) & 1u) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int w = k * 32 + lane;
            if (w < Wp) {
              removed[k] |= row_word<kStaged>(bits, s_bits, s_order, base,
                                              Wp, r0 + l, w);
            }
          }
        }
      }
      if ((alive >> lane) & 1u) atomicOr(&s_kept[wc], bc);
    }
  }
  __syncthreads();
  for (int j = tid; j < N; j += kThreads) {
    keep[base + j] = (s_kept[j >> 5] >> (j & 31)) & 1u;
  }
}

}  // namespace

extern "C" {

// iou (B, N, N) float32, scores (B, N) float32, mask (B, N) bool
// -> keep (B, N) bool.  Scratch from the caller: bits (B, N, Wp) int32
// with Wp = ceil(N / 32) rounded up to a multiple of 4, and order (B, N)
// int32.  N <= 8192.
int greedy_suppress_rows_f32(const void* iou, const void* scores,
                             const void* mask, void* keep, void* bits,
                             void* order, int B, int N, float thr,
                             void* stream) {
  if (N > 32 * kMaxWords) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int W = (N + 31) / 32;
  const int Wp = (W + 3) & ~3;
  const dim3 grid((N + kTileRows - 1) / kTileRows, B);
  greedy_bits_kernel<<<grid, kThreads, static_cast<size_t>(N) * 5, s>>>(
      static_cast<const float*>(iou), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(mask), static_cast<uint32_t*>(bits),
      static_cast<int32_t*>(order), N, Wp, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // the scan is launched as the bits kernel's programmatic dependent, so
  // its launch and prologue overlap the bits kernel
  const bool staged = N <= kStagedMaxN;
  size_t smem = align16(static_cast<size_t>(N) * 4);
  if (staged) smem += static_cast<size_t>(N) * Wp * 4;
  void (*kernel)(const uint32_t*, const int32_t*, const uint8_t*, uint8_t*,
                 int, int) = staged
                                 ? greedy_scan_kernel<1, true>
                                 : greedy_scan_kernel<kMaxWords / 32, false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const uint32_t*>(bits),
      static_cast<const int32_t*>(order), static_cast<const uint8_t*>(mask),
      static_cast<uint8_t*>(keep), N, Wp);
  // read (and clear) the last error too, so that no later launch reports it
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // extern "C"
