// Per-row greedy spherical-NMS suppression for Hopper (sm_90a).
//
// Replaces the XLA program repro/core/sphere.py _sph_nms_batch_device: its
// lax.while_loop (sphere.py:449-468) that keeps every row's best remaining
// box and suppresses that box's overlaps, until no row has a candidate.
//
// What bounds it on the H100: latency, not bytes or operations.  A row's
// loop runs once per box it keeps, and each step is a block-wide arg-max
// and one pass over one IoU row; per step the block touches N scores in
// shared memory and N floats of the IoU matrix.  The bytes that must move
// are the scores, the mask, the keep mask and the IoU rows of the kept
// boxes, which is little; the chain of dependent steps with barriers
// between them is what takes the time.
//
// Design: one block per row, so rows run in parallel on the SMs and a row's
// steps synchronise with __syncthreads only.  The row's scores and active
// flags live in shared memory (N * 5 bytes; N <= 8192 keeps it under the
// 48 KB of static launch).  Each step: a strided scan for the best active
// (score, index), a warp-shuffle then cross-warp reduction that breaks ties
// toward the lowest index (as jnp.argmax at sphere.py:456 and the NumPy
// host path do), keep[best] = 1, then every j with iou[best, j] > thr (and
// best itself) leaves the active set.  The loop ends when no candidate is
// left, so the keep mask equals the reference's exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// (s, i) beats (bs, bi): higher score, or the same score at a lower index.
__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

__global__ void greedy_rows_kernel(const float* __restrict__ iou,
                                   const float* __restrict__ scores,
                                   const uint8_t* __restrict__ mask,
                                   uint8_t* __restrict__ keep, int N,
                                   float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_score = reinterpret_cast<float*>(smem);
  uint8_t* s_active = reinterpret_cast<uint8_t*>(s_score + N);
  __shared__ float w_score[kWarps];
  __shared__ int w_idx[kWarps];
  __shared__ int s_best;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = static_cast<size_t>(row) * N;
  const float* iou_row = iou + base * N;

  for (int j = tid; j < N; j += kThreads) {
    s_score[j] = scores[base + j];
    s_active[j] = mask[base + j] != 0;
    keep[base + j] = 0;
  }
  __syncthreads();

  while (true) {
    // best active candidate: index N means "none"
    float bs = -INFINITY;
    int bi = N;
    for (int j = tid; j < N; j += kThreads) {
      if (s_active[j] && better(s_score[j], j, bs, bi)) {
        bs = s_score[j];
        bi = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, bs, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (oi < N && better(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
      }
    }
    if (lane == 0) {
      w_score[warp] = bs;
      w_idx[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      float fs = w_score[0];
      int fi = w_idx[0];
      for (int w = 1; w < kWarps; ++w) {
        if (w_idx[w] < N && better(w_score[w], w_idx[w], fs, fi)) {
          fs = w_score[w];
          fi = w_idx[w];
        }
      }
      s_best = fi;
    }
    __syncthreads();
    const int best = s_best;
    if (best >= N) break;  // every thread reads the same value
    if (tid == 0) keep[base + best] = 1;
    const float* r = iou_row + static_cast<size_t>(best) * N;
    for (int j = tid; j < N; j += kThreads) {
      if (s_active[j] && (j == best || r[j] > thr)) s_active[j] = 0;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// iou (B, N, N) float32, scores (B, N) float32, mask (B, N) bool
// -> keep (B, N) bool.
int greedy_suppress_rows_f32(const void* iou, const void* scores,
                             const void* mask, void* keep, int B, int N,
                             float thr, void* stream) {
  const size_t smem = static_cast<size_t>(N) * (sizeof(float) + 1);
  greedy_rows_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(iou), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(mask), static_cast<uint8_t*>(keep), N, thr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
