// The in-kernel radius-and-topk graph of one sample, shared by the whole-push
// rollout (rollout_chunk.cu, K1) and the single-step forward with in-kernel
// edges (gnn_forward.cu, K2e): the semantics of the JAX _edges_stacked
// (ops/fused_gnn.py) and of the plain versions' pairwise_sq_dists and
// smallest_k (ops/graph.py).
//
// For every valid receiver i, the K valid senders j nearest to it (invalid and
// tool-tool pairs excluded, the self-edge kept) whose squared distance is
// strictly below thresh, in order of distance, ties to the smallest index.
// Distances are x, y, z squared and summed in that order with round-to-nearest
// intrinsics (no fused multiply-add), so they equal the plain version's bit for
// bit and the picks agree.
#pragma once

#include <cuda_runtime.h>

namespace edges {

constexpr float kBig = 1e10f;          // distance of an excluded pair
constexpr int kColsPerLane = 4;        // Np <= 128 senders per row, 32 lanes
constexpr unsigned kFull = 0xffffffffu;

// One warp per receiver i < Np (warps stride over the rows): the squared
// distances to the senders j = lane + 32q in registers; each round takes the
// row minimum, ties to the smallest index, and retires it. pos: (Np, 3)
// positions; valid: (Np) row validity (> 0), or null for "i < N"; rows
// [n_p, N) are tools. Writes nbr[i * K + k] for the cnt[i] edges of row i.
// Every thread of the block calls it; no barrier.
__device__ inline void radius_topk(const float* pos, const float* valid, int Np, int N, int n_p,
                                   int K, float thresh, short* nbr, int* cnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int i = warp; i < Np; i += warps) {
    int c = 0;
    if (valid ? valid[i] > 0.f : i < N) {
      const bool tool_i = i >= n_p && i < N;
      unsigned dist[kColsPerLane];  // bit patterns: distances are >= 0, so they order alike
#pragma unroll
      for (int q = 0; q < kColsPerLane; ++q) {
        const int j = lane + 32 * q;
        float v = kBig;  // invalid and tool-tool pairs
        if (j < Np && (valid ? valid[j] > 0.f : j < N) && !(tool_i && j >= n_p && j < N)) {
          const float dx = __fsub_rn(pos[i * 3 + 0], pos[j * 3 + 0]);
          const float dy = __fsub_rn(pos[i * 3 + 1], pos[j * 3 + 1]);
          const float dz = __fsub_rn(pos[i * 3 + 2], pos[j * 3 + 2]);
          v = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        }
        dist[q] = j < Np ? __float_as_uint(v) : 0x7f800000u;  // +inf: no such column
      }
      for (int k = 0; k < K; ++k) {
        unsigned v = dist[0];
        int qa = 0;
#pragma unroll
        for (int q = 1; q < kColsPerLane; ++q)
          if (dist[q] < v) { v = dist[q]; qa = q; }
        const unsigned vmin = __reduce_min_sync(kFull, v);
        const int arg = (int)__reduce_min_sync(
            kFull, v == vmin ? (unsigned)(lane + 32 * qa) : 0xffffffffu);
        if (!(__uint_as_float(vmin) < thresh)) break;  // the rest are farther: masked slots
        if (lane == 0) nbr[i * K + k] = (short)arg;
        if (arg == lane + 32 * qa) {
#pragma unroll
          for (int q = 0; q < kColsPerLane; ++q)
            if (q == qa) dist[q] = __float_as_uint(kBig);
        }
        c = k + 1;
      }
    }
    if (lane == 0) cnt[i] = c;
  }
}

// Compact the edges of radius_topk (a receiver's edges are a prefix of its
// slots): off = exclusive prefix sum of cnt (Np + 1 entries), er[e] the
// receiver of edge e and, with es, es[e] its sender, edges grouped by
// receiver in slot order. Every thread of the block calls it; it starts and
// ends with a barrier. Returns the number of edges.
__device__ inline int compact_edges(const int* cnt, const short* nbr, int Np, int K, int* off,
                                    short* er, short* es) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (warp == 0) {
    int run = 0;
    for (int base = 0; base < Np; base += 32) {
      const int i = base + lane;
      const int c = (i < Np) ? cnt[i] : 0;
      int incl = c;
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      if (i < Np) off[i] = run + incl - c;
      run += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) off[Np] = run;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Np; i += blockDim.x)
    for (int k = 0; k < cnt[i]; ++k) {
      er[off[i] + k] = (short)i;
      if (es) es[off[i] + k] = nbr[i * K + k];
    }
  __syncthreads();
  return off[Np];
}

}  // namespace edges
