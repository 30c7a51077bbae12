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
//
// What bounds it on an H100: the warp-wide operations and their latency.
// Picking the K nearest one at a time takes two dependent warp reductions a
// pick (the row minimum, then the smallest index that holds it), K rounds a
// row, and that set the graph build's pace even with several rows a warp in
// flight. So each warp takes a row at a time and counts
// its candidates below four levels, thresh, thresh / 4, thresh / 16 and
// "at distance 0", in one reduction (four 8-bit counts in a word); the K
// nearest lie below the smallest level that still holds K of them. The
// candidates below it go to the warp's slice of a shared-memory scratch
// (four ballots), in order of index, and each lane counts, for each of its
// own, the ones before it in (distance, index) order: a candidate of rank r
// < K is slot r's sender. At the last level the candidates tie (duplicates
// of the receiver, as a padded point cloud has), so their order of index is
// their rank and nothing is counted. Where more than 32 candidates lie below
// the level (a tie at one distance that no level splits, as the copies of a
// padded point have for a row near them), counting costs more than picking:
// those rows take their K nearest of them one at a time (pick_rounds). The
// compaction scans the counts in every warp at once (no lone warp, two block
// barriers).
#pragma once

#include <cuda_runtime.h>

namespace edges {

constexpr float kBig = 1e10f;          // distance of an excluded pair
constexpr int kColsPerLane = 4;        // Np <= 128 senders per row, 32 lanes
constexpr unsigned kFull = 0xffffffffu;
// a warp's slice of radius_topk's scratch: the distances (bit patterns) of
// up to 32 candidates and the padding to a multiple of four, then their
// indices (a byte each), and 16 bytes to spare
constexpr int kDistsPerWarp = 36;
constexpr int kScratchPerWarp = kDistsPerWarp * 4 + 32 + 16;

// Bytes of radius_topk's scratch for a block of `warps` warps (16-byte
// aligned).
__host__ __device__ constexpr int scratch_bytes(int warps) { return warps * kScratchPerWarp; }

// The rank of lane l's candidate (entry l of the m <= 32 at dist[0 .. m),
// padded to a multiple of four with distances above every other; idx their
// indices): the number of entries before it in (distance, position) order,
// which is (distance, index) order. Slot rank < K of row i gets its index.
__device__ __forceinline__ void rank_candidates(const unsigned* dist, const unsigned char* idx,
                                                int m, int K, int i, short* nbr) {
  const int lane = threadIdx.x & 31;
  const unsigned me = lane < m ? dist[lane] : kFull;
  int rank = 0;
  for (int k = 0; k < m; k += 4) {
    const uint4 dk = *reinterpret_cast<const uint4*>(dist + k);  // the same for every lane
    const unsigned d4[4] = {dk.x, dk.y, dk.z, dk.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) rank += d4[u] < me || (d4[u] == me && k + u < lane);
  }
  if (lane < m && rank < K) nbr[i * K + rank] = idx[lane];
}

// Slots 0 .. K - 1 of row i, picked one at a time from the lane's candidates
// d (distance bit patterns, +inf where none; column j = lane + 32 q): each
// round takes the warp's smallest (distance, index) and retires it, two warp
// reductions a pick, until K are picked or none is left.
__device__ __forceinline__ void pick_rounds(unsigned (&d)[kColsPerLane], int K, int i,
                                            short* nbr) {
  const int lane = threadIdx.x & 31;
  for (int k = 0; k < K; ++k) {
    unsigned v = d[0];
    int qa = 0;
#pragma unroll
    for (int q = 1; q < kColsPerLane; ++q)
      if (d[q] < v) {
        v = d[q];
        qa = q;
      }
    const unsigned vmin = __reduce_min_sync(kFull, v);
    if (vmin == 0x7f800000u) break;  // none left
    const unsigned mine = v == vmin ? (unsigned)(lane + 32 * qa) : kFull;
    const unsigned arg = __reduce_min_sync(kFull, mine);
    if (lane == 0) nbr[i * K + k] = (short)arg;
#pragma unroll
    for (int q = 0; q < kColsPerLane; ++q)
      if (mine == arg && q == qa) d[q] = 0x7f800000u;
  }
}

// Warp w takes receivers i = w, w + warps, ... < Np: lane l computes the
// squared distances to the senders j = l + 32q (its columns' positions and
// validity read once), and the row's candidates below the level (see above)
// go to the warp's slice of `scratch` (scratch_bytes(warps) bytes of shared
// memory, 16-byte aligned, that nothing else uses meanwhile) to be ranked
// (rank_candidates). pos: (Np, 3) positions; valid: (Np) row validity (> 0),
// or null for "i < N"; rows [n_p, N) are tools. Writes nbr[i * K + k] for
// the cnt[i] edges of row i. Every thread of the block calls it with its
// index tid (threadIdx.x: a caller may pass it through a value the compiler
// cannot see, so that nothing derived from it is hoisted out of the caller's
// loops); no barrier.
__device__ inline void radius_topk(const float* pos, const float* valid, int Np, int N, int n_p,
                                   int K, float thresh, short* nbr, int* cnt, void* scratch,
                                   int tid) {
  const int lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  unsigned* const dist =
      reinterpret_cast<unsigned*>(static_cast<char*>(scratch) + warp * kScratchPerWarp);
  unsigned char* const idx = reinterpret_cast<unsigned char*>(dist + kDistsPerWarp);
  const unsigned before = (1u << lane) - 1;  // the lanes below this one
  // the levels: thresh / 4^l for l < 3, then the least positive float (below
  // it, a distance is 0), none above thresh
  const float level[4] = {thresh, thresh * 0.25f, thresh * 0.0625f,
                          fminf(thresh, __uint_as_float(1u))};
  float px[kColsPerLane], py[kColsPerLane], pz[kColsPerLane];
  bool col_ok[kColsPerLane], col_tool[kColsPerLane];
#pragma unroll
  for (int q = 0; q < kColsPerLane; ++q) {
    const int j = lane + 32 * q;
    col_ok[q] = j < Np && (valid ? valid[j] > 0.f : j < N);
    col_tool[q] = j >= n_p && j < N;
    px[q] = col_ok[q] ? pos[j * 3 + 0] : 0.f;
    py[q] = col_ok[q] ? pos[j * 3 + 1] : 0.f;
    pz[q] = col_ok[q] ? pos[j * 3 + 2] : 0.f;
  }
  for (int i = warp; i < Np; i += warps) {
    int n = 0;
    if (valid ? valid[i] > 0.f : i < N) {
      const bool tool_i = i >= n_p && i < N;
      const float xi = pos[i * 3 + 0], yi = pos[i * 3 + 1], zi = pos[i * 3 + 2];
      float v[kColsPerLane];
      unsigned counts = 0;  // byte l: this lane's candidates below level l
#pragma unroll
      for (int q = 0; q < kColsPerLane; ++q) {
        v[q] = kBig;  // invalid and tool-tool pairs
        if (col_ok[q] && !(tool_i && col_tool[q])) {
          const float dx = __fsub_rn(xi, px[q]);
          const float dy = __fsub_rn(yi, py[q]);
          const float dz = __fsub_rn(zi, pz[q]);
          v[q] = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        }
        if (lane + 32 * q >= Np) v[q] = __uint_as_float(0x7f800000u);  // no such column: +inf
#pragma unroll
        for (int l = 0; l < 4; ++l) counts += (unsigned)(v[q] < level[l]) << (8 * l);
      }
      counts = __reduce_add_sync(kFull, counts);
      n = counts & 0xff;  // below thresh: the row's edges are min(n, K) of them
      float lim = level[0];
      int m = n;          // candidates below lim (warp-uniform)
      bool ties = false;  // K or more at distance 0: ranked by position
#pragma unroll
      for (int l = 1; l < 4; ++l)
        if ((int)(counts >> (8 * l) & 0xff) >= K) {
          lim = level[l];
          m = counts >> (8 * l) & 0xff;
          ties = l == 3;
        }
      if (ties || m <= 32) {
        // the candidates below lim by position, in order of index
        int at0 = 0;
#pragma unroll
        for (int q = 0; q < kColsPerLane; ++q) {
          const bool take = v[q] < lim;
          const unsigned mask = __ballot_sync(kFull, take);
          const int at = at0 + __popc(mask & before);
          if (take && ties && at < K) nbr[i * K + at] = (short)(lane + 32 * q);
          if (take && !ties) {
            dist[at] = __float_as_uint(v[q]);
            idx[at] = (unsigned char)(lane + 32 * q);
          }
          at0 += __popc(mask);
        }
        if (!ties) {
          if (lane < ((m + 3) & ~3) - m) dist[m + lane] = kFull;  // the padding
          __syncwarp();
          rank_candidates(dist, idx, m, K, i, nbr);
          __syncwarp();  // the scratch is read: the next row may overwrite it
        }
      } else {
        unsigned d[kColsPerLane];
#pragma unroll
        for (int q = 0; q < kColsPerLane; ++q)
          d[q] = v[q] < lim ? __float_as_uint(v[q]) : 0x7f800000u;
        pick_rounds(d, K, i, nbr);
      }
    }
    if (lane == 0) cnt[i] = n < K ? n : K;
  }
}

// Compact the edges of radius_topk (a receiver's edges are a prefix of its
// slots): off = exclusive prefix sum of cnt (Np + 1 entries), er[e] the
// receiver of edge e and, with es, es[e] its sender, edges grouped by
// receiver in slot order. Every warp scans all the counts (lane l those of
// rows 4l .. 4l + 3, then one warp scan); warp w then writes rows w, w +
// warps, ..., a lane a slot. Every thread of the block calls it with its
// index tid (as radius_topk); it starts and ends with a barrier, and has no
// other. Returns the number of edges.
__device__ inline int compact_edges(const int* cnt, const short* nbr, int Np, int K, int* off,
                                    short* er, short* es, int tid) {
  const int lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  __syncthreads();
  int o[kColsPerLane], c[kColsPerLane], run = 0;
#pragma unroll
  for (int q = 0; q < kColsPerLane; ++q) {
    const int i = kColsPerLane * lane + q;
    c[q] = i < Np ? cnt[i] : 0;
    run += c[q];
  }
  int incl = run;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, s);
    if (lane >= s) incl += t;
  }
  o[0] = incl - run;
#pragma unroll
  for (int q = 1; q < kColsPerLane; ++q) o[q] = o[q - 1] + c[q - 1];
  const int total = __shfl_sync(kFull, incl, 31);
  for (int i = warp; i < Np; i += warps) {
    const int which = i % kColsPerLane, src = i / kColsPerLane;  // warp-uniform
    int oi = o[0], ci = c[0];
#pragma unroll
    for (int q = 1; q < kColsPerLane; ++q)
      if (which == q) { oi = o[q]; ci = c[q]; }
    oi = __shfl_sync(kFull, oi, src);
    ci = __shfl_sync(kFull, ci, src);
    if (lane == 0) off[i] = oi;
    for (int k = lane; k < ci; k += 32) {
      er[oi + k] = (short)i;
      if (es) es[oi + k] = nbr[i * K + k];
    }
  }
  if (tid == 0) off[Np] = total;
  __syncthreads();
  return total;
}

}  // namespace edges
