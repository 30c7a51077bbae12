// Whole-push GNN rollout for one MPPI chunk, one thread block per sample.
//
// Replaces the TPU kernel adaptigraph_tpu/ops/fused_gnn.py::_rollout_kernel
// (launched by fused_rollout_chunk). For each sample the block runs the push's
// substeps up to the sample's own repeat count (a sample's record cannot change
// after it): shift the n_his history, rebuild the radius-and-topk graph from the
// newest frame, run the relation encoder, pstep rounds of message passing and
// the motion head, record the prediction at the sample's repeat, and re-stick
// the end-effector rows to the min (or masked mean) object y plus the gripper
// lift. The particle encoder and its propagator term run once per push.
//
// What bounds it on an H100: arithmetic. At rope width (N 101, K 10, nf 128)
// a substep is ~72 M multiply-adds per sample, almost all in the relation MLP
// over the edge rows, against a few KB of inputs per sample.
//
// What the design does about it:
// - bf16 (the main path): every product runs on the tensor cores (mma.sync
//   m16n8k16 bf16 with float32 accumulators, operands loaded with ldmatrix;
//   each warp owns 32x32 output tiles and applies the layer's epilogue from
//   its registers). Activations are kept in bf16 in shared memory, which is
//   exact: the JAX kernel rounds every layer's output to bf16, and so does
//   this one, at the same places. float32 (the parity mode) runs the same
//   steps on the CUDA cores with a register-tiled matmul.
// - Only real edges are computed. A receiver's edges are a prefix of its
//   top-k slots (the selected distances ascend), so the edge list is compacted
//   with a prefix sum and the relation MLP runs on real edges only; masked
//   slots add exact zeros in the JAX kernel and are skipped here.
// - Node-sized state (history, effect, projections, distance matrix, the
//   staged weight matrix) lives in shared memory: ~192 KB (bf16) and
//   ~200 KB (float32) per block at rope width, ~197 KB and ~216 KB at granular
//   width (N 105, K 20), so one block runs per SM.
// - The edge-sized rel_base (E x nf, 266 KB in bf16 at rope width) does not fit
//   in shared memory. It is written once per substep to a scratch buffer in
//   global memory, 2*E*nf bytes per sample in bf16 (4*E*nf in f32), and read
//   in each of the pstep rounds. The wrapper allocates it (B*Np*K*nf values),
//   as it does the per-push particle encoding (B*Np*nf) and, in float32, the
//   propagator base (bf16 keeps that in shared memory).
//
// The graph is edge_build.cuh's, shared with gnn_forward.cu: distances equal
// the plain version's bit for bit, ties go to the smallest sender index.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "edge_build.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;                          // float32 blocks (CUDA-core matmul)
constexpr int kWarps = kThreads / 32;
constexpr int kTcThreads = 512;                        // bf16 blocks (tensor cores)
constexpr int kTcWidth = 128;                          // bf16 relation and effect width
constexpr int kRowsPerThread = 8;                      // CUDA-core matmul: rows per warp and tile
constexpr int kTileRows = kWarps * kRowsPerThread;     // 64 rows per CUDA-core matmul tile
constexpr int kColBlock = 128;                         // 32 lanes x 4 adjacent columns
constexpr int kKChunk = 16;                            // weight rows staged at a time (f32)
constexpr int kEdgeTile = 64;                          // edge rows per relation tile (f32)
constexpr int kNumWeights = 24;
// Phases timed in the profiling build (see PhaseClock).
enum Phase { kEncoder, kGraph, kRelation, kProjection, kAggregate, kUpdate, kHead, kRestick,
             kPhases };
constexpr float kBig = 1e10f;
constexpr unsigned kFull = 0xffffffffu;

// Per compute dtype: the threads per block, the column padding of matmul
// inputs (an mma k-step is 16 wide), the row padding a tile may read, and the
// extra row stride of shared-memory matrices (8 bf16 = 16 bytes, so the rows
// of a fragment load fall in different banks).
template <typename T> struct Cfg;
template <> struct Cfg<float> {
  static constexpr int kThreads = ::kThreads;
  static constexpr int kPad = 4, kRowPad = 1, kLdPad = 0;
};
template <> struct Cfg<bf16> {
  static constexpr int kThreads = kTcThreads;
  static constexpr int kPad = 16, kRowPad = 16, kLdPad = 8;
};
// Receivers aggregated before each propagator update: all of them in bf16
// (one update product for the whole graph), 16 at a time in float32, whose
// shared-memory budget is twice as tight.
template <typename T> __host__ __device__ inline int agg_tile_rows(int npr) {
  return sizeof(T) == 2 ? npr : 16;
}

struct Dims {
  int Np, N, n_p, K, n_his, pstep, Dp, nf_p, nf_r, nf_e, rel_in;
};

__host__ __device__ inline int round_to(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
template <typename T> __host__ __device__ inline int ldp(int w) { return w + Cfg<T>::kLdPad; }

// Shared-memory layout in bytes; every region starts 128-byte aligned.
struct Layout {
  int R, eff, agg, ws, pb, hist, sn, act, rec, valid, red, cnt, off, nbr, er, total;
};

template <typename T>
__host__ __device__ inline Layout make_layout(const Dims& d) {
  constexpr int es = sizeof(T), pad = Cfg<T>::kPad;
  const bool tc = sizeof(T) == 2;
  const int npr = round_to(d.Np, Cfg<T>::kRowPad);      // rows a tile may touch
  const int agg_rows = agg_tile_rows<T>(npr);
  const int nfa = imax(imax(d.nf_p, d.nf_r), d.nf_e);
  const int rw = imax(nfa, round_to(d.rel_in, pad));
  // relation MLP: CUDA cores, ping-pong edge tiles; tensor cores, a weight buffer
  int r_bytes = tc ? (kTcWidth + 8) * (kTcWidth + 8) * 2 : 2 * kEdgeTile * ldp<T>(rw) * es;
  r_bytes = imax(r_bytes, npr * ldp<T>(2 * d.nf_e) * es);  // recv|send projections
  r_bytes = imax(r_bytes, 2 * npr * ldp<T>(nfa) * es);  // hidden layers
  const int kmax = imax(imax(nfa, round_to(d.rel_in, pad)), round_to(d.Dp, pad));
  const int sizes[] = {
      r_bytes,                                                        // R
      npr * ldp<T>(d.nf_e) * es,                                      // eff
      imax(agg_rows * ldp<T>(d.nf_e), npr * ldp<T>(round_to(d.Dp, pad))) * es,  // agg; inputs
      tc ? kmax * (round_to(nfa, 32) + 8) * 2 + round_to(nfa, 32) * 4
         : kKChunk * kColBlock * 4,                                   // ws: weights, bias
      tc ? npr * ldp<T>(d.nf_e) * es : 0,                             // pb: propagator base
      (d.n_his + 1) * d.Np * 3 * 4,                                   // hist: ring of n_his+1
      d.Np * d.n_his * 3 * 4,                                         // sn
      d.Np * 3 * 4,                                                   // act
      d.n_p * 3 * 4,                                                  // rec
      d.Np * 4,                                                       // valid
      3 * (Cfg<T>::kThreads / 32) * 4,                                // red
      d.Np * 4,                                                       // cnt
      (d.Np + 1) * 4,                                                 // off
      d.Np * d.K * 2,                                                 // nbr: int16 senders
      d.Np * d.K * 2,                                                 // er: int16 receivers
  };
  int starts[15];
  int at = 0;
  for (int i = 0; i < 15; ++i) { starts[i] = at; at += round_to(sizes[i], 128); }
  Layout L;
  L.R = starts[0]; L.eff = starts[1]; L.agg = starts[2]; L.ws = starts[3]; L.pb = starts[4];
  L.hist = starts[5]; L.sn = starts[6]; L.act = starts[7]; L.rec = starts[8];
  L.valid = starts[9]; L.red = starts[10]; L.cnt = starts[11]; L.off = starts[12];
  L.nbr = starts[13]; L.er = starts[14];
  L.total = at;
  return L;
}

struct Params {
  const void* pin;       // (B, Np, Dp) compute dtype: [attrs | phys | action]
  const float* sa;       // (B, Np, 6): [state0 | action]
  const int* repeat;     // (B,)
  const float* valid;    // (B, Np)
  const void* w[kNumWeights];
  void* relbase;         // scratch (B, Np*K, nf_e)
  void* penc;            // scratch (B, Np, nf_e)
  void* pbase;           // scratch (B, Np, nf_e), float32 mode only (else null)
  float* out;            // (B, n_p, 3)
#ifdef ROLLOUT_PHASE_CLOCKS
  long long* clocks;     // (B, kPhases) SM cycles per phase, or null
#endif
  Dims d;
  float thresh, gripper_lift, motion_clamp;
  int max_repeat, mean_y;
};

__device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load(const bf16* p, size_t i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ void store(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(bf16* p, size_t i, float v) { p[i] = __float2bfloat16_rn(v); }

// 16 bytes (4 float or 8 bf16 values) at p, which is 16-byte aligned.
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load_vec(const bf16* p, float (&v)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    v[2 * q] = f.x;
    v[2 * q + 1] = f.y;
  }
}

// Round to the compute dtype and back (the JAX kernel's .astype(cd)).
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Y = X @ W for rows [0, M), float32 on the CUDA cores. X in shared memory,
// row stride ldx (a multiple of 4), zero in columns [Kin, round4(Kin)). W:
// (Kin, Nout) in global memory with row stride ldw, staged kKChunk rows at a
// time. Warp
// w owns rows w + 8*i of a 64-row tile, lane l the columns 4l..4l+3 of a
// 128-column block; products accumulate in k order. epi(r, c, acc + bias[c])
// (bias may be null) consumes every output and must not write X. Every
// thread of the block calls it. (The stage flag of the tensor-core version
// is ignored: W is staged in k-chunks here.)
template <typename Epi>
__device__ void matmul(const float* X, int ldx, int M, int Kin, const float* W, int ldw,
                       const float* bias, int Nout, void* ws, bool, Epi epi) {
  float* Ws = static_cast<float*>(ws);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kin4 = round_to(Kin, 4);
  for (int cb = 0; cb < Nout; cb += kColBlock) {
    for (int r0 = 0; r0 < M; r0 += kTileRows) {
      float acc[kRowsPerThread][4];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < kin4; k0 += kKChunk) {
        __syncthreads();  // the previous chunk is consumed
        for (int idx = threadIdx.x; idx < kKChunk * kColBlock; idx += kThreads) {
          const int k = k0 + idx / kColBlock, c = cb + idx % kColBlock;
          Ws[idx] = (k < Kin && c < Nout) ? W[(size_t)k * ldw + c] : 0.f;
        }
        __syncthreads();
        const int kn = min(kKChunk, kin4 - k0);
        for (int kk = 0; kk < kn; kk += 4) {
          const float4 w0 = reinterpret_cast<const float4*>(Ws + (kk + 0) * kColBlock)[lane];
          const float4 w1 = reinterpret_cast<const float4*>(Ws + (kk + 1) * kColBlock)[lane];
          const float4 w2 = reinterpret_cast<const float4*>(Ws + (kk + 2) * kColBlock)[lane];
          const float4 w3 = reinterpret_cast<const float4*>(Ws + (kk + 3) * kColBlock)[lane];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            const int r = r0 + warp + kWarps * i;
            if (r < M) {
              const float4 x = *reinterpret_cast<const float4*>(X + (size_t)r * ldx + k0 + kk);
              acc[i][0] = fmaf(x.w, w3.x, fmaf(x.z, w2.x, fmaf(x.y, w1.x, fmaf(x.x, w0.x, acc[i][0]))));
              acc[i][1] = fmaf(x.w, w3.y, fmaf(x.z, w2.y, fmaf(x.y, w1.y, fmaf(x.x, w0.y, acc[i][1]))));
              acc[i][2] = fmaf(x.w, w3.z, fmaf(x.z, w2.z, fmaf(x.y, w1.z, fmaf(x.x, w0.z, acc[i][2]))));
              acc[i][3] = fmaf(x.w, w3.w, fmaf(x.z, w2.w, fmaf(x.y, w1.w, fmaf(x.x, w0.w, acc[i][3]))));
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = r0 + warp + kWarps * i;
        if (r < M) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = cb + 4 * lane + j;
            if (c < Nout) epi(r, c, bias ? acc[i][j] + bias[c] : acc[i][j]);
          }
        }
      }
    }
  }
  __syncthreads();
}

// Tensor-core primitives (mma.cuh): ldmatrix loads of 8x8 bf16 tiles from
// shared memory, and the m16n8k16 bf16 product with float32 accumulators.
using tc::ldsm_x4;
using tc::ldsm_x4_trans;
using tc::mma_bf16;

// Y = X @ W for rows [0, M), bf16 on the tensor cores with float32
// accumulators. X in shared memory, row stride ldx (a multiple of 8, padded
// so the rows of an 8x8 load fall in different banks), rows up to
// round16(M) readable (rows past M only feed discarded outputs), zero in
// columns [Kin, round16(Kin)). The whole W (Kin, Nout; global row stride
// ldw) is staged into ws as
// (round16(Kin), round32(Nout)), zero-padded, with row stride round32(Nout)
// + 8, and the bias (may be null) after it; with stage false, ws already
// holds them from the previous call. Each warp computes 32x32 output
// tiles (eight m16n8 accumulators) and hands every output from its registers
// to epi(r, c, acc + bias[c]). Every thread of the block calls it.
template <typename Epi>
__device__ void matmul(const bf16* X, int ldx, int M, int Kin, const bf16* W, int ldw,
                       const bf16* bias, int Nout, void* ws, bool stage, Epi epi) {
  bf16* Ws = static_cast<bf16*>(ws);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kp = round_to(Kin, 16), np = round_to(Nout, 32), wld = np + 8;
  float* bs = reinterpret_cast<float*>(Ws + kp * wld);  // the bias, as float32
  __syncthreads();  // Ws is free and X is complete
  if (!stage) {
    // W and bias are in ws from the previous call
  } else if ((Nout & 7) == 0 && (ldw & 7) == 0) {
    // asynchronous 16-byte copies: every thread keeps all its loads in flight
    const int nv = np / 8;
    for (int idx = threadIdx.x; idx < kp * nv; idx += kTcThreads) {
      const int k = idx / nv, c = (idx % nv) * 8;
      if (k < Kin && c < Nout)
        __pipeline_memcpy_async(Ws + k * wld + c, W + (size_t)k * ldw + c, 16);
      else
        *reinterpret_cast<uint4*>(Ws + k * wld + c) = make_uint4(0u, 0u, 0u, 0u);
    }
    __pipeline_commit();
  } else {
    for (int idx = threadIdx.x; idx < kp * np; idx += kTcThreads) {
      const int k = idx / np, c = idx % np;
      Ws[k * wld + c] = (k < Kin && c < Nout) ? W[(size_t)k * ldw + c] : __float2bfloat16_rn(0.f);
    }
  }
  if (stage) {
    for (int c = threadIdx.x; c < np; c += kTcThreads)
      bs[c] = (bias && c < Nout) ? __bfloat162float(bias[c]) : 0.f;
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = (M + 31) / 32, nt = np / 32;
  for (int t = warp; t < mt * nt; t += kTcThreads / 32) {
    const int r0 = (t / nt) * 32, c0 = (t % nt) * 32;
    const bool lower = r0 + 16 < M;  // the tile's second 16 rows hold outputs
    float acc[2][4][4];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mb][nb][q] = 0.f;
    // this lane's row addresses for the 8x8 loads
    const bf16* xa = X + (size_t)(r0 + (lane & 15)) * ldx + (lane >> 4) * 8;
    const bf16* wb = Ws + (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) * wld + c0 + (lane >> 4) * 8;
    for (int k = 0; k < kp; k += 16) {
      unsigned a0[4], a1[4], b01[4], b23[4];
      ldsm_x4(a0, xa + k);
      ldsm_x4_trans(b01, wb + (size_t)k * wld);       // columns c0 .. c0+15
      ldsm_x4_trans(b23, wb + (size_t)k * wld + 16);  // columns c0+16 .. c0+31
      mma_bf16(acc[0][0], a0, b01[0], b01[1]);
      mma_bf16(acc[0][1], a0, b01[2], b01[3]);
      mma_bf16(acc[0][2], a0, b23[0], b23[1]);
      mma_bf16(acc[0][3], a0, b23[2], b23[3]);
      if (lower) {
        ldsm_x4(a1, xa + (size_t)16 * ldx + k);
        mma_bf16(acc[1][0], a1, b01[0], b01[1]);
        mma_bf16(acc[1][1], a1, b01[2], b01[3]);
        mma_bf16(acc[1][2], a1, b23[0], b23[1]);
        mma_bf16(acc[1][3], a1, b23[2], b23[3]);
      }
    }
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      if (mb == 1 && !lower) continue;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int c = c0 + nb * 8 + 2 * t4, r = r0 + mb * 16 + g;
        const float bias0 = bs[c], bias1 = bs[c + 1];
        if (r < M) {
          if (c < Nout) epi(r, c, acc[mb][nb][0] + bias0);
          if (c + 1 < Nout) epi(r, c + 1, acc[mb][nb][1] + bias1);
        }
        if (r + 8 < M) {
          if (c < Nout) epi(r + 8, c, acc[mb][nb][2] + bias0);
          if (c + 1 < Nout) epi(r + 8, c + 1, acc[mb][nb][3] + bias1);
        }
      }
    }
  }
  __syncthreads();
}

// Per-phase SM cycles of one block, taken by its thread 0 after the barrier
// that ends each phase, into the buffer set with
// rollout_chunk_set_phase_clocks. Only the profiling build
// (-DROLLOUT_PHASE_CLOCKS) counts; in the normal build mark() is empty.
#ifdef ROLLOUT_PHASE_CLOCKS
struct PhaseClock {
  long long* out;
  long long t;
  __device__ PhaseClock(const Params& p, int b)
      : out(threadIdx.x == 0 && p.clocks ? p.clocks + (size_t)b * kPhases : nullptr), t(0) {
    if (out) t = clock64();
  }
  __device__ void mark(int phase) {
    if (out) {
      const long long now = clock64();
      out[phase] += now - t;
      t = now;
    }
  }
};
long long* g_phase_clocks = nullptr;  // the next launches' clock buffer
#else
struct PhaseClock {
  __device__ PhaseClock(const Params&, int) {}
  __device__ void mark(int) {}
};
#endif

// ---- the relation MLP on the tensor cores, activations in registers ----
//
// bf16 only, widths kNF (relation and effect) and relation inputs <= 32.
// Each warp owns 16 edge rows of a tile (16 warps: 256 edges per tile) and
// carries them through the relation encoder's three layers and the rel_base
// layer without leaving its registers: an m16n8 accumulator tile, after bias,
// ReLU and rounding to bf16, is exactly the A fragment of the next layer's
// product. Only the weights go through shared memory, one layer at a time in
// two buffers, the next layer's copy in flight while this one computes.

// Stage one layer (kin rows of a (kin, kNF) bf16 matrix, zero rows up to
// round16(kin), then the kNF bias values) into dst, row stride kNF + 8;
// asynchronous, committed as one group.
template <int kNF>
__device__ void stage_layer(bf16* dst, const bf16* w, const bf16* bias, int kin) {
  constexpr int kLd = kNF + 8, kChunks = kNF / 8;
  const int kp = round_to(kin, 16);
  for (int idx = threadIdx.x; idx < kp * kChunks; idx += kTcThreads) {
    const int k = idx / kChunks, c = (idx % kChunks) * 8;
    if (k < kin)
      __pipeline_memcpy_async(dst + k * kLd + c, w + (size_t)k * kNF + c, 16);
    else
      *reinterpret_cast<uint4*>(dst + k * kLd + c) = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int idx = threadIdx.x; idx < kChunks; idx += kTcThreads)
    __pipeline_memcpy_async(dst + kp * kLd + idx * 8, bias + idx * 8, 16);
  __pipeline_commit();
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

struct EdgeGraph {
  int E, K, n_p, N, rel_in, nh3;
  const short* ER;
  const short* NBR;
  const int* OFF;
  const float* VALID;
  const float* SN;
};

// Relation input `col` of edge e (receiver i, sender j): [obj_i, eef_i, obj_j,
// eef_j, |obj_i - obj_j|, sn_i - sn_j]; 0 past the last edge or column.
__device__ __forceinline__ float edge_feature(const EdgeGraph& g, int e, int i, int j, int col) {
  if (e >= g.E || col >= g.rel_in) return 0.f;
  const float oi = (i < g.n_p) ? g.VALID[i] : 0.f, oj = (j < g.n_p) ? g.VALID[j] : 0.f;
  if (col == 0) return oi;
  if (col == 1) return (i >= g.n_p && i < g.N) ? 1.f : 0.f;
  if (col == 2) return oj;
  if (col == 3) return (j >= g.n_p && j < g.N) ? 1.f : 0.f;
  if (col == 4) return fabsf(oi - oj);
  return rnd<bf16>(g.SN[i * g.nh3 + col - 5] - g.SN[j * g.nh3 + col - 5]);
}

// rel_base[e] = (relu-MLP3(relation inputs of e)) @ W1 + b for the E real
// edges. W: the kernel's weight table; buf0, buf1: two staging buffers of
// (128 + 8) * (kNF + 8) bf16 each. Every thread of the block calls it.
template <int kNF>
__device__ void relation_mlp_tc(const EdgeGraph& g, const bf16* const* W, bf16* buf0, bf16* buf1,
                                bf16* relbase) {
  constexpr int kLd = kNF + 8, kNT = kNF / 8, kKS = kNF / 16;
  constexpr int kTile = (kTcThreads / 32) * 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gid = lane >> 2, t4 = lane & 3;
  const int ntiles = (g.E + kTile - 1) / kTile;
  if (ntiles == 0) return;
  // per layer: weight, bias, rows (the relation encoder, then rel_base)
  const bf16* lw[4] = {W[6], W[8], W[10], W[12]};
  const bf16* lb[4] = {W[7], W[9], W[11], W[14]};
  stage_layer<kNF>(buf0, lw[0], lb[0], g.rel_in);
  for (int tile = 0; tile < ntiles; ++tile) {
    const int row0 = tile * kTile + warp * 16;
    const bool active = row0 < g.E;  // warp-uniform
    const int ea = row0 + gid, eb = ea + 8;
    unsigned a[kKS][4];
    if (active) {
      int ia = 0, ja = 0, ib = 0, jb = 0;
      if (ea < g.E) { ia = g.ER[ea]; ja = g.NBR[ia * g.K + (ea - g.OFF[ia])]; }
      if (eb < g.E) { ib = g.ER[eb]; jb = g.NBR[ib * g.K + (eb - g.OFF[ib])]; }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int c = ks * 16 + 2 * t4;
        a[ks][0] = pack_bf16(edge_feature(g, ea, ia, ja, c), edge_feature(g, ea, ia, ja, c + 1));
        a[ks][1] = pack_bf16(edge_feature(g, eb, ib, jb, c), edge_feature(g, eb, ib, jb, c + 1));
        a[ks][2] = pack_bf16(edge_feature(g, ea, ia, ja, c + 8), edge_feature(g, ea, ia, ja, c + 9));
        a[ks][3] = pack_bf16(edge_feature(g, eb, ib, jb, c + 8), edge_feature(g, eb, ib, jb, c + 9));
      }
    }
#pragma unroll
    for (int L = 0; L < 4; ++L) {
      __pipeline_wait_prior(0);
      __syncthreads();  // layer L's weights are in; every warp is done with layer L-1
      if (L < 3)
        stage_layer<kNF>((L % 2) ? buf0 : buf1, lw[L + 1], lb[L + 1], kNF);
      else if (tile + 1 < ntiles)
        stage_layer<kNF>(buf0, lw[0], lb[0], g.rel_in);
      if (!active) continue;
      const bf16* ws = (L % 2) ? buf1 : buf0;
      const int kin = (L == 0) ? round_to(g.rel_in, 16) : kNF;
      float acc[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;
      const bf16* wb = ws + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + (lane >> 4) * 8;
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        if (ks * 16 < kin) {
#pragma unroll
          for (int nb = 0; nb < kNT / 2; ++nb) {
            unsigned b[4];
            ldsm_x4_trans(b, wb + ks * 16 * kLd + nb * 16);
            mma_bf16(acc[2 * nb], a[ks], b[0], b[1]);
            mma_bf16(acc[2 * nb + 1], a[ks], b[2], b[3]);
          }
        }
      }
      const bf16* bias = ws + kin * kLd;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int c = nt * 8 + 2 * t4;
        const float b0 = __bfloat162float(bias[c]), b1 = __bfloat162float(bias[c + 1]);
        if (L < 3) {  // ReLU, round: the next layer's A fragment
          a[nt / 2][(nt % 2) * 2] = pack_bf16(fmaxf(acc[nt][0] + b0, 0.f), fmaxf(acc[nt][1] + b1, 0.f));
          a[nt / 2][(nt % 2) * 2 + 1] =
              pack_bf16(fmaxf(acc[nt][2] + b0, 0.f), fmaxf(acc[nt][3] + b1, 0.f));
        } else {  // rel_base, rounded to bf16
          if (ea < g.E)
            *reinterpret_cast<unsigned*>(relbase + (size_t)ea * kNF + c) =
                pack_bf16(acc[nt][0] + b0, acc[nt][1] + b1);
          if (eb < g.E)
            *reinterpret_cast<unsigned*>(relbase + (size_t)eb * kNF + c) =
                pack_bf16(acc[nt][2] + b0, acc[nt][3] + b1);
        }
      }
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();
}

// Block-wide min, sum and count of one value each per thread; every thread
// gets the results.
template <int kWarpsInBlock>
__device__ inline void block_min_sum_count(float& vmin, float& vsum, float& vcnt, float* red) {
  constexpr int kWarps = kWarpsInBlock;
  for (int o = 16; o > 0; o >>= 1) {
    vmin = fminf(vmin, __shfl_xor_sync(kFull, vmin, o));
    vsum += __shfl_xor_sync(kFull, vsum, o);
    vcnt += __shfl_xor_sync(kFull, vcnt, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) { red[warp] = vmin; red[kWarps + warp] = vsum; red[2 * kWarps + warp] = vcnt; }
  __syncthreads();
  vmin = red[0];
  vsum = 0.f;
  vcnt = 0.f;
  for (int w = 0; w < kWarps; ++w) {
    vmin = fminf(vmin, red[w]);
    vsum += red[kWarps + w];
    vcnt += red[2 * kWarps + w];
  }
}

template <typename T>
__global__ void __launch_bounds__(Cfg<T>::kThreads, 1) rollout_chunk_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Dims d = p.d;
  const Layout L = make_layout<T>(d);
  T* R = reinterpret_cast<T*>(smem + L.R);
  T* EFF = reinterpret_cast<T*>(smem + L.eff);
  T* AGG = reinterpret_cast<T*>(smem + L.agg);
  void* WS = smem + L.ws;
  float* HIST = reinterpret_cast<float*>(smem + L.hist);
  float* SN = reinterpret_cast<float*>(smem + L.sn);
  float* ACT = reinterpret_cast<float*>(smem + L.act);
  float* REC = reinterpret_cast<float*>(smem + L.rec);
  float* VALID = reinterpret_cast<float*>(smem + L.valid);
  float* RED = reinterpret_cast<float*>(smem + L.red);
  int* CNT = reinterpret_cast<int*>(smem + L.cnt);
  int* OFF = reinterpret_cast<int*>(smem + L.off);
  short* NBR = reinterpret_cast<short*>(smem + L.nbr);
  short* ER = reinterpret_cast<short*>(smem + L.er);

  constexpr int kThr = Cfg<T>::kThreads, kWrp = kThr / 32;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int Np = d.Np, N = d.N, n_p = d.n_p, K = d.K, n_his = d.n_his, nf = d.nf_e;
  const int nh3 = n_his * 3, frame = Np * 3, n_slots = n_his + 1;
  const int npr = round_to(Np, Cfg<T>::kRowPad);
  const int dpk = round_to(d.Dp, Cfg<T>::kPad), rink = round_to(d.rel_in, Cfg<T>::kPad);
  // row strides of the shared-memory matrices
  const int ld_in = ldp<T>(dpk), ld_p = ldp<T>(d.nf_p), ld_r = ldp<T>(d.nf_r);
  const int ld_e = ldp<T>(nf), ld_rel = ldp<T>(rink), ld_rs = ldp<T>(2 * nf);
  const T* const* W = reinterpret_cast<const T* const*>(p.w);
  const T* pin = static_cast<const T*>(p.pin) + (size_t)b * Np * d.Dp;
  const float* sa = p.sa + (size_t)b * Np * 6;
  T* relbase = static_cast<T*>(p.relbase) + (size_t)b * Np * K * nf;
  T* penc = static_cast<T*>(p.penc) + (size_t)b * Np * nf;
  // the propagator's constant term: in shared memory in bf16, in the
  // global scratch in float32 (whose shared-memory budget is spent)
  T* PB = sizeof(T) == 2 ? reinterpret_cast<T*>(smem + L.pb)
                         : static_cast<T*>(p.pbase) + (size_t)b * Np * nf;
  const int ld_pb = sizeof(T) == 2 ? ldp<T>(nf) : nf;
  PhaseClock clk(p, b);

  // ---- inputs: validity, history (every frame = state0), action, record ----
  for (int i = tid; i < Np; i += kThr) VALID[i] = p.valid[(size_t)b * Np + i];
  for (int idx = tid; idx < frame; idx += kThr) {
    const int r = idx / 3, c = idx % 3;
    const float s0 = sa[r * 6 + c];
    for (int h = 0; h < n_his; ++h) HIST[h * frame + idx] = s0;
    ACT[idx] = sa[r * 6 + 3 + c];
    if (r < n_p) REC[idx] = s0;
  }
  for (int idx = tid; idx < npr * dpk; idx += kThr) {
    const int r = idx / dpk, c = idx % dpk;
    store(AGG, r * ld_in + c, (r < Np && c < d.Dp) ? load(pin, (size_t)r * d.Dp + c) : 0.f);
  }
  __syncthreads();

  // ---- once per push: particle encoder and the propagator's constant term ----
  {
    T* H1 = R;
    T* H2 = R + npr * ld_p;
    const T *w0 = W[0], *b0 = W[1], *w1 = W[2], *b1 = W[3], *w2 = W[4], *b2 = W[5];
    matmul(AGG, ld_in, N, d.Dp, w0, d.nf_p, b0, d.nf_p, WS, true, [&](int r, int c, float a) {
      store(H1, r * ld_p + c, rnd<T>(fmaxf(a, 0.f)));
    });
    matmul(H1, ld_p, N, d.nf_p, w1, d.nf_p, b1, d.nf_p, WS, true, [&](int r, int c, float a) {
      store(H2, r * ld_p + c, rnd<T>(fmaxf(a, 0.f)));
    });
    matmul(H2, ld_p, N, d.nf_p, w2, nf, b2, nf, WS, true, [&](int r, int c, float a) {
      const float v = rnd<T>(fmaxf(a, 0.f));
      store(EFF, r * ld_e + c, v);
      store(penc, (size_t)r * nf + c, v);
    });
    const T *wa = W[15], *bp = W[17];
    matmul(EFF, ld_e, N, nf, wa, nf, bp, nf, WS, true, [&](int r, int c, float a) {
      store(PB, (size_t)r * ld_pb + c, rnd<T>(a));
    });
  }
  clk.mark(kEncoder);

  const int rep = p.repeat[b];
  const int rmax = min(rep, p.max_repeat);
  int start = 0;  // ring slot of the oldest history frame
  for (int ai = 1; ai <= rmax; ++ai) {
    const float* last = HIST + ((start + n_his - 1) % n_slots) * frame;
    float* nxt = HIST + ((start + n_his) % n_slots) * frame;

    // ---- history features ----
    for (int idx = tid; idx < Np * nh3; idx += kThr) {
      const int i = idx / nh3, q = idx % nh3, h = q / 3, c = q % 3;
      float v;
      if (h < n_his - 1) {
        const float* f0 = HIST + ((start + h) % n_slots) * frame;
        const float* f1 = HIST + ((start + h + 1) % n_slots) * frame;
        v = __fsub_rn(f1[i * 3 + c], f0[i * 3 + c]);
      } else {
        v = last[i * 3 + c];
      }
      SN[idx] = rnd<T>(v);
    }

    // ---- radius-and-topk graph (edge_build.cuh), compacted by receiver ----
    edges::radius_topk(last, VALID, Np, N, n_p, K, p.thresh, NBR, CNT);
    const int E = edges::compact_edges(CNT, NBR, Np, K, OFF, ER, nullptr);
    clk.mark(kGraph);

    // ---- relation encoder + rel_base over real edges ----
    if constexpr (sizeof(T) == 2) {
      const EdgeGraph g{E, K, n_p, N, d.rel_in, nh3, ER, NBR, OFF, VALID, SN};
      relation_mlp_tc<kTcWidth>(g, reinterpret_cast<const bf16* const*>(p.w),
                                static_cast<bf16*>(WS), reinterpret_cast<bf16*>(R),
                                reinterpret_cast<bf16*>(relbase));
    } else {
      // CUDA cores: one tile of edges at a time through four matmuls
      constexpr int et = kEdgeTile;
      const int rw = imax(imax(imax(d.nf_p, d.nf_r), nf), rink);
      T* A = R;
      T* Bf = R + et * ldp<T>(rw);
      const T *w0 = W[6], *b0 = W[7], *w1 = W[8], *b1 = W[9], *w2 = W[10], *b2 = W[11];
      const T *w3 = W[12], *b3 = W[14];
      for (int e0 = 0; e0 < E; e0 += et) {
        const int ne = min(et, E - e0);
        for (int idx = tid; idx < et * rink; idx += kThr) {
          const int r = idx / rink, f = idx % rink;
          float v = 0.f;
          if (r < ne && f < d.rel_in) {
            const int e = e0 + r, i = ER[e], j = NBR[i * K + (e - OFF[i])];
            const float oi = (i < n_p) ? VALID[i] : 0.f, oj = (j < n_p) ? VALID[j] : 0.f;
            if (f == 0) v = oi;
            else if (f == 1) v = (i >= n_p && i < N) ? 1.f : 0.f;
            else if (f == 2) v = oj;
            else if (f == 3) v = (j >= n_p && j < N) ? 1.f : 0.f;
            else if (f == 4) v = fabsf(oi - oj);
            else v = SN[i * nh3 + f - 5] - SN[j * nh3 + f - 5];
          }
          store(A, r * ld_rel + f, v);
        }
        __syncthreads();
        matmul(A, ld_rel, ne, d.rel_in, w0, d.nf_r, b0, d.nf_r, WS, true, [&](int r, int c, float a) {
          store(Bf, r * ld_r + c, fmaxf(a, 0.f));
        });
        matmul(Bf, ld_r, ne, d.nf_r, w1, d.nf_r, b1, d.nf_r, WS, true, [&](int r, int c, float a) {
          store(A, r * ld_r + c, fmaxf(a, 0.f));
        });
        matmul(A, ld_r, ne, d.nf_r, w2, nf, b2, nf, WS, true, [&](int r, int c, float a) {
          store(Bf, r * ld_e + c, fmaxf(a, 0.f));
        });
        matmul(Bf, ld_e, ne, nf, w3, nf, b3, nf, WS, true, [&](int r, int c, float a) {
          store(relbase, (size_t)(e0 + r) * nf + c, a);
        });
      }
    }
    clk.mark(kRelation);

    // ---- pstep rounds of message passing ----
    constexpr int V = 16 / sizeof(T);  // channels per 16-byte vector
    const int nv = nf / V;
    for (int idx = tid; idx < N * nv; idx += kThr) {
      const int r = idx / nv, c0 = (idx % nv) * V;
      *reinterpret_cast<uint4*>(EFF + r * ld_e + c0) =
          *reinterpret_cast<const uint4*>(penc + (size_t)r * nf + c0);
    }
    __syncthreads();
    {
      const int agg_rows = agg_tile_rows<T>(npr);
      T* RS = R;  // (N, 2nf): [recv | send] projections
      const T *w23 = W[13], *wb = W[16];
      for (int s = 0; s < d.pstep; ++s) {
        // recv and send projections, one (nf, nf) product each
        for (int h = 0; h < 2; ++h) {
          matmul(EFF, ld_e, N, nf, w23 + h * nf, 2 * nf, (const T*)nullptr, nf, WS, true,
                 [&](int r, int c, float a) { store(RS, r * ld_rs + h * nf + c, rnd<T>(a)); });
        }
        clk.mark(kProjection);
        for (int i0 = 0; i0 < N; i0 += agg_rows) {
          const int nr = min(agg_rows, N - i0);
          // agg[i] = sum over i's edges of relu(rel_base[e] + recv[i] + send[j]),
          // V channels per thread, one 16-byte load of each operand per edge
          for (int idx = tid; idx < nr * nv; idx += kThr) {
            const int r = idx / nv, c0 = (idx % nv) * V, i = i0 + r;
            float acc[V];
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] = 0.f;
            const int ebeg = OFF[i], eend = OFF[i + 1];
            if constexpr (sizeof(T) == 2) {
              // bf16x2 adds round once, as rnd(float(a) + float(b)) does for bf16 inputs
              const uint4 recv = *reinterpret_cast<const uint4*>(RS + i * ld_rs + c0);
              const __nv_bfloat162* rv = reinterpret_cast<const __nv_bfloat162*>(&recv);
              const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
#pragma unroll 4
              for (int e = ebeg; e < eend; ++e) {
                const int j = NBR[i * K + (e - ebeg)];
                const uint4 rb = *reinterpret_cast<const uint4*>(relbase + (size_t)e * nf + c0);
                const uint4 sd = *reinterpret_cast<const uint4*>(RS + j * ld_rs + nf + c0);
                const __nv_bfloat162* rbv = reinterpret_cast<const __nv_bfloat162*>(&rb);
                const __nv_bfloat162* sdv = reinterpret_cast<const __nv_bfloat162*>(&sd);
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const float2 f = __bfloat1622float2(
                      __hmax2(__hadd2(__hadd2(rbv[q], rv[q]), sdv[q]), zero));
                  acc[2 * q] += f.x;
                  acc[2 * q + 1] += f.y;
                }
              }
            } else {
              float recv[V];
              load_vec(RS + i * ld_rs + c0, recv);
#pragma unroll 4
              for (int e = ebeg; e < eend; ++e) {
                const int j = NBR[i * K + (e - ebeg)];
                float rb[V], sd[V];
                load_vec(relbase + (size_t)e * nf + c0, rb);
                load_vec(RS + j * ld_rs + nf + c0, sd);
#pragma unroll
                for (int v = 0; v < V; ++v) acc[v] += fmaxf(rb[v] + recv[v] + sd[v], 0.f);
              }
            }
#pragma unroll
            for (int v = 0; v < V; ++v) store(AGG, r * ld_e + c0 + v, rnd<T>(acc[v]));
          }
          __syncthreads();
          clk.mark(kAggregate);
          // Wb is staged once per round, by the first tile
          matmul(AGG, ld_e, nr, nf, wb, nf, (const T*)nullptr, nf, WS, i0 == 0, [&](int r, int c, float a) {
            const int i = i0 + r;
            float t = rnd<T>(load(PB, (size_t)i * ld_pb + c) + rnd<T>(a));
            t = rnd<T>(t + load(EFF, i * ld_e + c));
            store(EFF, i * ld_e + c, fmaxf(t, 0.f));
          });
          clk.mark(kUpdate);
        }
      }
    }

    // ---- motion head on the object rows, clamp, predicted positions ----
    {
      T* H1 = R;
      T* H2 = R + npr * ld_e;
      const T *w0 = W[18], *b0 = W[19], *w1 = W[20], *b1 = W[21], *w2 = W[22], *b2 = W[23];
      const float mc = p.motion_clamp;
      matmul(EFF, ld_e, n_p, nf, w0, nf, b0, nf, WS, true, [&](int r, int c, float a) {
        store(H1, r * ld_e + c, rnd<T>(fmaxf(a, 0.f)));
      });
      matmul(H1, ld_e, n_p, nf, w1, nf, b1, nf, WS, true, [&](int r, int c, float a) {
        store(H2, r * ld_e + c, rnd<T>(fmaxf(a, 0.f)));
      });
      matmul(H2, ld_e, n_p, nf, w2, 3, b2, 3, WS, true, [&](int r, int c, float a) {
        const float m = rnd<T>(a);
        nxt[r * 3 + c] = __fadd_rn(last[r * 3 + c], fminf(fmaxf(m, -mc), mc));
      });
    }
    clk.mark(kHead);

    // ---- record at this sample's repeat; re-stick the eef rows ----
    float ymin = kBig, ysum = 0.f, ycnt = 0.f;
    for (int r = tid; r < n_p; r += kThr) {
      if (ai == rep) {
        REC[r * 3 + 0] = nxt[r * 3 + 0];
        REC[r * 3 + 1] = nxt[r * 3 + 1];
        REC[r * 3 + 2] = nxt[r * 3 + 2];
      }
      if (VALID[r] > 0.f) {
        ymin = fminf(ymin, nxt[r * 3 + 1]);
        ysum += nxt[r * 3 + 1];
        ycnt += 1.f;
      }
    }
    block_min_sum_count<kWrp>(ymin, ysum, ycnt, RED);
    const float y = (p.mean_y ? ysum / fmaxf(ycnt, 1.f) : ymin) + p.gripper_lift;
    for (int i = n_p + tid; i < Np; i += kThr) {
      if (i < N) {
        nxt[i * 3 + 0] = __fadd_rn(last[i * 3 + 0], ACT[i * 3 + 0]);
        nxt[i * 3 + 1] = y;
        nxt[i * 3 + 2] = __fadd_rn(last[i * 3 + 2], ACT[i * 3 + 2]);
      } else {
        nxt[i * 3 + 0] = nxt[i * 3 + 1] = nxt[i * 3 + 2] = 0.f;
      }
    }
    start = (start + 1) % n_slots;
    __syncthreads();
    clk.mark(kRestick);
  }

  for (int idx = tid; idx < n_p * 3; idx += kThr) p.out[(size_t)b * n_p * 3 + idx] = REC[idx];
}

template <typename T>
int launch(const Params& p, int B, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)make_layout<T>(p.d).total;
  err = cudaFuncSetAttribute(rollout_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) rollout_chunk_kernel<T><<<B, Cfg<T>::kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rollout_chunk_smem_bytes(int Np, int N, int n_p, int K, int n_his, int pstep, int Dp,
                             int nf_p, int nf_r, int nf_e, int rel_in, int bf16_mode) {
  const Dims d{Np, N, n_p, K, n_his, pstep, Dp, nf_p, nf_r, nf_e, rel_in};
  return bf16_mode ? make_layout<bf16>(d).total : make_layout<float>(d).total;
}

const char* rollout_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef ROLLOUT_PHASE_CLOCKS
// Profiling build only: `clocks`, when not null, is a zeroed (B, 8) int64
// buffer on the card into which the following launches add each block's SM
// cycles per phase (encoder, graph, relation, projection, aggregate, update,
// head, restick).
void rollout_chunk_set_phase_clocks(void* clocks) {
  g_phase_clocks = static_cast<long long*>(clocks);
}
#endif

// Launch on `stream` without synchronising; returns cudaGetLastError().
int rollout_chunk_launch(const void* pin, const void* sa, const void* repeat, const void* valid,
                         const void* const* weights, void* relbase, void* penc, void* pbase,
                         void* out, int B, int Np, int N, int n_p, int K, int n_his, int pstep,
                         int Dp, int nf_p, int nf_r, int nf_e, int rel_in, float thresh,
                         float gripper_lift, float motion_clamp, int max_repeat, int mean_y,
                         int bf16_mode, int device, void* stream) {
  Params p;
  p.pin = pin;
  p.sa = static_cast<const float*>(sa);
  p.repeat = static_cast<const int*>(repeat);
  p.valid = static_cast<const float*>(valid);
  for (int i = 0; i < kNumWeights; ++i) p.w[i] = weights[i];
  p.relbase = relbase;
  p.penc = penc;
  p.pbase = pbase;
  p.out = static_cast<float*>(out);
#ifdef ROLLOUT_PHASE_CLOCKS
  p.clocks = g_phase_clocks;
#endif
  p.d = Dims{Np, N, n_p, K, n_his, pstep, Dp, nf_p, nf_r, nf_e, rel_in};
  p.thresh = thresh;
  p.gripper_lift = gripper_lift;
  p.motion_clamp = motion_clamp;
  p.max_repeat = max_repeat;
  p.mean_y = mean_y;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_mode ? launch<bf16>(p, B, device, s) : launch<float>(p, B, device, s);
}

}  // extern "C"
