// Whole-push GNN rollout for one MPPI chunk, one thread block per sample.
//
// Replaces the TPU kernel adaptigraph_tpu/ops/fused_gnn.py::_rollout_kernel
// (launched by fused_rollout_chunk). For each sample the block runs the push's
// substeps up to the sample's own repeat count (a sample's record cannot change
// after it): shift the n_his history, rebuild the radius-and-topk graph from the
// newest frame, run the relation encoder, pstep rounds of message passing and
// the motion head, record the prediction at the sample's repeat, and re-stick
// the end-effector rows to the min (or masked mean) object y plus the gripper
// lift. The particle encoder, the propagator's constant term and the first
// round's recv|send projections depend only on the push's constant inputs and
// run once per push.
//
// What bounds it on an H100: arithmetic. At rope width (N 101, K 10, nf 128)
// a substep is ~72 M multiply-adds per sample, almost all in the relation MLP
// over the edge rows, against a few KB of inputs per sample. One block runs a
// sample on one SM, so what keeps an SM's tensor cores waiting is latency:
// weight staging, barriers, and loads of the edge-sized relation base.
//
// What the design does about it (bf16, the main path; 512 threads = four
// warpgroups, ~213 KB of shared memory, one block per SM):
// - Every product with 128 columns runs on wgmma (m64n128k16 and m64n64k16
//   bf16, float32 accumulators; mma.cuh) with both operands in 128-byte
//   swizzled shared memory: B the layer's weight, packed as W^T in PyTorch
//   (ops/fused_gnn.py::pack_tc_weights) and staged by cp.async, read once
//   per product by each warpgroup. A product's k-steps are issued back to
//   back and waited for once.
// - The relation MLP: each warpgroup owns 64 edge rows of a 256-edge tile
//   and carries them through the relation encoder's three layers and the
//   rel_base layer in its own 64 x 128 activation tile (after bias, relu and
//   rounding to bf16, a layer's accumulators become the next layer's A),
//   with only warpgroup barriers. The four layers' weights (112 KB swizzled)
//   stay resident for all of a substep's tiles; they are staged while the
//   previous substep's head, re-stick and graph build run.
// - Node-sized products (particle encoder, propagator base, recv|send as one
//   256-column product, update, motion head): 112 padded rows split into
//   64 x 64 (or 64 x 128) tiles over the four warpgroups. Each product's
//   weight is prefetched while the phase before it runs: recv|send's and
//   the head's during the previous update, Wb during the first aggregation.
// - Round 1's recv|send is a constant of the push (the effect starts every
//   substep from the particle encoding): it is computed once per push into a
//   per-sample scratch and copied back by cp.async each substep.
// - The aggregation: 32 threads per receiver, each summing four channels
//   over the receiver's edges in slot order; rel_base's rows are read from
//   global memory (L2), 256 contiguous bytes per edge.
// - The motion head's 3-wide last layer and the particle encoder's first
//   layer (a few inputs) run on the CUDA cores.
// - Only real edges are computed. A receiver's edges are a prefix of its
//   top-k slots (the selected distances ascend), so the edge list is compacted
//   with a prefix sum and the relation MLP runs on real edges only; masked
//   slots add exact zeros in the JAX kernel and are skipped here.
// - The edge-sized rel_base (E x nf, 266 KB in bf16 at rope width) does not fit
//   in shared memory. It is written once per substep to a scratch buffer in
//   global memory and read in each of the pstep rounds. The wrapper allocates
//   it (B*Np*K*nf values), the per-push particle encoding and propagator base
//   (B*Np*nf each) and, in bf16, round 1's recv|send (B*Np*2nf).
// Activations are kept in bf16, which is exact: the JAX kernel rounds every
// layer's output to bf16, and so does this one, at the same places.
//
// float32 (the parity mode, off the main path) runs the same steps on the
// CUDA cores with a register-tiled matmul (256 threads; ~200 KB of shared
// memory at rope width, ~216 KB at granular width).
//
// The graph is edge_build.cuh's, shared with gnn_forward.cu: distances equal
// the plain version's bit for bit, ties go to the smallest sender index.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "device_guard.cuh"
#include "edge_build.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;                          // float32 blocks (CUDA-core matmul)
constexpr int kWarps = kThreads / 32;
constexpr int kTcThreads = 512;                        // bf16 blocks: four warpgroups
constexpr int kRowsPerThread = 8;                      // CUDA-core matmul: rows per warp and tile
constexpr int kTileRows = kWarps * kRowsPerThread;     // 64 rows per CUDA-core matmul tile
constexpr int kColBlock = 128;                         // 32 lanes x 4 adjacent columns
constexpr int kKChunk = 16;                            // weight rows staged at a time (f32)
constexpr int kEdgeTile = 64;                          // edge rows per relation tile (f32)
constexpr int kNumWeights = 24;
constexpr int kNumTc = 11;                             // packed tensor-core layers (bf16)
// Phases timed in the profiling build (see PhaseClock).
enum Phase { kEncoder, kGraph, kRelation, kProjection, kAggregate, kUpdate, kHead, kRestick,
             kPhases };
constexpr float kBig = 1e10f;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Cfg;
template <> struct Cfg<float> {
  static constexpr int kThreads = ::kThreads;
  static constexpr int kPad = 4;  // column padding of matmul inputs (a float4 load)
};
template <> struct Cfg<bf16> {
  static constexpr int kThreads = kTcThreads;
};
// float32: receivers aggregated before each propagator update
constexpr int kAggTileRows = 16;

struct Dims {
  int Np, N, n_p, K, n_his, pstep, Dp, nf_p, nf_r, nf_e, rel_in;
};

__host__ __device__ inline int round_to(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// ---- float32 shared-memory layout in bytes; every region 128-byte aligned ----
struct Layout {
  int R, eff, agg, ws, hist, sn, act, rec, valid, red, cnt, off, nbr, er, total;
};

__host__ __device__ inline Layout make_layout(const Dims& d) {
  constexpr int es = 4, pad = Cfg<float>::kPad;
  const int npr = d.Np;
  const int nfa = imax(imax(d.nf_p, d.nf_r), d.nf_e);
  const int rw = imax(nfa, round_to(d.rel_in, pad));
  int r_bytes = 2 * kEdgeTile * rw * es;                 // ping-pong edge tiles
  r_bytes = imax(r_bytes, npr * 2 * d.nf_e * es);        // recv|send projections
  r_bytes = imax(r_bytes, 2 * npr * nfa * es);           // hidden layers
  const int sizes[] = {
      r_bytes,                                                        // R
      npr * d.nf_e * es,                                              // eff
      imax(kAggTileRows * d.nf_e, npr * round_to(d.Dp, pad)) * es,    // agg; inputs
      kKChunk * kColBlock * 4,                                        // ws: a weight chunk
      (d.n_his + 1) * d.Np * 3 * 4,                                   // hist: ring of n_his+1
      d.Np * d.n_his * 3 * 4,                                         // sn
      d.Np * 3 * 4,                                                   // act
      d.n_p * 3 * 4,                                                  // rec
      d.Np * 4,                                                       // valid
      3 * kWarps * 4,                                                 // red
      d.Np * 4,                                                       // cnt
      (d.Np + 1) * 4,                                                 // off
      d.Np * d.K * 2,                                                 // nbr: int16 senders
      d.Np * d.K * 2,                                                 // er: int16 receivers
  };
  int starts[14];
  int at = 0;
  for (int i = 0; i < 14; ++i) { starts[i] = at; at += round_to(sizes[i], 128); }
  Layout L;
  L.R = starts[0]; L.eff = starts[1]; L.agg = starts[2]; L.ws = starts[3];
  L.hist = starts[4]; L.sn = starts[5]; L.act = starts[6]; L.rec = starts[7];
  L.valid = starts[8]; L.red = starts[9]; L.cnt = starts[10]; L.off = starts[11];
  L.nbr = starts[12]; L.er = starts[13];
  L.total = at;
  return L;
}

// ---- bf16 shared-memory layout ----
//
// Widths are kNF (the wrapper checks nf_particle = nf_relation = nf_effect =
// 128). From a 1,024-aligned base: X (64 KB) and WB (32 KB), the swizzled
// weights; EFF and AGG (32 KB each), the node-sized A operands, 128 rows
// (two 64-row tiles; rows past N are never written and feed only dropped
// outputs) swizzled as the weights are (sw()); then STG (re0's weight, or
// the propagator base), and the small state. What each big region holds in
// each phase:
//   phase            X                     WB      STG           EFF      AGG
//   encoder          pe1 | pe2, then w23   Wa      -             h1, penc h2
//   relation MLP     re1 | re2             rp_w1   re0           the warpgroups'
//                                                                64-row A tiles
//   round s          recv|send (RS), then  Wb      PB            effect   agg
//                    the next round's w23
//                    (last round: nr0|nr1)
//   head             nr0 | nr1, then the   -       -             h2       h1
//                    next substep's relation weights (WB and STG too)
constexpr int kNF = 128;
constexpr int kWBytes = kNF * kNF * 2;            // one swizzled 128 x 128 matrix
constexpr int kCPT = 4;                           // aggregation: channels per thread
constexpr int kTPR = kNF / kCPT;                  // threads per receiver
constexpr int kRecvPerPass = kTcThreads / kTPR;
// kCPT adjacent bf16 channels, loaded and stored at once
struct alignas(kCPT * 2) Channels {
  __nv_bfloat162 v[kCPT / 2];
};
// float slots of the BIAS region: the biases (kNF each), then the head's last
// layer's bias (3, padded to 4) and weight (kNF x 3)
enum BiasSlot { kBpe0 = 0, kBpe1 = kNF, kBpe2 = 2 * kNF, kBre0 = 3 * kNF, kBrp = 6 * kNF,
                kBpp = 7 * kNF, kBnr0 = 8 * kNF, kBnr1 = 9 * kNF, kBnr2 = 10 * kNF,
                kWnr2 = 10 * kNF + 4, kBiasFloats = kWnr2 + 3 * kNF };
// packed tensor-core layers, in the order of ops/fused_gnn.py::TC_LAYERS
enum TcLayer { kPe1, kPe2, kRe1, kRe2, kRpW1, kRpW23, kPpWa, kPpWb, kNr0, kNr1, kRe0 };

struct TcLayout {
  int X, WB, eff, agg, STG, bias, hist, sn, act, rec, valid, red, cnt, off, nbr, er;
  int total;  // bytes to request, the 1,024 of the base's alignment included
};

__host__ __device__ inline TcLayout make_tc_layout(const Dims& d) {
  const int sizes[] = {
      kBiasFloats * 4,                  // bias
      (d.n_his + 1) * d.Np * 3 * 4,     // hist: ring of n_his+1
      d.Np * d.n_his * 3 * 4,           // sn
      d.Np * 3 * 4,                     // act
      d.n_p * 3 * 4,                    // rec
      d.Np * 4,                         // valid
      3 * (kTcThreads / 32) * 4,        // red
      d.Np * 4,                         // cnt
      (d.Np + 1) * 4,                   // off
      d.Np * d.K * 2,                   // nbr: int16 senders
      d.Np * d.K * 2,                   // er: int16 receivers
  };
  TcLayout L;
  L.X = 0;
  L.WB = 2 * kWBytes;
  L.eff = 3 * kWBytes;
  L.agg = 4 * kWBytes;
  L.STG = 5 * kWBytes;  // re0's weight (16 KB) or the propagator base
  int at = L.STG + round_to(imax(kWBytes / 2, d.Np * kNF * 2), 1024);
  int* dst[] = {&L.bias, &L.hist, &L.sn, &L.act, &L.rec, &L.valid, &L.red, &L.cnt, &L.off,
                &L.nbr, &L.er};
  for (int i = 0; i < 11; ++i) { *dst[i] = at; at += round_to(sizes[i], 128); }
  L.total = at + 1024;
  return L;
}

struct Params {
  const void* pin;       // (B, Np, Dp) compute dtype: [attrs | phys | action]
  const float* sa;       // (B, Np, 6): [state0 | action]
  const int* repeat;     // (B,)
  const float* valid;    // (B, Np)
  const void* w[kNumWeights];
  const void* tcw[kNumTc];  // bf16: the packed W^T of the tensor-core layers
  void* relbase;         // scratch (B, Np*K, nf_e)
  void* penc;            // scratch (B, Np, nf_e)
  void* pbase;           // scratch (B, Np, nf_e)
  void* rs1;             // scratch (B, Np, 2 nf_e), bf16 only (else null)
  float* out;            // (B, n_p, 3)
#ifdef ROLLOUT_PHASE_CLOCKS
  long long* clocks;     // (B, kPhases) SM cycles per phase, or null
#endif
  Dims d;
  float thresh, gripper_lift, motion_clamp;
  int max_repeat, mean_y;
};

__device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ void store(float* p, size_t i, float v) { p[i] = v; }

// 16 bytes (4 float values) at p, which is 16-byte aligned.
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
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
// thread of the block calls it.
template <typename Epi>
__device__ void matmul(const float* X, int ldx, int M, int Kin, const float* W, int ldw,
                       const float* bias, int Nout, void* ws, Epi epi) {
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


// ---- the steps both compute dtypes share ----

// Validity, the history (every frame = state0), the action and the record.
// Every thread calls it; the caller synchronises.
template <int kThr>
__device__ inline void load_inputs(const Params& p, int b, float* VALID, float* HIST, float* ACT,
                                   float* REC) {
  const Dims& d = p.d;
  const int Np = d.Np, frame = Np * 3;
  const float* sa = p.sa + (size_t)b * Np * 6;
  for (int i = threadIdx.x; i < Np; i += kThr) VALID[i] = p.valid[(size_t)b * Np + i];
  for (int idx = threadIdx.x; idx < frame; idx += kThr) {
    const int r = idx / 3, c = idx % 3;
    const float s0 = sa[r * 6 + c];
    for (int h = 0; h < d.n_his; ++h) HIST[h * frame + idx] = s0;
    ACT[idx] = sa[r * 6 + 3 + c];
    if (r < d.n_p) REC[idx] = s0;
  }
}

// The history features of the newest n_his frames (ring slot `start` the
// oldest), rounded to the compute dtype T. No barrier.
template <typename T, int kThr>
__device__ inline void history_features(const Dims& d, const float* HIST, int start, float* SN) {
  const int n_his = d.n_his, nh3 = n_his * 3, frame = d.Np * 3, n_slots = n_his + 1;
  const float* last = HIST + ((start + n_his - 1) % n_slots) * frame;
  for (int idx = threadIdx.x; idx < d.Np * nh3; idx += kThr) {
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
}

// Record the predicted object rows of nxt at this sample's repeat, and
// re-stick the eef rows of nxt to the min (or masked mean) object y plus the
// gripper lift. Every thread calls it; it ends with a barrier.
template <int kThr>
__device__ inline void record_restick(const Params& p, int ai, int rep, const float* last,
                                      float* nxt, const float* VALID, const float* ACT, float* REC,
                                      float* RED) {
  const int n_p = p.d.n_p, N = p.d.N, Np = p.d.Np, tid = threadIdx.x;
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
  block_min_sum_count<kThr / 32>(ymin, ysum, ycnt, RED);
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
  __syncthreads();
}

// ---- float32: the CUDA cores ----

__device__ __forceinline__ void rollout_f32(const Params& p, unsigned char* smem) {
  using T = float;
  const Dims d = p.d;
  const Layout L = make_layout(d);
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

  constexpr int kThr = kThreads;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int Np = d.Np, N = d.N, n_p = d.n_p, K = d.K, n_his = d.n_his, nf = d.nf_e;
  const int nh3 = n_his * 3, frame = Np * 3, n_slots = n_his + 1;
  const int npr = Np;
  const int dpk = round_to(d.Dp, Cfg<T>::kPad), rink = round_to(d.rel_in, Cfg<T>::kPad);
  // row strides of the shared-memory matrices
  const int ld_in = dpk, ld_p = d.nf_p, ld_r = d.nf_r;
  const int ld_e = nf, ld_rel = rink, ld_rs = 2 * nf;
  const T* const* W = reinterpret_cast<const T* const*>(p.w);
  const T* pin = static_cast<const T*>(p.pin) + (size_t)b * Np * d.Dp;
  T* relbase = static_cast<T*>(p.relbase) + (size_t)b * Np * K * nf;
  T* penc = static_cast<T*>(p.penc) + (size_t)b * Np * nf;
  // the propagator's constant term, in the global scratch (the shared-memory
  // budget is spent)
  T* PB = static_cast<T*>(p.pbase) + (size_t)b * Np * nf;
  const int ld_pb = nf;
  PhaseClock clk(p, b);

  // ---- inputs: validity, history (every frame = state0), action, record ----
  load_inputs<kThr>(p, b, VALID, HIST, ACT, REC);
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
    matmul(AGG, ld_in, N, d.Dp, w0, d.nf_p, b0, d.nf_p, WS, [&](int r, int c, float a) {
      store(H1, r * ld_p + c, rnd<T>(fmaxf(a, 0.f)));
    });
    matmul(H1, ld_p, N, d.nf_p, w1, d.nf_p, b1, d.nf_p, WS, [&](int r, int c, float a) {
      store(H2, r * ld_p + c, rnd<T>(fmaxf(a, 0.f)));
    });
    matmul(H2, ld_p, N, d.nf_p, w2, nf, b2, nf, WS, [&](int r, int c, float a) {
      const float v = rnd<T>(fmaxf(a, 0.f));
      store(EFF, r * ld_e + c, v);
      store(penc, (size_t)r * nf + c, v);
    });
    const T *wa = W[15], *bp = W[17];
    matmul(EFF, ld_e, N, nf, wa, nf, bp, nf, WS, [&](int r, int c, float a) {
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

    history_features<T, kThr>(d, HIST, start, SN);

    // ---- radius-and-topk graph (edge_build.cuh), compacted by receiver ----
    edges::radius_topk(last, VALID, Np, N, n_p, K, p.thresh, NBR, CNT);
    const int E = edges::compact_edges(CNT, NBR, Np, K, OFF, ER, nullptr);
    clk.mark(kGraph);

    // ---- relation encoder + rel_base over real edges, one tile of edges at
    // a time through four matmuls ----
    {
      constexpr int et = kEdgeTile;
      const int rw = imax(imax(imax(d.nf_p, d.nf_r), nf), rink);
      T* A = R;
      T* Bf = R + et * rw;
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
        matmul(A, ld_rel, ne, d.rel_in, w0, d.nf_r, b0, d.nf_r, WS, [&](int r, int c, float a) {
          store(Bf, r * ld_r + c, fmaxf(a, 0.f));
        });
        matmul(Bf, ld_r, ne, d.nf_r, w1, d.nf_r, b1, d.nf_r, WS, [&](int r, int c, float a) {
          store(A, r * ld_r + c, fmaxf(a, 0.f));
        });
        matmul(A, ld_r, ne, d.nf_r, w2, nf, b2, nf, WS, [&](int r, int c, float a) {
          store(Bf, r * ld_e + c, fmaxf(a, 0.f));
        });
        matmul(Bf, ld_e, ne, nf, w3, nf, b3, nf, WS, [&](int r, int c, float a) {
          store(relbase, (size_t)(e0 + r) * nf + c, a);
        });
      }
    }
    clk.mark(kRelation);

    // ---- pstep rounds of message passing ----
    constexpr int V = 4;  // channels per 16-byte vector
    const int nv = nf / V;
    for (int idx = tid; idx < N * nv; idx += kThr) {
      const int r = idx / nv, c0 = (idx % nv) * V;
      *reinterpret_cast<uint4*>(EFF + r * ld_e + c0) =
          *reinterpret_cast<const uint4*>(penc + (size_t)r * nf + c0);
    }
    __syncthreads();
    {
      const int agg_rows = kAggTileRows;
      T* RS = R;  // (N, 2nf): [recv | send] projections
      const T *w23 = W[13], *wb = W[16];
      for (int s = 0; s < d.pstep; ++s) {
        // recv and send projections, one (nf, nf) product each
        for (int h = 0; h < 2; ++h) {
          matmul(EFF, ld_e, N, nf, w23 + h * nf, 2 * nf, (const T*)nullptr, nf, WS,
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
#pragma unroll
            for (int v = 0; v < V; ++v) store(AGG, r * ld_e + c0 + v, rnd<T>(acc[v]));
          }
          __syncthreads();
          clk.mark(kAggregate);
          matmul(AGG, ld_e, nr, nf, wb, nf, (const T*)nullptr, nf, WS, [&](int r, int c, float a) {
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
      matmul(EFF, ld_e, n_p, nf, w0, nf, b0, nf, WS, [&](int r, int c, float a) {
        store(H1, r * ld_e + c, rnd<T>(fmaxf(a, 0.f)));
      });
      matmul(H1, ld_e, n_p, nf, w1, nf, b1, nf, WS, [&](int r, int c, float a) {
        store(H2, r * ld_e + c, rnd<T>(fmaxf(a, 0.f)));
      });
      matmul(H2, ld_e, n_p, nf, w2, 3, b2, 3, WS, [&](int r, int c, float a) {
        const float m = rnd<T>(a);
        nxt[r * 3 + c] = __fadd_rn(last[r * 3 + c], fminf(fmaxf(m, -mc), mc));
      });
    }
    clk.mark(kHead);

    // ---- record at this sample's repeat; re-stick the eef rows ----
    record_restick<kThr>(p, ai, rep, last, nxt, VALID, ACT, REC, RED);
    start = (start + 1) % n_slots;
    clk.mark(kRestick);
  }

  for (int idx = tid; idx < n_p * 3; idx += kThr) p.out[(size_t)b * n_p * 3 + idx] = REC[idx];
}

// ---- bfloat16: the tensor cores ----

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.f); }

// The four warpgroups' asynchronous copies of the block (cp.async, mma.cuh).
// nbytes (a multiple of 16) contiguous bytes; not committed.
__device__ inline void copy_async(void* dst, const void* src, int nbytes) {
  for (int o = threadIdx.x * 16; o < nbytes; o += kTcThreads * 16)
    tc::cp_async16(static_cast<char*>(dst) + o, static_cast<const char*>(src) + o, true);
}

// Rows [0, R) of a packed W^T (row stride kp bf16, a multiple of 16) into
// ceil(kp / 64) blocks of R rows x 64 columns, 128-byte swizzled (mma.cuh):
// the K-major B operand of Y = X W. Not committed.
__device__ inline void stage_wt(bf16* dst, const bf16* P, int R, int kp) {
  const int cpr = kp / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < R * cpr; idx += kTcThreads) {
    const int r = idx / cpr, k8 = idx % cpr;
    tc::cp_async16(dst + (k8 >> 3) * R * 64 + r * 64 + (((k8 & 7) ^ (r & 7)) << 3),
                   P + (size_t)r * kp + k8 * 8, true);
  }
}

// Wait for every copy in flight, make it visible to wgmma's reads, and
// synchronise the block.
__device__ inline void wait_staged() {
  tc::cp_async_wait<0>();
  tc::fence_proxy_async();
  __syncthreads();
}

// Element (r, c) of an R x kNF matrix in the 128-byte swizzled layout of
// mma.cuh (64-column blocks of R rows; 16-byte chunk q of row r at q ^ r % 8).
__device__ __forceinline__ int sw(int r, int c, int R = 128) {
  return (c >> 6) * (R * 64) + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

// The descriptor of a K-major k16 slice (ks) at row r0 of a swizzled matrix
// of R rows (a staged W^T, or EFF / AGG with R = 128).
__device__ __forceinline__ uint64_t sw_desc(const bf16* m, int R, int r0, int ks) {
  return tc::desc_sw128(m + (ks >> 2) * R * 64 + r0 * 64 + (ks & 3) * 16, 16, 1024);
}
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  tc::wgmma_m64n64k16<0, 0>(d, da, db, acc);
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  tc::wgmma_m64n128k16_ss(d, da, db, acc);
}

// Y = X W for rows [0, M) (M <= 128) and columns [0, ncols): X one of the
// swizzled 128-row matrices (kNF columns), W^T staged by stage_wt (R rows =
// Y's columns). Tile (mt, nt) of 64 x TN outputs goes to warpgroup
// mt * (ncols / TN) + nt (at most four tiles), which issues its eight
// k-steps back to back (a warpgroup without a tile repeats one and drops
// it, so no wgmma is under a branch). Then every thread calls pre(); with
// `sync` a barrier follows (the epilogue may overwrite W or read what pre()
// waited for), and epi(r, c, y[r][c], y[r][c + 1]) receives each pair of adjacent
// outputs of the rows < M from the registers. Every thread calls it; what a
// thread wrote before it must be fenced for the async proxy (wait_staged, or
// the fence that ends node_product and aggregate); it ends with such a fence
// and a barrier.
template <int TN, typename Pre, typename Epi>
__device__ void node_product(const bf16* X, int M, const bf16* Wsw, int R, int ncols, bool sync,
                             Pre pre, Epi epi) {
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int ntn = ncols / TN, tiles = (M + 63) / 64 * ntn;
  const bool mine = wg < tiles;  // warpgroup-uniform
  const int t = wg % tiles, m0 = (t / ntn) * 64, n0 = (t % ntn) * TN;
  float acc[TN / 2];
  tc::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kNF / 16; ++ks)
    wgmma_ss(acc, sw_desc(X, 128, m0, ks), sw_desc(Wsw, R, n0, ks), ks > 0);
  tc::wgmma_commit();
  tc::wgmma_wait0();
  tc::fence_regs(acc);
  pre();
  if (sync) __syncthreads();
  if (mine) {
    const int r = m0 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int i = 0; i < TN / 2; i += 2) {
      const int m = r + 8 * ((i & 3) >> 1), n = n0 + 8 * (i >> 2) + 2 * (lane & 3);
      if (m < M) epi(m, n, acc[i], acc[i + 1]);
    }
  }
  tc::fence_proxy_async();
  __syncthreads();
}

struct LayerWeights {
  const bf16* w[4];
};

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

// a barrier of the 128 threads of warpgroup wg (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// rel_base[e] = (relu-MLP3(relation inputs of e)) @ W1 + b for the E real
// edges. w: the four layers' staged W^T (re0 32 deep, zero past the relation
// inputs, then re1, re2, rp_w1); bias: their four biases as float, kNF
// apart. Each warpgroup takes 64 rows of every 256-edge tile (warp w rows
// 16w.. of them; rows past E compute and are dropped) through the four
// layers: a layer is one 64 x 128 product, its eight k-steps issued back to
// back and waited for once; after bias, relu and rounding to bf16 its
// output goes to the warpgroup's own 64 x 128 activation tile in shared
// memory (abuf + 16 KB per warpgroup, swizzled), the next layer's A. (With A
// in registers, the 128 registers a thread has in a 512-thread block cannot
// hold a layer's A fragments and its 64 accumulators beside the kernel's
// own state: ptxas serialised the products and spilled.) Only warpgroup
// barriers.
__device__ void relation_mlp(const EdgeGraph& g, const LayerWeights& lw, const float* bias,
                             bf16* relbase, bf16* abuf) {
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gid = lane >> 2, t4 = lane & 3;
  bf16* A = abuf + wg * 64 * kNF;
  const int ra = warp * 16 + gid, rb = ra + 8;  // this thread's rows of the tile
  const auto put = [&](int r, int c, unsigned v) {
    *reinterpret_cast<unsigned*>(A + sw(r, c, 64)) = v;
  };
  const int ntiles = __shfl_sync(kFull, (g.E + 4 * 64 - 1) / (4 * 64), 0);
  for (int tile = 0; tile < ntiles; ++tile) {
    const int ea = tile * 4 * 64 + wg * 64 + ra, eb = ea + 8;
    {
      int ia = 0, ja = 0, ib = 0, jb = 0;
      if (ea < g.E) { ia = g.ER[ea]; ja = g.NBR[ia * g.K + (ea - g.OFF[ia])]; }
      if (eb < g.E) { ib = g.ER[eb]; jb = g.NBR[ib * g.K + (eb - g.OFF[ib])]; }
#pragma unroll
      for (int c = 2 * t4; c < 32; c += 8) {
        put(ra, c, pack_bf16(edge_feature(g, ea, ia, ja, c), edge_feature(g, ea, ia, ja, c + 1)));
        put(rb, c, pack_bf16(edge_feature(g, eb, ib, jb, c), edge_feature(g, eb, ib, jb, c + 1)));
      }
    }
#pragma unroll  // a run-time L under the re0 test would serialise the products
    for (int L = 0; L < 4; ++L) {
      tc::fence_proxy_async();
      wg_sync(wg);  // the tile's A is written
      float acc[64];
      tc::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        if (L > 0 || ks < 2)
          tc::wgmma_m64n128k16_ss(acc, sw_desc(A, 64, 0, ks), sw_desc(lw.w[L], kNF, 0, ks),
                                  ks > 0);
      tc::wgmma_commit();
      tc::wgmma_wait0();
      tc::fence_regs(acc);
      const float* bl = bias + L * kNF;
#pragma unroll
      for (int nt = 0; nt < kNF / 8; ++nt) {
        const int c = nt * 8 + 2 * t4;
        const float2 bb = *reinterpret_cast<const float2*>(bl + c);
        const float* y = acc + 4 * nt;  // rows ra, rb; columns c, c + 1
        if (L < 3) {  // ReLU, round: the next layer's A
          put(ra, c, pack_bf16(relu(y[0] + bb.x), relu(y[1] + bb.y)));
          put(rb, c, pack_bf16(relu(y[2] + bb.x), relu(y[3] + bb.y)));
        } else {  // rel_base, rounded to bf16
          if (ea < g.E)
            *reinterpret_cast<unsigned*>(relbase + (size_t)ea * kNF + c) =
                pack_bf16(y[0] + bb.x, y[1] + bb.y);
          if (eb < g.E)
            *reinterpret_cast<unsigned*>(relbase + (size_t)eb * kNF + c) =
                pack_bf16(y[2] + bb.x, y[3] + bb.y);
        }
      }
    }
  }
}

// agg[i] = sum over i's edges, in slot order, of relu(rel_base[e] + recv[i]
// + send[j]) for every receiver i < N, rounded to bf16 into AGG. RS: (Np,
// 2 kNF) [recv | send]; rel_base is read from global memory, kTPR threads
// per receiver and kCPT channels per thread. It first waits for all but the
// newest group of cp.async copies in flight. Every thread calls it; it ends
// with a barrier.
__device__ void aggregate(const bf16* RS, const bf16* relbase, int N, const int* OFF,
                          const short* NBR, int K, bf16* AGG) {
  tc::cp_async_wait<1>();  // all but the newest group of cp.async copies
  __syncthreads();
  const int c0 = (threadIdx.x % kTPR) * kCPT;
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
  for (int i = threadIdx.x / kTPR; i < N; i += kRecvPerPass) {
    const Channels recv = *reinterpret_cast<const Channels*>(RS + i * 2 * kNF + c0);
    float acc[kCPT] = {};
    const int ebeg = OFF[i], eend = OFF[i + 1];
#pragma unroll 4
    for (int e = ebeg; e < eend; ++e) {
      const int j = NBR[i * K + (e - ebeg)];
      const Channels r = *reinterpret_cast<const Channels*>(relbase + (size_t)e * kNF + c0);
      const Channels sd = *reinterpret_cast<const Channels*>(RS + j * 2 * kNF + kNF + c0);
      // bf16x2 adds round once, as rnd(float(a) + float(b)) does for bf16 inputs
#pragma unroll
      for (int q = 0; q < kCPT / 2; ++q) {
        const float2 f =
            __bfloat1622float2(__hmax2(__hadd2(__hadd2(r.v[q], recv.v[q]), sd.v[q]), zero));
        acc[2 * q] += f.x;
        acc[2 * q + 1] += f.y;
      }
    }
    Channels out;
#pragma unroll
    for (int q = 0; q < kCPT / 2; ++q) out.v[q] = __floats2bfloat162_rn(acc[2 * q], acc[2 * q + 1]);
    *reinterpret_cast<Channels*>(AGG + sw(i, c0)) = out;
  }
  tc::fence_proxy_async();  // AGG is the update's A operand
  __syncthreads();
}

__device__ __forceinline__ void rollout_tc(const Params& p, unsigned char* smem_raw) {
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024u - (base & 1023u)) & 1023u);  // for the swizzle
  const Dims d = p.d;
  const TcLayout L = make_tc_layout(d);
  bf16* X = reinterpret_cast<bf16*>(smem + L.X);
  bf16* WB = reinterpret_cast<bf16*>(smem + L.WB);
  bf16* STG = reinterpret_cast<bf16*>(smem + L.STG);
  bf16* EFF = reinterpret_cast<bf16*>(smem + L.eff);
  bf16* AGG = reinterpret_cast<bf16*>(smem + L.agg);
  float* BIAS = reinterpret_cast<float*>(smem + L.bias);
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

  constexpr int kThr = kTcThreads;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int Np = d.Np, N = d.N, n_p = d.n_p, K = d.K, n_his = d.n_his;
  const int nh3 = n_his * 3, frame = Np * 3, n_slots = n_his + 1;
  const int rin16 = round_to(d.rel_in, 16);
  const bf16* const* W = reinterpret_cast<const bf16* const*>(p.w);
  const bf16* const* P = reinterpret_cast<const bf16* const*>(p.tcw);
  const bf16* pin = static_cast<const bf16*>(p.pin) + (size_t)b * Np * d.Dp;
  bf16* relbase = static_cast<bf16*>(p.relbase) + (size_t)b * Np * K * kNF;
  bf16* penc = static_cast<bf16*>(p.penc) + (size_t)b * Np * kNF;
  bf16* pbase = static_cast<bf16*>(p.pbase) + (size_t)b * Np * kNF;
  bf16* rs1 = static_cast<bf16*>(p.rs1) + (size_t)b * Np * 2 * kNF;
  bf16* const W2 = X + kNF * kNF;  // X's second 128 x 128 weight
  const auto none = [] {};
  // the relation encoder and rel_base layer: re1 | re2 in X, rp_w1 in WB, re0 in STG
  const LayerWeights rel_w{{STG, X, W2, WB}};
  const auto stage_relation = [&] {
    stage_wt(X, P[kRe1], kNF, kNF);
    stage_wt(W2, P[kRe2], kNF, kNF);
    stage_wt(WB, P[kRpW1], kNF, kNF);
    stage_wt(STG, P[kRe0], kNF, rin16);
    tc::cp_async_commit();
    for (int r = tid; r < kNF * (32 - rin16) / 8; r += kThr) {  // re0's depth past rin16: 0
      const int row = r / ((32 - rin16) / 8), k8 = rin16 / 8 + r % ((32 - rin16) / 8);
      *reinterpret_cast<uint4*>(STG + row * 64 + ((k8 ^ (row & 7)) << 3)) = make_uint4(0, 0, 0, 0);
    }
  };
  PhaseClock clk(p, b);

  // ---- inputs; the biases and the head's last layer as float ----
  stage_wt(X, P[kPe1], kNF, kNF);
  stage_wt(W2, P[kPe2], kNF, kNF);
  stage_wt(WB, P[kPpWa], kNF, kNF);
  tc::cp_async_commit();
  load_inputs<kThr>(p, b, VALID, HIST, ACT, REC);
  {
    const bf16* src[10] = {W[1], W[3], W[5], W[7], W[9], W[11], W[14], W[17], W[19], W[21]};
    for (int idx = tid; idx < 10 * kNF; idx += kThr)
      BIAS[idx] = __bfloat162float(src[idx / kNF][idx % kNF]);
    for (int idx = tid; idx < 3 * kNF; idx += kThr)
      BIAS[kWnr2 + idx] = __bfloat162float(W[22][idx]);
    if (tid < 3) BIAS[kBnr2 + tid] = __bfloat162float(W[23][tid]);
  }
  __syncthreads();

  // ---- once per push: particle encoder, the propagator's constant term and
  // round 1's recv|send ----
  // pe0 on the CUDA cores: its Dp inputs are a few
  for (int idx = tid; idx < N * kNF; idx += kThr) {
    const int r = idx / kNF, c = idx % kNF;
    float s = 0.f;
    for (int k = 0; k < d.Dp; ++k)
      s = fmaf(__bfloat162float(pin[r * d.Dp + k]), __bfloat162float(W[0][k * kNF + c]), s);
    EFF[sw(r, c)] = __float2bfloat16_rn(relu(s + BIAS[kBpe0 + c]));
  }
  wait_staged();
  node_product<64>(EFF, N, X, kNF, kNF, false, none, [=](int r, int c, float v0, float v1) {
    *reinterpret_cast<unsigned*>(AGG + sw(r, c)) =
        pack_bf16(relu(v0 + BIAS[kBpe1 + c]), relu(v1 + BIAS[kBpe1 + c + 1]));
  });
  node_product<64>(AGG, N, W2, kNF, kNF, false, none, [=](int r, int c, float v0, float v1) {
    const unsigned v = pack_bf16(relu(v0 + BIAS[kBpe2 + c]), relu(v1 + BIAS[kBpe2 + c + 1]));
    *reinterpret_cast<unsigned*>(EFF + sw(r, c)) = v;
    *reinterpret_cast<unsigned*>(penc + r * kNF + c) = v;
  });
  stage_wt(X, P[kRpW23], 2 * kNF, kNF);
  tc::cp_async_commit();
  node_product<64>(EFF, N, WB, kNF, kNF, false, none, [=](int r, int c, float v0, float v1) {
    *reinterpret_cast<unsigned*>(pbase + r * kNF + c) =
        pack_bf16(v0 + BIAS[kBpp + c], v1 + BIAS[kBpp + c + 1]);
  });
  wait_staged();
  node_product<128>(EFF, N, X, 2 * kNF, 2 * kNF, false, none,
                    [=](int r, int c, float v0, float v1) {
                      *reinterpret_cast<unsigned*>(rs1 + r * 2 * kNF + c) = pack_bf16(v0, v1);
                    });
  stage_relation();
  clk.mark(kEncoder);

  const int rep = p.repeat[b];
  const int rmax = min(rep, p.max_repeat);
  int start = 0;  // ring slot of the oldest history frame
  for (int ai = 1; ai <= rmax; ++ai) {
    const float* last = HIST + ((start + n_his - 1) % n_slots) * frame;
    float* nxt = HIST + ((start + n_his) % n_slots) * frame;

    history_features<bf16, kThr>(d, HIST, start, SN);
    // ---- radius-and-topk graph (edge_build.cuh), compacted by receiver ----
    edges::radius_topk(last, VALID, Np, N, n_p, K, p.thresh, NBR, CNT);
    const int E = edges::compact_edges(CNT, NBR, Np, K, OFF, ER, nullptr);
    clk.mark(kGraph);

    // ---- relation encoder + rel_base over real edges (weights staged
    // during the previous substep's head, or the encoder) ----
    wait_staged();
    const EdgeGraph g{E, K, n_p, N, d.rel_in, nh3, ER, NBR, OFF, VALID, SN};
    relation_mlp(g, rel_w, BIAS + kBre0, relbase, EFF);  // EFF and AGG: the A tiles
    __syncthreads();  // rel_base is written; the relation weights are free
    // round 1's recv|send and the effect's start (the particle encoding),
    // waited for by the first aggregation; Wb, by the first update
    copy_async(X, rs1, N * 2 * kNF * 2);
    for (int idx = tid; idx < N * (kNF / 8); idx += kThr) {
      const int r = idx / (kNF / 8), c = (idx % (kNF / 8)) * 8;
      tc::cp_async16(EFF + sw(r, c), penc + r * kNF + c, true);
    }
    tc::cp_async_commit();
    stage_wt(WB, P[kPpWb], kNF, kNF);
    tc::cp_async_commit();
    clk.mark(kRelation);

    // ---- pstep rounds of message passing ----
    for (int s = 0; s < d.pstep; ++s) {
      if (s > 0) {  // recv|send, one 256-column product into X, over its weight
        node_product<128>(EFF, N, X, 2 * kNF, 2 * kNF, true, none,
                          [=](int r, int c, float v0, float v1) {
                            *reinterpret_cast<unsigned*>(X + r * 2 * kNF + c) = pack_bf16(v0, v1);
                          });
      }
      clk.mark(kProjection);
      aggregate(X, relbase, N, OFF, NBR, K, AGG);
      clk.mark(kAggregate);
      // the propagator base into STG; the next product's weights into X
      copy_async(STG, pbase, N * kNF * 2);
      tc::cp_async_commit();
      if (s + 1 < d.pstep) {
        stage_wt(X, P[kRpW23], 2 * kNF, kNF);
      } else {
        stage_wt(X, P[kNr0], kNF, kNF);
        stage_wt(W2, P[kNr1], kNF, kNF);
      }
      tc::cp_async_commit();
      tc::cp_async_wait<2>();  // Wb (the first round), but not these two groups
      tc::fence_proxy_async();
      __syncthreads();
      // effect = relu(rnd(rnd(base + rnd(agg @ Wb)) + effect))
      node_product<64>(AGG, N, WB, kNF, kNF, true, [] { tc::cp_async_wait<1>(); },
                       [=](int r, int c, float v0, float v1) {
                         const float2 pb = __bfloat1622float2(
                             *reinterpret_cast<const __nv_bfloat162*>(STG + r * kNF + c));
                         __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(EFF + sw(r, c));
                         const float2 ef = __bfloat1622float2(*e);
                         float t0 = rnd<bf16>(pb.x + rnd<bf16>(v0));
                         float t1 = rnd<bf16>(pb.y + rnd<bf16>(v1));
                         t0 = rnd<bf16>(t0 + ef.x);
                         t1 = rnd<bf16>(t1 + ef.y);
                         *e = __floats2bfloat162_rn(relu(t0), relu(t1));
                       });
      wait_staged();
      clk.mark(kUpdate);
    }

    // ---- motion head on the object rows, clamp, predicted positions ----
    node_product<64>(EFF, n_p, X, kNF, kNF, false, none, [=](int r, int c, float v0, float v1) {
      *reinterpret_cast<unsigned*>(AGG + sw(r, c)) =
          pack_bf16(relu(v0 + BIAS[kBnr0 + c]), relu(v1 + BIAS[kBnr0 + c + 1]));
    });
    node_product<64>(AGG, n_p, W2, kNF, kNF, false, none, [=](int r, int c, float v0, float v1) {
      *reinterpret_cast<unsigned*>(EFF + sw(r, c)) =
          pack_bf16(relu(v0 + BIAS[kBnr1 + c]), relu(v1 + BIAS[kBnr1 + c + 1]));
    });
    // the next substep's relation weights, in flight through the rest of this
    // substep and the next graph build
    if (ai < rmax) stage_relation();
    // the 3-wide last layer on the CUDA cores
    {
      const float mc = p.motion_clamp;
      for (int idx = tid; idx < n_p * 3; idx += kThr) {
        const int r = idx / 3, c = idx % 3;
        float s = 0.f;
        for (int k = 0; k < kNF; ++k)
          s = fmaf(__bfloat162float(EFF[sw(r, k)]), BIAS[kWnr2 + k * 3 + c], s);
        const float m = rnd<bf16>(s + BIAS[kBnr2 + c]);
        nxt[r * 3 + c] = __fadd_rn(last[r * 3 + c], fminf(fmaxf(m, -mc), mc));
      }
    }
    __syncthreads();
    clk.mark(kHead);

    // ---- record at this sample's repeat; re-stick the eef rows ----
    record_restick<kThr>(p, ai, rep, last, nxt, VALID, ACT, REC, RED);
    start = (start + 1) % n_slots;
    clk.mark(kRestick);
  }
  tc::cp_async_wait<0>();  // the relation weights staged for a sample with no substep

  for (int idx = tid; idx < n_p * 3; idx += kThr) p.out[(size_t)b * n_p * 3 + idx] = REC[idx];
}

template <typename T>
__global__ void __launch_bounds__(Cfg<T>::kThreads, 1) rollout_chunk_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  if constexpr (sizeof(T) == 2)
    rollout_tc(p, smem);
  else
    rollout_f32(p, smem);
}

template <typename T> int smem_bytes(const Dims& d);
template <> int smem_bytes<float>(const Dims& d) { return make_layout(d).total; }
template <> int smem_bytes<bf16>(const Dims& d) { return make_tc_layout(d).total; }

template <typename T>
int launch(const Params& p, int B, int device, cudaStream_t stream) {
  const CurrentDeviceGuard restore;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)smem_bytes<T>(p.d);
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
  return bf16_mode ? smem_bytes<bf16>(d) : smem_bytes<float>(d);
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
// tc_weights: bf16, the packed W^T of the tensor-core layers
// (ops/fused_gnn.py::pack_tc_weights, transpose) and rs1 the scratch of round
// 1's recv|send; float32, both ignored.
int rollout_chunk_launch(const void* pin, const void* sa, const void* repeat, const void* valid,
                         const void* const* weights, const void* const* tc_weights, void* relbase,
                         void* penc, void* pbase, void* rs1, void* out, int B, int Np, int N,
                         int n_p, int K, int n_his, int pstep, int Dp, int nf_p, int nf_r,
                         int nf_e, int rel_in, float thresh, float gripper_lift,
                         float motion_clamp, int max_repeat, int mean_y, int bf16_mode,
                         int device, void* stream) {
  Params p;
  p.pin = pin;
  p.sa = static_cast<const float*>(sa);
  p.repeat = static_cast<const int*>(repeat);
  p.valid = static_cast<const float*>(valid);
  for (int i = 0; i < kNumWeights; ++i) p.w[i] = weights[i];
  for (int i = 0; i < kNumTc; ++i) p.tcw[i] = bf16_mode ? tc_weights[i] : nullptr;
  p.relbase = relbase;
  p.penc = penc;
  p.pbase = pbase;
  p.rs1 = rs1;
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
