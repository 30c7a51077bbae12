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
// warpgroups, ~220-230 KB of shared memory, one block per SM):
// - Every product with 128 columns runs on wgmma (m64n128k16 and m64n64k16
//   bf16, float32 accumulators; mma.cuh) with B, the layer's weight, in
//   128-byte swizzled shared memory (mma.cuh's sw128 layout), packed as W^T
//   in PyTorch (ops/fused_gnn.py::pack_tc_weights) and staged by cp.async
//   (tc::stage_sw). A product's k-steps are issued back to back and waited
//   for once.
// - The relation MLP: each warpgroup owns 64 edge rows of a 256-edge tile
//   and carries them through the relation encoder's three layers and the
//   rel_base layer. re0 reads the tile's relation inputs from the
//   warpgroup's own swizzled tile in shared memory; the inputs are built from
//   per-node rows staged once a substep (node_rows: an edge's history
//   features are its receiver's row minus its sender's). After bias, relu and
//   rounding to bf16 (one cvt.rn.relu per pair) a layer's accumulators are
//   the next layer's A in registers (wgmma with A from registers), so the
//   hidden layers touch no shared memory; rel_base goes to the tile and
//   leaves it in 16-byte stores. The four layers' weights (112 KB swizzled)
//   stay resident for all of a substep's tiles; they are staged while the
//   previous substep's head, re-stick and graph build run. A layer's
//   products take the tensor cores a small part of the time of its
//   epilogue, which sets the pace; the four warpgroups' chains overlap
//   without any ordering between them.
// - Node-sized products (particle encoder, propagator base, recv|send as one
//   256-column product, update, motion head): the 128 padded rows are two
//   64-row tiles, and the two warpgroups of a tile (a pair) each take one
//   column half (64 x 64, or 64 x 128 for recv|send). A layer that feeds the
//   next hands it over in the pair's rows of EFF or AGG and a named barrier
//   of the pair, not of the block: an update's effect feeds the next
//   round's recv|send, the head's nr0 feeds nr1 and nr1 the 3-wide layer.
//   Epilogues go through ldmatrix / stmatrix (16 bytes a row) and packed
//   bf16x2 arithmetic with the same single roundings; the update reads the
//   propagator base from global memory (L2), its loads in flight through the
//   products. The block waits at a barrier only where all of its rows are
//   needed: after the graph build, the relation MLP and recv|send (the
//   aggregation's senders), after the aggregation (its rows and the staged
//   weights) and after the head (the re-stick). recv|send never overwrites
//   a weight: recv goes to AGG, where the aggregation then writes each
//   receiver's sums over its own recv, send to STG (Np rows of kSendLd), so
//   W23 is staged once a substep and the head's weights during the last
//   aggregation. 13 block barriers a substep at pstep 3 (33 before).
// - Round 1's recv|send is a constant of the push (the effect starts every
//   substep from the particle encoding): it is computed once per push into a
//   per-sample scratch and copied back by cp.async each substep.
// - The graph build (edge_build.cuh) takes a row a warp: one warp reduction
//   counts its candidates below a few levels of the radius, and only those
//   below the smallest level that holds K of them are ranked (in a scratch
//   in EFF, free then), so a row costs a handful of warp-wide operations
//   rather than two a pick.
// - The aggregation: 16 threads per receiver, each summing eight channels
//   (16 bytes) over the receiver's edges in slot order. A receiver's edges
//   are contiguous rows of rel_base (global memory, L2): each thread loads
//   its 16 bytes of up to kRowsAhead of them at once (one predicated
//   16-byte load each), then sums with packed bf16 adds (add.rn and
//   fma.rn.relu on bf16x2, the same single roundings as before), so a pass
//   over 32 receivers waits for L2 once, not once per edge; slots past a
//   receiver's edges take a -inf sender row and add 0, so that no branch
//   splits a warp's two receivers.
// - What the substep loop needs (dimensions, the layout of the small state,
//   this substep's edge count) sits in shared memory (TcBlock) and is read
//   where used, and each phase starts from opaque_zero(): held in registers
//   through the loop, or hoisted out of it by the compiler, the kernel's
//   pointers, swizzle offsets and descriptors spilled beside the relation
//   MLP's accumulators. The kernel builds with no spill.
// - The motion head's 3-wide last layer (each output's products in k order,
//   16 bytes of the input row a load) and the particle encoder's first layer
//   (a few inputs, read with its weight from shared memory) run on the CUDA
//   cores.
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
// ... and thread 0's cycles inside some of them (see SubClock): in the
// relation MLP, building a tile's relation inputs, its products (the issue and
// the wait) and its epilogues (rel_base's stores included); in the
// aggregation, waiting for a receiver's rel_base rows, and summing them; in
// the graph build, the node rows, the top-k selection and the compaction (its
// barriers included); in the node-sized products (encoder, update,
// projection, head), the products, the epilogues and the waits at the
// barriers that follow them
enum SubPhase { kRelInputs, kRelProducts, kRelEpilogues, kAggRows, kAggSums, kGraphRows,
                kGraphSelection, kGraphCompaction, kNodeProducts, kNodeEpilogues, kNodeBarriers,
                kSubPhases };
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
  r_bytes = imax(r_bytes, edges::scratch_bytes(kWarps));  // the graph build's scratch
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
// (two 64-row tiles; rows past N hold what was left there and feed only
// dropped outputs) swizzled as the weights are (tc::sw128); then STG (re0's
// weight, or the send projections: Np rows of kSendLd), and the small state,
// with NR, the node rows of the relation inputs (node_rows). What each big
// region holds in each phase:
//   phase            X                     WB      STG           EFF      AGG
//   encoder          pe1 | pe2, then w23   Wa      -             h1, penc pe0's inputs,
//                                                                         then h2
//   relation MLP     re1 | re2             rp_w1   re0           the warpgroups'
//                                                                64-row A tiles
//   round s          w23 (last round:      Wb      send          effect   recv, then
//                    nr0 | nr1)                                           agg in place
//   head             nr0 | nr1, then the   -       -             h2       h1
//                    next substep's relation weights (WB and STG too)
constexpr int kNF = 128;
constexpr int kWBytes = kNF * kNF * 2;            // one swizzled 128 x 128 matrix
constexpr int kCPT = 8;                           // aggregation: channels per thread
constexpr int kTPR = kNF / kCPT;                  // threads per receiver
constexpr int kRecvPerPass = kTcThreads / kTPR;
constexpr int kRowsAhead = 10;                    // a receiver's rel_base rows loaded at once
constexpr int kNodeRow = 32;                      // bf16 per node row (the relation inputs)
constexpr int kSendLd = kNF + 8;                  // row stride of the send projections (bf16)
static_assert(edges::scratch_bytes(kTcThreads / 32) <= kWBytes,
              "the graph build's scratch fits in EFF");
// float slots of the BIAS region: the biases (kNF each), then the head's last
// layer's bias (3, padded to 4) and weight (3 rows of kW2Ld: column c's kNF
// weights together, the rows four banks apart)
constexpr int kW2Ld = kNF + 4;
enum BiasSlot { kBpe0 = 0, kBpe1 = kNF, kBpe2 = 2 * kNF, kBre0 = 3 * kNF, kBrp = 6 * kNF,
                kBpp = 7 * kNF, kBnr0 = 8 * kNF, kBnr1 = 9 * kNF, kBnr2 = 10 * kNF,
                kWnr2 = 10 * kNF + 4, kBiasFloats = kWnr2 + 3 * kW2Ld };
// packed tensor-core layers, in the order of ops/fused_gnn.py::TC_LAYERS
enum TcLayer { kPe1, kPe2, kRe1, kRe2, kRpW1, kRpW23, kPpWa, kPpWb, kNr0, kNr1, kRe0 };

// the big regions' offsets from the 1,024-aligned base
constexpr int kOffX = 0, kOffWB = 2 * kWBytes, kOffEff = 3 * kWBytes, kOffAgg = 4 * kWBytes,
              kOffSTG = 5 * kWBytes;

struct TcLayout {
  int X, WB, eff, agg, STG, bias, hist, nr, act, rec, valid, red, cnt, off, nbr, er, ninf, trash;
  int total;  // bytes to request, the 1,024 of the base's alignment included
};

__host__ __device__ inline TcLayout make_tc_layout(const Dims& d) {
  const int sizes[] = {
      kBiasFloats * 4,                  // bias
      (d.n_his + 1) * d.Np * 3 * 4,     // hist: ring of n_his+1
      d.Np * kNodeRow * 2,              // nr: bf16 node rows
      d.Np * 3 * 4,                     // act
      d.n_p * 3 * 4,                    // rec
      d.Np * 4,                         // valid
      3 * (kTcThreads / 32) * 4,        // red
      d.Np * 4,                         // cnt
      (d.Np + 1) * 4,                   // off
      d.Np * d.K * 2,                   // nbr: int16 senders
      d.Np * d.K * 2,                   // er: int16 receivers
      kNF * 2,                          // ninf: a row of bf16 -inf (aggregate)
      16,                               // trash: where rows past Np of a send tile go
  };
  TcLayout L;
  L.X = kOffX;
  L.WB = kOffWB;
  L.eff = kOffEff;
  L.agg = kOffAgg;
  L.STG = kOffSTG;  // re0's weight (16 KB) or the send projections
  int at = L.STG + round_to(imax(kWBytes / 2, d.Np * kSendLd * 2), 1024);
  int* dst[] = {&L.bias, &L.hist, &L.nr, &L.act, &L.rec, &L.valid, &L.red, &L.cnt, &L.off,
                &L.nbr, &L.er, &L.ninf, &L.trash};
  for (int i = 0; i < 13; ++i) { *dst[i] = at; at += round_to(sizes[i], 128); }
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
  long long* sub_clocks; // (B, kSubPhases) thread 0's cycles per sub-phase (bf16), or null
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
long long* g_sub_clocks = nullptr;    // ... and sub-phase buffer
// Thread 0's cycles in the sub-phases of the bf16 body (SubPhase): start()
// begins a span, mark(k) adds the cycles since the last start() or mark() to
// sub-phase k. They add up in shared memory (a read-modify-write of global
// memory at every mark would stall warp 0 and, through the barriers, the
// others), and flush() adds them to the buffer set with
// rollout_chunk_set_sub_clocks.
__shared__ long long s_sub[kSubPhases + 1];  // the counters, then the span's start
struct SubClock {
  const Params& p;
  __device__ SubClock(const Params& p_, int) : p(p_) {
    if (threadIdx.x == 0)
      for (int k = 0; k < kSubPhases; ++k) s_sub[k] = 0;
  }
  __device__ __forceinline__ void start() {
    if (threadIdx.x == 0) s_sub[kSubPhases] = clock64();
  }
  __device__ __forceinline__ void mark(int k) {
    if (threadIdx.x == 0) {
      const long long now = clock64();
      s_sub[k] += now - s_sub[kSubPhases];
      s_sub[kSubPhases] = now;
    }
  }
  __device__ void flush() {
    if (threadIdx.x == 0 && p.sub_clocks)
      for (int k = 0; k < kSubPhases; ++k)
        p.sub_clocks[(size_t)blockIdx.x * kSubPhases + k] += s_sub[k];
  }
};
// v, passed through an instruction that waits for it: a clock read after
// this one comes after v arrived
__device__ __forceinline__ float arrived(float v) {
  float r;
  asm volatile("mov.b32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}
#else
struct PhaseClock {
  __device__ PhaseClock(const Params&, int) {}
  __device__ void mark(int) {}
};
struct SubClock {
  __device__ SubClock(const Params&, int) {}
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ void flush() {}
};
__device__ __forceinline__ float arrived(float v) { return v; }
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
    edges::radius_topk(last, VALID, Np, N, n_p, K, p.thresh, NBR, CNT, R, tid);
    const int E = edges::compact_edges(CNT, NBR, Np, K, OFF, ER, nullptr, tid);
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

// The bf16 body's dimensions and shared-memory layout, kept in shared memory
// and read where used, as are the pointers derived from them: held in
// registers through the substep loop beside the relation MLP's 64
// accumulators and the aggregation's rows, they were spilled.
struct TcBlock {
  Dims d;
  TcLayout L;
  int rep, rmax;  // this sample's repeat, and the substeps it runs
  float thresh;   // the graph's radius squared
};

// A 0 the compilers cannot see through: read (volatile) from shared memory
// where it is used, it keeps what is computed from it inside the loop around
// the use. The bf16 body adds it to the thread index or a region's address
// where a phase begins: the addresses, swizzle offsets and descriptors that
// each phase computes from them were otherwise hoisted out of the substep
// and tile loops, held in registers beside the relation MLP's accumulators,
// and spilled.
__shared__ int s_zero;
__device__ __forceinline__ int opaque_zero() { return *reinterpret_cast<volatile int*>(&s_zero); }

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.f); }
// pack_bf16(relu(lo), relu(hi)) in one instruction (cvt.rn.relu: rounded,
// then negatives clamped to 0)
__device__ __forceinline__ unsigned pack_relu_bf16(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Rows [0, R) of a packed W^T (row stride kp bf16, a multiple of 16) into
// ceil(kp / 64) column blocks of R rows, swizzled (tc::stage_sw; the depth
// from kp to the next multiple of 64 zero): the K-major B operand of Y = X
// W. Not committed.
__device__ inline void stage_wt(bf16* dst, const bf16* P, int R, int kp) {
  tc::stage_sw(dst, P, kp, 0, R, R, 0, (kp + 63) / 64, kp, threadIdx.x + opaque_zero(),
               kTcThreads);
}

// The node-sized A operands (EFF, AGG) are swizzled matrices of 128 rows.
constexpr int kNodeRows = 128;

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  tc::wgmma_m64n64k16<0, 0>(d, da, db, acc);
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  tc::wgmma_m64n128k16_ss(d, da, db, acc);
}

// The node-sized products (Y = X W over the rows of a node matrix, X one of
// the swizzled 128-row matrices, W^T staged by stage_wt): warpgroup wg takes
// row tile mt = wg / 2 (rows 64 mt ..; both tiles are computed whatever N,
// rows past it feed only dropped outputs) and column half h = wg % 2. The
// warpgroups of a row tile (a pair) exchange what a layer feeds the next
// through shared memory and wait for each other at the pair's named barrier;
// no other warpgroup takes part.
struct NodeTile {
  int mt, h, warp, lane;
  // row (in the node matrix) of this lane's stmatrix / ldmatrix address:
  // row lane % 8 of 8 x 8 matrix lane / 8 (matrices in the order of quad())
  __device__ __forceinline__ int row() const {
    return 64 * mt + 16 * warp + 8 * ((lane >> 3) & 1) + (lane & 7);
  }
  // ... and its column in group j of the tile (columns 16 j ..)
  __device__ __forceinline__ int col(int j) const { return 16 * j + 8 * (lane >> 4); }
};
__device__ __forceinline__ NodeTile node_tile() {
  const int tid = threadIdx.x + opaque_zero();  // see opaque_zero
  return NodeTile{tid >> 8, (tid >> 7) & 1, (tid >> 5) & 3, tid & 31};
}

// the named barrier of row tile mt's two warpgroups (barriers 1 .. 4 are the
// relation MLP's, one a warpgroup)
__device__ __forceinline__ void pair_sync(int mt) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(5 + mt) : "memory");
}

// The warpgroup's 64 x TN product: rows m0 .. m0 + 63 of X, columns n0 .. n0
// + TN - 1 (rows of W^T, which has R), its eight k-steps issued back to back
// and waited for once. Accumulators as wgmma lays them out (tc::wgmma_m64n64k16).
template <int TN>
__device__ __forceinline__ void tile_products(float (&acc)[TN / 2], const bf16* X, int m0,
                                              const bf16* W, int R, int n0) {
  tc::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kNF / 16; ++ks)
    wgmma_ss(acc, tc::sw128_desc(X, kNodeRows, m0, ks), tc::sw128_desc(W, R, n0, ks), ks > 0);
  tc::wgmma_commit();
  tc::wgmma_wait0();
  tc::fence_regs(acc);
}

// Group j (columns 16 j .. 16 j + 15) of the warpgroup's accumulators as four
// bf16 pairs in stmatrix's order: pair m holds row 16 w + g + 8 hi of the
// tile (warp w, g = lane / 4, hi = m % 2), columns 8 nt + 2 t4 and the next
// (nt = 2 j + m / 2, t4 = lane % 4); make(v0, v1, nt, hi) packs the two
// accumulators. j, and so nt and hi, are compile-time constants.
template <int N, typename Make>
__device__ __forceinline__ void quad(const float (&acc)[N], int j, Make make, uint32_t (&q)[4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int nt = 2 * j + (m >> 1), i = 4 * nt + 2 * (m & 1);
    q[m] = make(acc[i], acc[i + 1], nt, m & 1);
  }
}

// relu(v + b) rounded, columns c, c + 1 of the bias b (float)
__device__ __forceinline__ unsigned bias_relu(const float* b, float v0, float v1, int c) {
  const float2 bb = *reinterpret_cast<const float2*>(b + c);
  return pack_relu_bf16(v0 + bb.x, v1 + bb.y);
}
// the column of pair nt of quad() in a tile starting at column n0
__device__ __forceinline__ int pair_col(int n0, int nt) {
  return n0 + 8 * nt + 2 * (threadIdx.x & 3);
}

// Every thread of a row tile's warpgroups stores its pairs (quad(), group j)
// into a swizzled 128-row node matrix at column n0 + 16 j .., 16 bytes a row.
__device__ __forceinline__ void store_quad(bf16* M, const NodeTile& t, int n0, int j,
                                           const uint32_t (&q)[4]) {
  tc::stmatrix_x4(M + tc::sw128(t.row(), n0 + t.col(j), kNodeRows), q);
}

struct EdgeGraph {
  int E, K, n_p, N;
  const short* ER;
  const short* NBR;
  const int* OFF;
  const float* VALID;
  const bf16* NR;
};

// The node rows of the relation inputs, NR (Np x kNodeRow bf16): row i
// holds zeros in columns [0, 5), i's history features of the newest n_his
// frames (ring slot `start` the oldest), rounded to bf16, in columns [5, 5 +
// 3 n_his), and zeros after. An edge's inputs from column 5 on are its
// receiver's row minus its sender's (edge_inputs). No barrier.
__device__ inline void node_rows(const Dims& d, const float* HIST, int start, bf16* NR) {
  const int tid = threadIdx.x + opaque_zero();
  const int n_his = d.n_his, n_slots = n_his + 1, frame = d.Np * 3;
  // this thread's column of every row it writes: history frame h's coordinate c
  const int q = tid % kNodeRow - 5, h = q / 3, c = q - 3 * h;
  const bool diff = q >= 0 && h < n_his - 1, newest = q >= 0 && h == n_his - 1;
  const float* f0 = HIST + ((start + (diff ? h : n_his - 1)) % n_slots) * frame + c;
  const float* f1 = HIST + ((start + h + 1) % n_slots) * frame + c;
  for (int i = tid / kNodeRow; i < d.Np; i += kTcThreads / kNodeRow) {
    float v = 0.f;
    if (diff) v = __fsub_rn(f1[i * 3], f0[i * 3]);
    else if (newest) v = f0[i * 3];
    NR[i * kNodeRow + tid % kNodeRow] = __float2bfloat16_rn(v);
  }
}

// rnd(a - b) for two bf16 pairs in one instruction (sub.rn.bf16x2: the
// exact difference rounded once, which is what rounding the float32
// difference gives: that is exact, or lies far from a bf16 rounding
// boundary)
__device__ __forceinline__ unsigned sub_bf16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The relation inputs of edge rows [e0, e0 + 64) (zero past E) into the
// first 32 columns of A, the warpgroup's swizzled 64-row tile: for receiver
// i and sender j, [obj_i, eef_i, obj_j, eef_j, |obj_i - obj_j|, sn_i - sn_j]
// rounded to bf16, sn_i - sn_j (and the zeros after it) as the difference of
// the node rows NR[i] - NR[j]. Thread t of the warpgroup writes the 16-byte
// chunks 2 (t % 2) and 2 (t % 2) + 1 of row t / 2. No barrier.
__device__ __forceinline__ void edge_inputs(const EdgeGraph& g, int e0, bf16* A) {
  const int t = threadIdx.x & 127, r = t >> 1, h = t & 1, e = e0 + r;
  uint4 v[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
  if (e < g.E) {
    const int i = g.ER[e], j = g.NBR[i * g.K + (e - g.OFF[i])];
    const uint4* ri = reinterpret_cast<const uint4*>(g.NR + i * kNodeRow) + 2 * h;
    const uint4* rj = reinterpret_cast<const uint4*>(g.NR + j * kNodeRow) + 2 * h;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint4 a = ri[q], b = rj[q];
      v[q] = make_uint4(sub_bf16x2(a.x, b.x), sub_bf16x2(a.y, b.y), sub_bf16x2(a.z, b.z),
                        sub_bf16x2(a.w, b.w));
    }
    if (h == 0) {  // columns 0 .. 4
      const float oi = (i < g.n_p) ? g.VALID[i] : 0.f, oj = (j < g.n_p) ? g.VALID[j] : 0.f;
      v[0].x = pack_bf16(oi, (i >= g.n_p && i < g.N) ? 1.f : 0.f);
      v[0].y = pack_bf16(oj, (j >= g.n_p && j < g.N) ? 1.f : 0.f);
      v[0].z = (v[0].z & 0xffff0000u) | (pack_bf16(fabsf(oi - oj), 0.f) & 0xffffu);
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q)
    *reinterpret_cast<uint4*>(A + tc::sw128(r, 8 * (2 * h + q), 64)) = v[q];
}

// a barrier of the 128 threads of warpgroup wg (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// Rows [e0, e0 + 64) of rel_base that lie below E, from the warpgroup's
// swizzled 64-row tile A, 16 bytes a store: sixteen threads write a row's
// 256 contiguous bytes. No barrier.
__device__ __forceinline__ void store_rows(const bf16* A, bf16* relbase, int e0, int E) {
  const int t = (threadIdx.x + opaque_zero()) & 127;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int r = 8 * k + (t >> 4), c = (t & 15) * 8;
    if (e0 + r < E)
      *reinterpret_cast<uint4*>(relbase + (size_t)(e0 + r) * kNF + c) =
          *reinterpret_cast<const uint4*>(A + tc::sw128(r, c, 64));
  }
}

// This substep's edge lists and node rows (see TcBlock), from the layout
// in shared memory, with `sm` the 1,024-aligned base; its edge count is the
// offsets' last entry.
__device__ __forceinline__ EdgeGraph edge_graph(const TcBlock& tb, unsigned char* sm) {
  const TcLayout& L = tb.L;
  return EdgeGraph{reinterpret_cast<const int*>(sm + L.off)[tb.d.Np],
                   tb.d.K,
                   tb.d.n_p,
                   tb.d.N,
                   reinterpret_cast<const short*>(sm + L.er),
                   reinterpret_cast<const short*>(sm + L.nbr),
                   reinterpret_cast<const int*>(sm + L.off),
                   reinterpret_cast<const float*>(sm + L.valid),
                   reinterpret_cast<const bf16*>(sm + L.nr)};
}

// the relation MLP's staged W^T, layer by layer: re0 in STG (32 deep, zero
// past the relation inputs), re1 | re2 in X, rp_w1 in WB
__host__ __device__ constexpr int rel_w(int L) {
  return L == 0 ? kOffSTG : L == 1 ? kOffX : L == 2 ? kOffX + kWBytes : kOffWB;
}

// rel_base[e] = (relu-MLP3(relation inputs of e)) @ W1 + b for the real
// edges of this substep, with the four layers' weights staged (rel_w) and
// their biases in the BIAS region (kBre0 on, kNF apart). Each warpgroup
// takes 64 rows of every 256-edge tile (warp w rows 16w.. of them; rows
// past E compute and are dropped) through the four layers: a layer is one
// 64 x 128 product, its k-steps issued back to back and waited for once.
// re0 reads the tile's relation inputs from the warpgroup's own swizzled
// 64-row tile in shared memory (EFF or AGG, 16 KB per warpgroup); after
// bias, relu and rounding to bf16 a layer's accumulators become the next
// layer's A in registers (32 a thread: wgmma with A from registers), and
// the last layer's, rel_base, go to the tile and leave it by store_rows.
// The products are short beside the epilogues, which set the pace, and the
// four warpgroups overlap one another's. What a tile needs comes from
// shared memory (tb) where it is used.
__device__ __forceinline__ void relation_mlp(const Params& p, const TcBlock& tb,
                                             unsigned char* smem, SubClock& sc) {
  const int E = reinterpret_cast<const int*>(smem + tb.L.off)[tb.d.Np];
  const int ntiles = __shfl_sync(kFull, (E + 4 * 64 - 1) / (4 * 64), 0);
  for (int tile = 0; tile < ntiles; ++tile) {
    unsigned char* const sm = smem + opaque_zero();  // see opaque_zero
    const int tid = threadIdx.x + opaque_zero();
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, gid = lane >> 2, t4 = lane & 3;
    bf16* const A = reinterpret_cast<bf16*>(sm + kOffEff) + wg * 64 * kNF;
    const int e0 = tile * 4 * 64 + wg * 64;
    sc.start();
    edge_inputs(edge_graph(tb, sm), e0, A);
    tc::fence_proxy_async();
    wg_sync(wg);  // the tile's relation inputs are written
    sc.mark(kRelInputs);
    uint32_t a[8][4];  // layers 1 .. 3: A, rows of the thread (wgmma_m64n128k16_rs)
#pragma unroll  // a run-time L under the re0 test would serialise the products
    for (int L = 0; L < 4; ++L) {
      // the weights at fixed offsets from the base: their descriptors are uniform
      const bf16* const W = reinterpret_cast<const bf16*>(smem + rel_w(L));
      float acc[64];
      tc::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        if (L == 0 && ks < 2)
          tc::wgmma_m64n128k16_ss(acc, tc::sw128_desc(A, 64, 0, ks),
                                  tc::sw128_desc(W, kNF, 0, ks), ks > 0);
        else if (L > 0)
          tc::wgmma_m64n128k16_rs(acc, a[ks], tc::sw128_desc(W, kNF, 0, ks), ks > 0);
      }
      tc::wgmma_commit();
      tc::wgmma_wait0();
      tc::fence_regs(acc);
      tc::fence_regs(a);
      sc.mark(kRelProducts);
      const float* bl = reinterpret_cast<const float*>(sm + tb.L.bias) + kBre0 + L * kNF;
      if (L < 3) {  // ReLU, round: the next layer's A
#pragma unroll
        for (int nt = 0; nt < kNF / 8; ++nt) {
          const float2 bb = *reinterpret_cast<const float2*>(bl + nt * 8 + 2 * t4);
          const float* y = acc + 4 * nt;  // rows gid, gid + 8; columns 8 nt + 2 t4 ..
          a[nt >> 1][2 * (nt & 1)] = pack_relu_bf16(y[0] + bb.x, y[1] + bb.y);
          a[nt >> 1][2 * (nt & 1) + 1] = pack_relu_bf16(y[2] + bb.x, y[3] + bb.y);
        }
      } else {  // rel_base, rounded to bf16, into the tile
        unsigned w[2][kNF / 8];  // rows warp * 16 + gid (+ 8), columns 8 nt + 2 t4 ..
#pragma unroll
        for (int nt = 0; nt < kNF / 8; ++nt) {
          const float2 bb = *reinterpret_cast<const float2*>(bl + nt * 8 + 2 * t4);
          const float* y = acc + 4 * nt;
          w[0][nt] = pack_bf16(y[0] + bb.x, y[1] + bb.y);
          w[1][nt] = pack_bf16(y[2] + bb.x, y[3] + bb.y);
        }
        // row warp * 16 + gid's 16-byte chunk q of a 64-column block lies at q ^
        // gid (tc::sw128); the row 8 below, 512 elements on
        bf16* const row = A + (warp * 16 + gid) * 64 + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < kNF / 8; ++nt) {
          bf16* const at = row + (nt >> 3) * 64 * 64 + (((nt & 7) ^ gid) << 3);
          *reinterpret_cast<unsigned*>(at) = w[0][nt];
          *reinterpret_cast<unsigned*>(at + 8 * 64) = w[1][nt];
        }
      }
      sc.mark(kRelEpilogues);
    }
    wg_sync(wg);  // the tile holds rel_base's rows
    store_rows(A, static_cast<bf16*>(p.relbase) + (size_t)blockIdx.x * tb.d.Np * tb.d.K * kNF,
               e0, reinterpret_cast<const int*>(sm + tb.L.off)[tb.d.Np]);
    wg_sync(wg);  // ... read: the next tile's inputs may overwrite them
    sc.mark(kRelEpilogues);
  }
}

// Two bf16 pairs in 32-bit words: rnd(a + b), one rounding (add.rn.bf16x2,
// as rnd(float(a) + float(b))), and relu(rnd(a + b)) (fma.rn.relu: a * 1 +
// b, negatives clamped to 0).
__device__ __forceinline__ unsigned add_bf16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned add_relu_bf16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("fma.rn.relu.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(0x3f803f80u), "r"(b));
  return d;
}

// acc[c] += relu(rnd(rnd(r + recv) + sd)) for the kCPT channels of three
// 16-byte rows (bf16 pairs; the low half of a word is the lower channel).
// An sd of -inf adds relu(-inf) = 0, which leaves the sums (a zero's sign
// never shows in them) as they are.
__device__ __forceinline__ void add_messages(float (&acc)[kCPT], const uint4& r, const uint4& recv,
                                             const uint4& sd) {
  const unsigned rw[4] = {r.x, r.y, r.z, r.w}, vw[4] = {recv.x, recv.y, recv.z, recv.w};
  const unsigned sw[4] = {sd.x, sd.y, sd.z, sd.w};
#pragma unroll
  for (int q = 0; q < kCPT / 2; ++q) {
    const unsigned m = add_relu_bf16x2(add_bf16x2(rw[q], vw[q]), sw[q]);
    acc[2 * q] += __uint_as_float(m << 16);
    acc[2 * q + 1] += __uint_as_float(m & 0xffff0000u);
  }
}

// A thread's 16 bytes of rel_base rows e .. e + kRowsAhead - 1 (rows of
// kNF, from `rows`, in global memory), one predicated 16-byte global load
// each (the same load written in C++ compiled to four 4-byte generic loads);
// rows from `end` on are not read, and r keeps what it held there.
__device__ __forceinline__ void load_rows(uint4 (&r)[kRowsAhead], const bf16* rows, int e,
                                          int end) {
  const bf16* p = rows + (size_t)e * kNF;
#pragma unroll
  for (int k = 0; k < kRowsAhead; ++k)
    asm volatile(
        "{\n.reg .pred q;\nsetp.lt.s32 q, %4, %5;\n"
        "@q ld.global.v4.u32 {%0, %1, %2, %3}, [%6];\n}\n"
        : "+r"(r[k].x), "+r"(r[k].y), "+r"(r[k].z), "+r"(r[k].w)
        : "r"(e + k), "r"(end), "l"(p + k * kNF));
}

// agg[i] = sum over i's edges, in slot order, of relu(rel_base[e] + recv[i]
// + send[j]) for every receiver i < N, rounded to bf16 into AGG over recv[i]
// (each thread reads its 16 bytes of recv[i] before it writes them). AGG
// holds recv (the swizzled 128-row node matrix), SEND send (Np rows of
// kSendLd); rel_base is read from global memory, kTPR threads per receiver
// and kCPT channels (16 bytes) per thread. A receiver's edges are contiguous
// rows of rel_base: a thread loads its 16 bytes of kRowsAhead of them at once
// (load_rows), then sums them in slot order; a slot past the receiver's
// edges sums with the -inf row NINF for send and adds 0, so that no branch
// splits a warp's two receivers. It opens with a barrier (recv|send is
// written; in round 0, by the cp.async copies in flight but the newest two
// groups), then calls open(); it ends with every cp.async copy waited for
// and a barrier. Every thread calls it.
template <typename Open>
__device__ __forceinline__ void aggregate(bf16* AGG, const bf16* SEND, const bf16* relbase, int N,
                                          const int* OFF, const short* NBR, int K,
                                          const bf16* NINF, Open open, SubClock& sc) {
  sc.start();
  tc::cp_async_wait<2>();
  __syncthreads();
  open();
  sc.mark(kAggRows);
  const int tid = threadIdx.x + opaque_zero();
  const int c0 = (tid % kTPR) * kCPT;
  const bf16* rows = relbase + c0;
  const bf16* send = SEND + c0;
  const bf16* ninf = NINF + c0;
  uint4 r[kRowsAhead];
#pragma unroll
  for (int k = 0; k < kRowsAhead; ++k) r[k] = make_uint4(0, 0, 0, 0);  // finite where unread
  for (int i = tid / kTPR; i < N; i += kRecvPerPass) {
    const int ebeg = OFF[i], eend = OFF[i + 1];
    const short* nbr = NBR + i * K - ebeg;  // nbr[e]: edge e's sender
    uint4* const at = reinterpret_cast<uint4*>(AGG + tc::sw128(i, c0, kNodeRows));
    const uint4 recv = *at;
    float acc[kCPT] = {};
    for (int e = ebeg; e < eend; e += kRowsAhead) {
      load_rows(r, rows, e, eend);
#pragma unroll
      for (int k = 0; k < kRowsAhead; ++k) {
        const bool on = e + k < eend;
        const bf16* sd = on ? send + nbr[e + k] * kSendLd : ninf;
        add_messages(acc, r[k], recv, *reinterpret_cast<const uint4*>(sd));
        if (k == 0) {  // the rows are in
          acc[0] = arrived(acc[0]);
          sc.mark(kAggRows);
        }
      }
    }
    uint4 out;
    out.x = pack_bf16(acc[0], acc[1]);
    out.y = pack_bf16(acc[2], acc[3]);
    out.z = pack_bf16(acc[4], acc[5]);
    out.w = pack_bf16(acc[6], acc[7]);
    *at = out;
    sc.mark(kAggSums);
  }
  tc::cp_async_wait<0>();
  tc::fence_proxy_async();  // AGG is the update's A operand, and so are the staged weights
  __syncthreads();
}

// The pairs of the propagator base that warpgroup (mt, h)'s thread adds in
// the update: rows 16 w + g and + 8 of tile mt, columns 64 h + 8 nt + 2 t4
// and the next (nt < 8), pair nt of row half `hi` at pw[hi][nt]. The encoder
// writes pbase in this order (pbase_at), so a thread's pairs of a row are
// 32 contiguous bytes; rows from N on are not read (zeros).
__device__ __forceinline__ int pbase_at(int r, int h, int t4) { return r * kNF + 64 * h + 16 * t4; }
__device__ __forceinline__ void load_pbase(unsigned (&pw)[2][8], const bf16* pbase, int N,
                                           const NodeTile& t) {
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int r = 64 * t.mt + 16 * t.warp + (t.lane >> 2) + 8 * hi;
    uint4 a = make_uint4(0, 0, 0, 0), b = a;
    if (r < N) {
      const uint4* src = reinterpret_cast<const uint4*>(pbase + pbase_at(r, t.h, t.lane & 3));
      a = src[0];
      b = src[1];
    }
    const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) pw[hi][nt] = w[nt];
  }
}

// effect = relu(rnd(rnd(base + rnd(agg @ Wb)) + effect)) for the warpgroup's
// 64 x 64 tile (AGG in, Wb in WB, base from global memory, the effect in
// EFF, read and written in place with ldmatrix / stmatrix: no other
// warpgroup reads or writes the tile's columns); then the pair's barrier,
// after which the pair's rows of EFF hold the new effect.
__device__ __forceinline__ void update(const TcBlock& tb, unsigned char* smem, const bf16* pbase,
                                       SubClock& sc) {
  unsigned char* const sm = smem + opaque_zero();
  const NodeTile t = node_tile();
  bf16* const EFF = reinterpret_cast<bf16*>(sm + kOffEff);
  unsigned pw[2][8];
  load_pbase(pw, pbase, tb.d.N, t);  // in flight through the products
  sc.start();
  float acc[32];
  tile_products<64>(acc, reinterpret_cast<const bf16*>(sm + kOffAgg), 64 * t.mt,
                    reinterpret_cast<const bf16*>(sm + kOffWB), kNF, 64 * t.h);
  sc.mark(kNodeProducts);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bf16* const at = EFF + tc::sw128(t.row(), 64 * t.h + t.col(j), kNodeRows);
    uint32_t ef[4], q[4];
    tc::ldmatrix_x4(ef, at);
    quad(acc, j, [&](float v0, float v1, int nt, int hi) {
      return add_relu_bf16x2(add_bf16x2(pw[hi][nt], pack_bf16(v0, v1)), ef[2 * (nt & 1) + hi]);
    }, q);
    tc::stmatrix_x4(at, q);
  }
  tc::fence_proxy_async();  // EFF is the next product's A operand
  sc.mark(kNodeEpilogues);
  pair_sync(t.mt);
  sc.mark(kNodeBarriers);
}

// recv|send = rnd(effect @ W23) for the warpgroup's 64 x 128 tile (EFF in,
// W23^T, 256 rows, in X): column half 0 (recv) into AGG, the swizzled
// 128-row matrix, half 1 (send) into SEND, rows from Np on into TRASH. What
// it overwrites was read before the barrier that ended the aggregation
// (send) or the pair's barrier that ended the update (recv, over agg);
// the next aggregation's opening barrier makes it visible.
__device__ __forceinline__ void projection(const TcBlock& tb, unsigned char* smem, SubClock& sc) {
  unsigned char* const sm = smem + opaque_zero();
  const NodeTile t = node_tile();
  sc.start();
  float acc[64];
  tile_products<128>(acc, reinterpret_cast<const bf16*>(sm + kOffEff), 64 * t.mt,
                     reinterpret_cast<const bf16*>(sm + kOffX), 2 * kNF, 128 * t.h);
  sc.mark(kNodeProducts);
  bf16* const recv = reinterpret_cast<bf16*>(sm + kOffAgg);
  bf16* const send = reinterpret_cast<bf16*>(sm + kOffSTG) + t.row() * kSendLd;
  const bool send_row = t.row() < tb.d.Np;
  bf16* const trash = reinterpret_cast<bf16*>(sm + tb.L.trash);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t q[4];
    quad(acc, j, [](float v0, float v1, int, int) { return pack_bf16(v0, v1); }, q);
    if (t.h == 0)
      store_quad(recv, t, 0, j, q);
    else
      tc::stmatrix_x4(send_row ? send + t.col(j) : trash, q);
  }
  sc.mark(kNodeEpilogues);
}

// The motion head on the object rows: relu layers nr0 (EFF -> AGG) and nr1
// (AGG -> EFF) as 64 x 64 tiles, each pair over its row tile with its
// barrier between, then the 3-wide last layer on the CUDA cores by the
// pair's threads, one output (row, coordinate) each, its kNF products in k
// order read 16 bytes at a time; the clamped motion added to the last frame
// gives the predicted rows of nxt. Every thread calls it; it ends with a
// barrier.
__device__ __forceinline__ void motion_head(const TcBlock& tb, unsigned char* smem, float mc,
                                            const float* last, float* nxt, SubClock& sc) {
  unsigned char* const sm = smem + opaque_zero();
  const NodeTile t = node_tile();
  bf16* const EFF = reinterpret_cast<bf16*>(sm + kOffEff);
  bf16* const AGG = reinterpret_cast<bf16*>(sm + kOffAgg);
  const float* const bias = reinterpret_cast<const float*>(sm + tb.L.bias);
#pragma unroll
  for (int layer = 0; layer < 2; ++layer) {
    const bf16* in = layer == 0 ? EFF : AGG;
    bf16* out = layer == 0 ? AGG : EFF;
    const float* b = bias + (layer == 0 ? kBnr0 : kBnr1);
    sc.start();
    float acc[32];
    const bf16* const W = reinterpret_cast<const bf16*>(sm + kOffX) + layer * kNF * kNF;
    tile_products<64>(acc, in, 64 * t.mt, W, kNF, 64 * t.h);
    sc.mark(kNodeProducts);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t q[4];
      quad(acc, j, [&](float v0, float v1, int nt, int) {
        return bias_relu(b, v0, v1, pair_col(64 * t.h, nt));
      }, q);
      store_quad(out, t, 64 * t.h, j, q);
    }
    if (layer == 0) tc::fence_proxy_async();  // AGG is nr1's A operand
    sc.mark(kNodeEpilogues);
    pair_sync(t.mt);
    sc.mark(kNodeBarriers);
  }
  sc.start();
  const int k = (t.h * 128 + t.warp * 32 + t.lane), r = 64 * t.mt + k / 3, c = k % 3;
  if (k < 64 * 3 && r < tb.d.n_p) {
    const float* w = bias + kWnr2 + c * kW2Ld;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kNF / 8; ++q) {
      const uint4 x = *reinterpret_cast<const uint4*>(EFF + tc::sw128(r, 8 * q, kNodeRows));
      const float4 w0 = *reinterpret_cast<const float4*>(w + 8 * q);
      const float4 w1 = *reinterpret_cast<const float4*>(w + 8 * q + 4);
      s = fmaf(__uint_as_float(x.x << 16), w0.x, s);
      s = fmaf(__uint_as_float(x.x & 0xffff0000u), w0.y, s);
      s = fmaf(__uint_as_float(x.y << 16), w0.z, s);
      s = fmaf(__uint_as_float(x.y & 0xffff0000u), w0.w, s);
      s = fmaf(__uint_as_float(x.z << 16), w1.x, s);
      s = fmaf(__uint_as_float(x.z & 0xffff0000u), w1.y, s);
      s = fmaf(__uint_as_float(x.w << 16), w1.z, s);
      s = fmaf(__uint_as_float(x.w & 0xffff0000u), w1.w, s);
    }
    const float m = rnd<bf16>(s + bias[kBnr2 + c]);
    nxt[r * 3 + c] = __fadd_rn(last[r * 3 + c], fminf(fmaxf(m, -mc), mc));
  }
  sc.mark(kNodeEpilogues);
  __syncthreads();
  sc.mark(kNodeBarriers);
}

// Once per push, from the particle encoder's first layer (h1, in EFF) on:
// pe1 (EFF -> AGG) and pe2 (AGG -> EFF and the scratch penc) with the pair's
// barrier after each, then a block barrier (X free, EFF whole); Wa's product
// (EFF -> the scratch pbase, in load_pbase's order) while W23 is staged into
// X, and round 1's recv|send (EFF -> the scratch rs1, row-major). The weights
// pe1 | pe2 in X and Wa in WB are staged and visible. Every thread calls it;
// it ends with a barrier.
__device__ __forceinline__ void encoder_products(const TcBlock& tb, unsigned char* smem,
                                                 const bf16* W23, bf16* penc, bf16* pbase,
                                                 bf16* rs1, SubClock& sc) {
  unsigned char* const sm = smem + opaque_zero();
  const NodeTile t = node_tile();
  bf16* const EFF = reinterpret_cast<bf16*>(sm + kOffEff);
  bf16* const AGG = reinterpret_cast<bf16*>(sm + kOffAgg);
  const float* const bias = reinterpret_cast<const float*>(sm + tb.L.bias);
  const int N = tb.d.N, g = t.lane >> 2;
  const int r0 = 64 * t.mt + 16 * t.warp + g;  // this thread's rows: r0, r0 + 8
#pragma unroll
  for (int layer = 0; layer < 2; ++layer) {
    const bf16* in = layer == 0 ? EFF : AGG;
    bf16* out = layer == 0 ? AGG : EFF;
    const float* b = bias + (layer == 0 ? kBpe1 : kBpe2);
    sc.start();
    float acc[32];
    const bf16* const W = reinterpret_cast<const bf16*>(sm + kOffX) + layer * kNF * kNF;
    tile_products<64>(acc, in, 64 * t.mt, W, kNF, 64 * t.h);
    sc.mark(kNodeProducts);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t q[4];
      quad(acc, j, [&](float v0, float v1, int nt, int hi) {
        const int c = pair_col(64 * t.h, nt), r = r0 + 8 * hi;
        const unsigned v = bias_relu(b, v0, v1, c);
        if (layer == 1 && r < N) *reinterpret_cast<unsigned*>(penc + r * kNF + c) = v;
        return v;
      }, q);
      store_quad(out, t, 64 * t.h, j, q);
    }
    tc::fence_proxy_async();
    sc.mark(kNodeEpilogues);
    if (layer == 0)
      pair_sync(t.mt);
    else
      __syncthreads();
    sc.mark(kNodeBarriers);
  }
  stage_wt(reinterpret_cast<bf16*>(sm + kOffX), W23, 2 * kNF, kNF);
  tc::cp_async_commit();
  {  // the propagator's constant term: rnd(penc @ Wa + b)
    sc.start();
    float acc[32];
    tile_products<64>(acc, EFF, 64 * t.mt, reinterpret_cast<const bf16*>(sm + kOffWB), kNF,
                      64 * t.h);
    sc.mark(kNodeProducts);
    const float* b = bias + kBpp;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      unsigned w[8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 bb = *reinterpret_cast<const float2*>(b + pair_col(64 * t.h, nt));
        w[nt] = pack_bf16(acc[4 * nt + 2 * hi] + bb.x, acc[4 * nt + 2 * hi + 1] + bb.y);
      }
      const int r = r0 + 8 * hi;
      if (r < N) {
        uint4* dst = reinterpret_cast<uint4*>(pbase + pbase_at(r, t.h, t.lane & 3));
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
    }
    sc.mark(kNodeEpilogues);
  }
  tc::cp_async_wait<0>();
  tc::fence_proxy_async();
  __syncthreads();  // W23 is in
  sc.mark(kNodeBarriers);
  {  // round 1's recv|send: rnd(penc @ W23)
    float acc[64];
    tile_products<128>(acc, EFF, 64 * t.mt, reinterpret_cast<const bf16*>(sm + kOffX), 2 * kNF,
                       128 * t.h);
    sc.mark(kNodeProducts);
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = r0 + 8 * hi;
        if (r < N)
          *reinterpret_cast<unsigned*>(rs1 + r * 2 * kNF + pair_col(128 * t.h, nt)) =
              pack_bf16(acc[4 * nt + 2 * hi], acc[4 * nt + 2 * hi + 1]);
      }
    sc.mark(kNodeEpilogues);
  }
  __syncthreads();  // X and WB are free
  sc.mark(kNodeBarriers);
}

__device__ __forceinline__ void rollout_tc(const Params& p, unsigned char* smem_raw) {
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024u - (base & 1023u)) & 1023u);  // for the swizzle
  __shared__ TcBlock tb;
  const int b = blockIdx.x, tid = threadIdx.x;
  if (tid == 0) {
    s_zero = 0;
    tb.d = p.d;
    tb.L = make_tc_layout(p.d);
    tb.rep = p.repeat[b];
    tb.rmax = min(tb.rep, p.max_repeat);
    tb.thresh = p.thresh;
  }
  __syncthreads();
  const Dims& d = tb.d;
  const TcLayout& L = tb.L;
  // the big regions lie at fixed offsets; the small state's, read from L
  bf16* const X = reinterpret_cast<bf16*>(smem + kOffX);
  bf16* const W2 = X + kNF * kNF;  // X's second 128 x 128 weight
  bf16* const WB = reinterpret_cast<bf16*>(smem + kOffWB);
  bf16* const EFF = reinterpret_cast<bf16*>(smem + kOffEff);
  bf16* const AGG = reinterpret_cast<bf16*>(smem + kOffAgg);
  bf16* const STG = reinterpret_cast<bf16*>(smem + kOffSTG);
  const auto BIAS = [&] { return reinterpret_cast<float*>(smem + L.bias); };
  const auto HIST = [&] { return reinterpret_cast<float*>(smem + L.hist); };
  const auto VALID = [&] { return reinterpret_cast<float*>(smem + L.valid); };
  const auto ACT = [&] { return reinterpret_cast<float*>(smem + L.act); };
  const auto REC = [&] { return reinterpret_cast<float*>(smem + L.rec); };
  const auto CNT = [&] { return reinterpret_cast<int*>(smem + L.cnt); };
  const auto OFF = [&] { return reinterpret_cast<int*>(smem + L.off); };
  const auto NBR = [&] { return reinterpret_cast<short*>(smem + L.nbr); };
  const auto ER = [&] { return reinterpret_cast<short*>(smem + L.er); };
  // this sample's scratch in global memory
  const auto relbase = [&] { return static_cast<bf16*>(p.relbase) + (size_t)b * d.Np * d.K * kNF; };
  const auto penc = [&] { return static_cast<bf16*>(p.penc) + (size_t)b * d.Np * kNF; };
  const auto pbase = [&] { return static_cast<bf16*>(p.pbase) + (size_t)b * d.Np * kNF; };
  const auto rs1 = [&] { return static_cast<bf16*>(p.rs1) + (size_t)b * d.Np * 2 * kNF; };
  // ring slot h of the history (frames of Np rows)
  const auto frame = [&](int h) { return HIST() + (h % (d.n_his + 1)) * d.Np * 3; };

  constexpr int kThr = kTcThreads;
  const bf16* const* W = reinterpret_cast<const bf16* const*>(p.w);
  const bf16* const* P = reinterpret_cast<const bf16* const*>(p.tcw);
  const auto stage_relation = [&] {  // re1 | re2 in X, rp_w1 in WB, re0 in STG
    stage_wt(X, P[kRe1], kNF, kNF);
    stage_wt(W2, P[kRe2], kNF, kNF);
    stage_wt(WB, P[kRpW1], kNF, kNF);
    stage_wt(STG, P[kRe0], kNF, round_to(d.rel_in, 16));  // re0's depth past the inputs: 0
    tc::cp_async_commit();
  };
  PhaseClock clk(p, b);
  SubClock sc(p, b);

  // ---- inputs; the biases and the head's last layer as float; pe0's
  // inputs and weight as float in AGG (free until pe1's epilogue) ----
  stage_wt(X, P[kPe1], kNF, kNF);
  stage_wt(W2, P[kPe2], kNF, kNF);
  stage_wt(WB, P[kPpWa], kNF, kNF);
  tc::cp_async_commit();
  load_inputs<kThr>(p, b, VALID(), HIST(), ACT(), REC());
  if (tid < kNF / 2)
    reinterpret_cast<unsigned*>(smem + L.ninf)[tid] = 0xff80ff80u;  // bf16 -inf pairs
  {
    const bf16* src[10] = {W[1], W[3], W[5], W[7], W[9], W[11], W[14], W[17], W[19], W[21]};
    float* bias = BIAS();
    for (int idx = tid; idx < 10 * kNF; idx += kThr)
      bias[idx] = __bfloat162float(src[idx / kNF][idx % kNF]);
    for (int idx = tid; idx < 3 * kNF; idx += kThr)  // (kNF, 3) -> rows of kW2Ld
      bias[kWnr2 + (idx % 3) * kW2Ld + idx / 3] = __bfloat162float(W[22][idx]);
    if (tid < 3) bias[kBnr2 + tid] = __bfloat162float(W[23][tid]);
    const bf16* pin = static_cast<const bf16*>(p.pin) + (size_t)b * d.Np * d.Dp;
    float* w0 = reinterpret_cast<float*>(AGG);  // (Dp, kNF), then the (N, Dp) inputs
    for (int idx = tid; idx < d.Dp * kNF; idx += kThr) w0[idx] = __bfloat162float(W[0][idx]);
    for (int idx = tid; idx < d.N * d.Dp; idx += kThr)
      w0[d.Dp * kNF + idx] = __bfloat162float(pin[idx]);
  }
  __syncthreads();

  // ---- once per push: particle encoder, the propagator's constant term and
  // round 1's recv|send ----
  // pe0 on the CUDA cores: its Dp inputs are a few
  {
    const float* bias = BIAS();
    const float* w0 = reinterpret_cast<const float*>(AGG);
    const float* in = w0 + d.Dp * kNF;
    for (int idx = tid; idx < d.N * kNF; idx += kThr) {
      const int r = idx / kNF, c = idx % kNF;
      float s = 0.f;
      for (int k = 0; k < d.Dp; ++k) s = fmaf(in[r * d.Dp + k], w0[k * kNF + c], s);
      EFF[tc::sw128(r, c, kNodeRows)] = __float2bfloat16_rn(relu(s + bias[kBpe0 + c]));
    }
  }
  tc::cp_async_wait<0>();
  tc::fence_proxy_async();
  __syncthreads();
  encoder_products(tb, smem, P[kRpW23], penc(), pbase(), rs1(), sc);
  stage_relation();
  clk.mark(kEncoder);

  int start = 0;  // ring slot of the oldest history frame
  for (int ai = 1; ai <= tb.rmax; ++ai) {
    // ---- radius-and-topk graph (edge_build.cuh), compacted by receiver ----
    sc.start();
    node_rows(d, HIST(), start, reinterpret_cast<bf16*>(smem + L.nr));
    sc.mark(kGraphRows);
    // (the threshold and the thread index read where used: see TcBlock and
    // opaque_zero)
    edges::radius_topk(frame(start + d.n_his - 1), VALID(), d.Np, d.N, d.n_p, d.K, tb.thresh,
                       NBR(), CNT(), EFF, threadIdx.x + opaque_zero());  // EFF: free till then
    sc.mark(kGraphSelection);
    // the relation weights (staged during the previous head, or the
    // encoder), visible after the compaction's barriers
    tc::cp_async_wait<0>();
    tc::fence_proxy_async();
    edges::compact_edges(CNT(), NBR(), d.Np, d.K, OFF(), ER(), nullptr,
                         threadIdx.x + opaque_zero());
    sc.mark(kGraphCompaction);
    clk.mark(kGraph);
    // ---- relation encoder + rel_base over real edges ----
    relation_mlp(p, tb, smem, sc);  // EFF and AGG: the A tiles
    __syncthreads();  // rel_base is written; the relation weights are free
    // round 1's recv (into AGG) and send (into STG) and the effect's start
    // (the particle encoding, into EFF), waited for by the first
    // aggregation; Wb, and W23 when a round follows, by its end
    {
      const bf16* rs = rs1();
      const bf16* pe = penc();
      const int n = d.N * (kNF / 8);  // 16-byte chunks of a node matrix
      for (int idx = threadIdx.x + opaque_zero(); idx < n; idx += kThr) {
        const int r = idx >> 4, c = (idx & 15) * 8;
        tc::cp_async16(AGG + tc::sw128(r, c, kNodeRows), rs + r * 2 * kNF + c, true);
        tc::cp_async16(STG + r * kSendLd + c, rs + r * 2 * kNF + kNF + c, true);
        tc::cp_async16(EFF + tc::sw128(r, c, kNodeRows), pe + r * kNF + c, true);
      }
    }
    tc::cp_async_commit();
    stage_wt(WB, P[kPpWb], kNF, kNF);
    tc::cp_async_commit();
    const int pstep = __shfl_sync(kFull, d.pstep, 0);
    if (pstep > 1) stage_wt(X, P[kRpW23], 2 * kNF, kNF);
    tc::cp_async_commit();
    clk.mark(kRelation);

    // ---- pstep rounds of message passing ----
    for (int s = 0; s < pstep; ++s) {
      const bool last = s + 1 == pstep;
      aggregate(AGG, STG, relbase(), d.N, OFF(), NBR(), d.K,
                reinterpret_cast<const bf16*>(smem + L.ninf), [&] {
                  if (last) {  // the head's weights (every projection is done)
                    stage_wt(X, P[kNr0], kNF, kNF);
                    stage_wt(W2, P[kNr1], kNF, kNF);
                  }
                  tc::cp_async_commit();
                }, sc);
      clk.mark(kAggregate);
      update(tb, smem, pbase(), sc);
      clk.mark(kUpdate);
      if (!last) {
        projection(tb, smem, sc);
        clk.mark(kProjection);
      }
    }

    // ---- motion head on the object rows, clamp, predicted positions ----
    motion_head(tb, smem, p.motion_clamp, frame(start + d.n_his - 1), frame(start + d.n_his), sc);
    clk.mark(kHead);
    // the next substep's relation weights, in flight through the re-stick
    // and the next graph build
    if (ai < tb.rmax) stage_relation();

    // ---- record at this sample's repeat; re-stick the eef rows ----
    record_restick<kThr>(p, ai, tb.rep, frame(start + d.n_his - 1), frame(start + d.n_his),
                         VALID(), ACT(), REC(), reinterpret_cast<float*>(smem + L.red));
    start = (start + 1) % (d.n_his + 1);
    clk.mark(kRestick);
  }
  tc::cp_async_wait<0>();  // the relation weights staged for a sample with no substep
  sc.flush();

  const float* rec = REC();
  for (int idx = tid; idx < d.n_p * 3; idx += kThr) p.out[(size_t)b * d.n_p * 3 + idx] = rec[idx];
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
// ... and `clocks`, when not null, a zeroed (B, rollout_chunk_sub_phases())
// int64 buffer into which the following bf16 launches add thread 0's cycles
// in the sub-phases of SubPhase (the relation MLP's input build, products
// and epilogues; the aggregation's wait for rel_base's rows and its sums;
// the graph build's node rows, selection and compaction; the node-sized
// products' products, epilogues and barriers), which overlap the phases above
void rollout_chunk_set_sub_clocks(void* clocks) {
  g_sub_clocks = static_cast<long long*>(clocks);
}
int rollout_chunk_sub_phases() { return kSubPhases; }
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
  p.sub_clocks = bf16_mode ? g_sub_clocks : nullptr;
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
