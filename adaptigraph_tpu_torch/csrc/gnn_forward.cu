// Single-step GNN forward, one thread block per sample at a time.
//
// Replaces the TPU kernel adaptigraph_tpu/ops/fused_gnn.py::_kernel as
// fused_forward_batch launches it, in both of its edge modes:
// - prebuilt edges (K2; training, and the planning step of the tool edge
//   policies): (k, i)-ordered sender and mask tables;
// - the in-kernel radius-and-topk build (K2e, build_edges=True; the per-substep
//   MPPI step of policy none, _edges_stacked): the graph of the newest frame,
//   built by edge_build.cuh's routine, the one the whole-push rollout
//   (rollout_chunk.cu) runs, into the same edge lists, so K2e on a state gives
//   K2's result on the tables that the plain graph build makes of it, bit for
//   bit.
// Per sample: the relation features of the real edges, the relation and
// particle encoders, pstep rounds of message passing with the hoisted rel_base
// / part_base terms, the motion head, pred = last + clip(motion), and the raw
// motion.
//
// What bounds it on an H100: arithmetic. At rope width (N 101, nf 128,
// pstep 3) the node-level products are ~50 MFLOP per sample against a few KB
// of inputs; the relation MLP adds ~0.1 MFLOP per real edge. One sample a
// block and one block an SM (up to 255 registers a thread), so the latency of
// each product and each epilogue is what the card sees unless the block
// hides it itself.
//
// What the design does about it: every product of depth and width >= 16
// runs on the tensor cores through gnn_common.cuh's layer routine, bf16 on
// wgmma and float32 as split TF32 (3xTF32) on wgmma tf32, from weights packed
// once per launch (ops/fused_gnn.py::pack_tc_weights); pe0 and the motion
// head's last layer stay on the CUDA cores. The routine hides latency
// within the block: its k-steps are asynchronous commit groups, each waited
// for behind the next while the CUDA cores add the previous step's sums
// (no wait after each step, so ptxas does not serialise the wgmma), and the
// two warpgroups run their own row tiles, each staging its next tile during
// its products, so one's epilogue (bias, relu, rounding, the redos) runs
// while the other's products do. Only real edges are
// computed (masked slots add exact zeros in the JAX kernel). A block's node
// and edge activations do not fit in shared memory beside the tiles, so they
// live in global buffers from the wrapper, in the compute dtype:
// - training (keep): every activation of every sample in its own place
//   (act_bufs), one block per sample; the backward (gnn_train_bwd.cu) reads
//   them instead of recomputing the forward;
// - a forward alone: one scratch per resident block (scratch_bufs), the grid
//   no larger than the blocks the card holds at once, each block looping over
//   samples; so the scratch does not grow with the batch (the planning batch
//   is 2,000) and no message is written.
//
// Profiling builds (ops/kernels.py variants; the counterpart of the JAX
// profiling copy scripts/profile_kernel_parts.py) change only the in-kernel
// graph: -DGNN_ABLATE_NO_EDGE gives every row i < Np the K senders
// (i + k) mod Np, every slot real (no distance work); -DGNN_ABLATE_NO_GATHER
// makes every edge's sender its receiver (no gather), on the graph built.

#include "device_guard.cuh"
#include "gnn_common.cuh"

namespace {

using namespace gnn;

static_assert(edges::scratch_bytes(kThreads / 32) <= tc_bytes<bf16>() &&
                  edges::scratch_bytes(kThreads / 32) <= tc_bytes<float>(),
              "the graph build's keys fit in the tensor-core tiles");

struct Params {
  const void* nodes;   // (B, Np, D) compute dtype
  const int* nbr;      // (B, K*Np) senders, (k, i) order; null: build in the kernel
  const float* mask;   // (B, K*Np)
  const float* last;   // (B, Np, 3)
  const void* w[kNumWeights];
  const void* hi[kNumTc];  // packed tensor-core weights (W^T, depth padded to 16)
  const void* lo[kNumTc];  // float32: their second TF32 parts; bf16: null
  void* node_acts;     // keep: B x act_node_elems; else grid x scratch_node_elems (compute dtype)
  void* edge_acts;     // keep: B x act_edge_elems; else grid x scratch_edge_elems
  float* pred;         // (B, n_p, 3)
  float* motion;       // (B, n_p, 3) or null
  Dims d;
  float motion_clamp;
  float thresh;        // radius², for the in-kernel build
  int B, keep;
};

// The in-kernel graph of sample b's newest frame into off/er/es (K2e).
__device__ int build_radius_edges(const Params& p, const Smem& L, unsigned char* smem, int b,
                                  int* off, short* er, short* es) {
  const Dims& d = p.d;
  const int Np = d.Np, K = d.K;
#ifdef GNN_ABLATE_NO_EDGE
  for (int idx = threadIdx.x; idx < Np * K; idx += blockDim.x) {
    const int i = idx / K, k = idx % K;
    er[idx] = (short)i;
    es[idx] = (short)((i + k) % Np);
  }
  for (int i = threadIdx.x; i <= Np; i += blockDim.x) off[i] = i * K;
  __syncthreads();
  const int E = Np * K;
#else
  short* nbr = reinterpret_cast<short*>(smem + L.nbr);
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);
  // the keys of the graph build in the tensor-core tiles, free until the forward
  edges::radius_topk(p.last + (size_t)b * Np * 3, nullptr, Np, d.N, d.n_p, K, p.thresh, nbr, cnt,
                     smem, threadIdx.x);
  const int E = edges::compact_edges(cnt, nbr, Np, K, off, er, es, threadIdx.x);
#endif
#ifdef GNN_ABLATE_NO_GATHER
  for (int e = threadIdx.x; e < E; e += blockDim.x) es[e] = er[e];
  __syncthreads();
#endif
  return E;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gnn_forward_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  __shared__ Dims sD;  // read where used, as the pointers below are
  if (threadIdx.x == 0) sD = p.d;
  __syncthreads();
  const Dims& d = sD;
  const int Np = d.Np, nf = d.nf;
  const Smem L = smem_layout(Np, d.K, false, p.nbr == nullptr, !std::is_same<T, float>::value);
  float* sm = reinterpret_cast<float*>(smem);
  int* off = reinterpret_cast<int*>(smem + L.off);
  short* er = reinterpret_cast<short*>(smem + L.er);
  short* es = reinterpret_cast<short*>(smem + L.es);
  // the weights' and the activations' pointers live in shared memory and
  // are read where used: held in registers for the whole kernel they would
  // crowd out the layer routine's accumulators
  __shared__ Weights<T> sW;
  __shared__ FwdBufs<T> sF;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kNumWeights; ++i) sW.w[i] = static_cast<const T*>(p.w[i]);
    for (int i = 0; i < kNumTc; ++i) {
      sW.hi[i] = static_cast<const T*>(p.hi[i]);
      sW.lo[i] = static_cast<const T*>(p.lo[i]);
    }
  }
  const Weights<T>& W = sW;
  const FwdBufs<T>& f = sF;

  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    GNN_PHASE(-1);
    const T* nodes = static_cast<const T*>(p.nodes) + (size_t)b * Np * d.D;
    const int E = p.nbr ? build_edges(p.nbr + (size_t)b * d.K * Np, p.mask + (size_t)b * d.K * Np,
                                      Np, d.K, off, er, es, nullptr, nullptr)
                        : build_radius_edges(p, L, smem, b, off, er, es);
    GNN_PHASE(9);
    if (threadIdx.x == 0)
      sF = p.keep ? act_bufs<T>(d, p.node_acts, p.edge_acts, b)
                  : scratch_bufs<T>(d, p.node_acts, p.edge_acts, blockIdx.x);
    __syncthreads();
    forward_body<T>(d, nodes, W, E, off, er, es, f, smem);

    // motion head's last layer (no relu; 3 outputs, on the CUDA cores), the
    // clamp and the position update
    const float* last = p.last + (size_t)b * Np * 3;
    float* pred = p.pred + (size_t)b * d.n_p * 3;
    float* motion = p.motion ? p.motion + (size_t)b * d.n_p * 3 : nullptr;
    const T* bias = W.w[kNr2b];
    const float clamp = p.motion_clamp;
    gemm(d.n_p, 3, nf, f.nr_h2, (size_t)nf, (size_t)1, W.w[kNr2w], (size_t)3, (size_t)1, sm,
         [&](int m, int n, float c) {
           const float mot = rnd<T>(c + ld(bias + n));
           if (motion) motion[m * 3 + n] = mot;
           pred[m * 3 + n] = last[m * 3 + n] + fminf(fmaxf(mot, -clamp), clamp);
         });
    GNN_PHASE(10);
  }
}

// Blocks in the grid: one per sample with `keep`, else at most the blocks the
// card runs at once (each needs a scratch slot).
template <typename T>
int grid_blocks(int B, int keep, size_t smem, int device, int* out) {
  if (keep) { *out = B; return 0; }
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaFuncSetAttribute(gnn_forward_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gnn_forward_kernel<T>, kThreads,
                                                        smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int resident = imax(per_sm, 1) * sms;
  *out = B < resident ? B : resident;
  return 0;
}

template <typename T>
int launch(const Params& p, int grid, int device, cudaStream_t stream) {
  const CurrentDeviceGuard restore;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      smem_layout(p.d.Np, p.d.K, false, p.nbr == nullptr, !std::is_same<T, float>::value).total;
  err = cudaFuncSetAttribute(gnn_forward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (p.B > 0) gnn_forward_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#ifdef GNN_PHASE_CLOCKS
// The profiling build's counters: 16 SM-cycle sums, one per phase
// (GNN_PHASE in forward_body and the kernel), added by every block.
int gnn_forward_set_phase_clocks(void* counters) {
  return (int)cudaMemcpyToSymbol(g_phase_clocks, &counters, sizeof(counters));
}
#endif

// Activation elements (of the compute dtype) per sample (keep) or per block
// (a forward alone, keep 0): which 0 = node buffers, 1 = edge buffers.
long long gnn_forward_act_elems(int Np, int K, int pstep, int nf_p, int nf_r, int nf, int rel_in,
                                int which, int keep) {
  Dims d{};
  d.Np = Np; d.K = K; d.pstep = pstep; d.nf_p = nf_p; d.nf_r = nf_r; d.nf = nf; d.rel_in = rel_in;
  if (keep) return (long long)(which == 0 ? act_node_elems(d) : act_edge_elems(d));
  return (long long)(which == 0 ? scratch_node_elems(d) : scratch_edge_elems(d));
}

// Where each kept activation buffer of a sample starts (act_bufs), in
// elements of the compute dtype from the sample's first: which 0 = the node
// buffers pe_h1, pe_h2, effs, pb, rs, aggs, nr_h1, nr_h2; which 1 = the edge
// buffers rel_in, re_h1, re_h2, r_enc, rel_base, ms; then their end. Fills
// out and returns the number of values (9 or 7).
int gnn_forward_act_offsets(int Np, int K, int pstep, int nf_p, int nf_r, int nf, int rel_in,
                            int which, long long* out) {
  Dims d{};
  d.Np = Np; d.K = K; d.pstep = pstep; d.nf_p = nf_p; d.nf_r = nf_r; d.nf = nf; d.rel_in = rel_in;
  float* base = reinterpret_cast<float*>(alignof(float) * 1024);  // any aligned address
  const FwdBufs<float> f = act_bufs<float>(d, base, base, 0);
  const float* starts[2][8] = {{f.pe_h1, f.pe_h2, f.effs, f.pb, f.rs, f.aggs, f.nr_h1, f.nr_h2},
                               {f.rel_in, f.re_h1, f.re_h2, f.r_enc, f.rel_base, f.ms}};
  const int n = which == 0 ? 8 : 6;
  for (int i = 0; i < n; ++i) out[i] = starts[which][i] - base;
  out[n] = (long long)(which == 0 ? act_node_elems(d) : act_edge_elems(d));
  return n + 1;
}

// Shared memory of a block; `radius` for the in-kernel graph build.
int gnn_forward_smem_bytes(int Np, int K, int radius, int bf16_mode) {
  return (int)smem_layout(Np, K, false, radius != 0, bf16_mode != 0).total;
}

// The grid a launch of B samples uses (its number of scratch slots when keep
// is 0); returns a CUDA error code, 0 on success.
int gnn_forward_grid(int B, int Np, int K, int radius, int keep, int bf16_mode, int device,
                     int* blocks) {
  const CurrentDeviceGuard restore;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_layout(Np, K, false, radius != 0, bf16_mode != 0).total;
  return bf16_mode ? grid_blocks<bf16>(B, keep, smem, device, blocks)
                   : grid_blocks<float>(B, keep, smem, device, blocks);
}

const char* gnn_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// Launch on `stream` without synchronising; returns cudaGetLastError(). With
// nbr null the graph is built in the kernel from `last` with radius² thresh
// (mask unused). packed: the kNumTc hi pointers, then the kNumTc lo ones
// (null in bf16). `grid` from gnn_forward_grid.
int gnn_forward_launch(const void* nodes, const void* nbr, const void* mask, const void* last,
                       const void* const* weights, const void* const* packed, void* node_acts,
                       void* edge_acts, void* pred, void* motion, int B, int Np, int N, int n_p,
                       int K, int n_his, int pstep, int Dp, int D, int nf_p, int nf_r, int nf,
                       int rel_in, float motion_clamp, float thresh, int keep, int grid,
                       int bf16_mode, int device, void* stream) {
  Params p;
  p.nodes = nodes;
  p.nbr = static_cast<const int*>(nbr);
  p.mask = static_cast<const float*>(mask);
  p.last = static_cast<const float*>(last);
  for (int i = 0; i < kNumWeights; ++i) p.w[i] = weights[i];
  for (int i = 0; i < kNumTc; ++i) {
    p.hi[i] = packed[i];
    p.lo[i] = packed[kNumTc + i];
  }
  p.node_acts = node_acts;
  p.edge_acts = edge_acts;
  p.pred = static_cast<float*>(pred);
  p.motion = static_cast<float*>(motion);
  p.d = Dims{Np, N, n_p, K, n_his, pstep, Dp, D, nf_p, nf_r, nf, rel_in};
  p.motion_clamp = motion_clamp;
  p.thresh = thresh;
  p.B = B;
  p.keep = keep;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_mode ? launch<bf16>(p, grid, device, s) : launch<float>(p, grid, device, s);
}

}  // extern "C"
