// Single-step GNN forward with prebuilt edges, one thread block per sample.
//
// Replaces the TPU kernel adaptigraph_tpu/ops/fused_gnn.py::_kernel as
// fused_forward_batch launches it with prebuilt edge tables (the training
// forward; the in-kernel edge build is not ported here). Per sample: the
// relation features of the real edges, the relation and particle encoders,
// pstep rounds of message passing with the hoisted rel_base / part_base
// terms, the motion head, pred = last + clip(motion), and the raw motion.
//
// What bounds it on an H100: arithmetic. At rope width (N 101, nf 128,
// pstep 3) the node-level products are ~50 MFLOP per sample against a few KB
// of inputs; the relation MLP adds ~0.1 MFLOP per real edge.
//
// What the design does about it, simply: float32 products on the CUDA cores
// (gnn_common.cuh's tiled gemm), in both compute dtypes; bfloat16 mode reads
// bf16 inputs and weights and rounds every layer's output to bf16 where the
// JAX kernel casts, so its activations are exact bf16 values kept in float32.
// Only real edges are computed (masked slots add exact zeros in the JAX
// kernel). Activations live in two global tensors from the wrapper, every
// one kept (gnn_common.cuh's act_bufs): a block's node and edge tensors do
// not fit in shared memory beside the gemm tiles, and the training backward
// (gnn_train_bwd.cu) reads them instead of recomputing the forward. The
// tensor cores are later work.

#include "gnn_common.cuh"

namespace {

using namespace gnn;

struct Params {
  const void* nodes;   // (B, Np, D) compute dtype
  const int* nbr;      // (B, K*Np) senders, (k, i) order
  const float* mask;   // (B, K*Np)
  const float* last;   // (B, Np, 3)
  const void* w[kNumWeights];
  float* node_acts;    // B x act_node_floats
  float* edge_acts;    // B x act_edge_floats
  float* pred;         // (B, n_p, 3)
  float* motion;       // (B, n_p, 3) or null
  Dims d;
  float motion_clamp;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) gnn_forward_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Dims d = p.d;
  const int b = blockIdx.x, Np = d.Np, nf = d.nf;
  const Smem L = smem_layout(Np, d.K, false);
  float* sm = reinterpret_cast<float*>(smem);
  int* off = reinterpret_cast<int*>(smem + L.off);
  short* er = reinterpret_cast<short*>(smem + L.er);
  short* es = reinterpret_cast<short*>(smem + L.es);

  const T* nodes = static_cast<const T*>(p.nodes) + (size_t)b * Np * d.D;
  const int E = build_edges(p.nbr + (size_t)b * d.K * Np, p.mask + (size_t)b * d.K * Np, Np, d.K,
                            off, er, es, nullptr, nullptr);

  const FwdBufs f = act_bufs(d, p.node_acts, p.edge_acts, b);
  const T* w[kNumWeights];
  for (int i = 0; i < kNumWeights; ++i) w[i] = static_cast<const T*>(p.w[i]);
  forward_body<T>(d, nodes, w, E, off, er, es, f, sm);

  // motion head's last layer (no relu), the clamp and the position update
  const float* last = p.last + (size_t)b * Np * 3;
  float* pred = p.pred + (size_t)b * d.n_p * 3;
  float* motion = p.motion ? p.motion + (size_t)b * d.n_p * 3 : nullptr;
  const T* bias = w[kNr2b];
  const float clamp = p.motion_clamp;
  gemm(d.n_p, 3, nf, f.nr_h2, (size_t)nf, (size_t)1, w[kNr2w], (size_t)3, (size_t)1, sm,
       [&](int m, int n, float c) {
         const float mot = rnd<T>(c + ld(bias + n));
         if (motion) motion[m * 3 + n] = mot;
         pred[m * 3 + n] = last[m * 3 + n] + fminf(fmaxf(mot, -clamp), clamp);
       });
}

template <typename T>
int launch(const Params& p, int B, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_layout(p.d.Np, p.d.K, false).total;
  err = cudaFuncSetAttribute(gnn_forward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) gnn_forward_kernel<T><<<B, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Activation floats per sample: which 0 = node buffers, 1 = edge buffers.
long long gnn_forward_act_floats(int Np, int K, int pstep, int nf_p, int nf_r, int nf, int rel_in,
                                 int which) {
  Dims d{};
  d.Np = Np; d.K = K; d.pstep = pstep; d.nf_p = nf_p; d.nf_r = nf_r; d.nf = nf; d.rel_in = rel_in;
  return (long long)(which == 0 ? act_node_floats(d) : act_edge_floats(d));
}

int gnn_forward_smem_bytes(int Np, int K) { return (int)smem_layout(Np, K, false).total; }

const char* gnn_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// Launch on `stream` without synchronising; returns cudaGetLastError().
int gnn_forward_launch(const void* nodes, const void* nbr, const void* mask, const void* last,
                       const void* const* weights, void* node_acts, void* edge_acts,
                       void* pred, void* motion, int B, int Np, int N, int n_p, int K, int n_his,
                       int pstep, int Dp, int D, int nf_p, int nf_r, int nf, int rel_in,
                       float motion_clamp, int bf16_mode, int device, void* stream) {
  Params p;
  p.nodes = nodes;
  p.nbr = static_cast<const int*>(nbr);
  p.mask = static_cast<const float*>(mask);
  p.last = static_cast<const float*>(last);
  for (int i = 0; i < kNumWeights; ++i) p.w[i] = weights[i];
  p.node_acts = static_cast<float*>(node_acts);
  p.edge_acts = static_cast<float*>(edge_acts);
  p.pred = static_cast<float*>(pred);
  p.motion = static_cast<float*>(motion);
  p.d = Dims{Np, N, n_p, K, n_his, pstep, Dp, D, nf_p, nf_r, nf, rel_in};
  p.motion_clamp = motion_clamp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_mode ? launch<bf16>(p, B, device, s) : launch<float>(p, B, device, s);
}

}  // extern "C"
