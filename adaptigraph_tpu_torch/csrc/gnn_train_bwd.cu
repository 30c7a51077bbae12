// Backward of the single-step GNN forward with prebuilt edges, in float32 or
// bfloat16, one thread block per sample, plus a reduction of the per-sample
// weight gradients.
//
// Replaces the TPU kernel adaptigraph_tpu/ops/fused_gnn_train.py::
// _train_bwd_kernel (launched by _bwd_pallas). The TPU kernel recomputes the
// forward in VMEM; here the forward kernel (gnn_forward.cu) has already
// written every activation to global memory, and this kernel reads them
// (gnn_common.cuh's act_bufs). Per sample it runs the chain rule back from
// the raw-motion cotangent: the motion head, the pstep rounds in reverse
// (message relu masks, receiver sums and sender scatters as ordered sums
// over each node's edges), the particle and relation encoders, and the
// relation features. It writes the packed node cotangents and the sample's
// 24 weight gradients. The clip derivative and the state-history chain rule
// stay in the wrapper, as in the JAX package.
//
// Both compute dtypes are one template (T, as in gnn_forward.cu). The
// bfloat16 mode reads bf16 nodes and weights and K2's float32 activations,
// which hold exact bf16 values, and rounds to bf16 exactly where the TPU
// kernel casts to its compute dtype: the raw-motion cotangent on entry,
// every cotangent product dX = dY W^T (but the particle inputs' one), the
// residual sums d_eff = d_pre + ... and d_p_enc = d_eff + ..., the receiver
// and sender sums of the message cotangents, and the propagator-base
// cotangents summed over the rounds in float32 and cast once. Weight
// gradients and the packed node cotangents are float32 sums of those
// values, as the TPU kernel's float32 accumulations of bf16 operands.
//
// What bounds it on an H100: in float32, arithmetic, about twice the
// forward's (two products per layer: dX = dY W^T and dW = X^T dY). In
// bfloat16 at the tensor cores' rate the products would take a tenth of the
// time of reading K2's float32 activations, so there the bytes bound it.
//
// What the design does about it, simply: float32 products on the CUDA cores
// through the one tiled gemm in both modes (the tensor cores are later
// work); cotangents in a global scratch from the wrapper (edge-sized ones on
// real edges only). The TPU kernel
// accumulates weight gradients across its sequential grid; blocks here run
// in parallel, so each writes its sample's gradients to its own slot and a
// second launch sums the slots in sample order. No atomics: a rerun is
// bit-identical.

#include <type_traits>

#include "gnn_common.cuh"

namespace {

using namespace gnn;

struct Params {
  const void* nodes;   // (B, Np, D) compute dtype
  const int* nbr;      // (B, K*Np) senders, (k, i) order
  const float* mask;   // (B, K*Np)
  const float* dmot;   // (B, Np, 3) raw-motion cotangent, zero beyond the object rows
  const void* w[kNumWeights];  // compute dtype
  float* node_acts;    // B x act_node_floats, the forward's (read only)
  float* edge_acts;    // B x act_edge_floats, the forward's (read only)
  float* node_scratch; // B x node_floats
  float* edge_scratch; // B x edge_floats
  float* dnodes;       // (B, Np, D)
  float* partial;      // (B, n_grad) per-sample weight gradients
  int goff[kNumWeights + 1];  // each weight's offset in a sample's slot
  Dims d;
};

__host__ __device__ inline int wn_of(const Dims& d) { return imax(d.nf_p, d.nf); }
__host__ __device__ inline int we_of(const Dims& d) { return imax(imax(d.nf_r, d.nf), d.rel_in); }

// dA, dB (wn), d_eff, d_pre, d_pb, d_agg, d_rs (2 nf)
__host__ __device__ inline size_t node_floats(const Dims& d) {
  return (size_t)d.Np * (2 * wn_of(d) + 6 * d.nf);
}

// d_m, d_rb, dA, dB (we)
__host__ __device__ inline size_t edge_floats(const Dims& d) {
  return (size_t)d.Np * d.K * (2 * d.nf + 2 * we_of(d));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gnn_train_bwd_kernel(Params p) {
  constexpr bool kRound = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const Dims d = p.d;
  const int b = blockIdx.x, Np = d.Np, nf = d.nf, nfp = d.nf_p, nfr = d.nf_r, rin = d.rel_in;
  const int D = d.D, Dp = d.Dp, nh3 = d.n_his * 3, P = d.pstep;
  const Smem L = smem_layout(Np, d.K, true);
  float* sm = reinterpret_cast<float*>(smem);
  int* off = reinterpret_cast<int*>(smem + L.off);
  int* soff = reinterpret_cast<int*>(smem + L.soff);
  short* er = reinterpret_cast<short*>(smem + L.er);
  short* es = reinterpret_cast<short*>(smem + L.es);
  int* sl = reinterpret_cast<int*>(smem + L.sl);

  const T* nodes = static_cast<const T*>(p.nodes) + (size_t)b * Np * D;
  const int E = build_edges(p.nbr + (size_t)b * d.K * Np, p.mask + (size_t)b * d.K * Np, Np, d.K,
                            off, er, es, soff, sl);

  // ---- the forward's activations, then this kernel's scratch ----
  const FwdBufs f = act_bufs(d, p.node_acts, p.edge_acts, b);
  const size_t nN = Np, eN = (size_t)Np * d.K;
  const int wn = wn_of(d), we = we_of(d);
  float* at = p.node_scratch + (size_t)b * node_floats(d);
  float* dA = at;    at += nN * wn;
  float* dB = at;    at += nN * wn;
  float* d_eff = at; at += nN * nf;
  float* d_pre = at; at += nN * nf;
  float* d_pb = at;  at += nN * nf;
  float* d_agg = at; at += nN * nf;
  float* d_rs = at;
  float* ae = p.edge_scratch + (size_t)b * edge_floats(d);
  float* d_m = ae;  ae += eN * nf;
  float* d_rb = ae; ae += eN * nf;
  float* dEA = ae;  ae += eN * we;
  float* dEB = ae;

  const T* w[kNumWeights];
  for (int i = 0; i < kNumWeights; ++i) w[i] = static_cast<const T*>(p.w[i]);

  float* g = p.partial + (size_t)b * p.goff[kNumWeights];
  float* dnodes = p.dnodes + (size_t)b * Np * D;

  // dW = X^T dY over `rows` rows, written or (acc) added to weight `wi`'s slot
  auto wgrad = [&](int wi, const auto* X, int ldx, int kin, const float* dY, int ldy, int nout,
                   int rows, bool acc) {
    float* G = g + p.goff[wi];
    gemm(kin, nout, rows, X, (size_t)1, (size_t)ldx, dY, (size_t)ldy, (size_t)1, sm,
         [&](int m, int n, float c) {
           const size_t i = (size_t)m * nout + n;
           G[i] = acc ? G[i] + c : c;
         });
  };
  // db = column sums of dY, rows in order
  auto bgrad = [&](int wi, const float* dY, int ldy, int nout, int rows) {
    float* G = g + p.goff[wi];
    for (int n = threadIdx.x; n < nout; n += kThreads) {
      float s = 0.f;
      for (int m = 0; m < rows; ++m) s += dY[(size_t)m * ldy + n];
      G[n] = s;
    }
    __syncthreads();
  };
  // out = (dY @ W^T [+ add]) [* (H > 0)]; W is (kin, nout) row-major. With
  // `round`, the product and then the sum are rounded to T.
  auto bprop = [&](int rows, int kin, int nout, const float* dY, int ldy, const T* Wt,
                   const float* add, const float* H, float* out, int ldo, bool round) {
    gemm(rows, kin, nout, dY, (size_t)ldy, (size_t)1, Wt, (size_t)1, (size_t)nout, sm,
         [&](int m, int n, float c) {
           float v = round ? rnd<T>(c) : c;
           if (add) v = rnd<T>(v + add[(size_t)m * kin + n]);
           if (H) v = H[(size_t)m * kin + n] > 0.f ? v : 0.f;
           out[(size_t)m * ldo + n] = v;
         });
  };

  // ---- motion head ----
  const float* dmot = p.dmot + (size_t)b * Np * 3;
  if (kRound) {  // the cotangent in T, in dB until the motion head's first product is done
    for (int idx = threadIdx.x; idx < Np * 3; idx += kThreads) dB[idx] = rnd<T>(dmot[idx]);
    __syncthreads();
    dmot = dB;
  }
  const float* effP = f.effs + (size_t)P * f.eff_step;
  wgrad(kNr2w, f.nr_h2, nf, nf, dmot, 3, 3, Np, false);
  bgrad(kNr2b, dmot, 3, 3, Np);
  bprop(Np, nf, 3, dmot, 3, w[kNr2w], nullptr, f.nr_h2, dA, nf, true);
  wgrad(kNr1w, f.nr_h1, nf, nf, dA, nf, nf, Np, false);
  bgrad(kNr1b, dA, nf, nf, Np);
  bprop(Np, nf, nf, dA, nf, w[kNr1w], nullptr, f.nr_h1, dB, nf, true);
  wgrad(kNr0w, effP, nf, nf, dB, nf, nf, Np, false);
  bgrad(kNr0b, dB, nf, nf, Np);
  bprop(Np, nf, nf, dB, nf, w[kNr0w], nullptr, nullptr, d_eff, nf, true);

  // ---- pstep rounds, last first ----
  for (int t = P - 1; t >= 0; --t) {
    const bool first = t == P - 1;
    const float* eff_next = f.effs + (size_t)(t + 1) * f.eff_step;
    for (int idx = threadIdx.x; idx < Np * nf; idx += kThreads) {
      const float v = eff_next[idx] > 0.f ? d_eff[idx] : 0.f;
      d_pre[idx] = v;
      d_pb[idx] = first ? v : d_pb[idx] + v;
    }
    __syncthreads();
    wgrad(kPpWb, f.aggs + (size_t)t * f.agg_step, nf, nf, d_pre, nf, nf, Np, !first);
    bprop(Np, nf, nf, d_pre, nf, w[kPpWb], nullptr, nullptr, d_agg, nf, true);
    const float* ms = f.ms + (size_t)t * f.ms_step;
    for (int idx = threadIdx.x; idx < E * nf; idx += kThreads) {
      const int e = idx / nf, c = idx % nf;
      const float v = ms[idx] > 0.f ? d_agg[(size_t)er[e] * nf + c] : 0.f;
      d_m[idx] = v;
      d_rb[idx] = first ? v : d_rb[idx] + v;
    }
    __syncthreads();
    // d_rs = [receiver sums | sender sums] of the message cotangents
    for (int idx = threadIdx.x; idx < Np * nf; idx += kThreads) {
      const int i = idx / nf, c = idx % nf;
      float r = 0.f, s = 0.f;
      for (int e = off[i]; e < off[i + 1]; ++e) r += d_m[(size_t)e * nf + c];
      for (int q = soff[i]; q < soff[i + 1]; ++q) s += d_m[(size_t)sl[q] * nf + c];
      d_rs[(size_t)i * 2 * nf + c] = rnd<T>(r);
      d_rs[(size_t)i * 2 * nf + nf + c] = rnd<T>(s);
    }
    __syncthreads();
    wgrad(kRpW23, f.effs + (size_t)t * f.eff_step, nf, nf, d_rs, 2 * nf, 2 * nf, Np, !first);
    bprop(Np, nf, 2 * nf, d_rs, 2 * nf, w[kRpW23], d_pre, nullptr, d_eff, nf, true);
  }
  if (kRound) {  // the propagator-base cotangents, summed over the rounds, in T
    for (int idx = threadIdx.x; idx < Np * nf; idx += kThreads) d_pb[idx] = rnd<T>(d_pb[idx]);
    for (int idx = threadIdx.x; idx < E * nf; idx += kThreads) d_rb[idx] = rnd<T>(d_rb[idx]);
    __syncthreads();
  }

  // ---- particle side: propagator base, then the encoder ----
  bgrad(kPpB, d_pb, nf, nf, Np);
  wgrad(kPpWa, f.effs, nf, nf, d_pb, nf, nf, Np, false);
  bprop(Np, nf, nf, d_pb, nf, w[kPpWa], d_eff, f.effs, dA, nf, true);      // d p_enc, relu mask
  wgrad(kPe2w, f.pe_h2, nfp, nfp, dA, nf, nf, Np, false);
  bgrad(kPe2b, dA, nf, nf, Np);
  bprop(Np, nfp, nf, dA, nf, w[kPe2w], nullptr, f.pe_h2, dB, nfp, true);
  wgrad(kPe1w, f.pe_h1, nfp, nfp, dB, nfp, nfp, Np, false);
  bgrad(kPe1b, dB, nfp, nfp, Np);
  bprop(Np, nfp, nfp, dB, nfp, w[kPe1w], nullptr, f.pe_h1, dA, nfp, true);
  wgrad(kPe0w, nodes, D, Dp, dA, nfp, nfp, Np, false);
  bgrad(kPe0b, dA, nfp, nfp, Np);
  bprop(Np, Dp, nfp, dA, nfp, w[kPe0w], nullptr, nullptr, dnodes, D, false);  // d p_inputs, f32

  // ---- relation side: relation base, then the encoder ----
  bgrad(kRpB, d_rb, nf, nf, E);
  wgrad(kRpW1, f.r_enc, nf, nf, d_rb, nf, nf, E, false);
  bprop(E, nf, nf, d_rb, nf, w[kRpW1], nullptr, f.r_enc, dEA, nf, true);
  wgrad(kRe2w, f.re_h2, nfr, nfr, dEA, nf, nf, E, false);
  bgrad(kRe2b, dEA, nf, nf, E);
  bprop(E, nfr, nf, dEA, nf, w[kRe2w], nullptr, f.re_h2, dEB, nfr, true);
  wgrad(kRe1w, f.re_h1, nfr, nfr, dEB, nfr, nfr, E, false);
  bgrad(kRe1b, dEB, nfr, nfr, E);
  bprop(E, nfr, nfr, dEB, nfr, w[kRe1w], nullptr, f.re_h1, dEA, nfr, true);
  wgrad(kRe0w, f.rel_in, rin, rin, dEA, nfr, nfr, E, false);
  bgrad(kRe0b, dEA, nfr, nfr, E);
  bprop(E, rin, nfr, dEA, nfr, w[kRe0w], nullptr, nullptr, dEB, rin, true);  // d rel_in

  // ---- relation features -> packed node_g = [state_norm | attrs | g] ----
  // rel_in = [T_a | G_a | |T_g - G_g| | T_sn - G_sn]; d|x| = sign(x) with
  // abs'(0) = 1, the JAX convention
  const int Dg = nh3 + 3;
  auto sg = [&](int e) {
    const float x = ld(nodes + (size_t)er[e] * D + Dp + nh3 + 2) - ld(nodes + (size_t)es[e] * D + Dp + nh3 + 2);
    return x < 0.f ? -1.f : 1.f;
  };
  for (int idx = threadIdx.x; idx < Np * Dg; idx += kThreads) {
    const int i = idx / Dg, c = idx % Dg;
    float s = 0.f;
    for (int e = off[i]; e < off[i + 1]; ++e) {  // i receives: the T side
      const float* dr = dEB + (size_t)e * rin;
      s += c < nh3 ? dr[5 + c] : c < nh3 + 2 ? dr[c - nh3] : dr[4] * sg(e);
    }
    for (int q = soff[i]; q < soff[i + 1]; ++q) {  // i sends: the G side
      const int e = sl[q];
      const float* dr = dEB + (size_t)e * rin;
      s += c < nh3 ? -dr[5 + c] : c < nh3 + 2 ? dr[2 + c - nh3] : -(dr[4] * sg(e));
    }
    dnodes[(size_t)i * D + Dp + c] = s;
  }
}

// grads[i] = sum over samples b, in order, of partial[b][i]
__global__ void sum_samples_kernel(const float* partial, int B, int n, float* grads) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += partial[(size_t)b * n + i];
  grads[i] = s;
}

template <typename T>
cudaError_t launch(const Params& p, int B, size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(gnn_train_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess || B == 0) return err;
  gnn_train_bwd_kernel<T><<<B, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch floats per sample: which 0 = node buffers, 1 = edge buffers.
long long gnn_train_bwd_scratch_floats(int Np, int K, int nf_p, int nf_r, int nf, int rel_in,
                                       int which) {
  Dims d{};
  d.Np = Np; d.K = K; d.nf_p = nf_p; d.nf_r = nf_r; d.nf = nf; d.rel_in = rel_in;
  return (long long)(which == 0 ? node_floats(d) : edge_floats(d));
}

int gnn_train_bwd_smem_bytes(int Np, int K) { return (int)smem_layout(Np, K, true).total; }

// Shared memory and scratch are the same in both compute dtypes.

// Launch both kernels on `stream` without synchronising; returns
// cudaGetLastError(). nodes and weights in bfloat16 with bf16_mode, else
// float32. node_acts / edge_acts: the activations the forward kernel wrote
// for these inputs and weights in the same mode (gnn_forward_launch's).
// goff: the 25 offsets of the weights in a sample's gradient slot (the last
// is the slot's size).
int gnn_train_bwd_launch(const void* nodes, const void* nbr, const void* mask, const void* dmot,
                         const void* const* weights, void* node_acts, void* edge_acts,
                         void* node_scratch, void* edge_scratch, void* dnodes, void* partial,
                         void* grads, const int* goff, int B, int Np, int N, int n_p, int K,
                         int n_his, int pstep, int Dp, int D, int nf_p, int nf_r, int nf,
                         int rel_in, int bf16_mode, int device, void* stream) {
  Params p;
  p.nodes = nodes;
  p.nbr = static_cast<const int*>(nbr);
  p.mask = static_cast<const float*>(mask);
  p.dmot = static_cast<const float*>(dmot);
  for (int i = 0; i < kNumWeights; ++i) p.w[i] = weights[i];
  p.node_acts = static_cast<float*>(node_acts);
  p.edge_acts = static_cast<float*>(edge_acts);
  p.node_scratch = static_cast<float*>(node_scratch);
  p.edge_scratch = static_cast<float*>(edge_scratch);
  p.dnodes = static_cast<float*>(dnodes);
  p.partial = static_cast<float*>(partial);
  for (int i = 0; i <= kNumWeights; ++i) p.goff[i] = goff[i];
  p.d = Dims{Np, N, n_p, K, n_his, pstep, Dp, D, nf_p, nf_r, nf, rel_in};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_layout(Np, K, true).total;
  err = bf16_mode ? launch<bf16>(p, B, smem, s) : launch<float>(p, B, smem, s);
  if (err != cudaSuccess) return (int)err;
  const int n = goff[kNumWeights];
  sum_samples_kernel<<<(n + 255) / 256, 256, 0, s>>>(p.partial, B, n, static_cast<float*>(grads));
  return (int)cudaGetLastError();
}

}  // extern "C"
