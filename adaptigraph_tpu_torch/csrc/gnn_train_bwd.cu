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
// bfloat16 mode reads bf16 nodes and weights and K2's bf16 activations, and
// rounds to bf16 exactly where the TPU kernel casts to its compute dtype:
// the raw-motion cotangent on entry, every cotangent product dX = dY W^T
// (but the particle inputs' one), the residual sums d_eff = d_pre + ... and
// d_p_enc = d_eff + ..., the receiver and sender sums of the message
// cotangents, and the propagator-base cotangents summed over the rounds in
// float32 and cast once. Weight gradients and the packed node cotangents are
// float32 sums of those values, as the TPU kernel's float32 accumulations of
// bf16 operands. Cotangents are kept in T, as the activations are: each kept
// value is already rounded to T.
//
// What bounds it on an H100: arithmetic, about twice the forward's (two
// products per layer: dX = dY W^T and dW = X^T dY), in float32 at the split
// TF32 rate (495/3 TFLOP/s); in bfloat16 at the tensor cores' rate the
// products take less time than reading K2's activations, so there the bytes
// bound this design (a design that recomputes the forward, as the TPU kernel
// does, would read none). One sample a block and one block an SM (up to
// 255 registers a thread): the products' latency, the epilogues (relu masks,
// rounding, bf16's redos) and the staging are what the card waits on unless
// the block overlaps them.
//
// What the design does about it: every dX and dW of depth and width >= 16
// runs through gnn_common.cuh's tensor-core layer routine (bf16 wgmma, float32
// 3xTF32 on wgmma tf32), from the weights packed once per launch
// (ops/fused_gnn.py::pack_tc_weights, W itself for dX = dY W^T). The routine
// overlaps them: its k-steps are asynchronous commit groups, each waited for
// behind the next (dX's fresh per-step sums added in k order meanwhile, dW's
// chunks accumulated in the tensor cores while the next chunk is staged and,
// in float32, split and transposed), so ptxas does not serialise the wgmma;
// in dX = dY W^T each warpgroup runs its own row tiles, so one's epilogue
// runs while the other's products do. The narrow
// layers (the motion head's 3 outputs, pe0) stay on the CUDA cores. Bias
// gradients are column sums in a fixed order, taken from the cotangent tiles
// that the weight-gradient products stage (the CUDA-core layers': parts of
// consecutive rows, then the parts in order); each round's weight gradients
// are one product over every round's rows. Cotangents live in a
// global scratch from the wrapper (edge-sized ones on real edges only). The
// TPU kernel accumulates weight gradients across its sequential grid; blocks
// here run in parallel, so each writes its sample's gradients to its own slot
// and a second launch sums the slots in sample order. No atomics: a rerun is
// bit-identical.

#include <type_traits>

#include "device_guard.cuh"
#include "gnn_common.cuh"

namespace {

using namespace gnn;

struct Params {
  const void* nodes;   // (B, Np, D) compute dtype
  const int* nbr;      // (B, K*Np) senders, (k, i) order
  const float* mask;   // (B, K*Np)
  const float* dmot;   // (B, Np, 3) raw-motion cotangent, zero beyond the object rows
  const void* w[kNumWeights];  // compute dtype
  const void* hi[kNumTc];      // packed tensor-core weights (W, depth padded to 16)
  const void* lo[kNumTc];      // float32: their second TF32 parts; bf16: null
  void* node_acts;     // B x act_node_elems, the forward's (read only)
  void* edge_acts;     // B x act_edge_elems, the forward's (read only)
  unsigned char* node_scratch;  // B x node_bytes
  unsigned char* edge_scratch;  // B x edge_bytes
  float* dnodes;       // (B, Np, D)
  float* partial;      // (B, n_grad) per-sample weight gradients
  int goff[kNumWeights + 1];  // each weight's offset in a sample's slot
  Dims d;
};

__host__ __device__ inline int wn_of(const Dims& d) { return imax(d.nf_p, d.nf); }
__host__ __device__ inline int we_of(const Dims& d) { return imax(imax(d.nf_r, d.nf), rel_in_ld(d)); }

// Per sample, in elements of T: dA, dB (wn), d_eff, d_pb, then per round
// d_pre, d_agg and d_rs (2 nf), so the rounds' weight gradients are one
// product each and d_rb is formed once; then the float32 sum of d_pb over
// the rounds (nf)
__host__ __device__ inline size_t node_elems(const Dims& d) {
  return (size_t)d.Np * (2 * wn_of(d) + 2 * d.nf + 4 * d.pstep * d.nf);
}
__host__ __device__ inline size_t node_bytes(const Dims& d, size_t elem) {
  return align16(node_elems(d) * elem) + align16((size_t)d.Np * d.nf * 4);
}

// d_rb, dEA, dEB (we; d rel_in in dEB has row stride rel_in_ld)
__host__ __device__ inline size_t edge_bytes(const Dims& d, size_t elem) {
  return align16((size_t)d.Np * d.K * (d.nf + 2 * we_of(d)) * elem);
}

template <typename T>
struct Scratch {
  T *dA, *dB, *d_eff, *d_pre, *d_pb, *d_agg, *d_rs, *d_rb, *dEA, *dEB;
  float* pb_sum;
};

template <typename T>
__device__ Scratch<T> scratch(const Dims& d, unsigned char* node_s, unsigned char* edge_s, int b) {
  const size_t nN = d.Np, eN = (size_t)d.Np * d.K, nf = d.nf, wn = wn_of(d), we = we_of(d);
  const size_t P = d.pstep;
  Scratch<T> s;
  unsigned char* base = node_s + (size_t)b * node_bytes(d, sizeof(T));
  T* at = reinterpret_cast<T*>(base);
  s.dA = at;    at += nN * wn;
  s.dB = at;    at += nN * wn;
  s.d_eff = at; at += nN * nf;
  s.d_pb = at;  at += nN * nf;
  s.d_pre = at; at += P * nN * nf;
  s.d_agg = at; at += P * nN * nf;
  s.d_rs = at;
  s.pb_sum = reinterpret_cast<float*>(base + align16(node_elems(d) * sizeof(T)));
  at = reinterpret_cast<T*>(edge_s + (size_t)b * edge_bytes(d, sizeof(T)));
  s.d_rb = at; at += eN * nf;
  s.dEA = at;  at += eN * we;
  s.dEB = at;
  return s;
}

// The two tensor-core products of the backward, as functors whose calls are
// always inlined (ptxas serialises the wgmma that a called function issues):
// dW = X^T dY over `rows` rows into weight wi's slot of the sample's
// gradients g (goff: each weight's offset); with bi >= 0 the column sums of
// dY (the bias gradient) into bias bi's slot.
template <typename T>
struct WeightGrad {
  float* g;
  const int* goff;
  unsigned char* smem;
  __device__ __forceinline__ void operator()(int wi, int bi, const T* X, int ldx, int kin,
                                             const T* dY, int ldy, int nout, int rows) const {
    float* G = g + goff[wi];
    wgrad_tc(kin, nout, rows, X, ldx, dY, ldy, smem, bi >= 0 ? g + goff[bi] : nullptr,
             [&](int m, int n, float c0, float c1) {
               const size_t i = (size_t)m * nout + n;
               G[i] = c0;
               G[i + 1] = c1;
             });
  }
};

// out = rnd(dY @ W^T) [then + add, rounded] [* (H > 0)], (rows, kin), on
// the tensor cores: W (kin, nout) is tensor-core layer l (in bf16, a
// product near a rounding midpoint is redone from weight_list's W). bf16
// holds both 64-column halves of a tile's sums, float32 one at a time: its
// 64 sums and their fresh sets leave this kernel too few registers.
template <typename T>
struct Bprop {
  const Weights<T>& W;
  unsigned char* smem;
  __device__ __forceinline__ void operator()(int rows, int kin, int nout, const T* dY, int ldy,
                                             int l, const T* add, const T* H, T* out) const {
    layer_tc<std::is_same<T, bf16>::value>(rows, kin, nout, dY, ldy, W.hi[l], W.lo[l], smem,
             Redo<T>{W.w[tc_weight(l)], nout, 1},
             epilogue([&](int m, int n) {  // the addend and the relu mask's activations
               const size_t i = (size_t)m * kin + n;
               const float2 a = add ? ld2(add + i) : make_float2(0.f, 0.f);
               const float2 h = H ? ldg2(H + i) : make_float2(0.f, 0.f);
               return make_float4(a.x, a.y, h.x, h.y);
             }, [&](int m, int n, float c0, float c1, float4 ah) {
               float v0 = rnd<T>(c0), v1 = rnd<T>(c1);
               if (add) v0 = rnd<T>(v0 + ah.x), v1 = rnd<T>(v1 + ah.y);
               if (H) v0 = ah.z > 0.f ? v0 : 0.f, v1 = ah.w > 0.f ? v1 : 0.f;
               st2(out + (size_t)m * kin + n, v0, v1);
               return decides<T>(c0, true, false, 0.f) || decides<T>(c1, true, false, 0.f);
             }));
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) gnn_train_bwd_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const Dims d = p.d;
  const int b = blockIdx.x, Np = d.Np, nf = d.nf, nfp = d.nf_p, nfr = d.nf_r, rin = d.rel_in;
  const int D = d.D, Dp = d.Dp, nh3 = d.n_his * 3, P = d.pstep, rld = rel_in_ld(d);
  const Smem L = smem_layout(Np, d.K, true, false, !std::is_same<T, float>::value);
  float* sm = reinterpret_cast<float*>(smem);
  int* off = reinterpret_cast<int*>(smem + L.off);
  int* soff = reinterpret_cast<int*>(smem + L.soff);
  short* er = reinterpret_cast<short*>(smem + L.er);
  short* es = reinterpret_cast<short*>(smem + L.es);
  int* sl = reinterpret_cast<int*>(smem + L.sl);

  GNN_PHASE(-1);
  const T* nodes = static_cast<const T*>(p.nodes) + (size_t)b * Np * D;
  const int E = build_edges(p.nbr + (size_t)b * d.K * Np, p.mask + (size_t)b * d.K * Np, Np, d.K,
                            off, er, es, soff, sl);

  // ---- the forward's activations (read only: the relu masks load them by
  // tc::ldg), this kernel's scratch and the weights: their pointers live in
  // shared memory and are read where used (held in registers for the whole
  // kernel they would crowd out the layer routine's accumulators) ----
  __shared__ FwdBufs<T> sF;
  __shared__ Scratch<T> sS;
  __shared__ Weights<T> sW;
  __shared__ int goff[kNumWeights + 1];  // each weight's offset in a sample's gradients
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i <= kNumWeights; ++i) goff[i] = p.goff[i];
    sF = act_bufs<T>(d, p.node_acts, p.edge_acts, b);
    sS = scratch<T>(d, p.node_scratch, p.edge_scratch, b);
    for (int i = 0; i < kNumWeights; ++i) sW.w[i] = static_cast<const T*>(p.w[i]);
    for (int i = 0; i < kNumTc; ++i) {
      sW.hi[i] = static_cast<const T*>(p.hi[i]);
      sW.lo[i] = static_cast<const T*>(p.lo[i]);
    }
  }
  __syncthreads();
  const FwdBufs<T>& f = sF;
  const Scratch<T>& s = sS;
  const Weights<T>& W = sW;

  float* g = p.partial + (size_t)b * p.goff[kNumWeights];
  float* dnodes = p.dnodes + (size_t)b * Np * D;

  const WeightGrad<T> wgrad{g, goff, smem};
  // ... on the CUDA cores (the narrow layers), the bias by colsum
  auto wgrad_cc = [&](int wi, int bi, const T* X, int ldx, int kin, const T* dY, int ldy, int nout,
                      int rows) {
    float* G = g + goff[wi];
    gemm(kin, nout, rows, X, (size_t)1, (size_t)ldx, dY, (size_t)ldy, (size_t)1, sm,
         [&](int m, int n, float c) { G[(size_t)m * nout + n] = c; });
    colsum(rows, nout, dY, ldy, g + goff[bi], sm);
  };
  const Bprop<T> bprop{W, smem};
  // ... on the CUDA cores, W (kin, nout) of weight_list; with `round` the
  // product rounded to T; out row stride ldo
  auto bprop_cc = [&](int rows, int kin, int nout, const T* dY, int ldy, const T* Wt, const T* H,
                      auto* out, int ldo, bool round) {
    gemm(rows, kin, nout, dY, (size_t)ldy, (size_t)1, Wt, (size_t)1, (size_t)nout, sm,
         [&](int m, int n, float c) {
           float v = round ? rnd<T>(c) : c;
           if (H) v = tc::ldg(H + (size_t)m * kin + n) > 0.f ? v : 0.f;
           st(out + (size_t)m * ldo + n, v);
         });
  };
  const int nv = nf / 8;  // the elementwise passes take eight channels per thread

  GNN_PHASE(12);
  // ---- motion head ----
  const float* dmot = p.dmot + (size_t)b * Np * 3;
  T* dm = s.dB;  // the cotangent in T, in dB until the motion head's first product is done
  for (int idx = threadIdx.x; idx < Np * 3; idx += kThreads) st(dm + idx, rnd<T>(dmot[idx]));
  __syncthreads();
  const T* effP = f.effs + (size_t)P * f.eff_step;
  wgrad_cc(kNr2w, kNr2b, f.nr_h2, nf, nf, dm, 3, 3, Np);
  bprop_cc(Np, nf, 3, dm, 3, W.w[kNr2w], f.nr_h2, s.dA, nf, true);
  wgrad(kNr1w, kNr1b, f.nr_h1, nf, nf, s.dA, nf, nf, Np);
  bprop(Np, nf, nf, s.dA, nf, kTcNr1, nullptr, f.nr_h1, s.dB);
  wgrad(kNr0w, kNr0b, effP, nf, nf, s.dB, nf, nf, Np);
  bprop(Np, nf, nf, s.dB, nf, kTcNr0, nullptr, nullptr, s.d_eff);
  GNN_PHASE(0);

  // ---- pstep rounds, last first ----
  for (int t = P - 1; t >= 0; --t) {
    const bool first = t == P - 1;
    const T* __restrict__ eff_next = f.effs + (size_t)(t + 1) * f.eff_step;
    T* d_pre = s.d_pre + (size_t)t * Np * nf;
    T* d_rs = s.d_rs + (size_t)t * Np * 2 * nf;
    for (int idx = threadIdx.x; idx < Np * nv; idx += kThreads) {
      const size_t at = (size_t)idx * 8;
      float h[8], v[8], sum[8];
      ld8(eff_next + at, h);
      ld8(s.d_eff + at, v);
      if (first) {
#pragma unroll
        for (int q = 0; q < 8; ++q) sum[q] = 0.f;
      } else {
        ld8(s.pb_sum + at, sum);
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        v[q] = h[q] > 0.f ? v[q] : 0.f;
        sum[q] = first ? v[q] : sum[q] + v[q];
      }
      st8(d_pre + at, v);
      st8(s.pb_sum + at, sum);
    }
    __syncthreads();
    T* d_agg = s.d_agg + (size_t)t * Np * nf;
    bprop(Np, nf, nf, d_pre, nf, kTcPpWb, nullptr, nullptr, d_agg);
    GNN_PHASE(1);
    // d_rs = [receiver sums | sender sums] of the message cotangents d_m(e) =
    // d_agg(receiver of e) where the kept message is > 0: per node and eight
    // channels, its received edges in slot order, then its sent edges in edge
    // order (d_m is not stored: d_rb is formed from the masks after the rounds)
    {
      const T* __restrict__ ms = f.ms + (size_t)t * f.ms_step;
      const T* __restrict__ dag = d_agg;
      for (int idx = threadIdx.x; idx < Np * nv; idx += kThreads) {
        const int i = idx / nv, c = (idx % nv) * 8;
        float da[8], r[8], q8[8];
        ld8(dag + (size_t)i * nf + c, da);
#pragma unroll
        for (int q = 0; q < 8; ++q) r[q] = q8[q] = 0.f;
#pragma unroll 2
        for (int e = off[i]; e < off[i + 1]; ++e) {
          float m[8];
          ld8(ms + (size_t)e * nf + c, m);
#pragma unroll
          for (int q = 0; q < 8; ++q) r[q] += m[q] > 0.f ? da[q] : 0.f;
        }
#pragma unroll 2
        for (int k = soff[i]; k < soff[i + 1]; ++k) {
          const int e = sl[k];
          float m[8], a[8];
          ld8(ms + (size_t)e * nf + c, m);
          ld8(dag + (size_t)er[e] * nf + c, a);
#pragma unroll
          for (int q = 0; q < 8; ++q) q8[q] += m[q] > 0.f ? a[q] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) r[q] = rnd<T>(r[q]), q8[q] = rnd<T>(q8[q]);
        st8(d_rs + (size_t)i * 2 * nf + c, r);
        st8(d_rs + (size_t)i * 2 * nf + nf + c, q8);
      }
    }
    __syncthreads();
    GNN_PHASE(2);
    bprop(Np, nf, 2 * nf, d_rs, 2 * nf, kTcRpW23, d_pre, nullptr, s.d_eff);
    GNN_PHASE(3);
  }
  // the rounds' weight gradients, one product over the P x Np rows of every
  // round (the activations of round t lie at slot t, as the cotangents do)
  wgrad(kPpWb, -1, f.aggs, nf, nf, s.d_pre, nf, nf, P * Np);
  wgrad(kRpW23, -1, f.effs, nf, nf, s.d_rs, 2 * nf, 2 * nf, P * Np);
  // the propagator-base cotangents, summed over the rounds in float32, cast once
  for (int idx = threadIdx.x; idx < Np * nv; idx += kThreads) {
    float v[8];
    ld8(s.pb_sum + (size_t)idx * 8, v);
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = rnd<T>(v[q]);
    st8(s.d_pb + (size_t)idx * 8, v);
  }
  // ... and the relation-base cotangents d_rb(e) = the sum over the rounds,
  // last first, of d_m(e) in float32, cast once
  for (int idx = threadIdx.x; idx < E * nv; idx += kThreads) {
    const int e = idx / nv, c = (idx % nv) * 8;
    float sum[8];
    for (int t = P - 1; t >= 0; --t) {
      const bool first = t == P - 1;
      float m[8], a[8], v[8];
      ld8(f.ms + (size_t)t * f.ms_step + (size_t)e * nf + c, m);
      ld8(s.d_agg + ((size_t)t * Np + er[e]) * nf + c, a);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        v[q] = m[q] > 0.f ? a[q] : 0.f;
        sum[q] = first ? v[q] : sum[q] + v[q];
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) sum[q] = rnd<T>(sum[q]);
    st8(s.d_rb + (size_t)e * nf + c, sum);
  }
  __syncthreads();
  GNN_PHASE(4);

  // ---- particle side: propagator base, then the encoder ----
  wgrad(kPpWa, kPpB, f.effs, nf, nf, s.d_pb, nf, nf, Np);
  bprop(Np, nf, nf, s.d_pb, nf, kTcPpWa, s.d_eff, f.effs, s.dA);  // d p_enc, relu mask
  wgrad(kPe2w, kPe2b, f.pe_h2, nfp, nfp, s.dA, nf, nf, Np);
  bprop(Np, nfp, nf, s.dA, nf, kTcPe2, nullptr, f.pe_h2, s.dB);
  wgrad(kPe1w, kPe1b, f.pe_h1, nfp, nfp, s.dB, nfp, nfp, Np);
  bprop(Np, nfp, nfp, s.dB, nfp, kTcPe1, nullptr, f.pe_h1, s.dA);
  GNN_PHASE(5);
  wgrad_cc(kPe0w, kPe0b, nodes, D, Dp, s.dA, nfp, nfp, Np);
  bprop_cc(Np, Dp, nfp, s.dA, nfp, W.w[kPe0w], nullptr, dnodes, D, false);  // d p_inputs, f32
  GNN_PHASE(6);

  // ---- relation side: relation base, then the encoder ----
  wgrad(kRpW1, kRpB, f.r_enc, nf, nf, s.d_rb, nf, nf, E);
  bprop(E, nf, nf, s.d_rb, nf, kTcRpW1, nullptr, f.r_enc, s.dEA);
  GNN_PHASE(7);
  wgrad(kRe2w, kRe2b, f.re_h2, nfr, nfr, s.dEA, nf, nf, E);
  bprop(E, nfr, nf, s.dEA, nf, kTcRe2, nullptr, f.re_h2, s.dEB);
  GNN_PHASE(8);
  wgrad(kRe1w, kRe1b, f.re_h1, nfr, nfr, s.dEB, nfr, nfr, E);
  bprop(E, nfr, nfr, s.dEB, nfr, kTcRe1, nullptr, f.re_h1, s.dEA);
  GNN_PHASE(9);
  // re0: rel_in and d rel_in have row stride rld, their columns past rin zero
  wgrad(kRe0w, kRe0b, f.rel_in, rld, rin, s.dEA, nfr, nfr, E);
  bprop(E, rld, nfr, s.dEA, nfr, kTcRe0, nullptr, nullptr, s.dEB);  // d rel_in
  GNN_PHASE(10);

  // ---- relation features -> packed node_g = [state_norm | attrs | g] ----
  // rel_in = [T_a | G_a | |T_g - G_g| | T_sn - G_sn]; d|x| = sign(x) with
  // abs'(0) = 1, the JAX convention
  const int Dg = nh3 + 3;
  const T* __restrict__ dEB = s.dEB;
  auto sg = [&](int e) {
    const float x = ld(nodes + (size_t)er[e] * D + Dp + nh3 + 2) - ld(nodes + (size_t)es[e] * D + Dp + nh3 + 2);
    return x < 0.f ? -1.f : 1.f;
  };
  for (int idx = threadIdx.x; idx < Np * Dg; idx += kThreads) {
    const int i = idx / Dg, c = idx % Dg;
    float acc = 0.f;
#pragma unroll 4
    for (int e = off[i]; e < off[i + 1]; ++e) {  // i receives: the T side
      const T* dr = dEB + (size_t)e * rld;
      acc += c < nh3 ? ld(dr + 5 + c) : c < nh3 + 2 ? ld(dr + c - nh3) : ld(dr + 4) * sg(e);
    }
#pragma unroll 4
    for (int q = soff[i]; q < soff[i + 1]; ++q) {  // i sends: the G side
      const int e = sl[q];
      const T* dr = dEB + (size_t)e * rld;
      acc += c < nh3 ? -ld(dr + 5 + c) : c < nh3 + 2 ? ld(dr + 2 + c - nh3) : -(ld(dr + 4) * sg(e));
    }
    dnodes[(size_t)i * D + Dp + c] = acc;
  }
  GNN_PHASE(11);
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

#ifdef GNN_PHASE_CLOCKS
// The profiling build's counters: 16 SM-cycle sums, one per phase
// (GNN_PHASE in the kernel), added by every block.
int gnn_train_bwd_set_phase_clocks(void* counters) {
  return (int)cudaMemcpyToSymbol(g_phase_clocks, &counters, sizeof(counters));
}
#endif

// Scratch bytes per sample: which 0 = node buffers, 1 = edge buffers.
long long gnn_train_bwd_scratch_bytes(int Np, int K, int pstep, int nf_p, int nf_r, int nf,
                                      int rel_in, int which, int bf16_mode) {
  Dims d{};
  d.Np = Np; d.K = K; d.pstep = pstep; d.nf_p = nf_p; d.nf_r = nf_r; d.nf = nf; d.rel_in = rel_in;
  const size_t elem = bf16_mode ? 2 : 4;
  return (long long)(which == 0 ? node_bytes(d, elem) : edge_bytes(d, elem));
}

int gnn_train_bwd_smem_bytes(int Np, int K, int bf16_mode) {
  return (int)smem_layout(Np, K, true, false, bf16_mode != 0).total;
}

// Launch both kernels on `stream` without synchronising; returns
// cudaGetLastError(). nodes and weights in bfloat16 with bf16_mode, else
// float32; packed: the kNumTc hi pointers of the backward's packed weights,
// then the kNumTc lo ones (null in bf16). node_acts / edge_acts: the
// activations the forward kernel wrote for these inputs and weights in the
// same mode (gnn_forward_launch's). goff: the 25 offsets of the weights in a
// sample's gradient slot (the last is the slot's size).
int gnn_train_bwd_launch(const void* nodes, const void* nbr, const void* mask, const void* dmot,
                         const void* const* weights, const void* const* packed, void* node_acts,
                         void* edge_acts, void* node_scratch, void* edge_scratch, void* dnodes,
                         void* partial, void* grads, const int* goff, int B, int Np, int N,
                         int n_p, int K, int n_his, int pstep, int Dp, int D, int nf_p, int nf_r,
                         int nf, int rel_in, int bf16_mode, int device, void* stream) {
  Params p;
  p.nodes = nodes;
  p.nbr = static_cast<const int*>(nbr);
  p.mask = static_cast<const float*>(mask);
  p.dmot = static_cast<const float*>(dmot);
  for (int i = 0; i < kNumWeights; ++i) p.w[i] = weights[i];
  for (int i = 0; i < kNumTc; ++i) {
    p.hi[i] = packed[i];
    p.lo[i] = packed[kNumTc + i];
  }
  p.node_acts = node_acts;
  p.edge_acts = edge_acts;
  p.node_scratch = static_cast<unsigned char*>(node_scratch);
  p.edge_scratch = static_cast<unsigned char*>(edge_scratch);
  p.dnodes = static_cast<float*>(dnodes);
  p.partial = static_cast<float*>(partial);
  for (int i = 0; i <= kNumWeights; ++i) p.goff[i] = goff[i];
  p.d = Dims{Np, N, n_p, K, n_his, pstep, Dp, D, nf_p, nf_r, nf, rel_in};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const CurrentDeviceGuard restore;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_layout(Np, K, true, false, bf16_mode != 0).total;
  err = bf16_mode ? launch<bf16>(p, B, smem, s) : launch<float>(p, B, smem, s);
  if (err != cudaSuccess) return (int)err;
  const int n = goff[kNumWeights];
  sum_samples_kernel<<<(n + 255) / 256, 256, 0, s>>>(p.partial, B, n, static_cast<float*>(grads));
  return (int)cudaGetLastError();
}

}  // extern "C"
