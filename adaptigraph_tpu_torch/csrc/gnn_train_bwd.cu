// Backward of the single-step GNN forward with prebuilt edges, in float32 or
// bfloat16, as three launches: the cotangent chain, one block per sample
// (gnn_train_bwd_kernel); the 24 weight gradients, formed batch-wide by
// persistent blocks over every sample's rows (wgrad_sum_samples_kernel); and
// the fixed-order sum of those blocks' partial gradients (sum_samples_kernel).
//
// Replaces the TPU kernel adaptigraph_tpu/ops/fused_gnn_train.py::
// _train_bwd_kernel (launched by _bwd_pallas). The TPU kernel recomputes the
// forward in VMEM; here the forward kernel (gnn_forward.cu) has already
// written every activation to global memory, and these kernels read them
// (gnn_common.cuh's act_bufs). Per sample the chain runs the chain rule back
// from the raw-motion cotangent: the motion head, the pstep rounds in reverse
// (message relu masks, receiver sums and sender scatters as ordered sums over
// each node's edges), the particle and relation encoders, and the relation
// features. It writes the packed node cotangents, and leaves every cotangent
// that a weight gradient needs in its own place of a global scratch (Scratch),
// with the sample's real edge count. The weight gradients are dW = sum over
// samples b of X_b^T dY_b, X the layer's kept input (an activation) and dY its
// output's cotangent, and the bias gradients the column sums of dY. The clip
// derivative and the state-history chain rule stay in the wrapper, as in the
// JAX package.
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
// What bounds them on an H100, and what the design does about it:
// - The chain: the dX products' latency (the same shapes as the forward's
//   products), the epilogues (relu masks, rounding, bf16's redos) and the
//   staging, at one sample a block and one block an SM (up to 255 registers a
//   thread). Every dX of depth and width >= 16 runs through gnn_common.cuh's
//   tensor-core layer routine (bf16 wgmma, float32 3xTF32 on wgmma tf32) from
//   the weights packed once per launch (ops/fused_gnn.py::pack_tc_weights, W
//   itself for dX = dY W^T), whose k-steps are asynchronous commit groups and
//   whose warpgroups run their own row tiles, so one's epilogue runs while the
//   other's products do; the narrow layers (the motion head's 3 outputs, pe0's
//   dX) stay on the CUDA cores.
// - The weight gradients: in float32, the work a staged chunk of rows takes,
//   not the bytes. Each gradient is a 128-wide output reduced over every
//   sample's rows (13 k node rows to ~470 k edge rows at B 128); a chunk of
//   32 rows (bf16: 64) costs about the same whatever its widths: its copies
//   into shared memory, in float32 its dY split into TF32 hi/lo parts and
//   transposed (tf32 wgmma takes B only K-major; bf16's MN-major B needs
//   neither), and 3xTF32 products (lo·hi, hi·lo, hi·hi) over 128 x 128. On
//   an H100 these parts add up rather than overlap (ablated at rope, B 128:
//   products, transposes and the copies' stalls each cost their share
//   in full), ~3,800 cycles a float32 chunk against ~2,300 for its bytes
//   alone. Per sample, inside the chain, the same chunks cost about as much
//   (with the transpose's stores 4 bytes wide), and every block wrote its
//   sample's 24 gradients for a second launch to sum.
//   Here persistent blocks (one an SM) walk a fixed list of work items, each
//   (weight, 128-column slice, samples, chunks of their rows), at most 512
//   rows deep (ops/fused_gnn_train.py::wgrad_plan). The list is fixed by B and
//   the table shapes, so it holds under CUDA-graph capture; every block counts
//   the chunks that hold rows from the chain's real edge counts (edge items
//   cover every slot) and takes an equal share of them (partition), so no
//   block waits on dead slots. Chunks are staged by cp.async into a ring,
//   three in flight, the next started while a chunk's last products run; dY
//   is transposed in 16-byte runs, its bias sums taken from the same loads;
//   both warpgroups run wgmma on X^T dY (64 rows of G each). An item's
//   products accumulate in the tensor cores, then are added in float32 to the
//   block's sum of its run in that slice, which goes to a slot of its own;
//   sum_samples_kernel adds a gradient's slots in block order. pe0's X (the
//   Dp particle inputs) and the motion head's dY (3 wide) are kept with rows
//   of a multiple of 8 by the chain, so every gradient takes the same path.
//   No atomics: a rerun is bit-identical.

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
  int* ecount;         // (B,) each sample's real edges
  Dims d;
};

// Per sample, in elements of T: the particle inputs (Np x pin_ld(d), zeros
// past Dp) and dm, the rounded raw-motion cotangent (Np x 8, zeros past 3),
// rows the weight-gradient kernel's 16-byte copies can read; then the dY of
// nr1 and nr0, d_eff (the chain's running effect cotangent), d_pb, per round
// d_pre, d_agg and d_rs (2 nf), then the dY of pe2, pe1 and pe0; then the
// float32 sum of d_pb over the rounds (nf). Every region starts 16-byte
// aligned (Np is a multiple of 8).
__host__ __device__ inline int pin_ld(const Dims& d) { return (d.Dp + 7) / 8 * 8; }
constexpr int kDmLd = 8;
__host__ __device__ inline size_t node_elems(const Dims& d) {
  return (size_t)d.Np * (pin_ld(d) + kDmLd + 5 * d.nf + 4 * d.pstep * d.nf + 2 * d.nf_p);
}
__host__ __device__ inline size_t node_bytes(const Dims& d, size_t elem) {
  return align16(node_elems(d) * elem) + align16((size_t)d.Np * d.nf * 4);
}

// d_rb (nf), the dY of re2 (nf), re1 and re0 (nf_r), d rel_in (row stride
// rel_in_ld), on real edges
__host__ __device__ inline size_t edge_bytes(const Dims& d, size_t elem) {
  return align16((size_t)d.Np * d.K * (2 * d.nf + 2 * d.nf_r + rel_in_ld(d)) * elem);
}

template <typename T>
struct Scratch {
  T *pin, *dm, *d_nr1, *d_nr0, *d_eff, *d_pb, *d_pre, *d_agg, *d_rs, *d_pe2, *d_pe1, *d_pe0;
  T *d_rb, *d_re2, *d_re1, *d_re0, *d_relin;
  float* pb_sum;
};

template <typename T>
__host__ __device__ Scratch<T> scratch(const Dims& d, unsigned char* node_s, unsigned char* edge_s,
                                       int b) {
  const size_t nN = d.Np, eN = (size_t)d.Np * d.K, nf = d.nf, nfp = d.nf_p, nfr = d.nf_r;
  const size_t P = d.pstep;
  Scratch<T> s;
  unsigned char* base = node_s + (size_t)b * node_bytes(d, sizeof(T));
  T* at = reinterpret_cast<T*>(base);
  s.pin = at;   at += nN * pin_ld(d);
  s.dm = at;    at += nN * kDmLd;
  s.d_nr1 = at; at += nN * nf;
  s.d_nr0 = at; at += nN * nf;
  s.d_eff = at; at += nN * nf;
  s.d_pb = at;  at += nN * nf;
  s.d_pre = at; at += P * nN * nf;
  s.d_agg = at; at += P * nN * nf;
  s.d_rs = at;  at += P * nN * 2 * nf;
  s.d_pe2 = at; at += nN * nf;
  s.d_pe1 = at; at += nN * nfp;
  s.d_pe0 = at;
  s.pb_sum = reinterpret_cast<float*>(base + align16(node_elems(d) * sizeof(T)));
  at = reinterpret_cast<T*>(edge_s + (size_t)b * edge_bytes(d, sizeof(T)));
  s.d_rb = at;  at += eN * nf;
  s.d_re2 = at; at += eN * nf;
  s.d_re1 = at; at += eN * nfr;
  s.d_re0 = at; at += eN * nfr;
  s.d_relin = at;
  return s;
}

// out = rnd(dY @ W^T) [then + add, rounded] [* (H > 0)], (rows, kin), on
// the tensor cores: W (kin, nout) is tensor-core layer l (in bf16, a
// product near a rounding midpoint is redone from weight_list's W). bf16
// holds both 64-column halves of a tile's sums, float32 one at a time: its
// 64 sums and their fresh sets leave this kernel too few registers. A functor
// whose calls are always inlined (ptxas serialises the wgmma that a called
// function emits).
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
  const int b = blockIdx.x, Np = d.Np, nf = d.nf, nfp = d.nf_p, nfr = d.nf_r;
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
  if (threadIdx.x == 0) p.ecount[b] = E;  // where the weight gradients' edge rows end

  // ---- the forward's activations (read only: the relu masks load them by
  // tc::ldg), this kernel's scratch and the weights: their pointers live in
  // shared memory and are read where used (held in registers for the whole
  // kernel they would crowd out the layer routine's accumulators) ----
  __shared__ FwdBufs<T> sF;
  __shared__ Scratch<T> sS;
  __shared__ Weights<T> sW;
  if (threadIdx.x == 0) {
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

  float* dnodes = p.dnodes + (size_t)b * Np * D;

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
  for (int idx = threadIdx.x; idx < Np * kDmLd; idx += kThreads) {
    const int i = idx / kDmLd, c = idx % kDmLd;
    st(s.dm + idx, c < 3 ? rnd<T>(dmot[i * 3 + c]) : 0.f);
  }
  for (int idx = threadIdx.x; idx < Np * pin_ld(d); idx += kThreads) {  // for pe0's dW
    const int i = idx / pin_ld(d), c = idx % pin_ld(d);
    st(s.pin + idx, c < Dp ? ld(nodes + (size_t)i * D + c) : 0.f);
  }
  __syncthreads();
  const T* effP = f.effs + (size_t)P * f.eff_step;
  bprop_cc(Np, nf, 3, s.dm, kDmLd, W.w[kNr2w], f.nr_h2, s.d_nr1, nf, true);
  bprop(Np, nf, nf, s.d_nr1, nf, kTcNr1, nullptr, f.nr_h1, s.d_nr0);
  bprop(Np, nf, nf, s.d_nr0, nf, kTcNr0, nullptr, nullptr, s.d_eff);
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
  bprop(Np, nf, nf, s.d_pb, nf, kTcPpWa, s.d_eff, f.effs, s.d_pe2);  // d p_enc, relu mask
  bprop(Np, nfp, nf, s.d_pe2, nf, kTcPe2, nullptr, f.pe_h2, s.d_pe1);
  bprop(Np, nfp, nfp, s.d_pe1, nfp, kTcPe1, nullptr, f.pe_h1, s.d_pe0);
  GNN_PHASE(5);
  bprop_cc(Np, Dp, nfp, s.d_pe0, nfp, W.w[kPe0w], nullptr, dnodes, D, false);  // d p_inputs, f32
  GNN_PHASE(6);

  // ---- relation side: relation base, then the encoder ----
  bprop(E, nf, nf, s.d_rb, nf, kTcRpW1, nullptr, f.r_enc, s.d_re2);
  GNN_PHASE(7);
  bprop(E, nfr, nf, s.d_re2, nf, kTcRe2, nullptr, f.re_h2, s.d_re1);
  GNN_PHASE(8);
  bprop(E, nfr, nfr, s.d_re1, nfr, kTcRe1, nullptr, f.re_h1, s.d_re0);
  GNN_PHASE(9);
  // re0: d rel_in has row stride rld, its columns past rel_in zero
  bprop(E, rld, nfr, s.d_re0, nfr, kTcRe0, nullptr, nullptr, s.d_relin);
  GNN_PHASE(10);

  // ---- relation features -> packed node_g = [state_norm | attrs | g] ----
  // rel_in = [T_a | G_a | |T_g - G_g| | T_sn - G_sn]; d|x| = sign(x) with
  // abs'(0) = 1, the JAX convention
  const int Dg = nh3 + 3;
  const T* __restrict__ dri = s.d_relin;
  auto sg = [&](int e) {
    const float x = ld(nodes + (size_t)er[e] * D + Dp + nh3 + 2) - ld(nodes + (size_t)es[e] * D + Dp + nh3 + 2);
    return x < 0.f ? -1.f : 1.f;
  };
  for (int idx = threadIdx.x; idx < Np * Dg; idx += kThreads) {
    const int i = idx / Dg, c = idx % Dg;
    float acc = 0.f;
#pragma unroll 4
    for (int e = off[i]; e < off[i + 1]; ++e) {  // i receives: the T side
      const T* dr = dri + (size_t)e * rld;
      acc += c < nh3 ? ld(dr + 5 + c) : c < nh3 + 2 ? ld(dr + c - nh3) : ld(dr + 4) * sg(e);
    }
#pragma unroll 4
    for (int q = soff[i]; q < soff[i + 1]; ++q) {  // i sends: the G side
      const int e = sl[q];
      const T* dr = dri + (size_t)e * rld;
      acc += c < nh3 ? -ld(dr + 5 + c) : c < nh3 + 2 ? ld(dr + 2 + c - nh3) : -(ld(dr + 4) * sg(e));
    }
    dnodes[(size_t)i * D + Dp + c] = acc;
  }
  GNN_PHASE(11);
}

// ---------------------------------------------------------------------------
// The weight gradients, batch-wide
// ---------------------------------------------------------------------------

// One job per weight gradient (with its bias's), in the order of
// ops/fused_gnn_train.py::WGRAD_JOBS.
enum Job { kJPe0, kJPe1, kJPe2, kJRe0, kJRe1, kJRe2, kJRpW1, kJRpW23, kJPpWa, kJPpWb, kJNr0, kJNr1,
           kJNr2, kNumJobs };

__host__ __device__ constexpr bool job_has_bias(int j) { return j != kJRpW23 && j != kJPpWb; }

constexpr int kSlice = 128;  // output columns of a work item

// Where a job's operands lie: sample b's X (rows x kin, row stride ldx) at x
// + b xs, its dY (rows x nout, row stride ldy) at y + b ys, elements of T.
struct JobDesc {
  const void* x;
  const void* y;
  long long xs, ys;
  int ldx, ldy, kin, nout;
  int rows;  // rows a sample; 0: its real edges (ecount)
  int bias;  // whether the column sums of dY are a bias gradient
};

struct WgParams {
  JobDesc job[kNumJobs];
  const int* ecount;      // (B,) the chain's real edge counts
  const int4* items;      // (b0, b1, c0, c1): chunks [c0, c1) of samples [b0, b1)
  const int* item_group;  // each item's (job, slice) group
  const int4* groups;     // (job, n0, first item, end item), in item order
  int n_items, n_groups;
  int* gstart;            // out: each group's first chunk in the chunk order, then the total
  int* bstart;            // out: each block's first chunk, then the total
  float* partial;         // block k's run in group g: slot k + g of `slot` floats, G(m, n - n0)
  int slot, bias_at;      // at m * kSlice + n - n0, the bias sums at bias_at
};

// The ring of staged chunks: rows a chunk, stages, chunks staged ahead of the
// products, bytes of a stage. float32: X then dY, 32 rows x 128 columns each
// of row stride kLd (fragment loads on 32 banks), and two buffers of dY's
// chunk split and transposed (its TF32 hi and lo parts, 128 rows x 32,
// K-major, swizzled); a stage is restaged once the block is past its chunk,
// whose products read only registers and the transposed buffer. bf16: X's two
// 64-column blocks, then dY's, 64 rows each, swizzled; a stage is restaged
// once the products that read it are done (one chunk's stay in flight). Then
// 256 floats for the bias halves and the partition's scan.
template <typename T> struct Ring;
template <> struct Ring<float> {
  static constexpr int kRows = 32, kStages = 4, kAhead = 3, kLd = 136;
  static constexpr size_t kStage = 2 * 32 * kLd * 4, kSplit = kStages * kStage;
  static constexpr size_t kRed = kSplit + 2 * 2 * 128 * 32 * 4, kBytes = kRed + 256 * 4;
};
template <> struct Ring<bf16> {
  static constexpr int kRows = 64, kStages = 5, kAhead = 3;
  static constexpr size_t kStage = 4 * 64 * 64 * 2;
  static constexpr size_t kRed = kStages * kStage, kBytes = kRed + 256 * 4;
};
static_assert(Ring<float>::kSplit % 1024 == 0 && Ring<bf16>::kStage % 1024 == 0,
              "swizzled tiles start 1,024-aligned");
static_assert(Ring<float>::kBytes + 1024 <= 232448 && Ring<bf16>::kBytes + 1024 <= 232448,
              "the ring fits in a block's shared memory");
// chunk s + kAhead is staged at chunk s into the stage of chunk s - 1 (float32:
// read into registers and the transposed buffer by then) or s - 2 (bf16: its
// products done)
static_assert(Ring<float>::kAhead + 1 <= Ring<float>::kStages &&
                  Ring<bf16>::kAhead + 2 <= Ring<bf16>::kStages,
              "the ring has the stages it restages");

// The chunks of item `it` that hold rows: every sample's chunks [c0, c1) up
// to its rows (an edge job's: its real edges).
template <int kRows>
__device__ __forceinline__ int item_chunks(const int4 it, const JobDesc& jb, const int* ecount) {
  int n = 0;
  for (int b = it.x; b < it.y; ++b) {
    const int rows = jb.rows > 0 ? jb.rows : ecount[b];
    n += imax(0, imin(it.w, (rows + kRows - 1) / kRows) - it.z);
  }
  return n;
}

// The partition: every block works out the chunks that hold rows (the plan
// is fixed by B and the table shapes; the real edge counts are the chain's)
// and takes the k-th of gridDim.x equal shares of them in item order, at
// chunk granularity, so dead edge slots cost no block time. Returns the
// block's first chunk (item, sample, chunk) in *at and its count. For the
// sum's kernel, every block writes its first chunk to bstart (the last block
// the total after it) and block 0 each group's first chunk, then the total,
// to gstart. red: 256 ints.
template <int kRows>
__device__ int partition(const WgParams& p, const JobDesc* J, int* red, int4* at) {
  const int n = p.n_items, per = (n + kThreads - 1) / kThreads;
  const int i0 = imin(n, threadIdx.x * per), i1 = imin(n, i0 + per);
  int mine = 0;
  for (int i = i0; i < i1; ++i)
    mine += item_chunks<kRows>(p.items[i], J[p.groups[p.item_group[i]].x], p.ecount);
  red[threadIdx.x] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {  // exclusive scan in thread order; the total to at->w
    int run = 0;
    for (int t = 0; t < kThreads; ++t) {
      const int v = red[t];
      red[t] = run;
      run += v;
    }
    *at = make_int4(0, 0, 0, run);
  }
  __syncthreads();
  const int total = at->w, G = gridDim.x, k = blockIdx.x;
  const int cs = (int)((long long)k * total / G), ce = (int)((long long)(k + 1) * total / G);
  int run = red[threadIdx.x];
  __syncthreads();
  for (int i = i0; i < i1; ++i) {
    const int4 it = p.items[i];
    const int g = p.item_group[i];
    const JobDesc& jb = J[p.groups[g].x];
    if (k == 0 && p.groups[g].z == i) p.gstart[g] = run;
    const int c = item_chunks<kRows>(it, jb, p.ecount);
    if (cs < ce && run <= cs && cs < run + c) {  // the block starts in this item
      int off = cs - run;
      for (int b = it.x; b < it.y; ++b) {
        const int rows = jb.rows > 0 ? jb.rows : p.ecount[b];
        const int nb = imax(0, imin(it.w, (rows + kRows - 1) / kRows) - it.z);
        if (off < nb) {
          *at = make_int4(i, b, it.z + off, total);
          break;
        }
        off -= nb;
      }
    }
    run += c;
  }
  if (threadIdx.x == 0) {
    p.bstart[k] = cs;
    if (k == G - 1) p.bstart[G] = total;
  }
  if (k == 0 && threadIdx.x == 0) {  // the groups past the last item (none but at B 0)
    for (int g = 0; g < p.n_groups; ++g)
      if (p.groups[g].z >= n) p.gstart[g] = total;
    p.gstart[p.n_groups] = total;
  }
  __syncthreads();
  return ce - cs;
}

// A place in a block's chunks: item, sample and chunk, with the item's group,
// job and first column, the sample's rows and the end of its chunks in the
// item.
struct Cur {
  int item, b, c, g, job, n0, rows, cend;
};

// Moves k to the first chunk at or after its place that holds rows of a
// sample (entering an item with b = -1). Every thread keeps the same cursors.
template <int kRows>
__device__ __forceinline__ void settle(Cur& k, const WgParams& p, const JobDesc* J) {
  for (;;) {
    const int4 it = p.items[k.item];
    if (k.b < 0) k.b = it.x, k.c = it.z;
    if (k.b >= it.y) {
      ++k.item;
      k.b = -1;
      continue;
    }
    k.g = p.item_group[k.item];
    const int4 gr = p.groups[k.g];
    k.job = gr.x;
    k.n0 = gr.y;
    k.rows = J[gr.x].rows > 0 ? J[gr.x].rows : p.ecount[k.b];
    k.cend = imin(it.w, (k.rows + kRows - 1) / kRows);
    if (k.c < k.cend) return;
    ++k.b;
    k.c = it.z;
  }
}

// ... to the next chunk after its place (only called while the block has one).
template <int kRows>
__device__ __forceinline__ void next_chunk(Cur& k, const WgParams& p, const JobDesc* J) {
  if (++k.c < k.cend) return;
  settle<kRows>(k, p, J);
}

// Chunk k of its job into stage st of the ring, by cp.async from every
// thread; nothing commits.
__device__ __forceinline__ void stage_chunk(unsigned char* ring, int st, const JobDesc& J,
                                            const Cur& k) {
  using R = Ring<float>;
  float* Xs = reinterpret_cast<float*>(ring + st * R::kStage);
  const float* X = static_cast<const float*>(J.x) + k.b * J.xs;
  const float* Y = static_cast<const float*>(J.y) + k.b * J.ys;
  stage_pad(Xs, R::kLd, X, J.ldx, k.c * 32, 32, k.rows, 0, 128, J.kin, threadIdx.x, kThreads);
  stage_pad(Xs + 32 * R::kLd, R::kLd, Y, J.ldy, k.c * 32, 32, k.rows, k.n0, 128, J.nout,
            threadIdx.x, kThreads);
}
__device__ __forceinline__ void stage_chunk16(unsigned char* ring, int st, const JobDesc& J,
                                              const Cur& k) {
  bf16* S = reinterpret_cast<bf16*>(ring + st * Ring<bf16>::kStage);
  const bf16* X = static_cast<const bf16*>(J.x) + k.b * J.xs;
  const bf16* Y = static_cast<const bf16*>(J.y) + k.b * J.ys;
  tc::stage_sw(S, X, J.ldx, k.c * 64, 64, k.rows, 0, 2, J.kin, threadIdx.x, kThreads);
  tc::stage_sw(S + 2 * 64 * 64, Y, J.ldy, k.c * 64, 64, k.rows, k.n0, 2, J.nout, threadIdx.x,
               kThreads);
}

// The products of a staged float32 chunk (stage st, the s-th of the block)
// into acc, and with `bias` its dY column sums into bs: dY's chunk split and
// transposed into buffer s % 2 (the one whose products, two chunks back, are
// done), K-major as tf32 wgmma takes B, then four k8 steps of X^T's fragments
// split in registers (two sets taken in turn), three products each a half
// (lo·hi, hi·lo, hi·hi), each step a commit group waited for behind the next.
__device__ __forceinline__ void chunk_products(float (&acc)[2][32], float& bs, bool bias,
                                               unsigned char* ring, int st, int s,
                                               uint32_t (&ah)[2][4], uint32_t (&al)[2][4]) {
  using R = Ring<float>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const float* Xs = reinterpret_cast<const float*>(ring + st * R::kStage);
  const float* Yc = Xs + 32 * R::kLd;
  float* Bh = reinterpret_cast<float*>(ring + R::kSplit) + (s & 1) * 2 * 128 * 32;
  float* Bl = Bh + 128 * 32;
  // column n = thread % 128, rows 4 q .. 4 q + 3 for q = thread / 128 + 2 j:
  // the loads of a warp on 32 banks, each row group's hi and lo parts one
  // 16-byte store (eight lanes a phase on eight bank groups); the column's
  // sum over those 16 rows in order is its share of the bias sums
  const int n = threadIdx.x & 127;
  float col = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = (threadIdx.x >> 7) + 2 * j;
    float v[4];
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = Yc[(4 * q + i) * R::kLd + n];
      tc::split_tf32(v[i], hi[i], lo[i]);
      col += v[i];
    }
    const int at = n * 32 + ((q ^ (n & 7)) << 2);
    *reinterpret_cast<uint4*>(Bh + at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(Bl + at) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  if (bias) bs += col;
  tc::fence_proxy_async();
  __syncthreads();
  // A = X^T from registers: (m, k) = X(r = k, m)
  const float* A = Xs + t * R::kLd + warp * 16 + g;
  const bf16* bh = reinterpret_cast<const bf16*>(Bh);
  const bf16* bl = reinterpret_cast<const bf16*>(Bl);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int f = kk & 1, o = kk * 8 * R::kLd, o4 = o + 4 * R::kLd;
    tc::split_tf32(A[o], ah[f][0], al[f][0]);
    tc::split_tf32(A[o + 8], ah[f][1], al[f][1]);
    tc::split_tf32(A[o4], ah[f][2], al[f][2]);
    tc::split_tf32(A[o4 + 8], ah[f][3], al[f][3]);
    tc::wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint64_t dh = tc::desc_sw128(bh + h * 64 * 64 + kk * 16, 16, 1024);
      const uint64_t dl = tc::desc_sw128(bl + h * 64 * 64 + kk * 16, 16, 1024);
      tc::wgmma_m64n64k8_tf32(acc[h], al[f], dh, 1);
      tc::wgmma_m64n64k8_tf32(acc[h], ah[f], dl, 1);
      tc::wgmma_m64n64k8_tf32(acc[h], ah[f], dh, 1);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<1>();  // the step before, whose register set the next step refills
  }
}

// ... of a staged bf16 chunk: four k16 steps for both halves, one commit
// group, waited for behind the next chunk's; the bias sums meanwhile.
__device__ __forceinline__ void chunk_products16(float (&acc)[2][32], float& bs, bool bias,
                                                 unsigned char* ring, int st) {
  const int wg = warpgroup(), wt = threadIdx.x & 127;
  const bf16* Xc = reinterpret_cast<const bf16*>(ring + st * Ring<bf16>::kStage);
  const bf16* Yc = Xc + 2 * 64 * 64;
  tc::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint64_t da = tc::desc_sw128(Xc + wg * 64 * 64 + ks * 16 * 64, 1024, 1024);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      tc::wgmma_m64n64k16<1, 1>(acc[h], da,
                                tc::desc_sw128(Yc + h * 64 * 64 + ks * 16 * 64, 1024, 1024), 1);
  }
  tc::wgmma_commit();
  if (bias) {  // column n0 + wt over rows wg * 32 .. + 32
    const bf16* col = Yc + (wt >> 6) * 64 * 64 + (wt & 7);
    const int c = (wt & 63) >> 3;
#pragma unroll 8
    for (int r = wg * 32; r < wg * 32 + 32; ++r) bs += ld(col + r * 64 + ((c ^ (r & 7)) << 3));
  }
  tc::wgmma_wait<1>();  // the chunk before's products
}

// A run's sums into its slot: G's rows m < kin and columns n0 + n < nout from
// the accumulator layout (warpgroup wg: rows wg * 64 ..), and with a bias the
// two row halves' column sums (red: 256 floats).
__device__ __forceinline__ void write_slot(float (&tot)[2][32], float bs, const JobDesc& J, int n0,
                                           bool bias, float* G, float* red, int bias_at) {
  const int wg = warpgroup(), wt = threadIdx.x & 127;
  const int r = wg * 64 + (wt >> 5) * 16 + ((wt & 31) >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int m = r + 8 * ((i & 3) >> 1), n = h * 64 + 8 * (i >> 2) + 2 * (wt & 3);
      if (m < J.kin && n0 + n < J.nout) st2(G + (size_t)m * kSlice + n, tot[h][i], tot[h][i + 1]);
    }
  if (bias) {
    red[threadIdx.x] = bs;
    __syncthreads();
    if (threadIdx.x < 128 && n0 + (int)threadIdx.x < J.nout)
      G[bias_at + threadIdx.x] = red[threadIdx.x] + red[128 + threadIdx.x];
    __syncthreads();
  }
}

// Profiling builds (-DGNN_PHASE_CLOCKS): the blocks' cycles in the loop by
// part (every thread keeps the marks, branch-free; thread 0 adds its own): 0
// waiting for a chunk's copies, 1 the products (float32: the split and
// transpose of dY too), 2 staging the chunk kAhead on, 3 the cursor, the
// drains and the slots; then 4 the blocks' totals, 5 the largest, 6 their
// chunks (gnn_train_bwd_set_wgrad_clocks).
#ifdef GNN_PHASE_CLOCKS
static __device__ unsigned long long* g_wgrad_clocks;
#define WG_START long long wg_c[4] = {0, 0, 0, 0}, wg_t = clock64(); const long long wg_0 = wg_t
#define WG_MARK(k)                 \
  do {                             \
    const long long n_ = clock64(); \
    wg_c[k] += n_ - wg_t;          \
    wg_t = n_;                     \
  } while (0)
#define WG_END(chunks) wgrad_clocks_done(wg_c, wg_t - wg_0, chunks)
__device__ __forceinline__ void wgrad_clocks_done(const long long (&c)[4], long long total,
                                                  int chunks) {
  if (threadIdx.x == 0) {
    for (int k = 0; k < 4; ++k) atomicAdd(g_wgrad_clocks + k, (unsigned long long)c[k]);
    atomicAdd(g_wgrad_clocks + 4, (unsigned long long)total);
    atomicMax(g_wgrad_clocks + 5, (unsigned long long)total);
    atomicAdd(g_wgrad_clocks + 6, (unsigned long long)chunks);
  }
}
#else
#define WG_START
#define WG_MARK(k)
#define WG_END(chunks)
#endif

// The block's n chunks from `at`: one pipeline over them in order, kAhead
// chunks' copies in flight. An item's products accumulate in acc (the tensor
// cores, at most WGRAD_DEPTH rows deep), and are added in float32 to tot,
// the sum of the block's run in the item's group, once its last chunk's (or
// the block's last) are done; a run's sums go to slot blockIdx.x + group.
template <typename T>
__device__ __forceinline__ void tc_chunks(const WgParams& p, const JobDesc* J, int4 at, int n,
                                          unsigned char* smem) {
  using R = Ring<T>;
  constexpr bool f32 = std::is_same<T, float>::value;
  float* red = reinterpret_cast<float*>(smem + R::kRed);
  Cur pk{at.x, at.y, at.z, 0, 0, 0, 0, 0};
  settle<R::kRows>(pk, p, J);
  Cur ck = pk;
  for (int j = 0; j < R::kAhead; ++j) {  // the first chunks in flight
    if (j < n) {
      if constexpr (f32) stage_chunk(smem, j % R::kStages, J[pk.job], pk);
      else stage_chunk16(smem, j % R::kStages, J[pk.job], pk);
      if (j + 1 < n) next_chunk<R::kRows>(pk, p, J);
    }
    tc::cp_async_commit();
  }
  float acc[2][32], tot[2][32], bs = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = tot[h][i] = 0.f;
  uint32_t ah[2][4], al[2][4];
  WG_START;
  for (int s = 0; s < n; ++s) {
    const int st = s % R::kStages;
    // chunk s is in; every thread is done with the stage chunk s + kAhead goes to
    tc::cp_async_wait<R::kAhead - 1>();
    if constexpr (!f32) tc::fence_proxy_async();
    __syncthreads();
    WG_MARK(0);
    const bool bias = uniform(J[ck.job].bias);
    if constexpr (f32) chunk_products(acc, bs, bias, smem, st, s, ah, al);
    else chunk_products16(acc, bs, bias, smem, st);
    WG_MARK(1);
    // the copies of chunk s + kAhead while the last products run
    if (s + R::kAhead < n) {
      if constexpr (f32) stage_chunk(smem, (s + R::kAhead) % R::kStages, J[pk.job], pk);
      else stage_chunk16(smem, (s + R::kAhead) % R::kStages, J[pk.job], pk);
      if (s + R::kAhead + 1 < n) next_chunk<R::kRows>(pk, p, J);
    }
    tc::cp_async_commit();
    WG_MARK(2);
    Cur nk = ck;
    const bool last = s + 1 == n;
    if (!last) next_chunk<R::kRows>(nk, p, J);
    if (uniform(last || nk.item != ck.item)) {  // the item's last chunk of the block
      tc::wgmma_wait<0>();
      tc::fence_regs(acc[0]);
      tc::fence_regs(acc[1]);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) tot[h][i] += acc[h][i], acc[h][i] = 0.f;
    }
    if (uniform(last || nk.g != ck.g)) {  // the run's
      write_slot(tot, bs, J[ck.job], ck.n0, bias,
                 p.partial + (size_t)(blockIdx.x + ck.g) * p.slot, red, p.bias_at);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) tot[h][i] = 0.f;
      bs = 0.f;
    }
    ck = nk;
    WG_MARK(3);
  }
  WG_END(n);
  tc::cp_async_wait<0>();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) wgrad_sum_samples_kernel(WgParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  __shared__ JobDesc J[kNumJobs];
  __shared__ int4 at;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kNumJobs; ++i) J[i] = p.job[i];
  }
  __syncthreads();
  int* red = reinterpret_cast<int*>(smem + Ring<T>::kRed);
  const int n = uniform(partition<Ring<T>::kRows>(p, J, red, &at));
  if (n > 0) tc_chunks<T>(p, J, at, n, smem);
}

// grads[i] = the sum, in block order, of its value in the slots of the runs
// of its weight's job and column slice: group g's chunks [gstart[g],
// gstart[g + 1]) fall to the blocks whose shares [bstart[k], bstart[k + 1])
// (partition) they meet, block k's run in slot k + g. wtab: each weight's
// first element (25 values, the last the end), its job (24) and its columns
// (24; 0: a bias); job_group: each job's first group.
__global__ void sum_samples_kernel(const float* partial, int slot, int bias_at, const int* wtab,
                                   const int* job_group, const int* gstart, const int* bstart,
                                   int blocks, float* grads) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= wtab[kNumWeights]) return;
  int w = 0;
  while (i >= wtab[w + 1]) ++w;
  const int e = i - wtab[w], cols = wtab[kNumWeights + 1 + kNumWeights + w];
  const int n = cols ? e % cols : e;
  const int at = cols ? (e / cols) * kSlice + n % kSlice : bias_at + n % kSlice;
  const int g = job_group[wtab[kNumWeights + 1 + w]] + n / kSlice;
  const int a = gstart[g], b = gstart[g + 1];
  int lo = 0, hi = blocks;  // the first block whose share ends past chunk a
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (bstart[mid + 1] <= a) lo = mid + 1;
    else hi = mid;
  }
  float s = 0.f;
  for (int k = lo; a < b && k < blocks && bstart[k] < b; ++k)  // in block order
    if (bstart[k + 1] > bstart[k]) s += partial[(size_t)(k + g) * slot + at];
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

// The jobs' operands in sample 0's buffers, and the strides to the others'.
template <typename T>
void job_table(const Dims& d, void* node_acts, void* edge_acts,
               unsigned char* node_s, unsigned char* edge_s, JobDesc* J) {
  const FwdBufs<T> f = act_bufs<T>(d, node_acts, edge_acts, 0);
  const Scratch<T> s = scratch<T>(d, node_s, edge_s, 0);
  const long long an = act_node_elems(d), ae = act_edge_elems(d);
  const long long sn = node_bytes(d, sizeof(T)) / sizeof(T);
  const long long se = edge_bytes(d, sizeof(T)) / sizeof(T);
  const int Np = d.Np, nf = d.nf, nfp = d.nf_p, nfr = d.nf_r, P = d.pstep, rld = rel_in_ld(d);
  auto job = [&](int j, const T* x, long long xs, int ldx, int kin, const T* y, long long ys,
                 int nout, int rows) {  // every dY but dm is dense: row stride nout
    J[j] = JobDesc{x, y, xs, ys, ldx, j == kJNr2 ? kDmLd : nout, kin, nout, rows,
                   job_has_bias(j) ? 1 : 0};
  };
  job(kJPe0, s.pin, sn, pin_ld(d), d.Dp, s.d_pe0, sn, nfp, Np);
  job(kJPe1, f.pe_h1, an, nfp, nfp, s.d_pe1, sn, nfp, Np);
  job(kJPe2, f.pe_h2, an, nfp, nfp, s.d_pe2, sn, nf, Np);
  job(kJRe0, f.rel_in, ae, rld, d.rel_in, s.d_re0, se, nfr, 0);
  job(kJRe1, f.re_h1, ae, nfr, nfr, s.d_re1, se, nfr, 0);
  job(kJRe2, f.re_h2, ae, nfr, nfr, s.d_re2, se, nf, 0);
  job(kJRpW1, f.r_enc, ae, nf, nf, s.d_rb, se, nf, 0);
  job(kJRpW23, f.effs, an, nf, nf, s.d_rs, sn, 2 * nf, P * Np);  // the rounds' rows, slot t at t Np
  job(kJPpWa, f.effs, an, nf, nf, s.d_pb, sn, nf, Np);
  job(kJPpWb, f.aggs, an, nf, nf, s.d_pre, sn, nf, P * Np);
  job(kJNr0, f.effs + (size_t)P * f.eff_step, an, nf, nf, s.d_nr0, sn, nf, Np);
  job(kJNr1, f.nr_h1, an, nf, nf, s.d_nr1, sn, nf, Np);
  job(kJNr2, f.nr_h2, an, nf, nf, s.dm, sn, 3, Np);
}

template <typename T>
cudaError_t launch_wgrad(const WgParams& p, int blocks, cudaStream_t s) {
  const size_t smem = Ring<T>::kBytes + 1024;
  cudaError_t err = cudaFuncSetAttribute(wgrad_sum_samples_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess || blocks == 0) return err;
  wgrad_sum_samples_kernel<T><<<blocks, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

#ifdef GNN_PHASE_CLOCKS
// The profiling build's counters: 16 SM-cycle sums, one per phase
// (GNN_PHASE in the chain kernel), added by every block.
int gnn_train_bwd_set_phase_clocks(void* counters) {
  return (int)cudaMemcpyToSymbol(g_phase_clocks, &counters, sizeof(counters));
}
// ... and the weight-gradient kernel's 7 (WG_MARK).
int gnn_train_bwd_set_wgrad_clocks(void* counters) {
  return (int)cudaMemcpyToSymbol(g_wgrad_clocks, &counters, sizeof(counters));
}
#endif

// Scratch bytes per sample: which 0 = node buffers, 1 = edge buffers.
long long gnn_train_bwd_scratch_bytes(int Np, int K, int pstep, int Dp, int nf_p, int nf_r, int nf,
                                      int rel_in, int which, int bf16_mode) {
  Dims d{};
  d.Np = Np; d.K = K; d.pstep = pstep; d.Dp = Dp; d.nf_p = nf_p; d.nf_r = nf_r; d.nf = nf;
  d.rel_in = rel_in;
  const size_t elem = bf16_mode ? 2 : 4;
  return (long long)(which == 0 ? node_bytes(d, elem) : edge_bytes(d, elem));
}

// Shared memory of a block of the chain kernel.
int gnn_train_bwd_smem_bytes(int Np, int K, int bf16_mode) {
  return (int)smem_layout(Np, K, true, false, bf16_mode != 0).total;
}

// Launch the three kernels on `stream` without synchronising; returns
// cudaGetLastError(). nodes and weights in bfloat16 with bf16_mode, else
// float32; packed: the kNumTc hi pointers of the backward's packed weights,
// then the kNumTc lo ones (null in bf16). node_acts / edge_acts: the
// activations the forward kernel wrote for these inputs and weights in the
// same mode (gnn_forward_launch's). plan: ops/fused_gnn_train.py::wgrad_plan's
// int32 tables one after another: items (n_items x 4), each item's group
// (n_items, padded to a multiple of 4), groups (n_groups x 4), job_group
// (13), wtab (73). gstart: n_groups + 1 + blocks + 1 ints of the launch's
// own (each group's first chunk and the total, each block's); partial:
// blocks + n_groups slots of `slot` floats, the last 128 a slot's bias sums;
// grads: the n_grad weight gradients in weight_list order.
int gnn_train_bwd_launch(const void* nodes, const void* nbr, const void* mask, const void* dmot,
                         const void* const* weights, const void* const* packed, void* node_acts,
                         void* edge_acts, void* node_scratch, void* edge_scratch, void* ecount,
                         void* dnodes, void* gstart, void* partial, void* grads, const void* plan,
                         int n_items, int n_groups, int blocks, int slot, int n_grad, int B,
                         int Np, int N, int n_p, int K, int n_his, int pstep, int Dp, int D,
                         int nf_p, int nf_r, int nf, int rel_in, int bf16_mode, int device,
                         void* stream) {
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
  p.ecount = static_cast<int*>(ecount);
  p.d = Dims{Np, N, n_p, K, n_his, pstep, Dp, D, nf_p, nf_r, nf, rel_in};

  const int* t = static_cast<const int*>(plan);
  WgParams w;
  if (bf16_mode)
    job_table<bf16>(p.d, node_acts, edge_acts, p.node_scratch, p.edge_scratch, w.job);
  else
    job_table<float>(p.d, node_acts, edge_acts, p.node_scratch, p.edge_scratch, w.job);
  w.ecount = p.ecount;
  w.items = reinterpret_cast<const int4*>(t);
  w.item_group = t + 4 * (size_t)n_items;
  w.groups = reinterpret_cast<const int4*>(w.item_group + ((size_t)n_items + 3) / 4 * 4);
  const int* job_group = reinterpret_cast<const int*>(w.groups + n_groups);
  const int* wtab = job_group + kNumJobs;
  w.n_items = n_items;
  w.n_groups = n_groups;
  w.gstart = static_cast<int*>(gstart);
  w.bstart = w.gstart + n_groups + 1;
  w.partial = static_cast<float*>(partial);
  w.slot = slot;
  w.bias_at = slot - kSlice;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const CurrentDeviceGuard restore;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_layout(Np, K, true, false, bf16_mode != 0).total;
  err = bf16_mode ? launch<bf16>(p, B, smem, s) : launch<float>(p, B, smem, s);
  if (err != cudaSuccess) return (int)err;
  err = bf16_mode ? launch_wgrad<bf16>(w, blocks, s) : launch_wgrad<float>(w, blocks, s);
  if (err != cudaSuccess) return (int)err;
  if (n_grad > 0)
    sum_samples_kernel<<<(n_grad + 255) / 256, 256, 0, s>>>(w.partial, slot, w.bias_at, wtab,
                                                           job_group, w.gstart, w.bstart, blocks,
                                                           static_cast<float*>(grads));
  return (int)cudaGetLastError();
}

}  // extern "C"
