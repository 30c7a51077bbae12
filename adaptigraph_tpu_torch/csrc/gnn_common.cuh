// Building blocks shared by the single-step GNN forward (gnn_forward.cu, K2)
// and its training backward (gnn_train_bwd.cu, K3): one thread block per
// sample, float32 arithmetic on the CUDA cores.
//
// - gemm: a 64 x 64 output tile at a time, 32-deep k chunks staged in shared
//   memory, 4 x 4 outputs per thread; operands are strided views, so the same
//   routine computes X @ W, dY @ W^T and X^T @ dY. Each output is the sum of
//   its products in k order, handed to an epilogue functor.
// - the real edges of a sample, compacted from the (k, i)-ordered prebuilt
//   tables and grouped by receiver (slot order within a receiver); the
//   backward also groups them by sender. Sums over a node's edges run in that
//   order, so a launch is deterministic: no atomics anywhere.
// - forward_body: the JAX kernel's arithmetic (ops/fused_gnn.py::_kernel) up
//   to the motion head's hidden layers, rounding to the compute dtype T
//   wherever the JAX kernel casts. Activations are kept in float32 buffers
//   (already rounded), edge-sized ones on real edges only: for training each
//   in its own place per sample (act_bufs), so the backward reads them as the
//   forward left them; for a forward alone in one reused scratch per resident
//   block (scratch_bufs).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "edge_build.cuh"

namespace gnn {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kLd = kBM + 4;                 // staged tile row stride (floats), 16-byte aligned
constexpr int kGemmFloats = 2 * kBK * kLd;
constexpr int kNumWeights = 24;

// weight_list order (ops/fused_gnn.py::weight_list)
enum W {
  kPe0w, kPe0b, kPe1w, kPe1b, kPe2w, kPe2b,
  kRe0w, kRe0b, kRe1w, kRe1b, kRe2w, kRe2b,
  kRpW1, kRpW23, kRpB,
  kPpWa, kPpWb, kPpB,
  kNr0w, kNr0b, kNr1w, kNr1b, kNr2w, kNr2b,
};

struct Dims {
  int Np, N, n_p, K, n_his, pstep, Dp, D, nf_p, nf_r, nf, rel_in;
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }

// Round to the compute dtype and back (the JAX kernel's .astype(cd)).
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// C(m, n) = sum_k A(m, k) B(k, n) for m < M, n < N, k < Kd, with
// A(m, k) = A[m * sam + k * sak] and B(k, n) = B[k * sbk + n * sbn];
// epi(m, n, c) receives every output. The epilogue may read and write
// position (m, n) of other buffers but nothing A or B point into. Every
// thread of the block calls it; it ends with a barrier.
template <typename TA, typename TB, typename Epi>
__device__ void gemm(int M, int N, int Kd, const TA* A, size_t sam, size_t sak, const TB* B,
                     size_t sbk, size_t sbn, float* sm, Epi epi) {
  float* As = sm;
  float* Bs = sm + kBK * kLd;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int m0 = 0; m0 < M; m0 += kBM) {
    for (int n0 = 0; n0 < N; n0 += kBN) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < Kd; k0 += kBK) {
        // neighbouring threads read neighbouring addresses of whichever index is contiguous
        for (int idx = tid; idx < kBK * kBM; idx += kThreads) {
          const int m = sak == 1 ? idx / kBK : idx % kBM;
          const int k = sak == 1 ? idx % kBK : idx / kBM;
          const int gm = m0 + m, gk = k0 + k;
          As[k * kLd + m] = (gm < M && gk < Kd) ? ld(A + gm * sam + gk * sak) : 0.f;
        }
        for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
          const int n = sbn == 1 ? idx % kBN : idx / kBK;
          const int k = sbn == 1 ? idx / kBN : idx % kBK;
          const int gn = n0 + n, gk = k0 + k;
          Bs[k * kLd + n] = (gn < N && gk < Kd) ? ld(B + gk * sbk + gn * sbn) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < kBK; ++k) {
          const float4 a = *reinterpret_cast<const float4*>(As + k * kLd + ty * 4);
          const float4 b = *reinterpret_cast<const float4*>(Bs + k * kLd + tx * 4);
          const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + tx * 4 + j;
          if (m < M && n < N) epi(m, n, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();
}

// Y = act(X @ W + b) rounded to T, for M rows: X (M, Kin) row stride ldx,
// W (Kin, Nout) and b (Nout) in the compute dtype, Y (M, Nout) dense.
template <typename T, typename TX>
__device__ void dense(int M, int Kin, int Nout, const TX* X, int ldx, const T* Wt, const T* bias,
                      float* Y, bool relu, float* sm) {
  gemm(M, Nout, Kin, X, (size_t)ldx, (size_t)1, Wt, (size_t)Nout, (size_t)1, sm,
       [&](int m, int n, float c) {
         float v = c + ld(bias + n);
         if (relu) v = fmaxf(v, 0.f);
         Y[(size_t)m * Nout + n] = rnd<T>(v);
       });
}

// The real edges of one sample (mask > 0 and a sender inside [0, Np)),
// grouped by receiver: edges off[i] .. off[i+1] have receiver i, in slot
// order; er/es hold each edge's receiver and sender. With sl/soff, also
// grouped by sender: sl[soff[j] .. soff[j+1]] are the edges sent by j, in
// edge order. Returns the number of real edges. Every thread calls it.
__device__ inline int build_edges(const int* nbr, const float* mask, int Np, int K, int* off, short* er,
                           short* es, int* soff, int* sl) {
  for (int i = threadIdx.x; i < Np; i += kThreads) {
    int c = 0;
    for (int k = 0; k < K; ++k) {
      const int j = nbr[k * Np + i];
      c += (mask[k * Np + i] > 0.f && j >= 0 && j < Np);
    }
    off[i + 1] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    off[0] = 0;
    for (int i = 0; i < Np; ++i) off[i + 1] += off[i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Np; i += kThreads) {
    int at = off[i];
    for (int k = 0; k < K; ++k) {
      const int j = nbr[k * Np + i];
      if (mask[k * Np + i] > 0.f && j >= 0 && j < Np) {
        er[at] = (short)i;
        es[at] = (short)j;
        ++at;
      }
    }
  }
  __syncthreads();
  const int E = off[Np];
  if (sl != nullptr) {
    for (int j = threadIdx.x; j < Np; j += kThreads) {
      int c = 0;
      for (int e = 0; e < E; ++e) c += (es[e] == j);
      soff[j + 1] = c;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      soff[0] = 0;
      for (int j = 0; j < Np; ++j) soff[j + 1] += soff[j];
    }
    __syncthreads();
    for (int j = threadIdx.x; j < Np; j += kThreads) {
      int at = soff[j];
      for (int e = 0; e < E; ++e)
        if (es[e] == j) sl[at++] = e;
    }
    __syncthreads();
  }
  return E;
}

// Shared memory of a block: the gemm tiles, then the edge lists; with
// `radius`, also the (Np, K) sender table and per-row counts that the
// in-kernel graph build (edge_build.cuh) fills.
struct Smem {
  size_t off, soff, er, es, sl, nbr, cnt, total;
};

__host__ __device__ inline Smem smem_layout(int Np, int K, bool senders, bool radius = false) {
  const size_t emax = (size_t)Np * K;
  Smem s;
  size_t at = (size_t)kGemmFloats * 4;
  s.off = at;  at = align16(at + (Np + 1) * 4);
  s.soff = at; at = align16(at + (senders ? (Np + 1) * 4 : 0));
  s.er = at;   at = align16(at + emax * 2);
  s.es = at;   at = align16(at + emax * 2);
  s.sl = at;   at = align16(at + (senders ? emax * 4 : 0));
  s.nbr = at;  at = align16(at + (radius ? emax * 2 : 0));
  s.cnt = at;  at = align16(at + (radius ? Np * 4 : 0));
  s.total = at;
  return s;
}

// Where the forward keeps its activations (float32, rounded to T). Edge
// buffers hold real-edge rows. Round t of message passing reads effect slot
// t % eff_slots and writes slot (t + 1) % eff_slots; the aggregate and the
// messages advance by agg_step and ms_step floats per round; ms may be null
// (a forward alone keeps no messages).
struct FwdBufs {
  float *rel_in, *re_h1, *re_h2, *r_enc, *rel_base, *ms;
  float *pe_h1, *pe_h2, *effs, *pb, *rs, *aggs, *nr_h1, *nr_h2;
  size_t eff_step, agg_step, ms_step;
  int eff_slots;
};

// The forward's activations of one sample, every one kept for the backward
// (the forward writes them, the backward reads them): node buffers pe_h1,
// pe_h2, effs (pstep + 1), pb, rs (2 nf), aggs (pstep), nr_h1, nr_h2; edge
// buffers rel_in, re_h1, re_h2, r_enc, rel_base, ms (pstep), sized for every
// slot and written on the real edges. chip_smoke.py's kernel_relu_outputs
// reads this layout.
__host__ __device__ inline size_t act_node_floats(const Dims& d) {
  const size_t nf = d.nf;
  return (size_t)d.Np * (2 * d.nf_p + (d.pstep + 1) * nf + nf + 2 * nf + d.pstep * nf + 2 * nf);
}

__host__ __device__ inline size_t act_edge_floats(const Dims& d) {
  return (size_t)d.Np * d.K * (d.rel_in + 2 * d.nf_r + 2 * d.nf + d.pstep * d.nf);
}

// Sample b's activation buffers in the two scratch tensors.
__host__ __device__ inline FwdBufs act_bufs(const Dims& d, float* node_acts, float* edge_acts,
                                            int b) {
  const size_t nN = d.Np, eN = (size_t)d.Np * d.K, nf = d.nf;
  float* at = node_acts + (size_t)b * act_node_floats(d);
  FwdBufs f;
  f.pe_h1 = at; at += nN * d.nf_p;
  f.pe_h2 = at; at += nN * d.nf_p;
  f.effs = at;  at += nN * nf * (d.pstep + 1);
  f.pb = at;    at += nN * nf;
  f.rs = at;    at += nN * 2 * nf;
  f.aggs = at;  at += nN * nf * d.pstep;
  f.nr_h1 = at; at += nN * nf;
  f.nr_h2 = at;
  float* ae = edge_acts + (size_t)b * act_edge_floats(d);
  f.rel_in = ae;   ae += eN * d.rel_in;
  f.re_h1 = ae;    ae += eN * d.nf_r;
  f.re_h2 = ae;    ae += eN * d.nf_r;
  f.r_enc = ae;    ae += eN * nf;
  f.rel_base = ae; ae += eN * nf;
  f.ms = ae;
  f.eff_step = f.agg_step = nN * nf;
  f.ms_step = eN * nf;
  f.eff_slots = d.pstep + 1;
  return f;
}

// A forward alone: the scratch of one resident block, reused by each sample
// it runs. Node buffers pe_h1, pe_h2, two effect slots, pb, rs (2 nf), one
// aggregate, nr_h1, nr_h2; edge buffers X, Y (each as wide as the widest of
// the layers that share it) and rel_base: rel_in and re_h2 in X, re_h1 and
// r_enc in Y, so no layer's output overwrites its input. No messages.
__host__ __device__ inline size_t scratch_node_floats(const Dims& d) {
  return (size_t)d.Np * (2 * d.nf_p + 2 * d.nf + d.nf + 2 * d.nf + d.nf + 2 * d.nf);
}

__host__ __device__ inline size_t scratch_edge_floats(const Dims& d) {
  return (size_t)d.Np * d.K * (imax(d.rel_in, d.nf_r) + imax(d.nf_r, d.nf) + d.nf);
}

__host__ __device__ inline FwdBufs scratch_bufs(const Dims& d, float* node_s, float* edge_s,
                                                int slot) {
  const size_t nN = d.Np, eN = (size_t)d.Np * d.K, nf = d.nf;
  float* at = node_s + (size_t)slot * scratch_node_floats(d);
  FwdBufs f;
  f.pe_h1 = at; at += nN * d.nf_p;
  f.pe_h2 = at; at += nN * d.nf_p;
  f.effs = at;  at += nN * nf * 2;
  f.pb = at;    at += nN * nf;
  f.rs = at;    at += nN * 2 * nf;
  f.aggs = at;  at += nN * nf;
  f.nr_h1 = at; at += nN * nf;
  f.nr_h2 = at;
  float* ae = edge_s + (size_t)slot * scratch_edge_floats(d);
  f.rel_in = f.re_h2 = ae;  ae += eN * imax(d.rel_in, d.nf_r);
  f.re_h1 = f.r_enc = ae;   ae += eN * imax(d.nf_r, d.nf);
  f.rel_base = ae;
  f.ms = nullptr;
  f.eff_step = nN * nf;
  f.agg_step = f.ms_step = 0;
  f.eff_slots = 2;
  return f;
}

// The JAX kernel's forward for one sample (prebuilt edges), up to the motion
// head's second hidden layer: nodes (Np, D) = [p_inputs (Dp) | state_norm
// (nh3) | attrs (2) | g (1)] in T; w the 24 weights in T.
template <typename T>
__device__ void forward_body(const Dims& d, const T* nodes, const T* const* w, int E, const int* off,
                             const short* er, const short* es, const FwdBufs& f, float* sm) {
  const int nh3 = d.n_his * 3, nf = d.nf, rin = d.rel_in, Np = d.Np, D = d.D, Dp = d.Dp;
  // relation inputs [T_attrs | G_attrs | |T_g - G_g| | T_sn - G_sn], differences in T
  for (int idx = threadIdx.x; idx < E * rin; idx += kThreads) {
    const int e = idx / rin, c = idx % rin;
    const T* gi = nodes + (size_t)er[e] * D + Dp;
    const T* gj = nodes + (size_t)es[e] * D + Dp;
    float v;
    if (c < 2) v = ld(gi + nh3 + c);
    else if (c < 4) v = ld(gj + nh3 + c - 2);
    else if (c == 4) v = fabsf(rnd<T>(ld(gi + nh3 + 2) - ld(gj + nh3 + 2)));
    else v = rnd<T>(ld(gi + c - 5) - ld(gj + c - 5));
    f.rel_in[(size_t)e * rin + c] = v;
  }
  __syncthreads();
  // relation encoder (relu after every layer) and the hoisted relation term
  dense<T>(E, rin, d.nf_r, f.rel_in, rin, w[kRe0w], w[kRe0b], f.re_h1, true, sm);
  dense<T>(E, d.nf_r, d.nf_r, f.re_h1, d.nf_r, w[kRe1w], w[kRe1b], f.re_h2, true, sm);
  dense<T>(E, d.nf_r, nf, f.re_h2, d.nf_r, w[kRe2w], w[kRe2b], f.r_enc, true, sm);
  dense<T>(E, nf, nf, f.r_enc, nf, w[kRpW1], w[kRpB], f.rel_base, false, sm);
  // particle encoder and the hoisted propagator term
  dense<T>(Np, Dp, d.nf_p, nodes, D, w[kPe0w], w[kPe0b], f.pe_h1, true, sm);
  dense<T>(Np, d.nf_p, d.nf_p, f.pe_h1, d.nf_p, w[kPe1w], w[kPe1b], f.pe_h2, true, sm);
  dense<T>(Np, d.nf_p, nf, f.pe_h2, d.nf_p, w[kPe2w], w[kPe2b], f.effs, true, sm);
  dense<T>(Np, nf, nf, f.effs, nf, w[kPpWa], w[kPpB], f.pb, false, sm);

  for (int t = 0; t < d.pstep; ++t) {
    const float* eff = f.effs + (t % f.eff_slots) * f.eff_step;
    float* eff_next = f.effs + ((t + 1) % f.eff_slots) * f.eff_step;
    float* agg = f.aggs + t * f.agg_step;
    float* ms = f.ms ? f.ms + t * f.ms_step : nullptr;
    float* rs = f.rs;
    // [recv | send] projections
    gemm(Np, 2 * nf, nf, eff, (size_t)nf, (size_t)1, w[kRpW23], (size_t)(2 * nf), (size_t)1, sm,
         [&](int m, int n, float c) { rs[(size_t)m * 2 * nf + n] = rnd<T>(c); });
    // messages relu(rel_base + recv_i + send_j), summed over each receiver's edges
    for (int idx = threadIdx.x; idx < Np * nf; idx += kThreads) {
      const int i = idx / nf, c = idx % nf;
      const float recv = rs[(size_t)i * 2 * nf + c];
      float acc = 0.f;
      for (int e = off[i]; e < off[i + 1]; ++e) {
        const float send = rs[(size_t)es[e] * 2 * nf + nf + c];
        const float v = fmaxf(rnd<T>(rnd<T>(f.rel_base[(size_t)e * nf + c] + recv) + send), 0.f);
        if (ms) ms[(size_t)e * nf + c] = v;
        acc += v;
      }
      agg[(size_t)i * nf + c] = rnd<T>(acc);
    }
    __syncthreads();
    // effect = relu(part_base + agg @ Wb + effect)
    const float* pb = f.pb;
    gemm(Np, nf, nf, agg, (size_t)nf, (size_t)1, w[kPpWb], (size_t)nf, (size_t)1, sm,
         [&](int m, int n, float c) {
           const size_t at = (size_t)m * nf + n;
           eff_next[at] = fmaxf(rnd<T>(rnd<T>(pb[at] + rnd<T>(c)) + eff[at]), 0.f);
         });
  }
  const float* eff = f.effs + (d.pstep % f.eff_slots) * f.eff_step;
  dense<T>(Np, nf, nf, eff, nf, w[kNr0w], w[kNr0b], f.nr_h1, true, sm);
  dense<T>(Np, nf, nf, f.nr_h1, nf, w[kNr1w], w[kNr1b], f.nr_h2, true, sm);
}

}  // namespace gnn
