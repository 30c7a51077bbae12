// Building blocks shared by the single-step GNN forward (gnn_forward.cu, K2)
// and its training backward (gnn_train_bwd.cu, K3): one thread block of two
// warpgroups per sample.
//
// - layer_tc, the tensor-core layer routine: every product but the two
//   below, Y = X W (the forward and the backward's dX = dY W^T, from weights
//   packed once per launch in PyTorch). (The backward's weight gradients
//   dW = X^T dY are formed batch-wide by gnn_train_bwd.cu's own kernel.)
//   bfloat16 runs on wgmma (m64n64k16, float32 accumulators: the JAX
//   kernel's bf16 dots with preferred_element_type=float32); float32 runs on
//   wgmma m64n64k8 tf32 with each operand split into two TF32 parts, hi·hi
//   + hi·lo + lo·hi ("3xTF32", ~2^-21 relative per product, where plain TF32
//   keeps ~3 digits): the activations are split in registers and fed as
//   wgmma's register operand, the weights' parts come packed (tf32 B must be
//   K-major). A layer's weight (or, in float32, a 128- or 64-row slice of
//   its hi and lo parts) is staged in shared memory once per call. Each
//   warpgroup stages its own 64-row activation tiles by cp.async, the next
//   one in flight during a tile's products, and runs its own tiles, so one
//   warpgroup's epilogue overlaps the other's products. No
//   k-step waits for its own products before the next is issued: each is a
//   wgmma commit group, waited for behind the next (Y = X W adds each step's
//   fresh sums to its accumulators in k order meanwhile), so ptxas keeps the
//   products asynchronous. The epilogue reads its inputs for eight output
//   pairs before it writes any, then runs from the accumulator registers,
//   two adjacent columns at a time, and redoes as float32 FMA chains the few
//   outputs whose bf16 rounding or relu the tensor cores' truncated sums
//   could decide otherwise than a float32 matmul (Redo).
// - gemm, the CUDA-core product, for the narrow products: the motion head's
//   last layer (3 outputs: its forward and dX) and the particle encoder's
//   first layer on the packed p_inputs (its forward and dX), whose rows
//   are not 16-byte aligned. re0 runs on the tensor cores: the relation
//   inputs are kept with a row stride of a multiple of 8 (rel_in_ld).
// - the real edges of a sample, compacted from the (k, i)-ordered prebuilt
//   tables and grouped by receiver (slot order within a receiver); the
//   backward also groups them by sender. Sums over a node's edges run in that
//   order, and every product in a fixed order, so a launch is
//   deterministic: no atomics anywhere.
// - forward_body: the JAX kernel's arithmetic (ops/fused_gnn.py::_kernel) up
//   to the motion head's hidden layers, rounding to the compute dtype T
//   wherever the JAX kernel casts. Activations are kept in T (exact: every
//   kept value is already rounded to T), edge-sized ones on real edges only:
//   for training each in its own place per sample (act_bufs), so the
//   backward reads them as the forward left them; for a forward alone in one
//   reused scratch per resident block (scratch_bufs).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "edge_build.cuh"
#include "mma.cuh"

namespace gnn {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;                // two warpgroups
constexpr int kBM = 64, kBN = 64, kBK = 32;  // CUDA-core gemm tiles
constexpr int kLd = kBM + 4;                 // its staged tile row stride (floats), 16-byte aligned
constexpr int kNumWeights = 24;

// weight_list order (ops/fused_gnn.py::weight_list)
enum W {
  kPe0w, kPe0b, kPe1w, kPe1b, kPe2w, kPe2b,
  kRe0w, kRe0b, kRe1w, kRe1b, kRe2w, kRe2b,
  kRpW1, kRpW23, kRpB,
  kPpWa, kPpWb, kPpB,
  kNr0w, kNr0b, kNr1w, kNr1b, kNr2w, kNr2b,
};

// The layers whose products run on the tensor cores, in the order of the
// packed weights (ops/fused_gnn.py::TC_LAYERS)
enum Tc { kTcPe1, kTcPe2, kTcRe1, kTcRe2, kTcRpW1, kTcRpW23, kTcPpWa, kTcPpWb, kTcNr0, kTcNr1,
          kTcRe0, kNumTc };
// ... and each one's weight in weight_list
__host__ __device__ constexpr int tc_weight(int l) {
  return l == kTcPe1 ? kPe1w : l == kTcPe2 ? kPe2w : l == kTcRe1 ? kRe1w : l == kTcRe2 ? kRe2w
       : l == kTcRpW1 ? kRpW1 : l == kTcRpW23 ? kRpW23 : l == kTcPpWa ? kPpWa
       : l == kTcPpWb ? kPpWb : l == kTcNr0 ? kNr0w : l == kTcNr1 ? kNr1w : kRe0w;
}

struct Dims {
  int Np, N, n_p, K, n_his, pstep, Dp, D, nf_p, nf_r, nf, rel_in;
};

// The row stride of the relation inputs (and of their cotangents): rel_in
// rounded up to 8, the columns past rel_in zero, so the tensor cores' 16-byte
// copies can read their rows.
__host__ __device__ inline int rel_in_ld(const Dims& d) { return (d.rel_in + 7) / 8 * 8; }

// The weights of a launch in T: the 24 of weight_list (the biases and the
// CUDA-core layers read them), and each tensor-core layer's packed matrix,
// the rows of its product's B^T zero-padded to a depth of round16 (and to a
// multiple of 8 rows): the forward's W^T (nout, round16(kin)), the
// backward's W (kin, round16(nout)).
// float32: hi and lo, the TF32 parts; bfloat16: hi the weight, lo null.
template <typename T>
struct Weights {
  const T* w[kNumWeights];
  const T* hi[kNumTc];
  const T* lo[kNumTc];
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }
__host__ __device__ inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// Eight consecutive elements (16-byte aligned: 32 bytes of float32, 16 of
// bf16) as floats, so an elementwise pass has one load in flight per eight
// values instead of one per value.
__device__ __forceinline__ void ld8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void ld8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void st8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void st8(bf16* p, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Two consecutive elements (8-byte aligned float32, 4-byte aligned bf16):
// the layer routine's epilogues take the two adjacent columns that a
// thread's accumulator fragment holds together.
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ldg2(const bf16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Profiling builds (-DGNN_PHASE_CLOCKS, ops/kernels.py's "phase_clocks"
// variant): GNN_PHASE(k) ends phase k of a block, adding the SM cycles since
// the previous mark to counter k of the buffer that the kernel's file sets
// (gnn_*_set_phase_clocks). The normal build has no counters.
#ifdef GNN_PHASE_CLOCKS
#define GNN_PHASE(k) ::gnn::phase_mark(k)
static __device__ unsigned long long* g_phase_clocks;  // per source file
__device__ __forceinline__ void phase_mark(int k) {
  __shared__ long long last;
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long now = clock64();
    if (k >= 0) atomicAdd(g_phase_clocks + k, (unsigned long long)(now - last));
    last = now;
  }
  __syncthreads();
}
// Inside the layer routine, thread 0's cycles go to counters 13 (staging:
// issuing the copies and waiting for them), 14 (the products) and 15 (the
// epilogue), summed over every call.
#define GNN_SUB_START(t) long long t = clock64()
#define GNN_SUB(k, t) ::gnn::sub_mark(k, t)
__device__ __forceinline__ void sub_mark(int k, long long& t) {
  if (threadIdx.x == 0) {
    const long long now = clock64();
    atomicAdd(g_phase_clocks + k, (unsigned long long)(now - t));
    t = now;
  }
}
#else
#define GNN_PHASE(k)
#define GNN_SUB_START(t)
#define GNN_SUB(k, t)
#endif

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
// ---------------------------------------------------------------------------
// The tensor-core layer routine
// ---------------------------------------------------------------------------
//
// The k-steps of a product run without a wait behind each one: every k-step
// is a wgmma commit group, and the routine waits for the groups but the
// newest (wgmma.wait_group 1) while the newest runs, so the tensor cores are
// fed while the CUDA cores add; a
// wait with nothing behind it is left only where a staged tile's last sums
// are read. ptxas keeps such a pipeline asynchronous only where it can
// follow it: every wgmma is in straight-line code (a step count of 2 or 4,
// each its own instance, chosen by a branch outside the products), every
// count that steers it passes through uniform() (a branch it cannot prove
// warp-uniform serialises the wgmma of the whole function, C7520), no
// function is called while products are in flight and nothing that issues
// wgmma is a function of its own (C7510: the routine and what calls it are
// inlined into the kernels), and no register spills (chip_smoke.py's build
// gate holds all three).
//
// layer_tc: each warpgroup takes its own 64-row tiles of X (tiles wg, wg + 2,
// ...), staged by its own 128 threads into its own two buffers, the next
// step's tile in flight during a step's products, and waited for at its own
// named barrier, so one warpgroup's epilogue runs while the other's products
// do. A step is one 64-deep (float32: 32-deep) tile for both 64-column
// halves of the weight slice (64 accumulators a thread, Wide) or for one
// (32, the halves one after the other, the second restaging the row tile's
// activations): the backward's float32 instance takes one half, as 64
// accumulators and their fresh sets leave too few registers beside its own.
// The float32 forward, with both halves, takes its fresh sums in 32-column
// quarters, three sets of 16.
//
// Shared memory (tc, 1,024-aligned), bfloat16:
//   layer_tc: the weight, up to 128 rows x 256 deep as four 64-column
//   swizzled blocks (64 KB), then per warpgroup two 64 x 64 activation tiles
//   (2 x 16 KB);
// float32:
//   layer_tc (wgmma tf32, A from registers): a slice of nc = 128 (depth <=
//   128) or 64 (depth <= 256) weight rows, hi and lo, K-major in 32-float
//   swizzled column blocks (2 x 64 KB), then per warpgroup two 64 x 32
//   activation tiles of row stride 36 (2 x 18 KB).
// The strides keep each warp's fragment loads on 32 different banks.
constexpr int kW16Bytes = 128 * 256 * 2;
constexpr int kA32Ld = 36;
constexpr int kW32Floats = 128 * 128;        // nc x round16(K) for either slice width
// layer_tc's activation tiles, a ring per warpgroup: bf16 64 rows x 64
// (swizzled), float32 64 rows x 32 (row stride kA32Ld). Rings of four and
// three ran no faster in float32 and slower in bf16 on an H100.
constexpr int kStages16 = 2, kA16Elems = 64 * 64;
constexpr int kStages32 = 2, kA32Elems = 64 * kA32Ld;

template <typename T> __host__ __device__ constexpr size_t tc_bytes();
template <> __host__ __device__ constexpr size_t tc_bytes<bf16>() {
  return kW16Bytes + 2 * kStages16 * kA16Elems * 2;
}
template <> __host__ __device__ constexpr size_t tc_bytes<float>() {
  return 2 * kW32Floats * 4 + 2 * kStages32 * kA32Elems * 4;
}
// gemm's two staged tiles reuse the tensor-core tiles
static_assert(2 * kBK * kLd * 4 <= tc_bytes<bf16>() && 2 * kBK * kLd * 4 <= tc_bytes<float>(),
              "the CUDA-core tiles must fit in the tensor-core tiles' space");

// The warpgroup of the calling thread, and a value that every thread of the
// block holds, as values the compiler knows to be the same across a warp.
__device__ __forceinline__ int warpgroup() { return __shfl_sync(~0u, (int)threadIdx.x >> 7, 0); }
__device__ __forceinline__ int uniform(int v) { return __shfl_sync(~0u, v, 0); }

// a barrier of the 128 threads of warpgroup wg (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// Outputs redone as float32 FMA chains. The tensor cores truncate their
// float32 sums (alignment and normalisation round toward zero), so a
// product's value can lie some float32 ulps from the FMA chain in k order
// that a float32 matmul on the CUDA cores computes (the plain versions'
// arithmetic, and that of this kernel's CUDA-core versions). Where that
// decides something, the layer routine redoes the output as that chain from
// X in global memory and the weight (redo_pairs): each epilogue says which of its
// values decide (decides()): in bfloat16, a value rounded to bf16 that lies
// within kMidUlps float32 ulps of a rounding midpoint, and a relu input
// within zero_share<T>() of its terms' sum of 0. The decisions are a
// function of the data: a rerun is bit-identical.
constexpr int kMidUlps = 256;
template <typename T>
__host__ __device__ constexpr float zero_share() {
  return std::is_same<T, float>::value ? 1.0f / 65536 : 1.0f / 4096;
}

// Whether value v of an epilogue decides a bf16 rounding (rnd: v is rounded
// to T) or, with a relu, the relu near 0 (terms: the sum of its terms'
// magnitudes).
template <typename T>
__device__ __forceinline__ bool decides(float v, bool rnd, bool relu, float terms) {
  if (relu && fabsf(v) < zero_share<T>() * terms) return true;
  if (std::is_same<T, float>::value || !rnd || (relu && v < 0.f)) return false;
  return abs(static_cast<int>(__float_as_uint(v) & 0xFFFFu) - 0x8000) <= kMidUlps;
}

// Where the layer routine redoes outputs from. float32: the weight as
// weight_list holds it, element (n, k) of the product's B^T at
// w[n * sn + k * sk] (the packed TF32 parts sum to it only within 2^-22);
// bfloat16 redoes from the packed weight as staged in shared memory, which
// is exact. w null: nothing is redone.
template <typename T>
struct Redo {
  const T* w;
  int sn, sk;
};

// sum_k x[k] w[k * sk], k < K, one FMA after another in k order (inlined:
// a call from the message pass, which the float32 forward makes where a
// relu input lies near 0, spills the registers live around it)
template <typename T>
__device__ __forceinline__ float fma_chain(const T* x, const T* w, size_t sk, int K) {
  float s = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) s = fmaf(ld(x + k), ld(w + k * sk), s);
  return s;
}

// The chains of outputs n and n + 1 of row x (global memory, 16-byte
// aligned, zero from K to the next multiple of 8): bfloat16 from rows r and
// r + 1 of the weight slice that layer_tc staged (Ws, swizzled as tc::stage_sw
// leaves it), 8 at a time in k order; float32 from r's weight (inlined, as
// fma_chain is: a call spills the float32 forward's registers live around
// it).
static __device__ __noinline__ void chain2(const bf16* x, const bf16* Ws, int r, int K, float& s0,
                                           float& s1) {
  float a = 0.f, b = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; k += 8) {
    const bf16* blk = Ws + (k >> 6) * 128 * 64;
    const int c = (k & 63) >> 3;
    float xv[8], w0[8], w1[8];
    ld8(x + k, xv);
    ld8(blk + r * 64 + ((c ^ (r & 7)) << 3), w0);
    ld8(blk + (r + 1) * 64 + ((c ^ ((r + 1) & 7)) << 3), w1);
#pragma unroll
    for (int q = 0; q < 8; ++q) a = fmaf(xv[q], w0[q], a), b = fmaf(xv[q], w1[q], b);
  }
  s0 = a, s1 = b;
}
static __device__ __forceinline__ void chain2(const float* x, const float* w, int sn, int sk,
                                              int K, float& s0, float& s1) {
  float a = 0.f, b = 0.f;
  for (int k = 0; k < K; ++k) {
    const float xv = x[k];
    a = fmaf(xv, w[(size_t)k * sk], a);
    b = fmaf(xv, w[sn + (size_t)k * sk], b);
  }
  s0 = a, s1 = b;
}

// An epilogue of the layer routine, in two parts: in(m, n) reads what
// outputs (m, n) and (m, n + 1) need besides their products (at most four
// values: biases, kept activations, cotangents), out(m, n, c0, c1, v) writes
// them from the products and v and returns whether a value decides something
// (decides()). The routine reads eight pairs' inputs (float32: four) before
// it writes any of them, so their loads are in flight together; the two parts may read
// and write only positions (m, n) and (m, n + 1) of other buffers than X.
template <typename In, typename Out>
struct Epilogue {
  In in;
  Out out;
};
template <typename In, typename Out>
__device__ __forceinline__ Epilogue<In, Out> epilogue(In in, Out out) {
  return {in, out};
}
// ... for an epilogue that reads nothing besides the products
struct NoInputs {
  __device__ __forceinline__ float4 operator()(int, int) const {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
};

// After a tile's epilogue: each pair of outputs whose bit j is set in
// `flags` (row r + 8 (j & 1), columns n = nb + 64 (j >> 4) + 8 ((j & 15) >> 1)
// and n + 1, as the accumulator fragments hold them) is redone by
// chain(m, n, s0, s1) and given to the epilogue again: it writes only its
// own positions, so the second write replaces the first.
template <typename Chain, typename Epi>
__device__ inline void redo_pairs(unsigned flags, int r, int nb, Chain chain, Epi& epi) {
  for (; flags != 0; flags &= flags - 1) {
    const int j = __ffs(flags) - 1;
    const int m = r + 8 * (j & 1), n = nb + 64 * (j >> 4) + 8 * ((j & 15) >> 1);
    float s0, s1;
    chain(m, n, s0, s1);
    epi.out(m, n, s0, s1, epi.in(m, n));
  }
}

// The epilogue of a tile of 64 rows and HA 64-column halves (acc[h]: columns
// n0 + 64 h ..) from the accumulators, G pairs at a time, inputs first; then,
// with redo, the pairs it flagged redone by chain. Rows r and r + 8 of the
// tile are this thread's (r: the tile's first row + its warp's 16 + lane /
// 4).
template <int G, int HA, typename Epi, typename Chain>
__device__ __forceinline__ void tile_epilogue(float (&acc)[HA][32], int r, int n0, int M, int N,
                                              bool redo, Chain chain, Epi& epi) {
  const int n1 = n0 + 2 * (threadIdx.x & 3);
  unsigned flags = 0;
#pragma unroll
  for (int h = 0; h < HA; ++h)
#pragma unroll
    for (int i0 = 0; i0 < 32; i0 += 2 * G) {
      float4 v[G];
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const int i = i0 + 2 * q, m = r + 8 * ((i & 3) >> 1), n = n1 + 64 * h + 8 * (i >> 2);
        v[q] = m < M && n < N ? epi.in(m, n) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const int i = i0 + 2 * q, m = r + 8 * ((i & 3) >> 1), n = n1 + 64 * h + 8 * (i >> 2);
        if (m < M && n < N && epi.out(m, n, acc[h][i], acc[h][i + 1], v[q]))
          flags |= 1u << (h * 16 + (i >> 1));
      }
    }
  if (redo) redo_pairs(flags, r, n1, chain, epi);
}

// Rows [r0, r0 + R) and columns [c0, c0 + C) of src into dst, row stride dld
// floats (zero beyond rlim / clim; C, clim, ld and c0 multiples of 4), from
// threads tid = 0 .. nt - 1.
__device__ __forceinline__ void stage_pad(float* dst, int dld, const float* src, int ld, int r0,
                                          int R, int rlim, int c0, int C, int clim, int tid,
                                          int nt) {
  const int cpr = C / 4, n = R * cpr;
  for (int idx = tid; idx < n; idx += nt) {
    const int r = idx / cpr, c = (idx % cpr) * 4;
    const int gr = r0 + r, gc = c0 + c;
    const bool ok = gr < rlim && gc < clim;
    tc::cp_async16(dst + r * dld + c, ok ? src + (size_t)gr * ld + gc : src, ok);
  }
}

// The products of one staged 64-deep tile of the bf16 layer_tc: KS k16 steps
// (2 or 4) for H 64-column halves of the weight slice (Bk: the first; acc[h]:
// half h's sums). Each step and half is a commit group into fresh
// accumulators, added to acc[h] by float32 adds in k order: carried through
// the tensor cores, the sum truncates toward zero at every step, which flips
// the bf16 rounding of the outputs far more often than a float32 FMA chain
// does. Two sets of fresh accumulators take the groups in turn: group g is
// issued, then g - 1 is waited for and added while g runs.
template <int KS, int H, int HA>
__device__ __forceinline__ void tile_products(float (&acc)[HA][32], const bf16* A, const bf16* Bk) {
  constexpr int NG = KS * H;
  float t[2][32];
#pragma unroll
  for (int g = 0; g <= NG; ++g) {
    if (g < NG) {
      const int ks = g / H, h = g % H;
      tc::wgmma_fence();
      tc::wgmma_m64n64k16<0, 0>(t[g & 1], tc::desc_sw128(A + ks * 16, 16, 1024),
                                tc::desc_sw128(Bk + h * 64 * 64 + ks * 16, 16, 1024), 0);
      tc::wgmma_commit();
    }
    if (g > 0) {
      if (g < NG) tc::wgmma_wait<1>(); else tc::wgmma_wait<0>();
      const int p = g - 1;
      tc::fence_regs(t[p & 1]);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p % H][i] += t[p & 1][i];
    }
  }
}

// ... and of one staged 32-deep tile of the float32 layer_tc (bh, bl: the
// first half's hi and lo parts): KS k8 steps (2 or 4) for H halves, each step
// and half a commit group of three products into fresh accumulators, the two
// small cross terms, then the large one, chained in the tensor cores (lo·hi,
// hi·lo, hi·hi), added to acc[h] by float32 adds in k order: carried through
// the 48 products of a 128-deep layer, the truncated sums gave ~9e-7 of the
// result and more of the forward's relu flips against float64. A: this
// thread's element of the tile (row g, column t of its warp's 16 rows),
// split in registers per step into two sets taken in turn.
template <int KS, int H, int HA>
__device__ __forceinline__ void tile_products(float (&acc)[HA][32], const float* A, const bf16* bh,
                                              const bf16* bl) {
  constexpr int NG = KS * H;
  float d[2][32];
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int g = 0; g <= NG; ++g) {
    if (g < NG) {
      const int kk = g / H, h = g % H, f = kk & 1;
      if (h == 0) {
        tc::split_tf32(A[kk * 8], ah[f][0], al[f][0]);
        tc::split_tf32(A[8 * kA32Ld + kk * 8], ah[f][1], al[f][1]);
        tc::split_tf32(A[kk * 8 + 4], ah[f][2], al[f][2]);
        tc::split_tf32(A[8 * kA32Ld + kk * 8 + 4], ah[f][3], al[f][3]);
      }
      const uint64_t dh = tc::desc_sw128(bh + h * 64 * 64 + kk * 16, 16, 1024);
      const uint64_t dl = tc::desc_sw128(bl + h * 64 * 64 + kk * 16, 16, 1024);
      tc::wgmma_fence();
      tc::wgmma_m64n64k8_tf32(d[g & 1], al[f], dh, 0);
      tc::wgmma_m64n64k8_tf32(d[g & 1], ah[f], dl, 1);
      tc::wgmma_m64n64k8_tf32(d[g & 1], ah[f], dh, 1);
      tc::wgmma_commit();
    }
    if (g > 0) {
      if (g < NG) tc::wgmma_wait<1>(); else tc::wgmma_wait<0>();
      const int p = g - 1;
      tc::fence_regs(d[p & 1]);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p % H][i] += d[p & 1][i];
    }
  }
}

// ... the same products for a warpgroup that holds both halves' sums (acc,
// 64 accumulators), in 32-column quarters of the slice: each step and
// quarter a commit group of three products into 16 fresh accumulators,
// added to its quarter of acc in k order, three sets of them taken in turn
// with two groups in flight while one is added. The same sums as for
// 64-column groups (the tensor cores sum each output over k alone), in a
// third fewer registers than two 64-column sets.
template <int KS, int H>
__device__ __forceinline__ void tile_products_q(float (&acc)[2][32], const float* A,
                                                const bf16* bh, const bf16* bl) {
  constexpr int Q = 2 * H, NG = KS * Q;
  float d[3][16];
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int g = 0; g < NG + 2; ++g) {
    if (g < NG) {
      const int kk = g / Q, q = g % Q, f = kk & 1;
      if (q == 0) {
        tc::split_tf32(A[kk * 8], ah[f][0], al[f][0]);
        tc::split_tf32(A[8 * kA32Ld + kk * 8], ah[f][1], al[f][1]);
        tc::split_tf32(A[kk * 8 + 4], ah[f][2], al[f][2]);
        tc::split_tf32(A[8 * kA32Ld + kk * 8 + 4], ah[f][3], al[f][3]);
      }
      const uint64_t dh = tc::desc_sw128(bh + q * 32 * 64 + kk * 16, 16, 1024);
      const uint64_t dl = tc::desc_sw128(bl + q * 32 * 64 + kk * 16, 16, 1024);
      tc::wgmma_fence();
      tc::wgmma_m64n32k8_tf32(d[g % 3], al[f], dh, 0);
      tc::wgmma_m64n32k8_tf32(d[g % 3], ah[f], dl, 1);
      tc::wgmma_m64n32k8_tf32(d[g % 3], ah[f], dh, 1);
      tc::wgmma_commit();
    }
    const int p = g - 2;  // the group added now: the groups after it stay in flight
    if (p >= 0) {
      if (g < NG) tc::wgmma_wait<2>();
      else if (g == NG) tc::wgmma_wait<1>();
      else tc::wgmma_wait<0>();
      tc::fence_regs(d[p % 3]);
      const int q = p % Q;
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[q >> 1][16 * (q & 1) + i] += d[p % 3][i];
    }
  }
}

// One instance of tile_products per step count and halves (ksteps, halves:
// uniform values; halves 2 only where the accumulators hold two). A tile of
// one or two k-steps runs two, one of three or four runs four: the staged
// tiles are zero past K (the activations from column K, the packed weights
// from their depth), so a step past K adds exact zeros and leaves the sums as
// they were.
template <int HA>
__device__ __forceinline__ void run_tile(int ksteps, int halves, float (&acc)[HA][32],
                                         const bf16* A, const bf16* Bk) {
  if constexpr (HA == 2) {
    if (halves == 2) {
      if (ksteps <= 2) tile_products<2, 2>(acc, A, Bk); else tile_products<4, 2>(acc, A, Bk);
      return;
    }
  }
  if (ksteps <= 2) tile_products<2, 1>(acc, A, Bk); else tile_products<4, 1>(acc, A, Bk);
}
template <int HA>
__device__ __forceinline__ void run_tile(int ksteps, int halves, float (&acc)[HA][32],
                                         const float* A, const bf16* bh, const bf16* bl) {
  if constexpr (HA == 2) {  // in quarters
    if (halves == 2) {
      if (ksteps <= 2) tile_products_q<2, 2>(acc, A, bh, bl);
      else tile_products_q<4, 2>(acc, A, bh, bl);
    } else {
      if (ksteps <= 2) tile_products_q<2, 1>(acc, A, bh, bl);
      else tile_products_q<4, 1>(acc, A, bh, bl);
    }
  } else {
    if (ksteps <= 2) tile_products<2, 1>(acc, A, bh, bl); else tile_products<4, 1>(acc, A, bh, bl);
  }
}

// layer_tc's step j of warpgroup wg into its ring As: the activation tile of
// the step's row tile (rows 64 (2 (j / per_tile) + wg) ..) and k-block (j
// modulo K's k-blocks), by cp.async from the warpgroup's threads; nothing
// commits.
__device__ __forceinline__ void stage_step(bf16* As, const bf16* X, int ldx, int M, int K, int j,
                                           int per_tile, int wg) {
  const int kbn = (round16(K) + 63) / 64;
  tc::stage_sw(As + j % kStages16 * kA16Elems, X, ldx, (2 * (j / per_tile) + wg) * 64, 64, M,
               j % kbn * 64, 1, K, threadIdx.x & 127, 128);
}
__device__ __forceinline__ void stage_step(float* As, const float* X, int ldx, int M, int K, int j,
                                           int per_tile, int wg) {
  const int kcn = (K + 31) / 32;
  stage_pad(As + j % kStages32 * kA32Elems, kA32Ld, X, ldx, (2 * (j / per_tile) + wg) * 64, 64, M,
            j % kcn * 32, 32, K, threadIdx.x & 127, 128);
}

// Y(m, n) = sum_k X(m, k) P(n, k) for m < M, n < N, k < K: X (M, K) of row
// stride ldx, P the packed weight (N, round16(K)) (lo: float32's second TF32
// part). epi (an Epilogue) receives every output from the registers, the
// two adjacent columns n (even) and n + 1 at once; where it returns that a
// value decides something, with rd.w, it receives the pair again redone as
// FMA chains. Every thread calls it; it ends with a barrier (or returns at
// once when M is 0). K <= 256; ldx and N multiples of 8, and K too unless X
// is zero from column K to the next multiple of 8 (the relation inputs,
// rel_in_ld). Per slice of the weight (128 columns, or float32's 64 when K >
// 128): the slice staged by the block, then each warpgroup's steps, the next
// step's activation tile in flight during a step's products. Wide: a step is
// a row tile's k-block for both 64-column halves of the slice (64
// accumulators a thread); else for one half, the halves one after the other
// (32 accumulators, for a kernel whose own registers leave no room for 64;
// the second half restages the row tile's activations).
template <bool Wide, typename Epi>
__device__ __forceinline__ void layer_tc(int M, int N, int K, const bf16* X, int ldx,
                                         const bf16* P, const bf16*, unsigned char* tcs,
                                         Redo<bf16> rd, Epi epi) {
  constexpr int HA = Wide ? 2 : 1;  // 64-column halves of accumulators a thread holds
  M = uniform(M), N = uniform(N), K = uniform(K);
  if (M == 0) return;
  const int Kp = round16(K), kbn = (Kp + 63) / 64;  // 64-deep blocks
  const int wg = warpgroup(), wt = threadIdx.x & 127;
  bf16* Ws = reinterpret_cast<bf16*>(tcs);
  bf16* As = reinterpret_cast<bf16*>(tcs + kW16Bytes) + wg * kStages16 * kA16Elems;  // its ring
  const int tiles = ((M + 63) / 64 + 1 - wg) / 2;  // row tiles wg, wg + 2, ...
  GNN_SUB_START(tt);
  for (int n0 = 0; n0 < N; n0 += 128) {
    const int halves = N - n0 > 64 ? 2 : 1;  // whether the slice's second 64 columns hold outputs
    const int per_tile = (Wide ? 1 : halves) * kbn, steps = tiles * per_tile;
    tc::stage_sw(Ws, P, Kp, n0, 128, N, 0, kbn, Kp, threadIdx.x, kThreads);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    tc::fence_proxy_async();
    __syncthreads();
    for (int j = 0; j < kStages16 - 1; ++j) {  // the first steps' tiles in flight
      if (j < steps) stage_step(As, X, ldx, M, K, j, per_tile, wg);
      tc::cp_async_commit();
    }
    float acc[HA][32];
    for (int s = 0; s < steps; ++s) {
      const int m0 = (2 * (s / per_tile) + wg) * 64, h = s % per_tile / kbn, kb = s % kbn;
      // this step's tile is in, and the warpgroup is done with the buffer the
      // tile kStages16 - 1 steps on goes to
      tc::cp_async_wait<kStages16 - 2>();
      tc::fence_proxy_async();
      wg_sync(wg);
      if (s + kStages16 - 1 < steps) stage_step(As, X, ldx, M, K, s + kStages16 - 1, per_tile, wg);
      tc::cp_async_commit();
      GNN_SUB(13, tt);
      if (kb == 0) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
#pragma unroll
          for (int c = 0; c < HA; ++c) acc[c][i] = 0.f;
      }
      run_tile(uniform(imin(4, (K - kb * 64 + 15) / 16)), Wide ? halves : 1, acc,
               As + s % kStages16 * kA16Elems, Ws + kb * 128 * 64 + h * 64 * 64);
      GNN_SUB(14, tt);
      if (kb == kbn - 1)
        tile_epilogue<8>(acc, m0 + (wt >> 5) * 16 + ((wt & 31) >> 2), n0 + 64 * h, M, N,
                      rd.w != nullptr, [&](int m, int n, float& s0, float& s1) {
                        chain2(X + (size_t)m * ldx, Ws, n - n0, K, s0, s1);
                      }, epi);
      GNN_SUB(15, tt);
    }
    __syncthreads();  // both warpgroups are done with the slice's weight
  }
}

template <bool Wide, typename Epi>
__device__ __forceinline__ void layer_tc(int M, int N, int K, const float* X, int ldx,
                                         const float* Ph, const float* Pl, unsigned char* tcs,
                                         Redo<float> rd, Epi epi) {
  constexpr int HA = Wide ? 2 : 1;  // 64-column halves of accumulators a thread holds
  M = uniform(M), N = uniform(N), K = uniform(K);
  if (M == 0) return;
  // the weight slice's hi and lo parts, K-major and swizzled (32-float column
  // blocks of nc rows; staged as bf16 pairs, the same bytes), then the A tiles
  const int Kp = round16(K), nc = Kp <= 128 ? 128 : 64;
  bf16* Sh = reinterpret_cast<bf16*>(tcs);
  bf16* Sl = reinterpret_cast<bf16*>(tcs + kW32Floats * 4);
  const int wg = warpgroup(), wt = threadIdx.x & 127, g = (wt & 31) >> 2, t = wt & 3;
  float* As = reinterpret_cast<float*>(tcs + 2 * kW32Floats * 4) + wg * kStages32 * kA32Elems;
  const int kcn = (K + 31) / 32, tiles = ((M + 63) / 64 + 1 - wg) / 2;
  GNN_SUB_START(tt);
  for (int n0 = 0; n0 < N; n0 += nc) {
    const int halves = imin(nc, N - n0) > 64 ? 2 : 1;
    const int per_tile = (Wide ? 1 : halves) * kcn, steps = tiles * per_tile;
    tc::stage_sw(Sh, reinterpret_cast<const bf16*>(Ph), 2 * Kp, n0, nc, N, 0, (Kp + 31) / 32,
                 2 * Kp, threadIdx.x, kThreads);
    tc::stage_sw(Sl, reinterpret_cast<const bf16*>(Pl), 2 * Kp, n0, nc, N, 0, (Kp + 31) / 32,
                 2 * Kp, threadIdx.x, kThreads);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    tc::fence_proxy_async();
    __syncthreads();
    for (int j = 0; j < kStages32 - 1; ++j) {  // the first steps' tiles in flight
      if (j < steps) stage_step(As, X, ldx, M, K, j, per_tile, wg);
      tc::cp_async_commit();
    }
    float acc[HA][32];
    for (int s = 0; s < steps; ++s) {
      const int m0 = (2 * (s / per_tile) + wg) * 64, h = s % per_tile / kcn, kc = s % kcn;
      // this step's tile is in, and the warpgroup is done with the buffer the
      // tile kStages32 - 1 steps on goes to
      tc::cp_async_wait<kStages32 - 2>();
      wg_sync(wg);
      if (s + kStages32 - 1 < steps) stage_step(As, X, ldx, M, K, s + kStages32 - 1, per_tile, wg);
      tc::cp_async_commit();
      GNN_SUB(13, tt);
      if (kc == 0) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
#pragma unroll
          for (int c = 0; c < HA; ++c) acc[c][i] = 0.f;
      }
      run_tile(uniform(imin(4, (K - kc * 32 + 7) / 8)), Wide ? halves : 1, acc,
               As + s % kStages32 * kA32Elems + ((wt >> 5) * 16 + g) * kA32Ld + t,
               Sh + kc * nc * 64 + h * 64 * 64, Sl + kc * nc * 64 + h * 64 * 64);
      GNN_SUB(14, tt);
      if (kc == kcn - 1)
        tile_epilogue<4>(acc, m0 + (wt >> 5) * 16 + g, n0 + 64 * h, M, imin(N, n0 + nc),
                      rd.w != nullptr, [&](int m, int n, float& s0, float& s1) {
                        chain2(X + (size_t)m * ldx, rd.w + (size_t)n * rd.sn, rd.sn, rd.sk, K, s0,
                               s1);
                      }, epi);
      GNN_SUB(15, tt);
    }
    __syncthreads();  // both warpgroups are done with the slice's weight
  }
}

// Y = act(X @ W + b) rounded to T, for M rows: X (M, Kin) row stride ldx,
// Y (M, Nout) dense. On the CUDA cores (W (Kin, Nout) of weight_list):
template <typename T, typename TX>
__device__ void dense(int M, int Kin, int Nout, const TX* X, int ldx, const T* Wt, const T* bias,
                      T* Y, bool relu, float* sm) {
  gemm(M, Nout, Kin, X, (size_t)ldx, (size_t)1, Wt, (size_t)Nout, (size_t)1, sm,
       [&](int m, int n, float c) {
         float v = c + ld(bias + n);
         if (relu) v = fmaxf(v, 0.f);
         st(Y + (size_t)m * Nout + n, rnd<T>(v));
       });
}

// ... and on the tensor cores (tensor-core layer l of the packed weights;
// with `redo`, the outputs that decide something are redone, from
// weight_list's W (Kin, Nout) in float32):
template <typename T>
__device__ __forceinline__ void dense_tc(int M, int Kin, int Nout, const T* X, int ldx,
                                         const Weights<T>& w, int l, const T* bias, T* Y,
                                         bool relu, bool redo, unsigned char* tcs) {
  const Redo<T> rd{redo ? w.w[tc_weight(l)] : nullptr, 1, Nout};
  layer_tc<true>(M, Nout, Kin, X, ldx, w.hi[l], w.lo[l], tcs, rd, epilogue([&](int, int n) {
    const float2 b = ld2(bias + n);
    return make_float4(b.x, b.y, 0.f, 0.f);
  }, [&](int m, int n, float c0, float c1, float4 b) {
    const float v0 = c0 + b.x, v1 = c1 + b.y;
    const bool again = decides<T>(v0, true, relu, fabsf(c0) + fabsf(b.x)) ||
                       decides<T>(v1, true, relu, fabsf(c1) + fabsf(b.y));
    st2(Y + (size_t)m * Nout + n, rnd<T>(relu ? fmaxf(v0, 0.f) : v0),
        rnd<T>(relu ? fmaxf(v1, 0.f) : v1));
    return again;
  }));
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
  if (sl != nullptr) {  // one warp per sender, 32 edges per ballot
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int j = warp; j < Np; j += kThreads / 32) {
      int c = 0;
      for (int e = lane; e - lane < E; e += 32) c += __popc(__ballot_sync(~0u, e < E && es[e] == j));
      if (lane == 0) soff[j + 1] = c;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      soff[0] = 0;
      for (int j = 0; j < Np; ++j) soff[j + 1] += soff[j];
    }
    __syncthreads();
    for (int j = warp; j < Np; j += kThreads / 32) {
      int at = soff[j];
      for (int e = lane; e - lane < E; e += 32) {
        const bool hit = e < E && es[e] == j;
        const unsigned m = __ballot_sync(~0u, hit);
        if (hit) sl[at + __popc(m & ((1u << lane) - 1))] = e;
        at += __popc(m);
      }
    }
    __syncthreads();
  }
  return E;
}

// Shared memory of a block, from a 1,024-aligned base (align_smem): the
// tensor-core tiles (which the CUDA-core gemm tiles and the column sums'
// scratch reuse), then the edge lists; with `radius`, also the (Np, K) sender
// table and per-row counts that the in-kernel graph build (edge_build.cuh)
// fills. `total` includes the 1,024 bytes the alignment may skip.
struct Smem {
  size_t off, soff, er, es, sl, nbr, cnt, total;
};

__host__ __device__ inline Smem smem_layout(int Np, int K, bool senders, bool radius, bool bf16_mode) {
  const size_t emax = (size_t)Np * K;
  Smem s;
  size_t at = bf16_mode ? tc_bytes<bf16>() : tc_bytes<float>();
  s.off = at;  at = align16(at + (Np + 1) * 4);
  s.soff = at; at = align16(at + (senders ? (Np + 1) * 4 : 0));
  s.er = at;   at = align16(at + emax * 2);
  s.es = at;   at = align16(at + emax * 2);
  s.sl = at;   at = align16(at + (senders ? emax * 4 : 0));
  s.nbr = at;  at = align16(at + (radius ? emax * 2 : 0));
  s.cnt = at;  at = align16(at + (radius ? Np * 4 : 0));
  s.total = at + 1024;
  return s;
}

__device__ inline unsigned char* align_smem(unsigned char* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// Where the forward keeps its activations (in T). Edge buffers hold
// real-edge rows. Round t of message passing reads effect slot
// t % eff_slots and writes slot (t + 1) % eff_slots; the aggregate and the
// messages advance by agg_step and ms_step elements per round; ms may be null
// (a forward alone keeps no messages).
template <typename T>
struct FwdBufs {
  T *rel_in, *re_h1, *re_h2, *r_enc, *rel_base, *ms;
  T *pe_h1, *pe_h2, *effs, *pb, *rs, *aggs, *nr_h1, *nr_h2;
  size_t eff_step, agg_step, ms_step;
  int eff_slots;
};

// The forward's activations of one sample, every one kept for the backward
// (the forward writes them, the backward reads them), in elements of T: node
// buffers pe_h1, pe_h2, effs (pstep + 1), pb, rs (2 nf), aggs (pstep), nr_h1,
// nr_h2; edge buffers rel_in, re_h1, re_h2, r_enc, rel_base, ms (pstep),
// sized for every slot and written on the real edges. gnn_forward.cu's
// gnn_forward_act_offsets exports where each buffer starts
// (ops/fused_gnn.py::act_layout).
__host__ __device__ inline size_t act_node_elems(const Dims& d) {
  const size_t nf = d.nf;
  return (size_t)d.Np * (2 * d.nf_p + (d.pstep + 1) * nf + nf + 2 * nf + d.pstep * nf + 2 * nf);
}

__host__ __device__ inline size_t act_edge_elems(const Dims& d) {
  return (size_t)d.Np * d.K * (rel_in_ld(d) + 2 * d.nf_r + 2 * d.nf + d.pstep * d.nf);
}

// Sample b's activation buffers in the two tensors.
template <typename T>
__host__ __device__ inline FwdBufs<T> act_bufs(const Dims& d, void* node_acts, void* edge_acts,
                                               int b) {
  const size_t nN = d.Np, eN = (size_t)d.Np * d.K, nf = d.nf;
  T* at = static_cast<T*>(node_acts) + (size_t)b * act_node_elems(d);
  FwdBufs<T> f;
  f.pe_h1 = at; at += nN * d.nf_p;
  f.pe_h2 = at; at += nN * d.nf_p;
  f.effs = at;  at += nN * nf * (d.pstep + 1);
  f.pb = at;    at += nN * nf;
  f.rs = at;    at += nN * 2 * nf;
  f.aggs = at;  at += nN * nf * d.pstep;
  f.nr_h1 = at; at += nN * nf;
  f.nr_h2 = at;
  T* ae = static_cast<T*>(edge_acts) + (size_t)b * act_edge_elems(d);
  f.rel_in = ae;   ae += eN * rel_in_ld(d);
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
__host__ __device__ inline size_t scratch_node_elems(const Dims& d) {
  return (size_t)d.Np * (2 * d.nf_p + 2 * d.nf + d.nf + 2 * d.nf + d.nf + 2 * d.nf);
}

__host__ __device__ inline size_t scratch_edge_elems(const Dims& d) {
  return (size_t)d.Np * d.K * (imax(rel_in_ld(d), d.nf_r) + imax(d.nf_r, d.nf) + d.nf);
}

template <typename T>
__host__ __device__ inline FwdBufs<T> scratch_bufs(const Dims& d, void* node_s, void* edge_s,
                                                   int slot) {
  const size_t nN = d.Np, eN = (size_t)d.Np * d.K, nf = d.nf;
  T* at = static_cast<T*>(node_s) + (size_t)slot * scratch_node_elems(d);
  FwdBufs<T> f;
  f.pe_h1 = at; at += nN * d.nf_p;
  f.pe_h2 = at; at += nN * d.nf_p;
  f.effs = at;  at += nN * nf * 2;
  f.pb = at;    at += nN * nf;
  f.rs = at;    at += nN * 2 * nf;
  f.aggs = at;  at += nN * nf;
  f.nr_h1 = at; at += nN * nf;
  f.nr_h2 = at;
  T* ae = static_cast<T*>(edge_s) + (size_t)slot * scratch_edge_elems(d);
  f.rel_in = f.re_h2 = ae;  ae += eN * imax(rel_in_ld(d), d.nf_r);
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
// (nh3) | attrs (2) | g (1)] in T. smem: the block's aligned shared memory.
template <typename T>
__device__ __forceinline__ void forward_body(const Dims& d, const T* nodes, const Weights<T>& W,
                                             int E, const int* off, const short* er,
                                             const short* es, const FwdBufs<T>& f,
                                             unsigned char* smem) {
  const int nh3 = d.n_his * 3, nf = d.nf, rin = d.rel_in, rld = rel_in_ld(d), Np = d.Np;
  const int D = d.D, Dp = d.Dp;
  const T* const* w = W.w;
  float* sm = reinterpret_cast<float*>(smem);
  // Outputs that decide a rounding or a relu are redone (Redo) in float32,
  // and in bfloat16 where the activations are kept for the backward
  // (training, where the backward's gradients depend on each decision): a
  // bf16 forward alone (planning at B 2,000) keeps the tensor cores' sums,
  // whose error lies within bf16's own, and skips the redos' cost.
  const bool redo = std::is_same<T, float>::value || f.ms != nullptr;
  // relation inputs [T_attrs | G_attrs | |T_g - G_g| | T_sn - G_sn], differences
  // in T, row stride rld (zeros past rin)
  {
    const T* __restrict__ nd = nodes;
    T* __restrict__ ri = f.rel_in;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < E * rld; idx += kThreads) {
      const int e = idx / rld, c = idx % rld;
      const T* gi = nd + (size_t)er[e] * D + Dp;
      const T* gj = nd + (size_t)es[e] * D + Dp;
      float v;
      if (c < 2) v = ld(gi + nh3 + c);
      else if (c < 4) v = ld(gj + nh3 + c - 2);
      else if (c == 4) v = fabsf(rnd<T>(ld(gi + nh3 + 2) - ld(gj + nh3 + 2)));
      else if (c < rin) v = rnd<T>(ld(gi + c - 5) - ld(gj + c - 5));
      else v = 0.f;
      st(ri + (size_t)e * rld + c, v);
    }
  }
  __syncthreads();
  GNN_PHASE(0);
  // relation encoder (relu after every layer) and the hoisted relation term
  dense_tc<T>(E, rin, d.nf_r, f.rel_in, rld, W, kTcRe0, w[kRe0b], f.re_h1, true, redo, smem);
  GNN_PHASE(1);
  dense_tc<T>(E, d.nf_r, d.nf_r, f.re_h1, d.nf_r, W, kTcRe1, w[kRe1b], f.re_h2, true, redo, smem);
  dense_tc<T>(E, d.nf_r, nf, f.re_h2, d.nf_r, W, kTcRe2, w[kRe2b], f.r_enc, true, redo, smem);
  dense_tc<T>(E, nf, nf, f.r_enc, nf, W, kTcRpW1, w[kRpB], f.rel_base, false, redo, smem);
  GNN_PHASE(2);
  // particle encoder and the hoisted propagator term
  dense<T>(Np, Dp, d.nf_p, nodes, D, w[kPe0w], w[kPe0b], f.pe_h1, true, sm);
  GNN_PHASE(3);
  dense_tc<T>(Np, d.nf_p, d.nf_p, f.pe_h1, d.nf_p, W, kTcPe1, w[kPe1b], f.pe_h2, true, redo, smem);
  dense_tc<T>(Np, d.nf_p, nf, f.pe_h2, d.nf_p, W, kTcPe2, w[kPe2b], f.effs, true, redo, smem);
  dense_tc<T>(Np, nf, nf, f.effs, nf, W, kTcPpWa, w[kPpB], f.pb, false, redo, smem);
  GNN_PHASE(4);

  for (int t = 0; t < d.pstep; ++t) {
    const T* eff = f.effs + (t % f.eff_slots) * f.eff_step;
    T* eff_next = f.effs + ((t + 1) % f.eff_slots) * f.eff_step;
    T* agg = f.aggs + t * f.agg_step;
    T* ms = f.ms ? f.ms + t * f.ms_step : nullptr;
    T* rs = f.rs;
    // [recv | send] projections
    layer_tc<true>(Np, 2 * nf, nf, eff, nf, W.hi[kTcRpW23], W.lo[kTcRpW23], smem,
             Redo<T>{redo ? w[kRpW23] : nullptr, 1, 2 * nf},
             epilogue(NoInputs(), [&](int m, int n, float c0, float c1, float4) {
               st2(rs + (size_t)m * 2 * nf + n, rnd<T>(c0), rnd<T>(c1));
               return decides<T>(c0, true, false, 0.f) || decides<T>(c1, true, false, 0.f);
             }));
    GNN_PHASE(5);
    // messages relu(rel_base + recv_i + send_j), summed over each receiver's
    // edges in slot order; eight channels per thread. float32: a message
    // whose relu input lies within zero_share of its terms' sum of 0 is
    // redone from FMA chains of its three products (bf16: its terms are
    // bf16 outputs of the layer routine, decided there)
    {
      const T* __restrict__ w1 = w[kRpW1];
      const T* __restrict__ w23 = w[kRpW23];
      auto chained = [&](int e, int i, int n) {
        const float base = fma_chain(f.r_enc + (size_t)e * nf, w1 + n, (size_t)nf, nf) + ld(w[kRpB] + n);
        const float recv = fma_chain(eff + (size_t)i * nf, w23 + n, (size_t)2 * nf, nf);
        return base + recv + fma_chain(eff + (size_t)es[e] * nf, w23 + nf + n, (size_t)2 * nf, nf);
      };
      const T* __restrict__ rsr = rs;
      const T* __restrict__ rb = f.rel_base;
      T* __restrict__ msw = ms;
      const int nv = nf / 8;
      for (int idx = threadIdx.x; idx < Np * nv; idx += kThreads) {
        const int i = idx / nv, c = (idx % nv) * 8;
        float recv[8], acc[8];
        ld8(rsr + (size_t)i * 2 * nf + c, recv);
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[q] = 0.f;
#pragma unroll 2
        for (int e = off[i]; e < off[i + 1]; ++e) {
          float base[8], send[8], v[8];
          ld8(rb + (size_t)e * nf + c, base);
          ld8(rsr + (size_t)es[e] * 2 * nf + nf + c, send);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            float z = rnd<T>(rnd<T>(base[q] + recv[q]) + send[q]);
            if constexpr (std::is_same<T, float>::value) {
              if (decides<T>(z, false, true, fabsf(base[q]) + fabsf(recv[q]) + fabsf(send[q])))
                z = chained(e, i, c + q);
            }
            v[q] = fmaxf(z, 0.f);
            acc[q] += v[q];
          }
          if (msw) st8(msw + (size_t)e * nf + c, v);
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[q] = rnd<T>(acc[q]);
        st8(agg + (size_t)i * nf + c, acc);
      }
    }
    __syncthreads();
    GNN_PHASE(6);
    // effect = relu(part_base + agg @ Wb + effect): agg @ Wb decides its
    // bf16 rounding and (float32, where it is not rounded) the relu
    const T* pb = f.pb;
    auto effect = [&](float b, float c, float e, bool& again) {
      const float z = rnd<T>(rnd<T>(b + rnd<T>(c)) + e);
      again |= decides<T>(c, true, false, 0.f) ||
               (std::is_same<T, float>::value &&
                decides<T>(z, false, true, fabsf(b) + fabsf(c) + fabsf(e)));
      return fmaxf(z, 0.f);
    };
    layer_tc<true>(Np, nf, nf, agg, nf, W.hi[kTcPpWb], W.lo[kTcPpWb], smem,
             Redo<T>{redo ? w[kPpWb] : nullptr, 1, nf}, epilogue([&](int m, int n) {
               const size_t at = (size_t)m * nf + n;
               const float2 b = ld2(pb + at), e = ld2(eff + at);
               return make_float4(b.x, b.y, e.x, e.y);
             }, [&](int m, int n, float c0, float c1, float4 be) {
               bool again = false;
               const float y0 = effect(be.x, c0, be.z, again), y1 = effect(be.y, c1, be.w, again);
               st2(eff_next + (size_t)m * nf + n, y0, y1);
               return again;
             }));
    GNN_PHASE(7);
  }
  const T* eff = f.effs + (d.pstep % f.eff_slots) * f.eff_step;
  dense_tc<T>(Np, nf, nf, eff, nf, W, kTcNr0, w[kNr0b], f.nr_h1, true, redo, smem);
  dense_tc<T>(Np, nf, nf, f.nr_h1, nf, W, kTcNr1, w[kNr1b], f.nr_h2, true, redo, smem);
  GNN_PHASE(8);
}

}  // namespace gnn
