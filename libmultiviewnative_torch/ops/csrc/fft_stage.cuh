// Shared-memory mixed-radix FFT stages for Hopper (sm_90a), fp32: the x and y
// stages of the fused engine's passes A (K4), C (K7), CQA (K8), CU (K9) and
// CUA (K10), and the z stage of passes B (K6) and BF (K5).
//
// They replace the DFT-as-matrix-product stages of the TPU kernels
// _pass_a_kernel / _pass_c_kernel (libmultiviewnative_tpu/ops/pallas/
// fused_dft2.py:986, :1209, reached by _run_pass_a :1703 and _run_pass_c
// :1825), _pass_cqa_kernel, _pass_cu_kernel and _pass_cua_kernel (reached by
// _run_pass_cqa :1854, _run_pass_cu :1909 and _run_pass_cua :1950: each runs
// K7's inverse y stage, then one x stage that holds the inverse, the
// pointwise step and, for CQA and CUA, the forward, and for those two K4's
// y stage) and _pass_b_kernel / _pass_bf_kernel (the z stage
// below).  The TPU computes a DFT as a product with a dense matrix because
// its matrix unit makes products cheap; fp32 CUDA cores do not, and an
// O(N^2) DFT on them costs 5-9x the HBM time of the pass.  An FFT does
// O(log N) work per value, so these stages are bound by HBM bytes: each
// pass reads its input once, writes and reads the (Kxp, Z, Y) scratch pair
// once, and writes its output once.  Everything else stays in shared memory.
//
// The transform (ops/fused_plan.py make_fft_stages): an in-place
// decimation-in-time FFT.  The load stores input i at position pos[i] (the
// mixed-radix digit reversal); stage j then combines, for each block b and
// k' < m_j, the r values at b*L_j + t*m_j + k' (L_j = r*m_j): each is
// multiplied by the twiddle W_{L_j}^{t k'} and the r of them are replaced by
// their r-point DFT, output k1 at b*L_j + k1*m_j + k'.  A butterfly reads and
// writes the same r places, so a stage needs no second buffer: one barrier
// after it.  Radices 2, 4 and 8 have butterflies of their own, 3, 5 and 7 a
// direct DFT unrolled at compile time; any other prime runs a generic stage
// in rounds of whole butterflies (results in registers, a barrier, then the
// writes).  Twiddles and roots are float64 values stored as float32 (no
// __sinf/__cosf on the device); the inverse conjugates them.
//
// A block holds P sequences interleaved, value i of sequence s at i*P + s,
// and its threads take the sequence index fastest.  So a warp reads and
// writes whole 128-byte lines in every stage, and in the loads and stores
// too: the x stage interleaves the column pairs of its y-column tile, whose
// rows are contiguous in global memory; the y stage interleaves rows and
// walks them fastest, so each row is read and written in 32-byte sectors.
//
// Butterflies use __fmaf_rn where a multiply-add is meant (the library is
// built with -fmad=false).
//
// Storage.  The spectral side of the y and z stages (u, v, the kernel
// spectrum K and the spectra K4, K5, K6, K8 and K10 write) is stored as
// float or as __nv_bfloat16 (the JAX package's LMVN_FUSED_SPEC_BF16,
// fused_dft2.py:530-550): a bf16 value is widened to f32 on load and
// rounded to nearest even on store, and everything between, the shared
// memory, the twiddles and the scratch pair t, stays f32.  The x stages
// read and write only t and real volumes, so they have one form.  Four
// spectral values move as a float4 or an 8-byte bf16 quad, two as a float2
// or a 4-byte bf16 pair (a warp still covers whole 32-byte sectors).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <algorithm>
#include <type_traits>

#include "rl_update.cuh"

extern "C" {

// Mirrors ops/fused.py's _FftArgs: the stage plan of one transform length.
// The kernels take it by value and keep it on their stack (run_stages
// indexes radix[] at run time), so it holds what they read and no more.
struct LmvnFft {
  int n, nstages;
  int radix[16];    // in the order the stages run
  const float* tw;  // (re, im) pairs: n - 1 twiddles, then the roots
  const int* pos;   // position of input i after the digit-reversed load
};

// Mirrors ops/fused.py's _AxisArgs: the plan of one axis (ops/fused_plan.py
// FftStages), of one of three kinds.  Direct: f, the shared-memory stages
// below.  Four-step and Bluestein: the long axes, through HBM
// (fft_long.cuh), f.n the length and no stages of their own.  Host memory:
// read by the launches, never passed to a kernel.
struct LmvnAxis {
  struct LmvnFft f;
  int kind;            // kDirect, kFourStep or kBluestein
  int m;               // Bluestein: the padded length, a power of two >= 2n - 1
  const float* chirp;  // Bluestein: n (re, im) pairs b_j = exp(i pi j^2 / n)
  const float* bhat;   // Bluestein: m (re, im) pairs, the m-point FFT of b / m
  // four-step: the direct plans of N1 and N2 (n = N1 N2); Bluestein: part[0]
  // the plan of m (direct or four-step)
  const struct LmvnAxis* part[2];
};

}  // extern "C"

namespace lmvn_fft {

constexpr int kThreads = 256;
constexpr int kMaxStages = 16;
constexpr int kGenericOuts = 4;  // results a thread holds in a generic round
constexpr int kMaxGenericRadix = kThreads * kGenericOuts;
constexpr int kBatch = 4;  // global loads a thread issues before it waits

// LmvnAxis.kind
constexpr int kDirect = 0, kFourStep = 1, kBluestein = 2;
// the longest axis served: a Bluestein transform of 2^25 points pads to
// 2^26 = 8192^2, the longest power of two whose four-step factors both fit a
// shared-memory stage
constexpr int kMaxLength = 1 << 25;
// blocks a grid's y dimension takes; a launch over more planes runs in
// slices of this many
constexpr int kMaxGridY = 65535;

// For e in [0, n) over the block's threads: load(e), kBatch of them at a
// time, all issued before the first store(e, value), so that each thread
// keeps kBatch loads from HBM in flight.
template <class T, class Load, class Store>
__device__ __forceinline__ void batched(int n, Load load, Store store) {
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * kThreads) {
    T v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (e0 + i * kThreads < n) v[i] = load(e0 + i * kThreads);
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (e0 + i * kThreads < n) store(e0 + i * kThreads, v[i]);
  }
}

struct Pair4 {
  float4 re, im;
};

// ------------------------------------------------------------ storage
__device__ __forceinline__ float widen(unsigned short b) {
  return __bfloat162float(__ushort_as_bfloat16(b));
}

__device__ __forceinline__ unsigned short narrow(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// a 4-byte bf16 pair: value 0 in the low half (the lower address)
__device__ __forceinline__ float2 widen2(unsigned w) {
  return make_float2(widen(w & 0xffffu), widen(w >> 16));
}

__device__ __forceinline__ unsigned narrow2(float a, float b) {
  return narrow(a) | (static_cast<unsigned>(narrow(b)) << 16);
}

// four values at p, through the read-only cache (p aliases no output)
__device__ __forceinline__ float4 ld_quad(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 ld_quad(const __nv_bfloat16* p) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = widen2(w.x), b = widen2(w.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void st_quad(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void st_quad(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(narrow2(v.x, v.y), narrow2(v.z, v.w));
}

// two values at p; NC through the read-only cache
template <bool NC>
__device__ __forceinline__ float2 ld_pair(const float* p) {
  const float2* q = reinterpret_cast<const float2*>(p);
  return NC ? __ldg(q) : *q;
}

template <bool NC>
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* p) {
  const unsigned* q = reinterpret_cast<const unsigned*>(p);
  return widen2(NC ? __ldg(q) : *q);
}

__device__ __forceinline__ void st_pair(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

__device__ __forceinline__ void st_pair(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<unsigned*>(p) = narrow2(v.x, v.y);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fmaf_rn(a.x, b.x, -(a.y * b.y)),
                     __fmaf_rn(a.x, b.y, a.y * b.x));
}

// acc + a*b
__device__ __forceinline__ float2 cmac(float2 acc, float2 a, float2 b) {
  return make_float2(__fmaf_rn(a.x, b.x, __fmaf_rn(-a.y, b.y, acc.x)),
                     __fmaf_rn(a.x, b.y, __fmaf_rn(a.y, b.x, acc.y)));
}

// entry i of a twiddle or root table, conjugated for the inverse
template <bool INV>
__device__ __forceinline__ float2 table(const float2* t, int i) {
  float2 w = __ldg(t + i);
  if (INV) w.y = -w.y;
  return w;
}

// v * (-i) forward, v * (+i) inverse: W_4^1
template <bool INV>
__device__ __forceinline__ float2 rot4(float2 v) {
  return INV ? make_float2(-v.y, v.x) : make_float2(v.y, -v.x);
}

// v * W_8^1: (1 - i)/sqrt(2) forward, (1 + i)/sqrt(2) inverse
template <bool INV>
__device__ __forceinline__ float2 rot8(float2 v) {
  constexpr float h = 0.70710678118654752440f;
  return INV ? make_float2((v.x - v.y) * h, (v.x + v.y) * h)
             : make_float2((v.x + v.y) * h, (v.y - v.x) * h);
}

template <bool INV>
__device__ __forceinline__ void dft4(float2& a, float2& b, float2& c,
                                     float2& d) {
  const float2 s0 = cadd(a, c), d0 = csub(a, c);
  const float2 s1 = cadd(b, d), d1 = rot4<INV>(csub(b, d));
  a = cadd(s0, s1);
  c = csub(s0, s1);
  b = cadd(d0, d1);
  d = csub(d0, d1);
}

// The r-point DFT of v in place; rt holds the roots W_R^s (direct radices).
template <int R, bool INV>
__device__ __forceinline__ void dft(float2 (&v)[R], const float2 (&rt)[R]) {
  if constexpr (R == 2) {
    const float2 a = v[0];
    v[0] = cadd(a, v[1]);
    v[1] = csub(a, v[1]);
  } else if constexpr (R == 4) {
    dft4<INV>(v[0], v[1], v[2], v[3]);
  } else if constexpr (R == 8) {
    // two 4-point DFTs of the even and odd values, then one radix-2 layer
    float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
    float2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
    dft4<INV>(e0, e1, e2, e3);
    dft4<INV>(o0, o1, o2, o3);
    o1 = rot8<INV>(o1);
    o2 = rot4<INV>(o2);
    o3 = rot4<INV>(rot8<INV>(o3));
    v[0] = cadd(e0, o0);
    v[4] = csub(e0, o0);
    v[1] = cadd(e1, o1);
    v[5] = csub(e1, o1);
    v[2] = cadd(e2, o2);
    v[6] = csub(e2, o2);
    v[3] = cadd(e3, o3);
    v[7] = csub(e3, o3);
  } else {
    float2 out[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float2 acc = v[0];
#pragma unroll
      for (int t = 1; t < R; ++t) acc = cmac(acc, v[t], rt[(t * k) % R]);
      out[k] = acc;
    }
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = out[k];
  }
}

// One stage of radix R over P interleaved sequences of length n: each
// thread takes whole butterflies and writes their results where it read
// their inputs, so the stage runs in place.  DIF runs the transposed stage:
// the twiddles multiply the butterfly's outputs instead of its inputs.
template <int R, int P, bool INV, bool DIF>
__device__ __forceinline__ void radix_stage(float2* buf, int n, int m,
                                            const float2* tw,
                                            const float2* roots) {
  float2 rt[R];
  if constexpr (R != 2 && R != 4 && R != 8) {
#pragma unroll
    for (int s = 0; s < R; ++s) rt[s] = table<INV>(roots, s);
  }
  const int L = R * m;
  const int total = P * (n / R);
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int s = e % P, bf = e / P;
    const int k = bf % m, b = bf / m;
    float2* at = buf + (b * L + k) * P + s;
    float2 v[R];
#pragma unroll
    for (int t = 0; t < R; ++t) v[t] = at[t * m * P];
    if (!DIF && k > 0) {
#pragma unroll
      for (int t = 1; t < R; ++t)
        v[t] = cmul(v[t], table<INV>(tw, m - 1 + (t - 1) * m + k));
    }
    dft<R, INV>(v, rt);
    if (DIF && k > 0) {
#pragma unroll
      for (int t = 1; t < R; ++t)
        v[t] = cmul(v[t], table<INV>(tw, m - 1 + (t - 1) * m + k));
    }
#pragma unroll
    for (int t = 0; t < R; ++t) at[t * m * P] = v[t];
  }
}

// A stage of any radix r <= kMaxGenericRadix: rounds of whole butterflies,
// each result a direct sum over the butterfly's r twiddled inputs (DIF: a
// sum over the plain inputs, then twiddled), held in registers until every
// thread has read, then written over the inputs.
template <int P, bool INV, bool DIF>
__device__ void generic_stage(float2* buf, int n, int r, int m,
                              const float2* tw, const float2* roots) {
  const int L = r * m;
  const int butterflies = P * (n / r);
  const int per_round = kMaxGenericRadix / r;
  for (int b0 = 0; b0 < butterflies; b0 += per_round) {
    const int outs = min(per_round, butterflies - b0) * r;
    float2 res[kGenericOuts];
#pragma unroll
    for (int i = 0; i < kGenericOuts; ++i) {
      const int o = threadIdx.x + i * kThreads;
      if (o >= outs) continue;
      const int bf = b0 + o / r, k1 = o % r;
      const int s = bf % P, j = bf / P;
      const int k = j % m, b = j / m;
      const float2* at = buf + (b * L + k) * P + s;
      float2 acc = at[0];
      int root = 0;  // t * k1 mod r
      for (int t = 1; t < r; ++t) {
        root += k1;
        if (root >= r) root -= r;
        float2 v = at[t * m * P];
        if (!DIF && k > 0) v = cmul(v, table<INV>(tw, m - 1 + (t - 1) * m + k));
        acc = cmac(acc, v, table<INV>(roots, root));
      }
      if (DIF && k > 0 && k1 > 0)
        acc = cmul(acc, table<INV>(tw, m - 1 + (k1 - 1) * m + k));
      res[i] = acc;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kGenericOuts; ++i) {
      const int o = threadIdx.x + i * kThreads;
      if (o >= outs) continue;
      const int bf = b0 + o / r, k1 = o % r;
      const int s = bf % P, j = bf / P;
      const int k = j % m, b = j / m;
      buf[(b * L + k1 * m + k) * P + s] = res[i];
    }
    __syncthreads();
  }
}

// One stage of radix r; m is the product of the radices of the stages that
// run before it in run_stages.  Ends with a barrier.
template <int P, bool INV, bool DIF>
__device__ __forceinline__ void stage(float2* buf, int n, int r, int m,
                                      const float2* tw, const float2* roots) {
  switch (r) {
    case 2:
      radix_stage<2, P, INV, DIF>(buf, n, m, tw, roots);
      break;
    case 4:
      radix_stage<4, P, INV, DIF>(buf, n, m, tw, roots);
      break;
    case 8:
      radix_stage<8, P, INV, DIF>(buf, n, m, tw, roots);
      break;
    case 3:
      radix_stage<3, P, INV, DIF>(buf, n, m, tw, roots);
      break;
    case 5:
      radix_stage<5, P, INV, DIF>(buf, n, m, tw, roots);
      break;
    case 7:
      radix_stage<7, P, INV, DIF>(buf, n, m, tw, roots);
      break;
    default:
      generic_stage<P, INV, DIF>(buf, n, r, m, tw, roots);
      break;
  }
  __syncthreads();
}

// whether a radix reads roots from the table (2, 4 and 8 build theirs in)
__device__ __forceinline__ bool has_roots(int r) {
  return r != 2 && r != 4 && r != 8;
}

// Every stage of f on the block's P sequences, loaded in digit-reversed
// order; leaves frequency (or, inverse, sample) i at position i.  Ends with
// a barrier.
template <int P, bool INV>
__device__ void run_stages(float2* buf, const LmvnFft& f) {
  const float2* tw = reinterpret_cast<const float2*>(f.tw);
  const float2* roots = tw + (f.n - 1);
  int m = 1;
  for (int j = 0; j < f.nstages; ++j) {
    const int r = f.radix[j];
    stage<P, INV, false>(buf, f.n, r, m, tw, roots);
    if (has_roots(r)) roots += r;
    m *= r;
  }
}

// The forward transform as the transpose of run_stages' (the DFT matrix is
// symmetric): the transposed stages in reverse order, on sequences loaded in
// natural order; leaves frequency i at position pos[i], where run_stages<P,
// true> takes its input.  Ends with a barrier.
template <int P>
__device__ void run_stages_dif(float2* buf, const LmvnFft& f) {
  const float2* tw = reinterpret_cast<const float2*>(f.tw);
  const float2* roots = tw + (f.n - 1);
  for (int j = 0; j < f.nstages; ++j)
    if (has_roots(f.radix[j])) roots += f.radix[j];
  int m = f.n;
  for (int j = f.nstages - 1; j >= 0; --j) {
    const int r = f.radix[j];
    m /= r;
    if (has_roots(r)) roots -= r;
    stage<P, false, true>(buf, f.n, r, m, tw, roots);
  }
}

// ------------------------------------------------------------ tiles
// Each stage holds a tile of P complex sequences of its length n in shared
// memory, 8 P n bytes, interleaved as above.  The tile is the widest that
// fits one block's opt-in maximum, halving from the stage's widest down to
// kMinTile; plan_ok refuses a direct plan that no tile fits (a longer axis
// takes a four-step or Bluestein plan, fft_long.cuh).  So each stage keeps
// its widest tile up to 232448 / (8 widest) and narrows only past it: x and z
// 16 up to 1816, 8 to 3632, 4 to 7264, 2 to 14528.  ops/fused.py mirrors
// these rules (_x_seq, _y_rows, _z_cols), and tests/test_torch_fft_stages.py
// reads them from here.
constexpr size_t kSmemMax = 232448;  // the opt-in maximum of a block on sm_90
constexpr int kMinTile = 2;

inline int widest_tile(int widest, int n) {
  for (int p = widest; p >= kMinTile; p /= 2)
    if (sizeof(float2) * p * n <= kSmemMax) return p;
  return 0;
}

// fn(std::integral_constant<int, P>()) for a tile width P the stages are
// built for; cudaErrorInvalidValue for any other.
template <class Fn>
int with_tile(int p, Fn fn) {
  switch (p) {
    case 16:
      return fn(std::integral_constant<int, 16>());
    case 8:
      return fn(std::integral_constant<int, 8>());
    case 4:
      return fn(std::integral_constant<int, 4>());
    case 2:
      return fn(std::integral_constant<int, 2>());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------------------ x stages
// A block per (y-column tile of 2S columns, plane z): the column pairs (2s,
// 2s+1) of the tile are the real and imaginary parts of sequence s < S, so
// one complex FFT of length X transforms two real columns.  A row of the
// tile moves as S/2 float4 vectors (quads).
constexpr int kXSeqMax = 16;

inline int x_seq(int X) { return widest_tile(kXSeqMax, X); }

// Vector e of the block's tile of an (X, Y) plane: row e / (S/2), columns
// c0 + 4 (e % (S/2)) on; zeros past Y.
template <int S>
__device__ __forceinline__ float4 tile_quad(const float* __restrict__ plane,
                                            int e, int c0, int Y) {
  constexpr int Q = S / 2;
  const int x = e / Q, c = c0 + 4 * (e % Q);
  return c < Y ? __ldg(reinterpret_cast<const float4*>(
                     plane + static_cast<size_t>(x) * Y + c))
               : make_float4(0.f, 0.f, 0.f, 0.f);
}

// The spectra A, B of the two real columns of sequence s come out of its
// FFT F by the hermitian split A_k = (F_k + conj F_{X-k}) / 2,
// B_k = (F_k - conj F_{X-k}) / 2i, stored as rows k < Kx of the block's
// (z, cols) column of t.  F_k sits at position k after run_stages, at pos[k]
// after run_stages_dif (AT_POS).  Rows k >= Kx of t are not written: the y
// stage writes the pad rows of its output as zeros without reading them.
template <int S, bool AT_POS>
__device__ __forceinline__ void store_half_spectra(float* t_re, float* t_im,
                                                   const float2* buf,
                                                   const LmvnFft& f, int Z,
                                                   int Y, int Kx, int c0,
                                                   int z) {
  constexpr int Q = S / 2;
  const int X = f.n;
  for (int e = threadIdx.x; e < Kx * Q; e += kThreads) {
    const int k = e / Q, q = e % Q, c = c0 + 4 * q;
    if (c >= Y) continue;
    const int kn = k == 0 ? 0 : X - k;
    const int at = AT_POS ? __ldg(f.pos + k) : k;
    const int atn = AT_POS ? __ldg(f.pos + kn) : kn;
    float re[4], im[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 a = buf[at * S + 2 * q + h];
      const float2 b = buf[atn * S + 2 * q + h];
      re[2 * h] = (a.x + b.x) * 0.5f;
      im[2 * h] = (a.y - b.y) * 0.5f;
      re[2 * h + 1] = (a.y + b.y) * 0.5f;
      im[2 * h + 1] = (b.x - a.x) * 0.5f;
    }
    const size_t o = (static_cast<size_t>(k) * Z + z) * Y + c;
    *reinterpret_cast<float4*>(t_re + o) = make_float4(re[0], re[1], re[2], re[3]);
    *reinterpret_cast<float4*>(t_im + o) = make_float4(im[0], im[1], im[2], im[3]);
  }
}

// Two columns' half spectra A, B (rows k < Kx of the block's (z, cols)
// column of t) become one full spectrum Z_k = A_k + i B_k,
// Z_{X-k} = conj A_k + i conj B_k, stored digit-reversed (at pos[k]) for
// run_stages<.., true>, whose inverse FFT is A's column plus i B's.  The
// imaginary parts of A and B at k = 0 and X/2 are dropped, as the zero sine
// columns of the plan's bxp drop them.  NC reads t through the read-only
// cache, for a kernel that does not write t.
template <int S, bool NC>
__device__ __forceinline__ void load_half_spectra(float2* buf,
                                                  const float* t_re,
                                                  const float* t_im,
                                                  const LmvnFft& f, int Z,
                                                  int Y, int Kx, int c0,
                                                  int z) {
  constexpr int Q = S / 2;
  const int X = f.n;
  batched<Pair4>(
      Kx * Q,
      [&](int e) {
        const int k = e / Q, c = c0 + 4 * (e % Q);
        Pair4 v = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
        if (c < Y) {
          const size_t i = (static_cast<size_t>(k) * Z + z) * Y + c;
          const float4* re = reinterpret_cast<const float4*>(t_re + i);
          const float4* im = reinterpret_cast<const float4*>(t_im + i);
          v.re = NC ? __ldg(re) : *re;
          v.im = NC ? __ldg(im) : *im;
        }
        return v;
      },
      [&](int e, Pair4 v) {
        const int k = e / Q, q = e % Q;
        const float4 re = v.re;
        const bool edge = k == 0 || 2 * k == X;
        const float4 im = edge ? make_float4(0.f, 0.f, 0.f, 0.f) : v.im;
        // sequence 2q: A = (re.x, im.x), B = (re.y, im.y); 2q + 1: (.z), (.w)
        *reinterpret_cast<float4*>(buf + __ldg(f.pos + k) * S + 2 * q) =
            make_float4(re.x - im.y, im.x + re.y, re.z - im.w, im.z + re.w);
        if (!edge)
          *reinterpret_cast<float4*>(buf + __ldg(f.pos + X - k) * S + 2 * q) =
              make_float4(re.x + im.y, re.y - im.x, re.z + im.w, re.w - im.z);
      });
}

// K4 launch 1: t[k, z, cols] = sum_x xt[z, x, cols] W_X^{k x} for k < Kx.
template <int S>
__global__ void __launch_bounds__(kThreads)
    x_forward_kernel(float* __restrict__ t_re, float* __restrict__ t_im,
                     const float* __restrict__ xt, const LmvnFft f, int Z,
                     int Y, int Kx, int z0) {
  constexpr int Q = S / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* buf = reinterpret_cast<float2*>(smem);
  const int X = f.n, c0 = blockIdx.x * 2 * S, z = z0 + blockIdx.y;
  const float* plane = xt + static_cast<size_t>(z) * X * Y;
  batched<float4>(
      X * Q, [&](int e) { return tile_quad<S>(plane, e, c0, Y); },
      [&](int e, float4 v) {
        const int x = e / Q, q = e % Q;
        *reinterpret_cast<float4*>(buf + __ldg(f.pos + x) * S + 2 * q) = v;
      });
  __syncthreads();
  run_stages<S, false>(buf, f);
  store_half_spectra<S, false>(t_re, t_im, buf, f, Z, Y, Kx, c0, z);
}

// The x stages that start from half spectra, a block per (y-column tile of
// 2S columns, plane z): K7's, K8's, K9's and K10's.  load_half_spectra and the
// inverse stages leave x in natural order in shared memory, where the value
// K7 stores, value * scale (scale = 1/X: out[z, x, cols] =
// scale * sum_k w_k Re(t[k, z, cols] W_X^{-k x}) over k < Kx, w the hermitian
// doubling weights), meets the pointwise op of the pass:
//   K7   StoreOp      out = value                              FORWARD false
//   K9   RlUpdateOp   out = psi' = lmvn::rl_one(psi, value, w)  FORWARD false
//   K8   QuotientOp   q = lmvn::quotient_one(view, value)       FORWARD true
//   K10  RlUpdateOp   psi' as K9's, stored to out               FORWARD true
// K9 thus computes K1 of K7's output with the same operations, bit for bit,
// and the integral volume is never stored.  FORWARD: the op's result
// replaces the value in shared memory; run_stages_dif, the transposed
// forward stages, take that natural order and leave frequency f at pos[f],
// so no permutation runs between the two transforms; the hermitian split of
// K4's x stage reads F_k and F_{X-k} there and stores rows k < Kx over the
// block's column of t.  The block reads its whole column before its first
// write and blocks own disjoint columns, so t is written in place (and then
// read past the read-only cache).  Columns past Y load as zero half spectra,
// hold zeros after the inverse, and are skipped by the op.
//
// An op reads its operands of the 4 columns at volume offset i (load), then
// maps the 4 values there to its result (apply), storing what it stores.
// The loads of kBatch vectors are issued before the first apply.

struct StoreOp {  // K7
  float* out;
  struct In {};
  __device__ In load(size_t) const { return {}; }
  __device__ float4 apply(In, float4 v, size_t i) const {
    *reinterpret_cast<float4*>(out + i) = v;
    return v;
  }
};

struct QuotientOp {  // K8: K2's quotient against the view
  const float* view;
  using In = float4;
  __device__ In load(size_t i) const {
    return __ldg(reinterpret_cast<const float4*>(view + i));
  }
  __device__ float4 apply(In d, float4 v, size_t) const {
    return make_float4(lmvn::quotient_one(d.x, v.x), lmvn::quotient_one(d.y, v.y),
                       lmvn::quotient_one(d.z, v.z), lmvn::quotient_one(d.w, v.w));
  }
};

// K9, K10: K1's update.  out may alias psi, so neither is __restrict__ and
// psi bypasses the read-only cache; each thread reads its psi vector before
// it writes the same vector of out.  w == NULL selects rp.w_scalar.
struct RlUpdateOp {
  const float* psi;
  float* out;
  const float* w;
  lmvn::RlParams rp;
  struct In {
    float4 psi, w;
  };
  __device__ In load(size_t i) const {
    In in;
    in.psi = *reinterpret_cast<const float4*>(psi + i);
    in.w = w ? __ldg(reinterpret_cast<const float4*>(w + i))
             : make_float4(rp.w_scalar, rp.w_scalar, rp.w_scalar, rp.w_scalar);
    return in;
  }
  __device__ float4 apply(In in, float4 v, size_t i) const {
    const float4 r = make_float4(lmvn::rl_one(in.psi.x, v.x, in.w.x, rp),
                                 lmvn::rl_one(in.psi.y, v.y, in.w.y, rp),
                                 lmvn::rl_one(in.psi.z, v.z, in.w.z, rp),
                                 lmvn::rl_one(in.psi.w, v.w, in.w.w, rp));
    *reinterpret_cast<float4*>(out + i) = r;
    return r;
  }
};

template <int S, bool FORWARD, class Op>
__global__ void __launch_bounds__(kThreads)
    x_stage_kernel(float* t_re, float* t_im, const LmvnFft f, int Z, int Y,
                   int Kx, float scale, const Op op, int z0) {
  using In = typename Op::In;
  constexpr int Q = S / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* buf = reinterpret_cast<float2*>(smem);
  const int X = f.n, c0 = blockIdx.x * 2 * S, z = z0 + blockIdx.y;
  load_half_spectra<S, !FORWARD>(buf, t_re, t_im, f, Z, Y, Kx, c0, z);
  __syncthreads();
  run_stages<S, true>(buf, f);
  const size_t plane = static_cast<size_t>(z) * X * Y;
  batched<In>(
      X * Q,
      [&](int e) {
        const int x = e / Q, c = c0 + 4 * (e % Q);
        return c < Y ? op.load(plane + static_cast<size_t>(x) * Y + c) : In{};
      },
      [&](int e, In in) {
        const int x = e / Q, q = e % Q, c = c0 + 4 * q;
        if (c >= Y) return;
        float4* at = reinterpret_cast<float4*>(buf + x * S + 2 * q);
        const float4 v = *at;
        const float4 r = op.apply(
            in, make_float4(v.x * scale, v.y * scale, v.z * scale, v.w * scale),
            plane + static_cast<size_t>(x) * Y + c);
        if (FORWARD) *at = r;
      });
  if constexpr (FORWARD) {
    __syncthreads();
    run_stages_dif<S>(buf, f);
    store_half_spectra<S, true>(t_re, t_im, buf, f, Z, Y, Kx, c0, z);
  }
}

// ------------------------------------------------------------ y stages
// A block per P rows g = k*Z + z of a (Kxp, Z, Y) pair, each row one
// length-Y FFT.  Spectra keep y in the interleaved split order of
// ops/fused_plan.py split_perm: position j = q*M + p holds frequency
// R*p + q, so the forward stores frequency f at (f mod R)*M + f div R and
// the inverse reads it from there; the omega combination of the split
// stages is not needed.  Threads take the row fastest in the loads and
// stores too: a row is read and written in 32-byte sectors.
// Rows a block: 16 up to Y = 512 (64 KB, for occupancy), then the widest
// tile from 8 (32-byte sectors still): 8 to 3632, 4 to 7264, 2 to 14528.
constexpr size_t kYSmemTarget = 64 * 1024;  // per block, for occupancy
constexpr int kYRowsMax = 16;

inline int y_rows(int Y) {
  return kYRowsMax * sizeof(float2) * Y <= kYSmemTarget
             ? kYRowsMax
             : widest_tile(kYRowsMax / 2, Y);
}

__device__ __forceinline__ int split_freq(int j, int R, int M) {
  return R * (j % M) + j / M;
}

// Forward (K4 launch 2): rows g >= valid (the pad x-frequencies) are
// written as zeros and not read.  Inverse (K7 launch 1): scale = 1/Y; pad
// rows are neither read nor written (the x stage reads k < Kx only).
// The spectral side (Out forward, In inverse) is float or bf16; the
// scratch side is t, always float.
template <int P, bool INV, class Out, class In>
__global__ void __launch_bounds__(kThreads)
    y_kernel(Out* __restrict__ o_re, Out* __restrict__ o_im,
             const In* __restrict__ i_re, const In* __restrict__ i_im,
             const LmvnFft f, int valid, int R, int M, float scale) {
  static_assert(std::is_same<typename std::conditional<INV, Out, In>::type, float>::value,
                "the scratch pair t is float");
  extern __shared__ __align__(16) unsigned char smem[];
  float2* buf = reinterpret_cast<float2*>(smem);
  const int Y = f.n, quads = Y / 4, g0 = blockIdx.x * P;
  if (g0 >= valid) {
    if (!INV) {
      for (int e = threadIdx.x; e < P * quads; e += kThreads) {
        const size_t o = static_cast<size_t>(g0 + e % P) * Y + 4 * (e / P);
        st_quad(o_re + o, make_float4(0.f, 0.f, 0.f, 0.f));
        st_quad(o_im + o, make_float4(0.f, 0.f, 0.f, 0.f));
      }
    }
    return;
  }
  batched<Pair4>(
      P * quads,
      [&](int e) {
        const int g = g0 + e % P;
        Pair4 v = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
        if (g < valid) {
          const size_t i = static_cast<size_t>(g) * Y + 4 * (e / P);
          v.re = ld_quad(i_re + i);
          v.im = ld_quad(i_im + i);
        }
        return v;
      },
      [&](int e, Pair4 v) {
        const int row = e % P, j = 4 * (e / P);
        const float vr[4] = {v.re.x, v.re.y, v.re.z, v.re.w};
        const float vi[4] = {v.im.x, v.im.y, v.im.z, v.im.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int src = INV ? split_freq(j + h, R, M) : j + h;
          buf[__ldg(f.pos + src) * P + row] = make_float2(vr[h], vi[h]);
        }
      });
  __syncthreads();
  run_stages<P, INV>(buf, f);
  for (int e = threadIdx.x; e < P * quads; e += kThreads) {
    const int row = e % P, j = 4 * (e / P), g = g0 + row;
    if (INV && g >= valid) continue;
    float vr[4], vi[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int at = INV ? j + h : split_freq(j + h, R, M);
      const float2 v = buf[at * P + row];
      vr[h] = INV ? v.x * scale : v.x;
      vi[h] = INV ? v.y * scale : v.y;
    }
    const size_t o = static_cast<size_t>(g) * Y + j;
    st_quad(o_re + o, make_float4(vr[0], vr[1], vr[2], vr[3]));
    st_quad(o_im + o, make_float4(vi[0], vi[1], vi[2], vi[3]));
  }
}

// ------------------------------------------------------------ z stage
// K6 (pass B) and K5 (pass BF), replacing the split z-DFT stages of the TPU
// kernels _pass_b_kernel / _pass_bf_kernel (fused_dft2.py:1066, :1096,
// reached by _run_pass_b :1735 and _run_pass_bf :1764).  A block per
// (tile of P y columns, x-frequency k) of a (Kxp, Z, Y) pair: column c of
// the slice k is one complex length-Z sequence, strided by Y in memory.
// The block holds its P columns interleaved, value z of column s at
// z*P + s, as the x stage holds its sequences; a thread takes two
// neighbouring columns, so the global rows move as 8-byte pairs (a warp
// covers whole 32-byte sectors) and shared memory as 16-byte vectors with
// no bank conflicts.  The forward transform is run_stages_dif: the columns
// load in natural order and frequency f comes out at pos[f], the digit-
// reversed order in which the inverse stages take their input, so pass B
// needs no permutation between its two transforms.
//   pass B:  forward stages; frequency f times K[k, (f mod R)*M + f div R]
//            (the kernel spectrum is stored in z's split order), or its
//            conjugate; inverse stages; z stored in natural order times
//            1/Z.  The block reads its whole tile before it writes, so the
//            output may alias u (the main path runs pass B in place).
//   pass BF: the forward stages alone, frequency f stored at
//            (f mod R)*M + f div R, as the y stage stores y.
// Pad x-frequencies k >= Kx are written as zeros and not read.
// Like the x and y stages it is bound by HBM bytes: u (and K) read once,
// the output written once, the transform in shared memory.
// Columns per block: the widest tile from 16 (32 KB at Z = 256, 64 KB at
// 512, 227 KB at 1816), then 8 to 3632, 4 to 7264, 2 to 14528.  A 32-column
// form was timed against 16 once on an H100 80GB HBM3 at 700 W (chip_smoke.py
// phases 9 and 15 of the same run): at Z = 256 pass B tied (0.1426 ms at 32,
// 0.1453 at 16) and pass BF lost (0.0951 against 0.0900); at Z = 512, where
// 32 columns take 128 KB and one block an SM, both lost (pass B 1.6278
// against 0.9624 ms, pass BF 0.7984 against 0.5921).
constexpr int kZColsMax = 16;

inline int z_cols(int Z) { return widest_tile(kZColsMax, Z); }

// S, the storage type of u, K and the output: float or bf16.
template <int P, bool FWD_ONLY, class S>
__global__ void __launch_bounds__(kThreads)
    z_kernel(S* o_re, S* o_im, const S* u_re, const S* u_im,
             const S* __restrict__ k_re, const S* __restrict__ k_im,
             float ksign, const LmvnFft f, int Y, int Kx, int R, int M,
             float scale, int k0) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* buf = reinterpret_cast<float2*>(smem);
  constexpr int Q = P / 2;  // column pairs per row of the tile
  const int Z = f.n, c0 = blockIdx.x * P, k = k0 + blockIdx.y;
  const size_t base = static_cast<size_t>(k) * Z * Y;
  if (k >= Kx) {
    for (int e = threadIdx.x; e < Z * Q; e += kThreads) {
      const int c = c0 + 2 * (e % Q);
      if (c >= Y) continue;
      const size_t o = base + static_cast<size_t>(e / Q) * Y + c;
      st_pair(o_re + o, make_float2(0.f, 0.f));
      st_pair(o_im + o, make_float2(0.f, 0.f));
    }
    return;
  }
  batched<float4>(
      Z * Q,
      [&](int e) {
        const int c = c0 + 2 * (e % Q);
        if (c >= Y) return make_float4(0.f, 0.f, 0.f, 0.f);
        const size_t i = base + static_cast<size_t>(e / Q) * Y + c;
        const float2 re = ld_pair<false>(u_re + i);
        const float2 im = ld_pair<false>(u_im + i);
        return make_float4(re.x, im.x, re.y, im.y);
      },
      [&](int e, float4 v) { *reinterpret_cast<float4*>(buf + 2 * e) = v; });
  __syncthreads();
  run_stages_dif<P>(buf, f);
  // row j of K (and of pass BF's output) holds frequency R*(j mod M) + j div M
  if constexpr (!FWD_ONLY) {
    for (int e = threadIdx.x; e < Z * Q; e += kThreads) {
      const int j = e / Q, t = e % Q, c = c0 + 2 * t;
      if (c >= Y) continue;
      const size_t i = base + static_cast<size_t>(j) * Y + c;
      const float2 kr = ld_pair<true>(k_re + i);
      const float2 ki = ld_pair<true>(k_im + i);
      float4* at = reinterpret_cast<float4*>(
          buf + __ldg(f.pos + split_freq(j, R, M)) * P + 2 * t);
      const float4 v = *at;
      const float2 a = cmul(make_float2(v.x, v.y), make_float2(kr.x, ksign * ki.x));
      const float2 b = cmul(make_float2(v.z, v.w), make_float2(kr.y, ksign * ki.y));
      *at = make_float4(a.x, a.y, b.x, b.y);
    }
    __syncthreads();
    run_stages<P, true>(buf, f);
  }
  for (int e = threadIdx.x; e < Z * Q; e += kThreads) {
    const int j = e / Q, t = e % Q, c = c0 + 2 * t;
    if (c >= Y) continue;
    const int at = FWD_ONLY ? __ldg(f.pos + split_freq(j, R, M)) : j;
    const float4 v = *reinterpret_cast<const float4*>(buf + at * P + 2 * t);
    const size_t o = base + static_cast<size_t>(j) * Y + c;
    st_pair(o_re + o, make_float2(v.x * scale, v.z * scale));
    st_pair(o_im + o, make_float2(v.y * scale, v.w * scale));
  }
}

// ------------------------------------------------------------ column FFTs
// The shared-memory step of the long axes' transforms (fft_long.cuh): a
// direct plan f run in place over sequences in HBM.  Plane p < planes holds C
// columns, column c's value e < f.n at w[p*PS + e*ES + c]; a block takes P
// neighbouring columns of one plane (the value of column s at e*P + s, as
// the z stage holds its columns), so a warp moves whole lines wherever
// neighbouring columns are neighbours in memory.  The load stores value e at
// pos[e] and run_stages leaves the transform in natural order; with tw_n > 0
// output e is then multiplied by W_{tw_n}^{e j} (conjugated for the inverse),
// j = p mod tw_div (tw_plane) or c div tw_div: the four-step twiddle, a
// float64 value rounded to float32 as the stage tables are.
__device__ __forceinline__ float2 twiddle(long long r, int n, bool inv) {
  double sn, cs;
  sincospi(2.0 * static_cast<double>(r) / static_cast<double>(n), &sn, &cs);
  return make_float2(static_cast<float>(cs), static_cast<float>(inv ? sn : -sn));
}

template <int P, bool INV>
__global__ void __launch_bounds__(kThreads)
    col_fft_kernel(float2* __restrict__ w, const LmvnFft f, long long col_blocks,
                   int C, long long PS, long long ES, int tw_n, int tw_div,
                   bool tw_plane) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* buf = reinterpret_cast<float2*>(smem);
  const long long p = blockIdx.x / col_blocks;
  const int c0 = static_cast<int>(blockIdx.x % col_blocks) * P;
  float2* base = w + p * PS + c0;
  const int n = f.n;
  batched<float2>(
      n * P,
      [&](int i) {
        const int s = i % P;
        return c0 + s < C ? base[(i / P) * ES + s] : make_float2(0.f, 0.f);
      },
      [&](int i, float2 v) { buf[__ldg(f.pos + i / P) * P + i % P] = v; });
  __syncthreads();
  run_stages<P, INV>(buf, f);
  for (int i = threadIdx.x; i < n * P; i += kThreads) {
    const int s = i % P, e = i / P;
    if (c0 + s >= C) continue;
    float2 v = buf[i];
    if (tw_n > 0 && e > 0) {
      const long long j = tw_plane ? p % tw_div : (c0 + s) / tw_div;
      v = cmul(v, twiddle((e * j) % tw_n, tw_n, INV));
    }
    base[e * ES + s] = v;
  }
}

// ------------------------------------------------------------ launches
// Each returns cudaGetLastError() after its launch.

inline unsigned blocks(int a, int b) {
  return static_cast<unsigned>((a + b - 1) / b);
}

// The launches are templates on the tile width, defined here and
// instantiated by LMVN_FFT_TILE below, one width per nvcc process.

template <int S>
int x_forward(float* t_re, float* t_im, const float* xt, const LmvnFft& f,
              int Z, int Y, int Kx, cudaStream_t s) {
  const size_t smem = sizeof(float2) * S * f.n;
  cudaError_t e = cudaFuncSetAttribute(
      x_forward_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int z0 = 0; z0 < Z; z0 += kMaxGridY)
    x_forward_kernel<S><<<dim3(blocks(Y, 2 * S), std::min(Z - z0, kMaxGridY)),
                          kThreads, smem, s>>>(t_re, t_im, xt, f, Z, Y, Kx, z0);
  return static_cast<int>(cudaGetLastError());
}

// The x stage of K7, K8, K9 or K10 on the scratch pair t (in place when
// FORWARD).
template <int S, bool FORWARD, class Op>
int x_launch(float* t_re, float* t_im, const LmvnFft& f, int Z, int Y, int Kx,
             const Op& op, cudaStream_t s) {
  const size_t smem = sizeof(float2) * S * f.n;
  cudaError_t e = cudaFuncSetAttribute(
      x_stage_kernel<S, FORWARD, Op>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int z0 = 0; z0 < Z; z0 += kMaxGridY)
    x_stage_kernel<S, FORWARD, Op>
        <<<dim3(blocks(Y, 2 * S), std::min(Z - z0, kMaxGridY)), kThreads, smem, s>>>(
            t_re, t_im, f, Z, Y, Kx, 1.0f / static_cast<float>(f.n), op, z0);
  return static_cast<int>(cudaGetLastError());
}

template <int P, bool INV, class Out, class In>
int y_launch(Out* o_re, Out* o_im, const In* i_re, const In* i_im,
             const LmvnFft& f, int rows, int valid, int R, int M,
             cudaStream_t s) {
  const size_t smem = sizeof(float2) * P * f.n;
  cudaError_t e = cudaFuncSetAttribute(
      y_kernel<P, INV, Out, In>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  y_kernel<P, INV, Out, In><<<blocks(rows, P), kThreads, smem, s>>>(
      o_re, o_im, i_re, i_im, f, valid, R, M,
      INV ? 1.0f / static_cast<float>(f.n) : 1.0f);
  return static_cast<int>(cudaGetLastError());
}

template <int P, bool FWD_ONLY, class S>
int z_launch(S* o_re, S* o_im, const S* u_re, const S* u_im, const S* k_re,
             const S* k_im, float ksign, const LmvnFft& f, int Y, int Kx,
             int Kxp, int R, int M, cudaStream_t s) {
  const size_t smem = sizeof(float2) * P * f.n;
  cudaError_t e = cudaFuncSetAttribute(
      z_kernel<P, FWD_ONLY, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int k0 = 0; k0 < Kxp; k0 += kMaxGridY)
    z_kernel<P, FWD_ONLY, S>
        <<<dim3(blocks(Y, P), std::min(Kxp - k0, kMaxGridY)), kThreads, smem, s>>>(
            o_re, o_im, u_re, u_im, k_re, k_im, ksign, f, Y, Kx, R, M,
            FWD_ONLY ? 1.0f : 1.0f / static_cast<float>(f.n), k0);
  return static_cast<int>(cudaGetLastError());
}

template <int P, bool INV>
int col_fft(float2* w, const LmvnFft& f, long long planes, int C, long long PS,
            long long ES, int tw_n, int tw_div, bool tw_plane, cudaStream_t s) {
  const size_t smem = sizeof(float2) * P * f.n;
  cudaError_t e = cudaFuncSetAttribute(
      col_fft_kernel<P, INV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long col_blocks = blocks(C, P);
  if (planes * col_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  col_fft_kernel<P, INV><<<static_cast<unsigned>(planes * col_blocks), kThreads, smem, s>>>(
      w, f, col_blocks, C, PS, ES, tw_n, tw_div, tw_plane);
  return static_cast<int>(cudaGetLastError());
}

// The launches of tile width P: PREFIX extern declares them, as below for
// every width, so that no file that includes this header compiles their
// kernels; empty instantiates them, which fft_tiles.cu does for one width,
// -DLMVN_TILE=P.  Each width's 13 stage kernels and 2 column FFTs compile in an
// nvcc process of their own.
#define LMVN_COL_FFT(PREFIX, P, INV)                                          \
  PREFIX template int col_fft<P, INV>(float2*, const LmvnFft&, long long, int, \
                                      long long, long long, int, int, bool,   \
                                      cudaStream_t);
#define LMVN_X_LAUNCH(PREFIX, P, FWD, OP)                                   \
  PREFIX template int x_launch<P, FWD, OP>(float*, float*, const LmvnFft&, \
                                           int, int, int, const OP&,      \
                                           cudaStream_t);
#define LMVN_Y_LAUNCH(PREFIX, P, INV, OUT, IN)                              \
  PREFIX template int y_launch<P, INV, OUT, IN>(                            \
      OUT*, OUT*, const IN*, const IN*, const LmvnFft&, int, int, int, int, \
      cudaStream_t);
#define LMVN_Z_LAUNCH(PREFIX, P, FWD_ONLY, S)                                \
  PREFIX template int z_launch<P, FWD_ONLY, S>(                              \
      S*, S*, const S*, const S*, const S*, const S*, float, const LmvnFft&, \
      int, int, int, int, int, cudaStream_t);
#define LMVN_FFT_TILE(PREFIX, P)                                          \
  PREFIX template int x_forward<P>(float*, float*, const float*,         \
                                   const LmvnFft&, int, int, int,        \
                                   cudaStream_t);                        \
  LMVN_X_LAUNCH(PREFIX, P, false, StoreOp)                                \
  LMVN_X_LAUNCH(PREFIX, P, true, QuotientOp)                              \
  LMVN_X_LAUNCH(PREFIX, P, false, RlUpdateOp)                             \
  LMVN_X_LAUNCH(PREFIX, P, true, RlUpdateOp)                              \
  LMVN_Y_LAUNCH(PREFIX, P, false, float, float)                           \
  LMVN_Y_LAUNCH(PREFIX, P, false, __nv_bfloat16, float)                   \
  LMVN_Y_LAUNCH(PREFIX, P, true, float, float)                            \
  LMVN_Y_LAUNCH(PREFIX, P, true, float, __nv_bfloat16)                    \
  LMVN_Z_LAUNCH(PREFIX, P, false, float)                                  \
  LMVN_Z_LAUNCH(PREFIX, P, true, float)                                   \
  LMVN_Z_LAUNCH(PREFIX, P, false, __nv_bfloat16)                          \
  LMVN_Z_LAUNCH(PREFIX, P, true, __nv_bfloat16)                           \
  LMVN_COL_FFT(PREFIX, P, false)                                          \
  LMVN_COL_FFT(PREFIX, P, true)

LMVN_FFT_TILE(extern, 16)
LMVN_FFT_TILE(extern, 8)
LMVN_FFT_TILE(extern, 4)
LMVN_FFT_TILE(extern, 2)

// The stages as the passes call them, each at the tile width of its
// length.

inline int x_forward_stage(float* t_re, float* t_im, const float* xt,
                           const LmvnFft& f, int Z, int Y, int Kx,
                           cudaStream_t s) {
  return with_tile(x_seq(f.n), [&](auto w) {
    return x_forward<decltype(w)::value>(t_re, t_im, xt, f, Z, Y, Kx, s);
  });
}

// The x stage of K7, K8, K9 or K10 on the scratch pair t (in place when
// FORWARD).
template <bool FORWARD, class Op>
int x_stage(float* t_re, float* t_im, const LmvnFft& f, int Z, int Y, int Kx,
            const Op& op, cudaStream_t s) {
  return with_tile(x_seq(f.n), [&](auto w) {
    return x_launch<decltype(w)::value, FORWARD>(t_re, t_im, f, Z, Y, Kx, op, s);
  });
}

// The y stage over rows = Kxp*Z rows, of which valid = Kx*Z are not pad:
// forward from t into a float or bf16 spectrum, inverse back into t.
template <bool INV, class Out, class In>
int y_stage(Out* o_re, Out* o_im, const In* i_re, const In* i_im,
            const LmvnFft& f, int rows, int valid, int R, int M,
            cudaStream_t s) {
  return with_tile(y_rows(f.n), [&](auto w) {
    return y_launch<decltype(w)::value, INV>(o_re, o_im, i_re, i_im, f, rows,
                                             valid, R, M, s);
  });
}

// The z stage over the Kxp slices of a (Kxp, Z, Y) pair, of which Kx are
// not pad; z's split is (R, M).  S is float or bf16.
template <bool FWD_ONLY, class S>
int z_stage(S* o_re, S* o_im, const S* u_re, const S* u_im, const S* k_re,
            const S* k_im, bool conj_k, const LmvnFft& f, int Y, int Kx,
            int Kxp, int R, int M, cudaStream_t s) {
  return with_tile(z_cols(f.n), [&](auto w) {
    return z_launch<decltype(w)::value, FWD_ONLY>(o_re, o_im, u_re, u_im, k_re,
                                                  k_im, conj_k ? -1.f : 1.f,
                                                  f, Y, Kx, Kxp, R, M, s);
  });
}

// The column FFT over w, tiled by the widest tile of its length from 16.
template <bool INV>
int col_fft_stage(float2* w, const LmvnFft& f, long long planes, int C,
                  long long PS, long long ES, int tw_n, int tw_div,
                  bool tw_plane, cudaStream_t s) {
  return with_tile(widest_tile(16, f.n), [&](auto t) {
    return col_fft<decltype(t)::value, INV>(w, f, planes, C, PS, ES, tw_n,
                                            tw_div, tw_plane, s);
  });
}

// What the kernels rely on.  A direct plan: the tables match the length,
// every stage radix fits a generic round, and the stage has a tile for the
// length (tile > 0).  A four-step plan: n = N1 N2 of two direct plans, each
// with a column tile.  A Bluestein plan: its tables, and a padded length m, a
// power of two >= 2n - 1, of a direct or four-step plan.  plan_ok holds the
// length of an axis to kMaxLength.
inline bool stages_ok(const LmvnFft& f, int n, int tile) {
  if (f.n != n || f.nstages < 0 || f.nstages > kMaxStages) return false;
  if (!f.tw || !f.pos || tile <= 0) return false;
  long long prod = 1;
  for (int j = 0; j < f.nstages; ++j) {
    if (f.radix[j] < 2 || f.radix[j] > kMaxGenericRadix) return false;
    prod *= f.radix[j];
  }
  return prod == n;
}

inline bool axis_ok(const LmvnAxis& a, int n, int tile) {
  if (a.f.n != n || n < 1) return false;
  if (a.kind == kFourStep) {
    const LmvnAxis *p = a.part[0], *q = a.part[1];
    return p && q && p->kind == kDirect && q->kind == kDirect &&
           static_cast<long long>(p->f.n) * q->f.n == n &&
           stages_ok(p->f, p->f.n, widest_tile(16, p->f.n)) &&
           stages_ok(q->f, q->f.n, widest_tile(16, q->f.n));
  }
  if (a.kind == kBluestein) {
    const LmvnAxis* inner = a.part[0];
    return a.chirp && a.bhat && inner && a.m > 0 && (a.m & (a.m - 1)) == 0 &&
           a.m >= 2LL * n - 1 && inner->kind != kBluestein &&
           axis_ok(*inner, a.m, widest_tile(16, a.m));
  }
  return a.kind == kDirect && stages_ok(a.f, n, tile);
}

inline bool plan_ok(const LmvnAxis& a, int n, int tile) {
  return n <= kMaxLength && axis_ok(a, n, tile);
}

}  // namespace lmvn_fft
