// The fused RL-step engine's passes for Hopper (sm_90a), fp32.
//
// Hand-written counterparts of the TPU kernels in
// libmultiviewnative_tpu/ops/pallas/fused_dft2.py (dense packed x-mode,
// twiddle-folded split stages, the 'highest' precision contract):
//   K4  lmvn_fused_pass_a    <- _run_pass_a   / _pass_a_kernel
//   K5  lmvn_fused_pass_bf   <- _run_pass_bf  / _pass_bf_kernel
//   K6  lmvn_fused_pass_b    <- _run_pass_b   / _pass_b_kernel
//   K7  lmvn_fused_pass_c    <- _run_pass_c   / _pass_c_kernel
//   K8  lmvn_fused_pass_cqa  <- _run_pass_cqa / _pass_cqa_kernel
//   K9  lmvn_fused_pass_cu   <- _run_pass_cu  / _pass_cu_kernel
//   K10 lmvn_fused_pass_cua  <- _run_pass_cua / _pass_cua_kernel
//
// Layouts are the JAX package's: volumes (Z, X, Y); spectra split re/im
// (Kxp, Z, Y) float32, z and y in the interleaved split order, pad rows
// k in [Kx, Kxp) written as zeros.  Plan constants come from ops/fused_plan.py.
//
// Two designs live here.
//
// K4-K8 are shared-memory FFT stages (fft_stage.cuh): an x stage (a block
// per (plane, 32 y columns), one complex FFT per pair of real columns), a
// y stage (a block per few rows, one FFT per row, frequencies stored in the
// split order) and a z stage (a block per (x-frequency, 16 y columns),
// one FFT per column, K5's frequencies stored in the split order,
// K6's multiplied by the kernel spectrum and transformed back).  K8's x
// stage holds the inverse x FFT, the quotient and the forward x FFT in one
// block (x_cqa_kernel).  They are bound by HBM bytes: the inputs, a scratch
// pair written and read once, the output.
//
// K9 and K10 compute their DFTs as matrix products, so the FLOPs of
// those O(N^2) products, not the bytes their functions need, set their time:
// two register-tiled fp32 GEMM cores on CUDA cores (no tensor cores: the
// contract is full fp32):
//   rgemm  real product, for the x stages (packed x-irfft, x-rfft);
//   cgemm  complex product in the 3-multiplication Karatsuba form
//          (re = m1 - m2, im = m3 - m1 - m2), for the split y stages.
// Each block of 256 threads owns a BM x BN output tile; each thread a TM x TN
// register tile; BK = 16 deep slices of both operands are staged in shared
// memory by loader functors (double-buffered: the next slice is fetched into
// registers while the current one is multiplied).  Dot products use
// __fmaf_rn explicitly: the library is built with -fmad=false.  The FFT
// stages are the base for their later redesign.
//
// How a Pallas pass maps onto blocks.  A TPU pass holds an 8-plane slab in
// VMEM; a Hopper block has at most 227 KB of shared memory, so passes are
// cut along what each stage needs:
//   y stages are row-local (a row = the Y values of one (k, z)): one launch
//     over all Kxp*Z rows (ystage_kernel, fft_stage.cuh y_kernel);
//   x stages are column-local within a plane: a block per (plane, y-column
//     tile) (xcqa_kernel, xcu_kernel, fft_stage.cuh x_*_kernel); pass CQA's
//     keeps its column in shared memory from the inverse x FFT through the
//     quotient to the forward x FFT, writing t in place;
//   the z stage of passes B and BF is column-local within an x-frequency
//     slice: a block per (k, y-column tile) keeps its columns in shared
//     memory from the forward FFT through the product with the kernel
//     spectrum to the inverse (fft_stage.cuh z_kernel).
// The omega_R halves of the GEMM passes' split y stages run as an in-place
// R-point DFT across column blocks (combine_kernel), skipped when R == 1;
// the FFT y stage needs none.
// Launches per pass call (R > 1 / R == 1): A 2 (x stage into a scratch
// spectrum, y stage), BF 1, B 1, C 2 (y stage into the scratch, x stage),
// CQA 3 (C's y stage into the scratch, the x stage in place on it, A's y
// stage), CU 3/2 (y products, combine, x-inverse + RL update), CUA 5/3
// (y products, combine, x-inverse + RL update + x-forward in one block with
// psi' stored and also kept in shared memory, combine, y products).  The
// scratch spectrum goes through HBM (a (Kxp, Z, Y) pair, 71 MB at 256^3);
// the quotient and the integral volumes never do.
//
// Plain C interface for ctypes: every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "fft_stage.cuh"
#include "rl_update.cuh"

extern "C" {

// Mirrors ops/fused.py's _PlanArgs (ctypes.Structure), field by field.
struct LmvnFusedPlan {
  int Z, X, Y, Kx, Kxp, Ry, My, Rz, Mz, pad_;
  const float* fxp;  // (2*Kxp, X)
  const float* bxp;  // (X, 2*Kxp)
  const float* wfy_re;  // (Ry*My, My) forward y stage, per-q folded
  const float* wfy_im;
  const float* wiy_re;  // inverse y stage (1/My folded)
  const float* wiy_im;
  // the (q, r) complex omega tables of the y stage, row stride R, re/im
  // pairs, 128 floats each: omf, omi
  const float* om;
  LmvnFft fx;  // the FFT stages of passes A and C: length X
  LmvnFft fy;  // length Y
  LmvnFft fz;  // the FFT stages of passes B and BF: length Z
};

}  // extern "C"

namespace {

constexpr int kThreads = 256;
constexpr int BK = 16;
constexpr int kMaxR = 8;

constexpr int kOmega = 2 * kMaxR * kMaxR;  // floats per omega table
enum { kOmfY = 0, kOmiY = 1 };

// copy one omega table (2*R*R floats) into shared memory; the caller syncs
__device__ __forceinline__ void load_omega(float* dst, const float* src,
                                           int R) {
  for (int i = threadIdx.x; i < 2 * R * R; i += kThreads) dst[i] = src[i];
}

// complex scalar (q, r) of an omega table times (x + i y), the order of the
// JAX package's _scalar_cmul general path
__device__ __forceinline__ void om_mul(const float* om, int R, int q, int r,
                                       float x, float y, float& re,
                                       float& im) {
  const float a = om[2 * (q * R + r)], b = om[2 * (q * R + r) + 1];
  re = a * x - b * y;
  im = b * x + a * y;
}

template <int T>
__device__ __forceinline__ void lds(float (&dst)[T], const float* src) {
  if constexpr (T % 4 == 0) {
#pragma unroll
    for (int i = 0; i < T; i += 4) {
      float4 v = *reinterpret_cast<const float4*>(src + i);
      dst[i] = v.x;
      dst[i + 1] = v.y;
      dst[i + 2] = v.z;
      dst[i + 3] = v.w;
    }
  } else if constexpr (T % 2 == 0) {
#pragma unroll
    for (int i = 0; i < T; i += 2) {
      float2 v = *reinterpret_cast<const float2*>(src + i);
      dst[i] = v.x;
      dst[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < T; ++i) dst[i] = src[i];
  }
}

// ------------------------------------------------------------ GEMM cores
// Shared tiles are k-major ([BK][B* + 4]) so a thread reads its TM (TN)
// consecutive rows (columns) as one vector; the +4 pad keeps 16-byte
// alignment and spreads the transposing stores over the banks.

template <int BM, int BN>
struct RTile {
  float a[BK][BM + 4];
  float b[BK][BN + 4];
};

template <int BM, int BN>
struct CTile {
  float a_re[BK][BM + 4];
  float a_im[BK][BM + 4];
  float b_re[BK][BN + 4];
  float b_im[BK][BN + 4];
};

// Element e of a BM x BK (or BK x BN) slice: KFAST walks the contraction
// index fastest (coalesced when the source is contiguous along k).
template <int ROWS, bool KFAST>
__device__ __forceinline__ void slice_index(int e, int& r, int& kk) {
  if (KFAST) {
    kk = e % BK;
    r = e / BK;
  } else {
    r = e % ROWS;
    kk = e / ROWS;
  }
}

// Software pipeline shared by both cores: the slice k0 + BK is fetched from
// global memory into registers while the block computes on slice k0 from
// shared buffer `cur`; it is then stored into the other buffer, and one
// barrier per slice separates the two.
//   fetch(k0)   global -> registers     stash(buf)   registers -> shared
//   compute(buf)                        shared -> accumulators
template <class Fetch, class Stash, class Compute>
__device__ __forceinline__ void pipeline(int K, Fetch fetch, Stash stash,
                                         Compute compute) {
  fetch(0);
  stash(0);
  __syncthreads();
  int cur = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) fetch(k0 + BK);
    compute(cur);
    if (more) stash(cur ^ 1);
    __syncthreads();
    cur ^= 1;
  }
}

// acc[i][j] = sum_k A(ty*TM + i, k) B(k, tx*TN + j) over k < K.
// load_a(m, k) / load_b(k, n) take tile-local m / n and a global k < K, and
// return 0 outside the operand (they do their own bounds checks).
template <int BM, int BN, int TM, int TN, bool A_KFAST, bool B_KFAST,
          class LoadA, class LoadB>
__device__ __forceinline__ void rgemm(float (&acc)[TM][TN],
                                      RTile<BM, BN> (&s)[2], int K,
                                      LoadA load_a, LoadB load_b) {
  constexpr int TX = BN / TN;
  constexpr int NA = BM * BK / kThreads, NB = BN * BK / kThreads;
  static_assert((BM / TM) * TX == kThreads, "tile does not match the block");
  static_assert(NA * kThreads == BM * BK && NB * kThreads == BN * BK, "");
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float ra[NA], rb[NB];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int e = 0; e < NA; ++e) {
      int m, kk;
      slice_index<BM, A_KFAST>(tid + e * kThreads, m, kk);
      ra[e] = (k0 + kk < K) ? load_a(m, k0 + kk) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < NB; ++e) {
      int n, kk;
      slice_index<BN, B_KFAST>(tid + e * kThreads, n, kk);
      rb[e] = (k0 + kk < K) ? load_b(k0 + kk, n) : 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int e = 0; e < NA; ++e) {
      int m, kk;
      slice_index<BM, A_KFAST>(tid + e * kThreads, m, kk);
      s[buf].a[kk][m] = ra[e];
    }
#pragma unroll
    for (int e = 0; e < NB; ++e) {
      int n, kk;
      slice_index<BN, B_KFAST>(tid + e * kThreads, n, kk);
      s[buf].b[kk][n] = rb[e];
    }
  };
  auto compute = [&](int buf) {
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
      lds<TM>(a, &s[buf].a[kk][ty * TM]);
      lds<TN>(b, &s[buf].b[kk][tx * TN]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
  };
  pipeline(K, fetch, stash, compute);
}

// Complex product, Karatsuba: acc[0] = sum Are Bre, acc[1] = sum Aim Bim,
// acc[2] = sum (Are + Aim)(Bre + Bim).  The loaders write (re, im).
template <int BM, int BN, int TM, int TN, bool A_KFAST, bool B_KFAST,
          class LoadA, class LoadB>
__device__ __forceinline__ void cgemm(float (&acc)[3][TM][TN],
                                      CTile<BM, BN> (&s)[2], int K,
                                      LoadA load_a, LoadB load_b) {
  constexpr int TX = BN / TN;
  constexpr int NA = BM * BK / kThreads, NB = BN * BK / kThreads;
  static_assert((BM / TM) * TX == kThreads, "tile does not match the block");
  static_assert(NA * kThreads == BM * BK && NB * kThreads == BN * BK, "");
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[p][i][j] = 0.f;
  float ra_re[NA], ra_im[NA], rb_re[NB], rb_im[NB];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int e = 0; e < NA; ++e) {
      int m, kk;
      slice_index<BM, A_KFAST>(tid + e * kThreads, m, kk);
      ra_re[e] = ra_im[e] = 0.f;
      if (k0 + kk < K) load_a(m, k0 + kk, ra_re[e], ra_im[e]);
    }
#pragma unroll
    for (int e = 0; e < NB; ++e) {
      int n, kk;
      slice_index<BN, B_KFAST>(tid + e * kThreads, n, kk);
      rb_re[e] = rb_im[e] = 0.f;
      if (k0 + kk < K) load_b(k0 + kk, n, rb_re[e], rb_im[e]);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int e = 0; e < NA; ++e) {
      int m, kk;
      slice_index<BM, A_KFAST>(tid + e * kThreads, m, kk);
      s[buf].a_re[kk][m] = ra_re[e];
      s[buf].a_im[kk][m] = ra_im[e];
    }
#pragma unroll
    for (int e = 0; e < NB; ++e) {
      int n, kk;
      slice_index<BN, B_KFAST>(tid + e * kThreads, n, kk);
      s[buf].b_re[kk][n] = rb_re[e];
      s[buf].b_im[kk][n] = rb_im[e];
    }
  };
  auto compute = [&](int buf) {
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ar[TM], ai[TM], as[TM], br[TN], bi[TN], bs[TN];
      lds<TM>(ar, &s[buf].a_re[kk][ty * TM]);
      lds<TM>(ai, &s[buf].a_im[kk][ty * TM]);
      lds<TN>(br, &s[buf].b_re[kk][tx * TN]);
      lds<TN>(bi, &s[buf].b_im[kk][tx * TN]);
#pragma unroll
      for (int i = 0; i < TM; ++i) as[i] = ar[i] + ai[i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bs[j] = br[j] + bi[j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[0][i][j] = __fmaf_rn(ar[i], br[j], acc[0][i][j]);
          acc[1][i][j] = __fmaf_rn(ai[i], bi[j], acc[1][i][j]);
          acc[2][i][j] = __fmaf_rn(as[i], bs[j], acc[2][i][j]);
        }
    }
  };
  pipeline(K, fetch, stash, compute);
}

// Hand each output of a tile to store(m, n, value) (tile-local m, n).
template <int BN, int TM, int TN, class Store>
__device__ __forceinline__ void epilogue(const float (&acc)[TM][TN],
                                         Store store) {
  constexpr int TX = BN / TN;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) store(ty * TM + i, tx * TN + j, acc[i][j]);
}

template <int BN, int TM, int TN, class Store>
__device__ __forceinline__ void cepilogue(const float (&acc)[3][TM][TN],
                                          Store store) {
  constexpr int TX = BN / TN;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float m1 = acc[0][i][j], m2 = acc[1][i][j], m3 = acc[2][i][j];
      store(ty * TM + i, tx * TN + j, m1 - m2, m3 - m1 - m2);
    }
}

// ------------------------------------------------------------ y stages
// The omega_R half of a split stage (_fwd_split_* / _inv_split_*) is an
// R-point DFT across the R column blocks of a row, in place, in the order
// of the JAX package's accumulations:
//   forward: y_q = sum_r omf[q,r] x_r      inverse: x_r = sum_q omi[q,r] z_q
// It touches each value once (bound by HBM bytes), so it runs as its own
// launch and leaves the matrix products plain.
template <int R>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(float* re, float* im, const float* __restrict__ om_table,
                   bool inverse, int rows, int Y, int M) {
  __shared__ float om[kOmega];
  load_omega(om, om_table, R);
  __syncthreads();
  const size_t n = static_cast<size_t>(rows) * M;
  for (size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       e < n; e += static_cast<size_t>(gridDim.x) * kThreads) {
    const size_t base = (e / M) * Y + e % M;
    float xr[R], xi[R];
#pragma unroll
    for (int b = 0; b < R; ++b) {
      xr[b] = re[base + b * M];
      xi[b] = im[base + b * M];
    }
#pragma unroll
    for (int a = 0; a < R; ++a) {
      float ar = 0.f, ai = 0.f;
#pragma unroll
      for (int b = 0; b < R; ++b) {
        float tr, ti;
        if (inverse)
          om_mul(om, R, b, a, xr[b], xi[b], tr, ti);
        else
          om_mul(om, R, a, b, xr[b], xi[b], tr, ti);
        ar = (b == 0) ? tr : ar + tr;
        ai = (b == 0) ? ti : ai + ti;
      }
      re[base + a * M] = ar;
      im[base + a * M] = ai;
    }
  }
}

// The (M, M) products of a split y stage over rows g = k*Z + z of a
// (Kxp, Z, Y) pair: out[g, q*M + p] = in[g, q*M + j] @ W_q[j, p], W_q the
// rows [q*M, (q+1)*M) of the stacked (R*M, M) plan matrix (twiddles folded
// in).  Rows of the pad x-frequencies (k >= Kx) are written as zeros.
constexpr int YBM = 64, YBN = 64, YTM = 4, YTN = 4;

__global__ void __launch_bounds__(kThreads)
    ystage_kernel(float* __restrict__ out_re, float* __restrict__ out_im,
                  const float* __restrict__ in_re,
                  const float* __restrict__ in_im,
                  const float* __restrict__ w_re,
                  const float* __restrict__ w_im, int rows, int Y, int M,
                  int Z, int Kx) {
  __shared__ __align__(16) CTile<YBM, YBN> s[2];
  const int m0 = blockIdx.x * YBM, n0 = blockIdx.y * YBN;
  const int o = n0 / M;  // the block q of the output columns
  const int c0 = n0 - o * M;
  const float* a_re = in_re + o * M;
  const float* a_im = in_im + o * M;
  const float* b_re = w_re + static_cast<size_t>(o) * M * M;
  const float* b_im = w_im + static_cast<size_t>(o) * M * M;
  auto load_a = [&](int m, int k, float& re, float& im) {
    const int g = m0 + m;
    if (g >= rows) return;
    const size_t i = static_cast<size_t>(g) * Y + k;
    re = a_re[i];
    im = a_im[i];
  };
  auto load_b = [&](int k, int n, float& re, float& im) {
    const int c = c0 + n;
    if (c >= M) return;
    const size_t i = static_cast<size_t>(k) * M + c;
    re = b_re[i];
    im = b_im[i];
  };
  float acc[3][YTM][YTN];
  cgemm<YBM, YBN, YTM, YTN, true, false>(acc, s, M, load_a, load_b);
  cepilogue<YBN, YTM, YTN>(acc, [&](int m, int n, float re, float im) {
    const int g = m0 + m, c = c0 + n;
    if (g >= rows || c >= M) return;
    const bool pad = g / Z >= Kx;
    const size_t i = static_cast<size_t>(g) * Y + o * M + c;
    out_re[i] = pad ? 0.f : re;
    out_im[i] = pad ? 0.f : im;
  });
}

// ------------------------------------------------------------ x stages
// Packed x-rfft rows: T = fxp @ plane, row r of T is the real part of
// x-frequency r (r < Kxp) or the imaginary part of r - Kxp.
__device__ __forceinline__ void store_t(float* t_re, float* t_im, int row,
                                        int z, int col, float v, int Z, int Y,
                                        int Kx, int Kxp) {
  const int k = row < Kxp ? row : row - Kxp;
  float* dst = row < Kxp ? t_re : t_im;
  dst[(static_cast<size_t>(k) * Z + z) * Y + col] = k < Kx ? v : 0.f;
}

constexpr int XBM = 64, XBN = 64, XTM = 4, XTN = 4;

// The packed x-irfft operand: rows kk < Kxp of t_re, then Kxp rows of t_im.
__device__ __forceinline__ float load_s(const float* t_re, const float* t_im,
                                        int kk, int z, int col, int Z, int Y,
                                        int Kxp) {
  if (col >= Y) return 0.f;
  const float* src = kk < Kxp ? t_re : t_im;
  const int k = kk < Kxp ? kk : kk - Kxp;
  return src[(static_cast<size_t>(k) * Z + z) * Y + col];
}

// K10 launch 3, a block per (y-column tile, plane z):
//   integral (X, cols) = bxp (X, 2Kxp) @ [t_re; t_im][:, z, cols]
//   Q = psi' = rl_one(psi, integral, w): K1's update; psi' is stored to out
//     and its (X, cols) column stays in shared memory
//   T[:, z, cols] = fxp (2Kxp, X) @ Q               (into t, in place)
// so the x-forward of the next view step's pass A runs from the same block.
// The block reads all of its (z, cols) column of t before it writes it, and
// each element of psi before it writes that element of out, so t may be
// written in place and out may alias psi.
constexpr int QBM = 64, QBN = 64, QTM = 4, QTN = 4;

size_t xcqa_smem(int X) {
  return 2 * sizeof(RTile<QBM, QBN>) + sizeof(float) * X * QBN;
}

__global__ void __launch_bounds__(kThreads)
    xcqa_kernel(float* t_re, float* t_im, const float* psi, float* out,
                const float* __restrict__ w, lmvn::RlParams rp,
                const LmvnFusedPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& s = *reinterpret_cast<RTile<QBM, QBN>(*)[2]>(smem);
  float* q = reinterpret_cast<float*>(smem + 2 * sizeof(RTile<QBM, QBN>));
  const int n0 = blockIdx.x * QBN, z = blockIdx.y;
  const int X = p.X, Y = p.Y, Z = p.Z, Kxp = p.Kxp, K2 = 2 * Kxp;
  const float* bxp = p.bxp;
  const float* fxp = p.fxp;
  const size_t plane = static_cast<size_t>(z) * X * Y;
  float acc[QTM][QTN];
  for (int m0 = 0; m0 < X; m0 += QBM) {
    rgemm<QBM, QBN, QTM, QTN, true, false>(
        acc, s, K2,
        [&](int m, int k) {
          const int x = m0 + m;
          return x < X ? bxp[static_cast<size_t>(x) * K2 + k] : 0.f;
        },
        [&](int k, int n) { return load_s(t_re, t_im, k, z, n0 + n, Z, Y, Kxp); });
    epilogue<QBN, QTM, QTN>(acc, [&](int m, int n, float v) {
      const int x = m0 + m, c = n0 + n;
      if (x >= X) return;
      float qv = 0.f;
      if (c < Y) {
        const size_t i = plane + static_cast<size_t>(x) * Y + c;
        qv = lmvn::rl_one(psi[i], v, w ? w[i] : rp.w_scalar, rp);
        out[i] = qv;
      }
      q[x * QBN + n] = qv;
    });
  }
  __syncthreads();
  for (int m0 = 0; m0 < K2; m0 += QBM) {
    rgemm<QBM, QBN, QTM, QTN, true, false>(
        acc, s, X,
        [&](int m, int k) {
          const int r = m0 + m;
          return r < K2 ? fxp[static_cast<size_t>(r) * X + k] : 0.f;
        },
        [&](int k, int n) { return q[k * QBN + n]; });
    epilogue<QBN, QTM, QTN>(acc, [&](int m, int n, float v) {
      const int r = m0 + m, c = n0 + n;
      if (r < K2 && c < Y) store_t(t_re, t_im, r, z, c, v, Z, Y, p.Kx, Kxp);
    });
  }
}

// K9 launch 2: integral (X, cols) = bxp @ [t_re; t_im][:, z, cols], then the
// RL update of K1 (lmvn::rl_one); out may alias psi.
__global__ void __launch_bounds__(kThreads)
    xcu_kernel(float* out, const float* __restrict__ t_re,
               const float* __restrict__ t_im, const float* psi,
               const float* __restrict__ w, lmvn::RlParams rp,
               const LmvnFusedPlan p) {
  __shared__ __align__(16) RTile<XBM, XBN> s[2];
  const int m0 = blockIdx.x * XBM, n0 = blockIdx.y * XBN, z = blockIdx.z;
  const int X = p.X, Y = p.Y, Z = p.Z, Kxp = p.Kxp, K2 = 2 * Kxp;
  const float* bxp = p.bxp;
  float acc[XTM][XTN];
  rgemm<XBM, XBN, XTM, XTN, true, false>(
      acc, s, K2,
      [&](int m, int k) {
        const int x = m0 + m;
        return x < X ? bxp[static_cast<size_t>(x) * K2 + k] : 0.f;
      },
      [&](int k, int n) { return load_s(t_re, t_im, k, z, n0 + n, Z, Y, Kxp); });
  epilogue<XBN, XTM, XTN>(acc, [&](int m, int n, float integral) {
    const int x = m0 + m, c = n0 + n;
    if (x >= X || c >= Y) return;
    const size_t i = (static_cast<size_t>(z) * X + x) * Y + c;
    out[i] = lmvn::rl_one(psi[i], integral, w ? w[i] : rp.w_scalar, rp);
  });
}

unsigned cdiv(int a, int b) { return static_cast<unsigned>((a + b - 1) / b); }

// The omega half of a split y stage, in place; nothing to do at R == 1.
int combine(bool inverse, float* re, float* im, const LmvnFusedPlan& p,
            cudaStream_t s) {
  const int rows = p.Kxp * p.Z;
  const float* om = p.om + (inverse ? kOmiY : kOmfY) * kOmega;
  const size_t n = static_cast<size_t>(rows) * p.My;
  const unsigned grid = static_cast<unsigned>(
      (n + kThreads - 1) / kThreads < 8192 ? (n + kThreads - 1) / kThreads
                                           : 8192);
  switch (p.Ry) {
    case 1:
      return 0;
    case 2:
      combine_kernel<2><<<grid, kThreads, 0, s>>>(re, im, om, inverse, rows,
                                                  p.Y, p.My);
      break;
    case 4:
      combine_kernel<4><<<grid, kThreads, 0, s>>>(re, im, om, inverse, rows,
                                                  p.Y, p.My);
      break;
    case 8:
      combine_kernel<8><<<grid, kThreads, 0, s>>>(re, im, om, inverse, rows,
                                                  p.Y, p.My);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The per-q products of a split y stage, forward or inverse.
int ystage(bool inv, float* out_re, float* out_im, const float* in_re,
           const float* in_im, const LmvnFusedPlan& p, cudaStream_t s) {
  const int rows = p.Kxp * p.Z;
  dim3 grid(cdiv(rows, YBM), cdiv(p.Y, YBN));
  ystage_kernel<<<grid, kThreads, 0, s>>>(
      out_re, out_im, in_re, in_im, inv ? p.wiy_re : p.wfy_re,
      inv ? p.wiy_im : p.wfy_im, rows, p.Y, p.My, p.Z, p.Kx);
  return static_cast<int>(cudaGetLastError());
}

// The x stage of pass CUA, in place on the scratch pair t.
int xcqa(float* tr, float* ti, const float* psi, float* out, const float* w,
         lmvn::RlParams rp, const LmvnFusedPlan& p, cudaStream_t s) {
  const size_t smem = xcqa_smem(p.X);
  cudaError_t e = cudaFuncSetAttribute(
      xcqa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  xcqa_kernel<<<dim3(cdiv(p.Y, QBN), p.Z), kThreads, smem, s>>>(
      tr, ti, psi, out, w, rp, p);
  return static_cast<int>(cudaGetLastError());
}

// The largest Z the engine serves: the edge its z stage has run at.  The FFT
// z stage itself fits up to Z = 1816 (16 columns of Z complex values in
// 227 KB); a larger bound needs its own run at the new edge.
constexpr int kMaxZ = 736;
// The (X, 64) column of pass CUA, at most 1 KB under the opt-in maximum:
// X <= 832, the edge the passes have run at (X = 840 would fill the 227 KB
// exactly).
constexpr size_t kXcqaSmemMax = 232448 - 1024;

// the checks the kernels rely on; cudaErrorInvalidValue otherwise
bool plan_ok(const LmvnFusedPlan* p) {
  if (p->Ry < 1 || p->Ry > kMaxR || p->Rz < 1) return false;
  if (p->Ry & (p->Ry - 1)) return false;  // combine_kernel: R in {1, 2, 4, 8}
  if (p->Ry * p->My != p->Y || p->Rz * p->Mz != p->Z) return false;
  // a y-column tile must not straddle two split blocks
  if (p->Ry > 1 && p->My % YBN != 0) return false;
  return p->Z <= kMaxZ && xcqa_smem(p->X) <= kXcqaSmemMax &&
         lmvn_fft::plan_ok(p->fx, p->X, lmvn_fft::x_smem(p->X), 232448) &&
         lmvn_fft::plan_ok(p->fy, p->Y, lmvn_fft::y_smem(p->Y), 232448) &&
         lmvn_fft::plan_ok(p->fz, p->Z, lmvn_fft::z_smem(p->Z), 232448);
}

int start_call(int device, const LmvnFusedPlan* p) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return plan_ok(p) ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// K4: u = pass A(xt), two FFT stages.  t is a (Kxp, Z, Y) scratch pair.
int lmvn_fused_pass_a(int device, const LmvnFusedPlan* p, void* u_re,
                      void* u_im, void* t_re, void* t_im, const void* xt,
                      void* stream) {
  int err = start_call(device, p);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* tr = static_cast<float*>(t_re);
  float* ti = static_cast<float*>(t_im);
  err = lmvn_fft::x_forward(tr, ti, static_cast<const float*>(xt), p->fx, p->Z,
                            p->Y, p->Kx, s);
  if (!err)
    err = lmvn_fft::y_stage<false>(static_cast<float*>(u_re),
                                   static_cast<float*>(u_im), tr, ti, p->fy,
                                   p->Kxp * p->Z, p->Kx * p->Z, p->Ry, p->My, s);
  return err;
}

// K6: out = pass B(u, K), one FFT z stage (out may alias u); conj_k != 0
// multiplies by conj(K).
int lmvn_fused_pass_b(int device, const LmvnFusedPlan* p, void* o_re,
                      void* o_im, const void* u_re, const void* u_im,
                      const void* k_re, const void* k_im, int conj_k,
                      void* stream) {
  int err = start_call(device, p);
  if (err) return err;
  return lmvn_fft::z_stage<false>(
      static_cast<float*>(o_re), static_cast<float*>(o_im),
      static_cast<const float*>(u_re), static_cast<const float*>(u_im),
      static_cast<const float*>(k_re), static_cast<const float*>(k_im),
      conj_k != 0, p->fz, p->Y, p->Kx, p->Kxp, p->Rz, p->Mz,
      static_cast<cudaStream_t>(stream));
}

// K8: u = pass A(view · (1/pass C(v))), three FFT stages: K7's y stage into
// the scratch pair t, the x stage in place on t, K4's y stage into u.  t is
// a scratch pair distinct from v and u; u may alias v (v is read in full by
// the first launch, u written by the last).
int lmvn_fused_pass_cqa(int device, const LmvnFusedPlan* p, void* u_re,
                        void* u_im, void* t_re, void* t_im, const void* v_re,
                        const void* v_im, const void* view, void* stream) {
  int err = start_call(device, p);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* tr = static_cast<float*>(t_re);
  float* ti = static_cast<float*>(t_im);
  const int rows = p->Kxp * p->Z, valid = p->Kx * p->Z;
  err = lmvn_fft::y_stage<true>(tr, ti, static_cast<const float*>(v_re),
                                static_cast<const float*>(v_im), p->fy, rows,
                                valid, p->Ry, p->My, s);
  if (!err)
    err = lmvn_fft::x_cqa(tr, ti, static_cast<const float*>(view), p->fx, p->Z,
                          p->Y, p->Kx, s);
  if (!err)
    err = lmvn_fft::y_stage<false>(static_cast<float*>(u_re),
                                   static_cast<float*>(u_im), tr, ti, p->fy,
                                   rows, valid, p->Ry, p->My, s);
  return err;
}

// K9: out = RL update of psi with integral pass C(v).  w == NULL selects the
// scalar weight w_scalar.  t is a scratch pair; out may alias psi.
int lmvn_fused_pass_cu(int device, const LmvnFusedPlan* p, void* out,
                       void* t_re, void* t_im, const void* v_re,
                       const void* v_im, const void* psi, const void* w,
                       float w_scalar, float lam, float min_value,
                       void* stream) {
  int err = start_call(device, p);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* tr = static_cast<float*>(t_re);
  float* ti = static_cast<float*>(t_im);
  err = ystage(true, tr, ti, static_cast<const float*>(v_re),
               static_cast<const float*>(v_im), *p, s);
  if (!err) err = combine(true, tr, ti, *p, s);
  if (err) return err;
  xcu_kernel<<<dim3(cdiv(p->X, XBM), cdiv(p->Y, XBN), p->Z), kThreads, 0, s>>>(
      static_cast<float*>(out), tr, ti, static_cast<const float*>(psi),
      static_cast<const float*>(w), lmvn::rl_params(w_scalar, lam, min_value),
      *p);
  return static_cast<int>(cudaGetLastError());
}

// K5: o = pass BF(u), the forward z FFT alone, frequencies stored in z's
// split order.  o must not alias u.
int lmvn_fused_pass_bf(int device, const LmvnFusedPlan* p, void* o_re,
                       void* o_im, const void* u_re, const void* u_im,
                       void* stream) {
  int err = start_call(device, p);
  if (err) return err;
  return lmvn_fft::z_stage<true>(
      static_cast<float*>(o_re), static_cast<float*>(o_im),
      static_cast<const float*>(u_re), static_cast<const float*>(u_im),
      nullptr, nullptr, false, p->fz, p->Y, p->Kx, p->Kxp, p->Rz, p->Mz,
      static_cast<cudaStream_t>(stream));
}

// K7: out = pass C(v), the real (Z, X, Y) volume, two FFT stages.  t is a
// scratch pair.
int lmvn_fused_pass_c(int device, const LmvnFusedPlan* p, void* out,
                      void* t_re, void* t_im, const void* v_re,
                      const void* v_im, void* stream) {
  int err = start_call(device, p);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* tr = static_cast<float*>(t_re);
  float* ti = static_cast<float*>(t_im);
  err = lmvn_fft::y_stage<true>(tr, ti, static_cast<const float*>(v_re),
                                static_cast<const float*>(v_im), p->fy,
                                p->Kxp * p->Z, p->Kx * p->Z, p->Ry, p->My, s);
  if (!err)
    err = lmvn_fft::x_inverse(static_cast<float*>(out), tr, ti, p->fx, p->Z,
                              p->Y, p->Kx, s);
  return err;
}

// K10: out = RL update of psi with integral pass C(v), and u = pass A(out).
// w == NULL selects the scalar weight w_scalar.  t is a scratch pair distinct
// from v and u; u may alias v, out may alias psi.
int lmvn_fused_pass_cua(int device, const LmvnFusedPlan* p, void* out,
                        void* u_re, void* u_im, void* t_re, void* t_im,
                        const void* v_re, const void* v_im, const void* psi,
                        const void* w, float w_scalar, float lam,
                        float min_value, void* stream) {
  int err = start_call(device, p);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* tr = static_cast<float*>(t_re);
  float* ti = static_cast<float*>(t_im);
  err = ystage(true, tr, ti, static_cast<const float*>(v_re),
               static_cast<const float*>(v_im), *p, s);
  if (!err) err = combine(true, tr, ti, *p, s);
  if (!err)
    err = xcqa(tr, ti, static_cast<const float*>(psi),
               static_cast<float*>(out), static_cast<const float*>(w),
               lmvn::rl_params(w_scalar, lam, min_value), *p, s);
  if (!err) err = combine(false, tr, ti, *p, s);
  if (!err) err = ystage(false, static_cast<float*>(u_re),
                         static_cast<float*>(u_im), tr, ti, *p, s);
  return err;
}

}  // extern "C"
