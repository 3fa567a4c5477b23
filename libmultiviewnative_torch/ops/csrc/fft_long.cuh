// The long axes of the fused passes (sm_90a, fp32): the x, y and z stages of
// K4-K10 at a length no shared-memory stage holds, n > 14528 or with a prime
// factor over 1024, up to kMaxLength = 2^25.  Declarations; the kernels and
// the stage functions are in fft_long.cu, an nvcc unit of their own.
//
// Such a stage runs as a short sequence of launches over a work buffer w in
// HBM, float2 (groups, npad, L): value e of sequence (g, c) at
// (g*npad + e)*L + c, npad = n (four-step) or m (Bluestein).  A gather launch
// applies the stage's load rule (the x stage's column pairs or half spectra,
// the y stage's rows, the z stage's columns, each from its own layout) and
// writes the sequences into w; the transform runs in place on w; a scatter
// launch applies the store rule and writes the stage's output where the
// shared-memory stage writes it.  Between two transforms a pointwise launch
// applies the pass's step: K7-K10's op on the real values (x), K6's product
// with the kernel spectrum (z).  The pass's inputs, outputs and rounding
// points are those of the shared-memory stage.
//
// The transforms (ops/fused_plan.py FftStages):
//   four-step (Bailey), n = N1 N2, both direct: the N1-point column FFTs at
//     stride N2 (col_fft_stage of fft_stage.cuh), times W_n^{j2 k1}, then the
//     N2-point FFTs, which leave frequency k1 + N1 k2 at N2 k1 + k2
//     (spectrum_at); the inverse runs the two steps back, from that order to
//     the natural one.  No transpose runs: the gathers and scatters read and
//     write the spectrum at spectrum_at.
//   Bluestein (chirp-z), any n: x_j conj(b_j) zero-padded to m (b_j =
//     exp(i pi j^2/n)), the m-point FFT (direct or four-step), times bhat (the
//     m-point FFT of b wrapped to m, over m), the inverse m-point FFT, then
//     the first n values times conj(b_k): frequency k at k.  The inverse
//     takes the conjugate chirp.
// The chirp and bhat are float64 values stored as float32, like the stage
// twiddles; the four-step twiddles are computed in float64 and rounded.
//
// Memory: w holds one value for each of the stage's complex values (the x
// stage's column pairs, the y and z stages' rows and columns of the Kx
// spectral slices), times m/n for Bluestein: about one scratch pair.

#pragma once

#include "fft_stage.cuh"

namespace lmvn_fft {

// rows of the y stage a group of w interleaves (L of the y stage)
constexpr int kYLongRows = 16;

inline long long npad(const LmvnAxis& a) {
  return a.kind == kBluestein ? a.m : a.f.n;
}

// Work-buffer values (float2) a long stage needs; 0 for a direct one.
// ops/fused.py _work_values mirrors these.
inline long long x_work(const LmvnAxis& a, int Z, int Y) {
  return a.kind == kDirect ? 0 : static_cast<long long>(Z) * npad(a) * (Y / 2);
}

inline long long y_work(const LmvnAxis& a, int valid) {
  const long long groups = (valid + kYLongRows - 1) / kYLongRows;
  return a.kind == kDirect ? 0 : groups * kYLongRows * npad(a);
}

inline long long z_work(const LmvnAxis& a, int Kx, int Y) {
  return a.kind == kDirect ? 0 : static_cast<long long>(Kx) * npad(a) * Y;
}

// K4's x stage: t = the half spectra of the length-X FFTs of xt's column
// pairs (x_forward_kernel's function).
int x_forward_long(float* t_re, float* t_im, const float* xt, const LmvnAxis& a,
                   int Z, int Y, int Kx, float2* w, cudaStream_t s);

// K7-K10's x stage (x_stage_kernel's function): the half spectra of t to
// real values, times 1/X, the op; with FORWARD the op's result transformed
// back into t.
template <bool FORWARD, class Op>
int x_stage_long(float* t_re, float* t_im, const LmvnAxis& a, int Z, int Y,
                 int Kx, const Op& op, float2* w, cudaStream_t s);

// The y stage (y_kernel's function) over rows, valid of them not pad.
template <bool INV, class Out, class In>
int y_stage_long(Out* o_re, Out* o_im, const In* i_re, const In* i_im,
                 const LmvnAxis& a, int rows, int valid, int R, int M,
                 float2* w, cudaStream_t s);

// The z stage of K5 and K6 (z_kernel's function).
template <bool FWD_ONLY, class S>
int z_stage_long(S* o_re, S* o_im, const S* u_re, const S* u_im, const S* k_re,
                 const S* k_im, bool conj_k, const LmvnAxis& a, int Y, int Kx,
                 int Kxp, int R, int M, float2* w, cudaStream_t s);

}  // namespace lmvn_fft
