// The Richardson-Lucy update and the quotient of one voxel.  The update is
// shared by K1 (elementwise.cu, lmvn_rl_update) and the x stage of K9 and
// K10 (fft_stage.cuh, x_stage_kernel with RlUpdateOp), the quotient by K2
// (elementwise.cu, lmvn_quotient) and K8's x stage (QuotientOp), so that
// for the same integral each gives bitwise the same value.
//
// The quotient: view * (1 / integral), reciprocal then multiply
// (inc/cpu_kernels.h:20-26, core/kernels.py compute_quotient).
//
// The update: inc/cpu_kernels.h:29-90, in the order of core/kernels.py and
// of the JAX package's _rl_update_block (ops/pallas/fused_dft2.py:1357):
//   value = psi * integral
//   Tikhonov (lam > 0): value = (1/lam) * (sqrt(1 + (2 lam) value) - 1)
//   value <= 0 or NaN -> min_value; NaN/Inf -> min_value; else max(value, min)
//   psi' = w * (next - psi) + psi
// Compiled with -fmad=false: every multiply and add rounds on its own.

#pragma once

#include <cuda_runtime.h>

namespace lmvn {

struct RlParams {
  float w_scalar;
  float lam;
  float two_lam;
  float lam_inv;
  float min_value;
};

inline RlParams rl_params(float w_scalar, float lam, float min_value) {
  RlParams p;
  p.w_scalar = w_scalar;
  p.lam = lam;
  p.two_lam = 2.f * lam;
  p.lam_inv = lam > 0.f ? 1.f / lam : 0.f;
  p.min_value = min_value;
  return p;
}

__device__ __forceinline__ float rl_one(float psi, float integral, float w,
                                        const RlParams& p) {
  float value = psi * integral;
  float t = value;
  if (p.lam > 0.f) t = p.lam_inv * (sqrtf(1.f + p.two_lam * value) - 1.f);
  value = (value > 0.f) ? t : p.min_value;
  float nxt = (isnan(value) || isinf(value)) ? p.min_value
                                             : fmaxf(value, p.min_value);
  return w * (nxt - psi) + psi;
}

__device__ __forceinline__ float quotient_one(float view, float integral) {
  return view * (1.f / integral);
}

}  // namespace lmvn
