// The fused RL-step engine's passes for Hopper (sm_90a), fp32 compute.
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
// (Kxp, Z, Y), z and y in the interleaved split order, pad rows k in
// [Kx, Kxp) written as zeros.  Plan constants come from ops/fused_plan.py.
//
// Each entry has a _bf16 twin: the same pass with every spectrum it reads
// or writes (u, v, K, its spectral output) stored as bf16, the JAX
// package's LMVN_FUSED_SPEC_BF16 storage (fused_dft2.py:530-550).  Values
// are widened to f32 on load and rounded to nearest even on store; the
// x stage, the scratch pair t and the real volumes are f32 in both forms,
// so a bf16 pass computes what the f32 pass computes on the widened inputs,
// rounded once where it stores a spectrum.  The twins share the template
// bodies below; the f32 entries are their float instances.
//
// Every pass is built from the shared-memory FFT stages of fft_stage.cuh,
// where the TPU kernels multiply by dense DFT matrices: fp32 CUDA cores make
// an O(N^2) DFT cost several times the pass's HBM time, and an FFT's
// O(log N) work per value leaves the pass bound by its bytes.
//
// How a Pallas pass maps onto blocks.  A TPU pass holds an 8-plane slab in
// VMEM; a Hopper block has at most 227 KB of shared memory, so passes are
// cut along what each stage needs:
//   y stages are row-local (a row = the Y values of one (k, z)): a block per
//     few rows, one FFT per row, frequencies stored in the split order
//     (y_kernel);
//   x stages are column-local within a plane: a block per (plane, 2S y
//     columns, S = 16 sequences up to X = 1816, fewer past it), one complex
//     FFT per pair of real columns (x_forward_kernel, x_stage_kernel); the
//     x stage of passes C, CQA, CU and CUA starts from
//     half spectra and holds the inverse x FFT, the pass's pointwise step
//     (CQA: K2's quotient; CU and CUA: K1's update) and, for CQA and CUA, the
//     forward x FFT in one block, writing the scratch pair in place;
//   the z stage of passes B and BF is column-local within an x-frequency
//     slice: a block per (k, P y columns, 16 up to Z = 1816, fewer past it)
//     keeps its columns in shared memory from the forward FFT through the
//     product with the kernel spectrum to the inverse (z_kernel).
// Each stage's tile is the widest that fits 227 KB at its length
// (fft_stage.cuh, "tiles"), so the shared-memory stages serve every axis up
// to 14528 whose prime factors are at most 1024.  Past that (a long axis: a
// four-step or Bluestein plan, up to 2^25), the stage of that axis runs as a
// short sequence of launches through a work buffer in HBM (fft_long.cuh),
// each inside the pass it belongs to, with the same inputs, outputs and
// rounding points; the other stages of the pass are unchanged.
// Launches per pass call, each stage of a direct length one launch: A 2 (x
// stage into a scratch spectrum, y stage),
// BF 1, B 1, C 2 (y stage into the scratch, x stage), CU 2 (C's, with the RL
// update in place of C's store), CQA 3 and CUA 3 (C's y stage into the
// scratch, the x stage in place on it, A's y stage).  The scratch spectrum
// goes through HBM (a (Kxp, Z, Y) pair, 71 MB at 256^3); the quotient and the
// integral volumes never do.
//
// Plain C interface for ctypes: every entry returns cudaGetLastError().  w
// is the work buffer of the long stages, w_values float2 values (NULL and 0
// where no stage of the pass is long).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <algorithm>

#include "fft_long.cuh"
#include "fft_stage.cuh"
#include "rl_update.cuh"

extern "C" {

// Mirrors ops/fused.py's _PlanArgs (ctypes.Structure), field by field.
struct LmvnFusedPlan {
  int Z, X, Y, Kx, Kxp, Ry, My, Rz, Mz;
  LmvnAxis fx;  // the FFT plan of length X (x stages)
  LmvnAxis fy;  // length Y (y stages; y's split is (Ry, My))
  LmvnAxis fz;  // length Z (the z stage of passes B and BF; z's split (Rz, Mz))
};

}  // extern "C"

namespace {

// the checks the kernels rely on; cudaErrorInvalidValue otherwise.  Any
// split (R, M) of y and z is served: the stages read and write the split
// order directly.  Each length has a direct plan whose stage has a tile that
// fits one block's shared memory (x_seq, y_rows, z_cols: up to 14528) and
// radices up to kMaxGenericRadix, or a four-step or Bluestein plan, up to
// kMaxLength; ops/fused.py fused_limit mirrors this.  The x and z stages
// launch their planes in slices of up to 65535 (grid y).
bool plan_ok(const LmvnFusedPlan* p) {
  if (p->Ry < 1 || p->Rz < 1) return false;
  if (p->Ry * p->My != p->Y || p->Rz * p->Mz != p->Z) return false;
  return lmvn_fft::plan_ok(p->fx, p->X, lmvn_fft::x_seq(p->X)) &&
         lmvn_fft::plan_ok(p->fy, p->Y, lmvn_fft::y_rows(p->Y)) &&
         lmvn_fft::plan_ok(p->fz, p->Z, lmvn_fft::z_cols(p->Z));
}

// The work buffer (float2 values) each stage of a long axis needs
// (fft_long.cuh); ops/fused.py _work_values mirrors these.
long long x_work(const LmvnFusedPlan* p) { return lmvn_fft::x_work(p->fx, p->Z, p->Y); }
long long y_work(const LmvnFusedPlan* p) { return lmvn_fft::y_work(p->fy, p->Kx * p->Z); }
long long z_work(const LmvnFusedPlan* p) { return lmvn_fft::z_work(p->fz, p->Kx, p->Y); }

// need: the work values of the pass's long stages, which w must hold
int start_call(int device, const LmvnFusedPlan* p, const void* w, long long w_values,
               long long need) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!plan_ok(p) || (need > 0 && (!w || w_values < need)))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

float2* work(void* w) { return static_cast<float2*>(w); }

// The first launch of passes C, CQA, CU and CUA: K7's inverse y stage from
// v (stored as S) into the scratch pair t.
template <class S>
int y_inverse(float* tr, float* ti, const void* v_re, const void* v_im,
              const LmvnFusedPlan* p, void* w, cudaStream_t s) {
  const S* vr = static_cast<const S*>(v_re);
  const S* vi = static_cast<const S*>(v_im);
  if (p->fy.kind != lmvn_fft::kDirect)
    return lmvn_fft::y_stage_long<true>(tr, ti, vr, vi, p->fy, p->Kxp * p->Z, p->Kx * p->Z,
                                        p->Ry, p->My, work(w), s);
  return lmvn_fft::y_stage<true>(tr, ti, vr, vi, p->fy.f, p->Kxp * p->Z, p->Kx * p->Z, p->Ry,
                                 p->My, s);
}

// The last launch of passes A, CQA and CUA: K4's forward y stage from t into
// u (stored as S).
template <class S>
int y_forward(void* u_re, void* u_im, const float* tr, const float* ti,
              const LmvnFusedPlan* p, void* w, cudaStream_t s) {
  S* ur = static_cast<S*>(u_re);
  S* ui = static_cast<S*>(u_im);
  if (p->fy.kind != lmvn_fft::kDirect)
    return lmvn_fft::y_stage_long<false>(ur, ui, tr, ti, p->fy, p->Kxp * p->Z, p->Kx * p->Z,
                                         p->Ry, p->My, work(w), s);
  return lmvn_fft::y_stage<false>(ur, ui, tr, ti, p->fy.f, p->Kxp * p->Z, p->Kx * p->Z, p->Ry,
                                  p->My, s);
}

// K4's x stage from xt into t.
int x_forward(float* tr, float* ti, const void* xt, const LmvnFusedPlan* p, void* w,
              cudaStream_t s) {
  const float* x = static_cast<const float*>(xt);
  if (p->fx.kind != lmvn_fft::kDirect)
    return lmvn_fft::x_forward_long(tr, ti, x, p->fx, p->Z, p->Y, p->Kx, work(w), s);
  return lmvn_fft::x_forward_stage(tr, ti, x, p->fx.f, p->Z, p->Y, p->Kx, s);
}

// The x stage of K7-K10 on t (in place when FORWARD).
template <bool FORWARD, class Op>
int x_stage(float* tr, float* ti, const LmvnFusedPlan* p, const Op& op, void* w,
            cudaStream_t s) {
  if (p->fx.kind != lmvn_fft::kDirect)
    return lmvn_fft::x_stage_long<FORWARD>(tr, ti, p->fx, p->Z, p->Y, p->Kx, op, work(w), s);
  return lmvn_fft::x_stage<FORWARD>(tr, ti, p->fx.f, p->Z, p->Y, p->Kx, op, s);
}

// The z stage of K5 and K6.
template <bool FWD_ONLY, class S>
int z_stage(void* o_re, void* o_im, const void* u_re, const void* u_im, const void* k_re,
            const void* k_im, bool conj_k, const LmvnFusedPlan* p, void* w, cudaStream_t s) {
  S* or_ = static_cast<S*>(o_re);
  S* oi = static_cast<S*>(o_im);
  const S* ur = static_cast<const S*>(u_re);
  const S* ui = static_cast<const S*>(u_im);
  const S* kr = static_cast<const S*>(k_re);
  const S* ki = static_cast<const S*>(k_im);
  if (p->fz.kind != lmvn_fft::kDirect)
    return lmvn_fft::z_stage_long<FWD_ONLY, S>(or_, oi, ur, ui, kr, ki, conj_k, p->fz, p->Y,
                                               p->Kx, p->Kxp, p->Rz, p->Mz, work(w), s);
  return lmvn_fft::z_stage<FWD_ONLY, S>(or_, oi, ur, ui, kr, ki, conj_k, p->fz.f, p->Y, p->Kx,
                                        p->Kxp, p->Rz, p->Mz, s);
}

lmvn_fft::RlUpdateOp rl_update_op(const void* psi, void* out, const void* w,
                                  float w_scalar, float lam, float min_value) {
  return {static_cast<const float*>(psi), static_cast<float*>(out),
          static_cast<const float*>(w), lmvn::rl_params(w_scalar, lam, min_value)};
}

// The passes, for S = float or bf16 spectra.

// K4: u = pass A(xt), two FFT stages.  t is a (Kxp, Z, Y) scratch pair.
template <class S>
int pass_a(int device, const LmvnFusedPlan* p, void* u_re, void* u_im,
           void* t_re, void* t_im, const void* xt, void* w, long long w_values,
           void* stream) {
  int err = start_call(device, p, w, w_values, std::max(x_work(p), y_work(p)));
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* tr = static_cast<float*>(t_re);
  float* ti = static_cast<float*>(t_im);
  err = x_forward(tr, ti, xt, p, w, s);
  if (!err) err = y_forward<S>(u_re, u_im, tr, ti, p, w, s);
  return err;
}

// K6: out = pass B(u, K), one FFT z stage (out may alias u); conj_k != 0
// multiplies by conj(K).
template <class S>
int pass_b(int device, const LmvnFusedPlan* p, void* o_re, void* o_im,
           const void* u_re, const void* u_im, const void* k_re,
           const void* k_im, int conj_k, void* w, long long w_values, void* stream) {
  int err = start_call(device, p, w, w_values, z_work(p));
  if (err) return err;
  return z_stage<false, S>(o_re, o_im, u_re, u_im, k_re, k_im, conj_k != 0, p, w,
                           static_cast<cudaStream_t>(stream));
}

// K8: u = pass A(view · (1/pass C(v))), three FFT stages: K7's y stage into
// the scratch pair t, the x stage in place on t, K4's y stage into u.  t is
// a scratch pair distinct from v and u; u may alias v (v is read in full by
// the first launch, u written by the last).
template <class S>
int pass_cqa(int device, const LmvnFusedPlan* p, void* u_re, void* u_im,
             void* t_re, void* t_im, const void* v_re, const void* v_im,
             const void* view, void* w, long long w_values, void* stream) {
  int err = start_call(device, p, w, w_values, std::max(x_work(p), y_work(p)));
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* tr = static_cast<float*>(t_re);
  float* ti = static_cast<float*>(t_im);
  err = y_inverse<S>(tr, ti, v_re, v_im, p, w, s);
  if (!err)
    err = x_stage<true>(tr, ti, p, lmvn_fft::QuotientOp{static_cast<const float*>(view)}, w,
                        s);
  if (!err) err = y_forward<S>(u_re, u_im, tr, ti, p, w, s);
  return err;
}

// K9: out = RL update of psi with integral pass C(v), two FFT stages: K7's y
// stage into the scratch pair t, then K7's x stage with K1's update in place
// of its store.  w == NULL selects the scalar weight w_scalar; out may alias
// psi.
template <class S>
int pass_cu(int device, const LmvnFusedPlan* p, void* out, void* t_re,
            void* t_im, const void* v_re, const void* v_im, const void* psi,
            const void* w, float w_scalar, float lam, float min_value,
            void* work_, long long w_values, void* stream) {
  int err = start_call(device, p, work_, w_values, std::max(x_work(p), y_work(p)));
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* tr = static_cast<float*>(t_re);
  float* ti = static_cast<float*>(t_im);
  err = y_inverse<S>(tr, ti, v_re, v_im, p, work_, s);
  if (!err)
    err = x_stage<false>(tr, ti, p, rl_update_op(psi, out, w, w_scalar, lam, min_value),
                         work_, s);
  return err;
}

// K5: o = pass BF(u), the forward z FFT alone, frequencies stored in z's
// split order.  o must not alias u.
template <class S>
int pass_bf(int device, const LmvnFusedPlan* p, void* o_re, void* o_im,
            const void* u_re, const void* u_im, void* w, long long w_values,
            void* stream) {
  int err = start_call(device, p, w, w_values, z_work(p));
  if (err) return err;
  return z_stage<true, S>(o_re, o_im, u_re, u_im, nullptr, nullptr, false, p, w,
                          static_cast<cudaStream_t>(stream));
}

// K7: out = pass C(v), the real (Z, X, Y) volume, two FFT stages.  t is a
// scratch pair.
template <class S>
int pass_c(int device, const LmvnFusedPlan* p, void* out, void* t_re,
           void* t_im, const void* v_re, const void* v_im, void* w,
           long long w_values, void* stream) {
  int err = start_call(device, p, w, w_values, std::max(x_work(p), y_work(p)));
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* tr = static_cast<float*>(t_re);
  float* ti = static_cast<float*>(t_im);
  err = y_inverse<S>(tr, ti, v_re, v_im, p, w, s);
  if (!err)
    err = x_stage<false>(tr, ti, p, lmvn_fft::StoreOp{static_cast<float*>(out)}, w, s);
  return err;
}

// K10: out = RL update of psi with integral pass C(v), and u = pass A(out),
// three FFT stages, K8's with K1's update in place of the quotient: psi' is
// stored to out and replaces the value in shared memory before the forward
// x FFT.  w == NULL selects the scalar weight w_scalar.  t is a scratch pair
// distinct from v and u; u may alias v, out may alias psi.
template <class S>
int pass_cua(int device, const LmvnFusedPlan* p, void* out, void* u_re,
             void* u_im, void* t_re, void* t_im, const void* v_re,
             const void* v_im, const void* psi, const void* w, float w_scalar,
             float lam, float min_value, void* work_, long long w_values,
             void* stream) {
  int err = start_call(device, p, work_, w_values, std::max(x_work(p), y_work(p)));
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* tr = static_cast<float*>(t_re);
  float* ti = static_cast<float*>(t_im);
  err = y_inverse<S>(tr, ti, v_re, v_im, p, work_, s);
  if (!err)
    err = x_stage<true>(tr, ti, p, rl_update_op(psi, out, w, w_scalar, lam, min_value),
                        work_, s);
  if (!err) err = y_forward<S>(u_re, u_im, tr, ti, p, work_, s);
  return err;
}

}  // namespace

// The C entries: each pass as f32 and as bf16 (_bf16) spectra, with the
// arguments of the template above it.
#define LMVN_PASS(name, params, args)                                \
  int lmvn_fused_##name params { return name<float> args; }          \
  int lmvn_fused_##name##_bf16 params { return name<__nv_bfloat16> args; }

extern "C" {

LMVN_PASS(pass_a,
          (int device, const LmvnFusedPlan* p, void* u_re, void* u_im,
           void* t_re, void* t_im, const void* xt, void* w, long long w_values,
           void* stream),
          (device, p, u_re, u_im, t_re, t_im, xt, w, w_values, stream))

LMVN_PASS(pass_b,
          (int device, const LmvnFusedPlan* p, void* o_re, void* o_im,
           const void* u_re, const void* u_im, const void* k_re,
           const void* k_im, int conj_k, void* w, long long w_values,
           void* stream),
          (device, p, o_re, o_im, u_re, u_im, k_re, k_im, conj_k, w, w_values,
           stream))

LMVN_PASS(pass_cqa,
          (int device, const LmvnFusedPlan* p, void* u_re, void* u_im,
           void* t_re, void* t_im, const void* v_re, const void* v_im,
           const void* view, void* w, long long w_values, void* stream),
          (device, p, u_re, u_im, t_re, t_im, v_re, v_im, view, w, w_values,
           stream))

LMVN_PASS(pass_cu,
          (int device, const LmvnFusedPlan* p, void* out, void* t_re,
           void* t_im, const void* v_re, const void* v_im, const void* psi,
           const void* w, float w_scalar, float lam, float min_value,
           void* work, long long w_values, void* stream),
          (device, p, out, t_re, t_im, v_re, v_im, psi, w, w_scalar, lam,
           min_value, work, w_values, stream))

LMVN_PASS(pass_bf,
          (int device, const LmvnFusedPlan* p, void* o_re, void* o_im,
           const void* u_re, const void* u_im, void* w, long long w_values,
           void* stream),
          (device, p, o_re, o_im, u_re, u_im, w, w_values, stream))

LMVN_PASS(pass_c,
          (int device, const LmvnFusedPlan* p, void* out, void* t_re,
           void* t_im, const void* v_re, const void* v_im, void* w,
           long long w_values, void* stream),
          (device, p, out, t_re, t_im, v_re, v_im, w, w_values, stream))

LMVN_PASS(pass_cua,
          (int device, const LmvnFusedPlan* p, void* out, void* u_re,
           void* u_im, void* t_re, void* t_im, const void* v_re,
           const void* v_im, const void* psi, const void* w, float w_scalar,
           float lam, float min_value, void* work, long long w_values,
           void* stream),
          (device, p, out, u_re, u_im, t_re, t_im, v_re, v_im, psi, w,
           w_scalar, lam, min_value, work, w_values, stream))

}  // extern "C"
