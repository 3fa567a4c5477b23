// Elementwise Richardson-Lucy kernels for Hopper (sm_90a).
//
// Hand-written counterparts of the TPU kernels in
// libmultiviewnative_tpu/ops/pallas/elementwise.py:
//   K1 lmvn_rl_update          <- rl_update_pallas / _rl_update_kernel
//   K2 lmvn_quotient           <- quotient_pallas / _quotient_kernel
//   K3 lmvn_spectral_multiply  <- spectral_multiply_pallas / _spectral_scale_kernel
//
// All three are bound by HBM bytes (a handful of flops per 8-24 bytes
// moved), so each is one pass over 16-byte vectors when every pointer is
// 16-byte aligned, a scalar loop for the tail, size_t offsets, launched on
// the caller's stream.  K1 and K3 run grid-stride loops on at most 8192
// blocks; K2 runs one vector of each operand a thread and as many blocks as
// the volume needs, which ties torch.div where the capped loop trailed it by
// 3 % at 512^3 (its 8192 blocks are 7.76 waves of the card) and a grid of
// one whole wave trailed by 6 % (scripts/measure_quotient.py).  K1 takes a
// scalar weight as a float and never reads a weight volume for it; K3 reads
// each kernel spectrum value once and applies it to every batch entry, so the
// batch is never materialised, and conjugates on the fly for the adjoint
// kernel.  K1's weight volume and K2's view may likewise be shared by a
// batch of volumes (psi shaped (B, Z, Y, X) against (Z, Y, X) weights or
// views): the *_bcast kernels follow K3's design, each thread loading one
// shared value (a float4 on the vector path) once and looping over the B
// entries, so the shared operand is read once, 4n(3B + 1) bytes for K1 and
// 4n(2B + 1) for K2 instead of the 16nB and 12nB of a materialised
// broadcast.  A batch of 1 takes the single-volume kernels unchanged.
//
// Built with -fmad=false: w*(nxt-psi)+psi and the complex products round
// after every operation, as the plain PyTorch versions do.  sqrtf and 1/x
// are IEEE-rounded (no fast-math).
//
// Plain C interface for ctypes: every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "rl_update.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxBlocks = 8192;

unsigned grid_for(size_t work) {
  size_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__device__ __forceinline__ size_t global_index() {
  return static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ size_t grid_stride() {
  return static_cast<size_t>(gridDim.x) * blockDim.x;
}

// ---------------------------------------------------------------- K1
// the update itself is lmvn::rl_one (rl_update.cuh), shared with K9 and K10
using lmvn::RlParams;
using lmvn::rl_one;

// w == nullptr: the scalar weight p.w_scalar applies to every voxel
__global__ void rl_update_vec4(float4* out, const float4* psi,
                               const float4* integral, const float4* w,
                               RlParams p, size_t n4) {
  for (size_t i = global_index(); i < n4; i += grid_stride()) {
    float4 a = psi[i];
    float4 b = integral[i];
    float4 c = w ? w[i] : make_float4(p.w_scalar, p.w_scalar, p.w_scalar,
                                      p.w_scalar);
    out[i] = make_float4(rl_one(a.x, b.x, c.x, p), rl_one(a.y, b.y, c.y, p),
                         rl_one(a.z, b.z, c.z, p), rl_one(a.w, b.w, c.w, p));
  }
}

__global__ void rl_update_scalar(float* out, const float* psi,
                                 const float* integral, const float* w,
                                 RlParams p, size_t begin, size_t n) {
  for (size_t i = begin + global_index(); i < n; i += grid_stride()) {
    out[i] = rl_one(psi[i], integral[i], w ? w[i] : p.w_scalar, p);
  }
}

// w: n values shared by `batch` volumes of psi, integral and out, entry b
// at b * n (n4 = n / 4 float4s); the vector path needs n % 4 == 0
__global__ void rl_update_bcast_vec4(float4* out, const float4* psi,
                                     const float4* integral, const float4* w,
                                     RlParams p, size_t n4, size_t batch) {
  for (size_t j = global_index(); j < n4; j += grid_stride()) {
    const float4 c = w[j];
    for (size_t b = 0; b < batch; ++b) {
      const size_t i = b * n4 + j;
      const float4 a = psi[i];
      const float4 d = integral[i];
      out[i] = make_float4(rl_one(a.x, d.x, c.x, p), rl_one(a.y, d.y, c.y, p),
                           rl_one(a.z, d.z, c.z, p), rl_one(a.w, d.w, c.w, p));
    }
  }
}

__global__ void rl_update_bcast_scalar(float* out, const float* psi,
                                       const float* integral, const float* w,
                                       RlParams p, size_t n, size_t batch) {
  for (size_t j = global_index(); j < n; j += grid_stride()) {
    const float c = w[j];
    for (size_t b = 0; b < batch; ++b) {
      const size_t i = b * n + j;
      out[i] = rl_one(psi[i], integral[i], c, p);
    }
  }
}

// ---------------------------------------------------------------- K2
// the quotient itself is lmvn::quotient_one (rl_update.cuh), shared with K8
using lmvn::quotient_one;

__global__ void quotient_vec4(float4* out, const float4* view,
                              const float4* integral, size_t n4) {
  const size_t i = global_index();
  if (i >= n4) return;
  const float4 v = view[i];
  const float4 d = integral[i];
  out[i] = make_float4(quotient_one(v.x, d.x), quotient_one(v.y, d.y),
                       quotient_one(v.z, d.z), quotient_one(v.w, d.w));
}

__global__ void quotient_scalar(float* out, const float* view,
                                const float* integral, size_t begin,
                                size_t n) {
  for (size_t i = begin + global_index(); i < n; i += grid_stride()) {
    out[i] = quotient_one(view[i], integral[i]);
  }
}

// view: n values shared by `batch` integrals and outs, as for K1's weights
__global__ void quotient_bcast_vec4(float4* out, const float4* view,
                                    const float4* integral, size_t n4,
                                    size_t batch) {
  for (size_t j = global_index(); j < n4; j += grid_stride()) {
    const float4 v = view[j];
    for (size_t b = 0; b < batch; ++b) {
      const size_t i = b * n4 + j;
      const float4 d = integral[i];
      out[i] = make_float4(quotient_one(v.x, d.x), quotient_one(v.y, d.y),
                           quotient_one(v.z, d.z), quotient_one(v.w, d.w));
    }
  }
}

__global__ void quotient_bcast_scalar(float* out, const float* view,
                                      const float* integral, size_t n,
                                      size_t batch) {
  for (size_t j = global_index(); j < n; j += grid_stride()) {
    const float v = view[j];
    for (size_t b = 0; b < batch; ++b) {
      const size_t i = b * n + j;
      out[i] = quotient_one(v, integral[i]);
    }
  }
}

// ---------------------------------------------------------------- K3
// (xr + i xi)(kr + i ki) with ki negated for conj; interleaved complex64
__device__ __forceinline__ float2 cmul(float2 x, float2 k) {
  return make_float2(x.x * k.x - x.y * k.y, x.x * k.y + x.y * k.x);
}

// two complex values per float4; nk2 = number of pairs in one kernel
// spectrum, batch = number of x spectra sharing it
__global__ void spectral_multiply_vec4(float4* out, const float4* x,
                                       const float4* k, size_t nk2,
                                       size_t batch, float ksign) {
  for (size_t j = global_index(); j < nk2; j += grid_stride()) {
    float4 kk = k[j];
    float2 k0 = make_float2(kk.x, ksign * kk.y);
    float2 k1 = make_float2(kk.z, ksign * kk.w);
    for (size_t b = 0; b < batch; ++b) {
      size_t i = b * nk2 + j;
      float4 xx = x[i];
      float2 r0 = cmul(make_float2(xx.x, xx.y), k0);
      float2 r1 = cmul(make_float2(xx.z, xx.w), k1);
      out[i] = make_float4(r0.x, r0.y, r1.x, r1.y);
    }
  }
}

__global__ void spectral_multiply_scalar(float2* out, const float2* x,
                                         const float2* k, size_t nk,
                                         size_t batch, float ksign) {
  for (size_t j = global_index(); j < nk; j += grid_stride()) {
    float2 kk = k[j];
    kk.y *= ksign;
    for (size_t b = 0; b < batch; ++b) {
      size_t i = b * nk + j;
      out[i] = cmul(x[i], kk);
    }
  }
}

}  // namespace

extern "C" {

const char* lmvn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// psi, integral and out hold batch * n values, w n values shared by the
// batch entries (batch > 1 needs w).  out may alias psi.  w == NULL selects
// the scalar weight w_scalar.
int lmvn_rl_update(int device, void* out, const void* psi,
                   const void* integral, const void* w, float w_scalar,
                   float lam, float min_value, long long n, long long batch,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || batch <= 0) return 0;
  RlParams p = lmvn::rl_params(w_scalar, lam, min_value);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t total = static_cast<size_t>(n);
  if (batch > 1) {
    if (w == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    size_t nb = static_cast<size_t>(batch);
    if (total % 4 == 0 && aligned16(out) && aligned16(psi) &&
        aligned16(integral) && aligned16(w)) {
      rl_update_bcast_vec4<<<grid_for(total / 4), kThreads, 0, s>>>(
          static_cast<float4*>(out), static_cast<const float4*>(psi),
          static_cast<const float4*>(integral), static_cast<const float4*>(w),
          p, total / 4, nb);
    } else {
      rl_update_bcast_scalar<<<grid_for(total), kThreads, 0, s>>>(
          static_cast<float*>(out), static_cast<const float*>(psi),
          static_cast<const float*>(integral), static_cast<const float*>(w),
          p, total, nb);
    }
    return static_cast<int>(cudaGetLastError());
  }
  size_t done = 0;
  if (aligned16(out) && aligned16(psi) && aligned16(integral) &&
      (w == nullptr || aligned16(w))) {
    size_t n4 = total / 4;
    if (n4 > 0) {
      rl_update_vec4<<<grid_for(n4), kThreads, 0, s>>>(
          static_cast<float4*>(out), static_cast<const float4*>(psi),
          static_cast<const float4*>(integral),
          static_cast<const float4*>(w), p, n4);
    }
    done = n4 * 4;
  }
  if (done < total) {
    rl_update_scalar<<<grid_for(total - done), kThreads, 0, s>>>(
        static_cast<float*>(out), static_cast<const float*>(psi),
        static_cast<const float*>(integral), static_cast<const float*>(w), p,
        done, total);
  }
  return static_cast<int>(cudaGetLastError());
}

// integral and out hold batch * n values, view n values shared by the
// batch entries.  out may alias integral, and view when batch is 1.
int lmvn_quotient(int device, void* out, const void* view,
                  const void* integral, long long n, long long batch,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || batch <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t total = static_cast<size_t>(n);
  if (batch > 1) {
    size_t nb = static_cast<size_t>(batch);
    if (total % 4 == 0 && aligned16(out) && aligned16(view) &&
        aligned16(integral)) {
      quotient_bcast_vec4<<<grid_for(total / 4), kThreads, 0, s>>>(
          static_cast<float4*>(out), static_cast<const float4*>(view),
          static_cast<const float4*>(integral), total / 4, nb);
    } else {
      quotient_bcast_scalar<<<grid_for(total), kThreads, 0, s>>>(
          static_cast<float*>(out), static_cast<const float*>(view),
          static_cast<const float*>(integral), total, nb);
    }
    return static_cast<int>(cudaGetLastError());
  }
  size_t done = 0;
  if (aligned16(out) && aligned16(view) && aligned16(integral)) {
    size_t n4 = total / 4;
    if (n4 > 0) {
      quotient_vec4<<<static_cast<unsigned>((n4 + kThreads - 1) / kThreads),
                      kThreads, 0, s>>>(
          static_cast<float4*>(out), static_cast<const float4*>(view),
          static_cast<const float4*>(integral), n4);
    }
    done = n4 * 4;
  }
  if (done < total) {
    quotient_scalar<<<grid_for(total - done), kThreads, 0, s>>>(
        static_cast<float*>(out), static_cast<const float*>(view),
        static_cast<const float*>(integral), done, total);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: batch * nk complex64 values, k: nk complex64 values, out like x (may
// alias x).  conj_k != 0 multiplies by conj(k).
int lmvn_spectral_multiply(int device, void* out, const void* x,
                           const void* k, long long batch, long long nk,
                           int conj_k, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || nk <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float ksign = conj_k ? -1.f : 1.f;
  size_t nkz = static_cast<size_t>(nk);
  size_t nb = static_cast<size_t>(batch);
  if (nkz % 2 == 0 && aligned16(out) && aligned16(x) && aligned16(k)) {
    size_t nk2 = nkz / 2;
    spectral_multiply_vec4<<<grid_for(nk2), kThreads, 0, s>>>(
        static_cast<float4*>(out), static_cast<const float4*>(x),
        static_cast<const float4*>(k), nk2, nb, ksign);
  } else {
    spectral_multiply_scalar<<<grid_for(nkz), kThreads, 0, s>>>(
        static_cast<float2*>(out), static_cast<const float2*>(x),
        static_cast<const float2*>(k), nkz, nb, ksign);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
