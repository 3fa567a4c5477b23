// The fft engine's z axis for Hopper (sm_90a), fp32 compute: one pass of a
// circular convolution with a pre-forwarded kernel spectrum (core/convolve.py
// convolve_spectrum, its hand route).
//
// The fft engine transforms a volume with cuFFT.  cuFFT's x and y passes run
// near the card's bytes, but its z axis is strided by a whole plane of the
// half spectrum and ran at 31 % of its bytes at Z = 300 (PERF.md §5), and
// the product with the kernel spectrum (K3) and PyTorch's 1/N scaling read
// and wrote the whole spectrum twice more.  Here cuFFT transforms x and y
// only (ops/z_convolve.py), into a half spectrum with (X//2+1, Z, Y) in
// memory, the order the kernel spectra already have, and this one pass takes
// the rest in shared memory:
//
//   z_convolve_kernel<P>: a block of 256 threads per (x-frequency k, tile of
//     P y columns); column c of the slice k is one complex length-Z
//     sequence, strided by Y.  The block loads its P columns over all Z,
//     value z of column s at z*P + s (the layout of K6's z_kernel), runs the
//     forward FFT as the transposed stages (run_stages_dif: natural order
//     in, frequency f out at pos[f]), multiplies frequency f by the kernel
//     spectrum's value at (f, y, k), or by its conjugate under conj_k (K6's
//     ksign), runs the inverse stages (run_stages<P, true>: pos[f] in,
//     natural order out), scales by 1/(Z*Y*X) and stores the tile in place.
//     The block reads its whole tile before it writes, and blocks own
//     disjoint tiles.
//
// The stages and the plan are those of fft_stage.cuh (make_fft_stages(Z) in
// ops/fused_plan.py); the tile, P, is z_convolve_tile(Z) below.  The route
// that reaches this pass takes only lengths whose radices are 2, 3, 4, 5, 7
// and 8, so no generic stage runs here.
//
// Bytes: the spectrum read and written once and the kernel spectrum read
// once, 24 B a complex value, where cuFFT's two z passes, K3 and the 1/N
// pass moved three times as much.  Interleaved complex64 throughout; a
// thread moves one complex value (8 B) a step (the tile in by cp.async), so
// a warp covers whole 32-byte sectors of a tile's rows, and any Y (odd
// included) keeps every access aligned.  The kernel spectrum is read
// through its own strides (complex elements), so any dense layout of it
// serves; the engine's own order, (X//2+1, Z, Y), reads it in rows as the
// spectrum is read.
//
// Plain C interface for ctypes: the entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "fft_stage.cuh"

namespace lmvn_fft {

// Blocks of the pass an SM holds: the launch bound caps a thread at 64
// registers (256 threads, 4 blocks), and the tile is the widest from 16 whose
// shared memory leaves room for 4 blocks (16 columns up to Z = 454, 8 to 908,
// 4 to 1816, 2 to 3632), else the widest that fits one.  Timed on an H100
// 80GB HBM3 at 700 W (ms, (Z, Y, X)) against a first form that read the
// kernel spectrum one load a thread at a time and took z_cols(Z)'s 16
// columns at 94 registers (3 blocks an SM): (300, 1024, 1024) 2.50 against
// 3.80, (256, 1024, 1024) 1.85 against 2.70, (512, 512, 512) 0.98 (8
// columns) against 1.32, (1024, 1024, 1024) 9.66 (4 columns) against 18.54;
// the batched loads of the kernel spectrum alone took 7-20 % off.  The tile
// then came in by cp.async (every copy of the block in flight at once,
// through no register) where it had come through registers kBatch loads a
// thread at a time: 2.35, 1.63, 0.88 and 8.68 ms at those four shapes, 1.92
// for 2.30 at (280, 1024, 1024), bitwise the same; a second buffer that
// took the kernel spectrum's tile by cp.async during the forward stages
// halved the blocks an SM and lost (2.47 at Z = 300).
constexpr int kZConvBlocks = 4;

inline int z_convolve_tile(int Z) {
  for (int p = kZColsMax; p >= kMinTile; p /= 2)
    if (sizeof(float2) * p * Z <= kSmemMax / kZConvBlocks) return p;
  return widest_tile(kMinTile, Z);
}

// 8 bytes global -> shared without a register (cp.async, sm_80 and later);
// the block waits for its copies with wait_async() and a barrier
__device__ __forceinline__ void copy8_async(float2* shared_at, const float2* global_at) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(shared_at));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(at), "l"(global_at));
}

__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int P>
__global__ void __launch_bounds__(kThreads, kZConvBlocks)
    z_convolve_kernel(float2* s, const float2* __restrict__ kh, long long ksz,
                      long long ksy, long long ksk, float ksign, const LmvnFft f,
                      int Y, float scale, int k0) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* buf = reinterpret_cast<float2*>(smem);
  const int Z = f.n, c0 = blockIdx.x * P, k = k0 + blockIdx.y;
  float2* col = s + static_cast<size_t>(k) * Z * Y + c0;
  const int cols = min(P, Y - c0);
  for (int e = threadIdx.x; e < Z * P; e += kThreads) {
    const int t = e % P;
    if (t < cols)
      copy8_async(buf + e, col + static_cast<size_t>(e / P) * Y + t);
    else
      buf[e] = make_float2(0.f, 0.f);
  }
  wait_async();
  __syncthreads();
  run_stages_dif<P>(buf, f);
  const float2* kcol = kh + static_cast<long long>(c0) * ksy + static_cast<long long>(k) * ksk;
  batched<float2>(
      Z * P,
      [&](int e) {
        const int t = e % P;
        return t < cols ? __ldg(kcol + (e / P) * ksz + t * ksy) : make_float2(0.f, 0.f);
      },
      [&](int e, float2 kv) {
        const int t = e % P;
        if (t >= cols) return;
        kv.y *= ksign;
        float2* at = buf + __ldg(f.pos + e / P) * P + t;
        *at = cmul(*at, kv);
      });
  __syncthreads();
  run_stages<P, true>(buf, f);
  for (int e = threadIdx.x; e < Z * P; e += kThreads) {
    const int t = e % P;
    if (t >= cols) continue;
    const float2 v = buf[e];
    col[static_cast<size_t>(e / P) * Y + t] = make_float2(v.x * scale, v.y * scale);
  }
}

template <int P>
int z_convolve_launch(float2* s, const float2* kh, long long ksz, long long ksy,
                      long long ksk, float ksign, const LmvnFft& f, int Y, int Kx,
                      float scale, cudaStream_t st) {
  const size_t smem = sizeof(float2) * P * f.n;
  cudaError_t e = cudaFuncSetAttribute(z_convolve_kernel<P>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int k0 = 0; k0 < Kx; k0 += kMaxGridY)
    z_convolve_kernel<P>
        <<<dim3(blocks(Y, P), std::min(Kx - k0, kMaxGridY)), kThreads, smem, st>>>(
            s, kh, ksz, ksy, ksk, ksign, f, Y, scale, k0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lmvn_fft

extern "C" {

// s: the (Kx, Z, Y) interleaved complex64 half spectrum of one volume, x and
// y forwarded, convolved in place; kh: the kernel spectrum, its (z, y, k)
// element at kh[z*ksz + y*ksy + k*ksk]; f: the direct plan of Z (host
// memory, its tables on the device), stages of radix 2 to 8 only; scale:
// 1/(Z*Y*X).
int lmvn_z_convolve(int device, void* s, const void* kh, long long ksz, long long ksy,
                    long long ksk, int conj_k, const LmvnFft* f, int Y, int Kx, float scale,
                    void* stream) {
  using namespace lmvn_fft;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!f || Y < 1 || Kx < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tile = z_convolve_tile(f->n);
  if (!stages_ok(*f, f->n, tile)) return static_cast<int>(cudaErrorInvalidValue);
  for (int j = 0; j < f->nstages; ++j)
    if (f->radix[j] > 8 || f->radix[j] == 6) return static_cast<int>(cudaErrorInvalidValue);
  return with_tile(tile, [&](auto w) {
    return z_convolve_launch<decltype(w)::value>(
        static_cast<float2*>(s), static_cast<const float2*>(kh), ksz, ksy, ksk,
        conj_k ? -1.f : 1.f, *f, Y, Kx, scale, static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
