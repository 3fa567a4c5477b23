// The z-sparse forwarding of a kernel stack's fused spectra, for Hopper
// (sm_90a), fp32 compute.
//
// Counterpart of the z-sparse branch of kernel_spectrum_fused in
// libmultiviewnative_tpu/ops/pallas/fused_dft2.py (:1642-1665), which runs
// pass A on the kz planes a wrapped kernel occupies and forms the z-DFT as
// one (Z, Zs) contraction over them (an XLA einsum at HIGHEST there).  Here
// the whole (V, kz, ky, kx) stack goes through three steps, each one launch
// or one pass for all V views (ops/fused.py kernel_stack_spectrum_fused):
//
//   lmvn_fused_spectrum_gather: the wrapped, transposed kernel planes of
//     every view into one (V*Zs, X, Y) float32 buffer, Zs = ceil8(kz): plane
//     v*Zs + s holds what wrap_kernel(kernel[v], (Zs, Y, X)) puts at z = s,
//     transposed to (X, Y).  Data movement only where the kernel fits the
//     volume, so bitwise that chain; a kernel wider than Y or X folds, each
//     position the sum of the taps that alias onto it (to float32 rounding
//     of wrap_kernel's sum, whose reduction order is torch's own).
//   K4 (lmvn_fused_pass_a) over the V*Zs planes: pass A is plane-local, so
//     each view's slice is that view's own K4.
//   lmvn_fused_spectrum_zsparse (and _bf16): the complex contraction
//       out[v, k, p, y] = sum_s T[p, s] * u[k, v*Zs + s, y]
//     over the kz planes the kernel occupies (the gather's pad planes are
//     zero and skipped), T the (Z, Zs) table of ops/fused.py _sparse_table,
//     written straight into the contiguous (V, Kxp, Z, Y) re and im stacks.
//
// What bounds the contraction: it writes 8 B * V * Kxp * Z * Y (285 MB a
// stack at 256^3, 2.2 GB at 512^3) and forms 4 * kz multiply-adds a complex
// output value (3-3.6 G at 256^3, 23 G at 512^3), so it sits near the line
// between the card's bytes (3.35 TB/s) and its fp32 rate (67 TFLOP/s), and
// every issue slot a multiply-add does not take costs time.  The design
// keeps both busy: a block takes (v, k, 64 y columns, 512 frequencies p),
// stages u's kz x 64 slab in shared memory once (widened to f32) and walks
// eight tiles of 64 p; each of its 256 threads forms 8 frequencies at 2
// adjacent y in registers, reading two float4 of u and eight broadcast
// float4 of T (two planes each) for every 128 multiply-adds, so shared
// memory serves half of what the multiply-adds take.  T comes packed at the
// occupied planes (ops/fused.py _packed_table), so the next tile's T is
// copied in 16 bytes at a time (cp.async) while the current one is summed,
// and a tile's stores (along y, a float2 or a bf16 pair a thread, whole
// lines a warp) drain while the next is summed.
//
// Rounding, as the einsum chain it replaces (ops/fused.py
// spectrum_zsparse_plain): u is read in its storage dtype and widened; the
// four real sums sum_s tr*ur, ti*ui, tr*ui, ti*ur are formed in f32 in the
// order of s, one multiply-add each (__fmaf_rn: the library is built with
// -fmad=false, and cuBLAS's fp32 gemm contracts the same way); re = first -
// second and im = third + fourth are rounded once to the storage dtype at
// the store.  No TF32: these are CUDA-core instructions.  The pad rows k in
// [Kx, Kxp) are written as zeros.
//
// Plain C interface for ctypes: every entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace lmvn_fft {

constexpr int kGatherThreads = 256;
constexpr long long kGatherBlocks = 1 << 16;

// g (V*Zs, X, Y) from the (V, kz, ky, kx) stack, as wrap_kernel's
// target[(i - k/2) mod e] += kernel[i] on each axis: a block per row
// (plane, x), threads along y.  z never folds (Zs >= kz).  Where the stack
// fits the volume (fold false) a position takes one tap or none, copied
// bit for bit (-0.0f + t is t); where it folds on y or x, the taps that
// alias onto a position are added from 0.0f in the order of wrap_kernel's
// period blocks, the x block fastest.  Y is a multiple of 8 (the fused
// engine's axes are, checked at the entry), so a row starts on a 32-byte
// boundary.
__global__ void __launch_bounds__(kGatherThreads)
    spectrum_gather_kernel(float* __restrict__ g, const float* __restrict__ kern, int kz,
                           int ky, int kx, int Zs, int X, int Y, bool fold, long long rows) {
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const int x = static_cast<int>(r % X);
    const long long q = r / X;
    const int s = static_cast<int>(q % Zs);
    const long long v = q / Zs;
    int i = s + kz / 2;
    if (i >= Zs) i -= Zs;
    const int l0 = static_cast<int>((x + static_cast<long long>(kx / 2)) % X);
    float* out = g + r * Y;
    if (i >= kz || l0 >= kx) {  // a row the kernel misses: zeros, 16 bytes a store
      for (int y = 4 * threadIdx.x; y < Y; y += 4 * kGatherThreads)
        *reinterpret_cast<float4*>(out + y) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    const float* src = kern + ((v * kz + i) * ky) * kx;
    for (int y = threadIdx.x; y < Y; y += kGatherThreads) {
      const int j0 = static_cast<int>((y + static_cast<long long>(ky / 2)) % Y);
      if (j0 >= ky) {
        out[y] = 0.0f;
        continue;
      }
      float acc = fold ? 0.0f : -0.0f;
      for (int j = j0; j < ky; j += Y)
        for (int l = l0; l < kx; l += X) acc += __ldg(src + static_cast<long long>(j) * kx + l);
      out[y] = acc;
    }
  }
}

constexpr int kZsYTile = 64;                          // y columns a block covers
constexpr int kZsRows = 8;                            // thread rows: p = p0 + row + 8 j
constexpr int kZsPer = 8;                             // frequencies a thread forms
constexpr int kZsPTile = kZsRows * kZsPer;            // z frequencies a step forms
constexpr int kZsThreads = (kZsYTile / 2) * kZsRows;  // 256
constexpr int kZsPlanes = 32;                         // planes staged at a time (even)
constexpr int kZsTilesPerBlock = 8;                   // p tiles a block walks

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 16 bytes global -> shared without a register (cp.async, sm_80 and later)
__device__ __forceinline__ void copy_async(float4* smem, const float4* gmem) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(at), "l"(gmem));
}

// four spectral values at p, widened (p aliases no output)
__device__ __forceinline__ float4 load_quad(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load_quad(const __nv_bfloat16* p) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The four real sums of one complex output value at two y: re = a - b,
// im = c + d.
struct Acc {
  float a[2], b[2], c[2], d[2];
};

// acc += t * u at the thread's two y, u = (re y0, im y0, re y1, im y1)
__device__ __forceinline__ void mac(Acc& acc, float tr, float ti, float4 u) {
  acc.a[0] = __fmaf_rn(tr, u.x, acc.a[0]);
  acc.b[0] = __fmaf_rn(ti, u.y, acc.b[0]);
  acc.c[0] = __fmaf_rn(tr, u.y, acc.c[0]);
  acc.d[0] = __fmaf_rn(ti, u.x, acc.d[0]);
  acc.a[1] = __fmaf_rn(tr, u.z, acc.a[1]);
  acc.b[1] = __fmaf_rn(ti, u.w, acc.b[1]);
  acc.c[1] = __fmaf_rn(tr, u.w, acc.c[1]);
  acc.d[1] = __fmaf_rn(ti, u.z, acc.d[1]);
}

// the gathered plane of the jj-th plane a kernel occupies: the head planes
// [0, kz - kz/2) first, then the tail, after the gather's Zs - kz zeros
__device__ __forceinline__ int occupied(int jj, int kz, int Zs) {
  return jj < kz - kz / 2 ? jj : jj + Zs - kz;
}

// u (Kxp, V*Zs, Y) -> out (V, Kxp, Z, Y); t (Z, kzp) (re, im) pairs, the
// table's columns at the kz occupied planes in the order summed, kzp = kz
// rounded up to even (a zero column last).  Block b: the p group
// fastest (kZsTilesPerBlock p tiles), then the y tile, then the row
// v*Kxp + k.  A block stages u's slab of the kz occupied planes (up to
// kZsPlanes at a time) once and walks its p tiles; T's tile of the next step
// is copied into the other half of a double buffer (cp.async) while the
// current one is summed.  Y is a multiple of 8 (the fused engine's axes
// are), so a thread's pair of y, and a quad of u, is in range together.
template <class S>
__global__ void __launch_bounds__(kZsThreads, 2)
    spectrum_zsparse_kernel(S* __restrict__ o_re, S* __restrict__ o_im,
                            const S* __restrict__ u_re, const S* __restrict__ u_im,
                            const float2* __restrict__ t, int V, int Kx, int Kxp, int Z,
                            int Y, int Zs, int kz,
                            int p_groups, int y_tiles) {
  __shared__ __align__(16) float2 us[kZsPlanes][kZsYTile];
  __shared__ __align__(16) float2 ts[2][kZsPTile][kZsPlanes];
  long long b = blockIdx.x;
  const int pg = static_cast<int>(b % p_groups);
  b /= p_groups;
  const int yt = static_cast<int>(b % y_tiles);
  const long long row = b / y_tiles;  // v * Kxp + k
  const int v = static_cast<int>(row / Kxp), k = static_cast<int>(row % Kxp);
  const int y0 = yt * kZsYTile;
  const int tx = threadIdx.x % (kZsYTile / 2), ty = threadIdx.x / (kZsYTile / 2);
  const int y = y0 + 2 * tx;
  const bool y_in = y < Y;
  const int p_first = pg * kZsTilesPerBlock * kZsPTile;
  const int p_end = min(Z, p_first + kZsTilesPerBlock * kZsPTile);
  const long long out_row = row * Z;

  if (k >= Kx) {  // a pad row: zeros
    if (y_in)
      for (int p = p_first + ty; p < p_end; p += kZsRows) {
        store_pair(o_re + (out_row + p) * Y + y, 0.0f, 0.0f);
        store_pair(o_im + (out_row + p) * Y + y, 0.0f, 0.0f);
      }
    return;
  }

  const int chunks = (kz + kZsPlanes - 1) / kZsPlanes;
  const int tiles = (p_end - p_first + kZsPTile - 1) / kZsPTile;
  const int steps = tiles * chunks;
  const long long u_row = (static_cast<long long>(k) * V + v) * Zs;  // plane v*Zs of row k

  // the planes of chunk c, and their count rounded up to even (the odd
  // one's partner staged as zeros)
  auto planes = [&](int c) { return min(kZsPlanes, kz - c * kZsPlanes); };
  auto stage_u = [&](int c) {
    const int nc = planes(c), ncp = (nc + 1) & ~1;
    constexpr int kQuads = kZsYTile / 4;
    for (int e = threadIdx.x; e < ncp * kQuads; e += kZsThreads) {
      const int jj = e / kQuads, yy = 4 * (e % kQuads);
      float4 re = make_float4(0.0f, 0.0f, 0.0f, 0.0f), im = re;
      if (jj < nc && y0 + yy < Y) {  // Y is a multiple of 8: the quad is in range
        const long long at = (u_row + occupied(c * kZsPlanes + jj, kz, Zs)) * Y + y0 + yy;
        re = load_quad(u_re + at);
        im = load_quad(u_im + at);
      }
      float4* to = reinterpret_cast<float4*>(&us[jj][yy]);
      to[0] = make_float4(re.x, im.x, re.y, im.y);
      to[1] = make_float4(re.z, im.z, re.w, im.w);
    }
  };
  // T's tile of step st into ts[buf], two pairs a 16-byte cp.async
  const int kzp = (kz + 1) & ~1;
  auto copy_t = [&](int st, int buf) {
    const int c = st % chunks, p0 = p_first + (st / chunks) * kZsPTile;
    const int halves = ((planes(c) + 1) & ~1) / 2;
    for (int e = threadIdx.x; e < kZsPTile * halves; e += kZsThreads) {
      const int pp = e / halves, jj = 2 * (e % halves), p = p0 + pp;
      float4* at = reinterpret_cast<float4*>(&ts[buf][pp][jj]);
      if (p < Z)
        copy_async(at, reinterpret_cast<const float4*>(
                           t + static_cast<long long>(p) * kzp + c * kZsPlanes + jj));
      else
        *at = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    copy_async_commit();
  };

  Acc acc[kZsPer];
  copy_t(0, 0);
  if (chunks == 1) stage_u(0);
  for (int st = 0; st < steps; ++st) {
    const int c = st % chunks, buf = st & 1;
    copy_async_wait();
    __syncthreads();  // T's tile of st and u are in; step st - 1 is summed
    if (chunks > 1) {
      stage_u(c);
      __syncthreads();
    }
    if (st + 1 < steps) copy_t(st + 1, buf ^ 1);
    if (c == 0)
#pragma unroll
      for (int j = 0; j < kZsPer; ++j) acc[j] = Acc{};
    const int ncp = (planes(c) + 1) & ~1;
    for (int jj = 0; jj < ncp; jj += 2) {
      const float4 u0 = *reinterpret_cast<const float4*>(&us[jj][2 * tx]);
      const float4 u1 = *reinterpret_cast<const float4*>(&us[jj + 1][2 * tx]);
#pragma unroll
      for (int j = 0; j < kZsPer; ++j) {
        const float4 t = *reinterpret_cast<const float4*>(&ts[buf][ty + kZsRows * j][jj]);
        mac(acc[j], t.x, t.y, u0);
        mac(acc[j], t.z, t.w, u1);
      }
    }
    if (c == chunks - 1 && y_in) {
      const int p0 = p_first + (st / chunks) * kZsPTile;
#pragma unroll
      for (int j = 0; j < kZsPer; ++j) {
        const int p = p0 + ty + kZsRows * j;
        if (p < p_end) {
          const long long at = (out_row + p) * Y + y;
          store_pair(o_re + at, acc[j].a[0] - acc[j].b[0], acc[j].a[1] - acc[j].b[1]);
          store_pair(o_im + at, acc[j].c[0] + acc[j].d[0], acc[j].c[1] + acc[j].d[1]);
        }
      }
    }
  }
}

}  // namespace lmvn_fft

namespace {

int select_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}

template <class S>
int spectrum_zsparse(int device, void* o_re, void* o_im, const void* u_re, const void* u_im,
                     const void* t, int V, int Kx, int Kxp, int Z, int Y, int Zs, int kz,
                     void* stream) {
  using namespace lmvn_fft;
  int err = select_device(device);
  if (err) return err;
  if (V < 1 || Kx < 1 || Kxp < Kx || Z < 1 || Y < 8 || Y % 8 || kz < 1 || Zs < kz)
    return static_cast<int>(cudaErrorInvalidValue);
  const int p_groups = (Z + kZsTilesPerBlock * kZsPTile - 1) / (kZsTilesPerBlock * kZsPTile);
  const int y_tiles = (Y + kZsYTile - 1) / kZsYTile;
  const long long blocks = static_cast<long long>(V) * Kxp * p_groups * y_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  spectrum_zsparse_kernel<S><<<static_cast<unsigned>(blocks), kZsThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<S*>(o_re), static_cast<S*>(o_im), static_cast<const S*>(u_re),
      static_cast<const S*>(u_im), static_cast<const float2*>(t), V, Kx, Kxp, Z, Y, Zs, kz,
      p_groups, y_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// g: (V*Zs, X, Y) float32; kernels: a contiguous (V, kz, ky, kx) float32
// stack with kz <= Zs; X and Y multiples of 8; ky and kx any extent (a
// kernel wider than the volume folds).
int lmvn_fused_spectrum_gather(int device, void* g, const void* kernels, int V, int kz, int ky,
                               int kx, int Zs, int X, int Y, void* stream) {
  using namespace lmvn_fft;
  int err = select_device(device);
  if (err) return err;
  if (V < 1 || kz < 1 || ky < 1 || kx < 1 || kz > Zs || X < 8 || X % 8 || Y < 8 || Y % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(V) * Zs * X;
  const unsigned grid = static_cast<unsigned>(std::min(rows, kGatherBlocks));
  spectrum_gather_kernel<<<grid, kGatherThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(g), static_cast<const float*>(kernels), kz, ky, kx, Zs, X, Y,
      ky > Y || kx > X, rows);
  return static_cast<int>(cudaGetLastError());
}

// out (o_re, o_im): (V, Kxp, Z, Y); u: (Kxp, V*Zs, Y), both stored as float
// (or __nv_bfloat16 in the _bf16 twin); t: the (Z, kzp) table of (re, im)
// float32 pairs at the occupied planes (ops/fused.py _packed_table).
int lmvn_fused_spectrum_zsparse(int device, void* o_re, void* o_im, const void* u_re,
                                const void* u_im, const void* t, int V, int Kx, int Kxp, int Z,
                                int Y, int Zs, int kz, void* stream) {
  return spectrum_zsparse<float>(device, o_re, o_im, u_re, u_im, t, V, Kx, Kxp, Z, Y, Zs, kz,
                                 stream);
}

int lmvn_fused_spectrum_zsparse_bf16(int device, void* o_re, void* o_im, const void* u_re,
                                     const void* u_im, const void* t, int V, int Kx, int Kxp,
                                     int Z, int Y, int Zs, int kz, void* stream) {
  return spectrum_zsparse<__nv_bfloat16>(device, o_re, o_im, u_re, u_im, t, V, Kx, Kxp, Z, Y,
                                         Zs, kz, stream);
}

}  // extern "C"
