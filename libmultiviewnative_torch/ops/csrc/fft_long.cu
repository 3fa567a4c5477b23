// The long-axis stages of the fused passes (fft_long.cuh): the gathers,
// scatters and pointwise launches around the transforms through HBM, and
// the transforms' own chirp and spectrum launches.  Every launch is a
// grid-stride loop over the values it moves, with 64-bit indices.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "fft_long.cuh"

namespace lmvn_fft {

namespace {

// where a forward transform leaves frequency k (and where its inverse takes
// it): k, or N2 (k mod N1) + k div N1 after a four-step
struct At {
  int n1, n2;  // n1 = 0: k itself
  __device__ __forceinline__ long long operator()(long long k) const {
    return n1 ? (k % n1) * n2 + k / n1 : k;
  }
};

At spectrum_at(const LmvnAxis& a) {
  return a.kind == kFourStep ? At{a.part[0]->f.n, a.part[1]->f.n} : At{0, 0};
}

unsigned grid(long long values) {
  return static_cast<unsigned>(std::max(1LL, std::min((values + kThreads - 1) / kThreads, 4096LL)));
}

#define LMVN_EACH(i, total)                                                  \
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; \
       i < (total); i += static_cast<long long>(gridDim.x) * kThreads)

__device__ __forceinline__ float2 conjugate(float2 v) { return make_float2(v.x, -v.y); }

__device__ __forceinline__ float ld_one(const float* p) { return *p; }
__device__ __forceinline__ float ld_one(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ------------------------------------------------------------ Bluestein
// PRE: w[e] times conj(b_e) (the inverse: b_e) for e < n, zero for e in
// [n, m); else (POST) the first n values times the same.
template <bool INV, bool PRE>
__global__ void __launch_bounds__(kThreads)
    chirp_kernel(float2* w, long long groups, int L, int n, int m,
                 const float2* __restrict__ chirp) {
  const int span = PRE ? m : n;
  LMVN_EACH(i, groups * span * L) {
    const long long c = i % L, r = i / L;
    const int e = static_cast<int>(r % span);
    float2* at = w + ((r / span) * m + e) * L + c;
    if (PRE && e >= n) {
      *at = make_float2(0.f, 0.f);
    } else {
      const float2 b = __ldg(chirp + e);
      *at = cmul(*at, INV ? b : conjugate(b));
    }
  }
}

// frequency k of the m-point transform (at spectrum_at of its plan) times
// bhat[k]; the inverse times conj(bhat[(m - k) mod m]), the spectrum of the
// conjugate chirp
template <bool INV>
__global__ void __launch_bounds__(kThreads)
    bhat_kernel(float2* w, long long groups, int L, int m, At at,
                const float2* __restrict__ bhat) {
  LMVN_EACH(i, groups * m * L) {
    const long long c = i % L, r = i / L;
    const int k = static_cast<int>(r % m);
    float2* v = w + ((r / m) * m + at(k)) * L + c;
    const float2 b = INV ? conjugate(__ldg(bhat + (m - k) % m)) : __ldg(bhat + k);
    *v = cmul(*v, b);
  }
}

template <bool INV>
int long_fft(float2* w, const LmvnAxis& x, long long groups, int L, cudaStream_t s);

// The Bluestein transform of each sequence of w (groups, m, L), its first n
// values natural in and out.
template <bool INV>
int bluestein(float2* w, const LmvnAxis& x, long long groups, int L, cudaStream_t s) {
  const LmvnAxis& inner = *x.part[0];
  const int n = x.f.n, m = x.m;
  const float2* chirp = reinterpret_cast<const float2*>(x.chirp);
  chirp_kernel<INV, true><<<grid(groups * m * L), kThreads, 0, s>>>(w, groups, L, n, m, chirp);
  int err = static_cast<int>(cudaGetLastError());
  if (!err) err = long_fft<false>(w, inner, groups, L, s);
  if (!err) {
    bhat_kernel<INV><<<grid(groups * m * L), kThreads, 0, s>>>(
        w, groups, L, m, spectrum_at(inner), reinterpret_cast<const float2*>(x.bhat));
    err = static_cast<int>(cudaGetLastError());
  }
  if (!err) err = long_fft<true>(w, inner, groups, L, s);
  if (!err) {
    chirp_kernel<INV, false><<<grid(groups * n * L), kThreads, 0, s>>>(w, groups, L, n, m, chirp);
    err = static_cast<int>(cudaGetLastError());
  }
  return err;
}

// The transform of every sequence of w (groups, npad(x), L) in place:
// forward, natural order in, frequency k at spectrum_at(x)(k) out; inverse
// (unscaled), from that order to the natural one.
template <bool INV>
int long_fft(float2* w, const LmvnAxis& x, long long groups, int L, cudaStream_t s) {
  const int n = x.f.n;
  const long long nL = static_cast<long long>(n) * L;
  if (x.kind == kDirect) return col_fft_stage<INV>(w, x.f, groups, L, nL, L, 0, 1, false, s);
  if (x.kind == kBluestein) return bluestein<INV>(w, x, groups, L, s);
  const LmvnFft &a = x.part[0]->f, &b = x.part[1]->f;
  const long long n2L = static_cast<long long>(b.n) * L;
  const int C1 = static_cast<int>(n2L);
  int err;
  if (!INV) {
    // N1-point transforms over j1 (stride N2 L), times W_n^{j2 k1}, j2 = c / L
    err = col_fft_stage<false>(w, a, groups, C1, nL, n2L, n, L, false, s);
    // N2-point transforms over j2 of each row k1
    return err ? err : col_fft_stage<false>(w, b, groups * a.n, L, n2L, L, 0, 1, false, s);
  }
  // inverse N2-point transforms of each row k1, times W_n^{-j2 k1}, k1 = p mod N1
  err = col_fft_stage<true>(w, b, groups * a.n, L, n2L, L, n, a.n, true, s);
  return err ? err : col_fft_stage<true>(w, a, groups, C1, nL, n2L, 0, 1, false, s);
}

// ------------------------------------------------------------ x stage
// w (Z, npad, L = Y/2): sequence c of plane z is the column pair (2c, 2c+1)
// of the plane's (X, Y) values; four columns (two sequences) a thread.

__global__ void __launch_bounds__(kThreads)
    x_gather_real(float2* w, const float* __restrict__ xt, long long Z, int X,
                  int Y, long long npad) {
  const int Q = Y / 4, L = Y / 2;
  LMVN_EACH(i, Z * X * Q) {
    const long long r = i / Q;  // z*X + x
    const int q = static_cast<int>(i % Q), x = static_cast<int>(r % X);
    const float4 v = __ldg(reinterpret_cast<const float4*>(xt + r * Y + 4 * q));
    *reinterpret_cast<float4*>(w + ((r / X) * npad + x) * L + 2 * q) = v;
  }
}

// store_half_spectra's split: A_k = (F_k + conj F_{X-k}) / 2 and
// B_k = (F_k - conj F_{X-k}) / 2i of each column pair into t's rows k < Kx
__global__ void __launch_bounds__(kThreads)
    x_scatter_half(float* t_re, float* t_im, const float2* __restrict__ w, int Z,
                   int X, int Y, int Kx, long long npad, At at) {
  const int Q = Y / 4, L = Y / 2;
  LMVN_EACH(i, static_cast<long long>(Kx) * Z * Q) {
    const long long r = i / Q;  // k*Z + z
    const int q = static_cast<int>(i % Q), z = static_cast<int>(r % Z);
    const int k = static_cast<int>(r / Z), kn = k == 0 ? 0 : X - k;
    const float2* fa = w + (z * npad + at(k)) * L + 2 * q;
    const float2* fb = w + (z * npad + at(kn)) * L + 2 * q;
    float re[4], im[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 a = fa[h], b = fb[h];
      re[2 * h] = (a.x + b.x) * 0.5f;
      im[2 * h] = (a.y - b.y) * 0.5f;
      re[2 * h + 1] = (a.y + b.y) * 0.5f;
      im[2 * h + 1] = (b.x - a.x) * 0.5f;
    }
    *reinterpret_cast<float4*>(t_re + r * Y + 4 * q) = make_float4(re[0], re[1], re[2], re[3]);
    *reinterpret_cast<float4*>(t_im + r * Y + 4 * q) = make_float4(im[0], im[1], im[2], im[3]);
  }
}

// load_half_spectra's rule: Z_k = A_k + i B_k at k, Z_{X-k} = conj A_k +
// i conj B_k at X - k (the imaginary parts dropped at k = 0 and X/2), each
// at spectrum_at
__global__ void __launch_bounds__(kThreads)
    x_gather_half(float2* w, const float* __restrict__ t_re,
                  const float* __restrict__ t_im, int Z, int X, int Y, int Kx,
                  long long npad, At at) {
  const int Q = Y / 4, L = Y / 2;
  LMVN_EACH(i, static_cast<long long>(Kx) * Z * Q) {
    const long long r = i / Q;  // k*Z + z
    const int q = static_cast<int>(i % Q), z = static_cast<int>(r % Z);
    const int k = static_cast<int>(r / Z);
    const float4 re = __ldg(reinterpret_cast<const float4*>(t_re + r * Y + 4 * q));
    const bool edge = k == 0 || 2 * k == X;
    const float4 im = edge ? make_float4(0.f, 0.f, 0.f, 0.f)
                           : __ldg(reinterpret_cast<const float4*>(t_im + r * Y + 4 * q));
    *reinterpret_cast<float4*>(w + (z * npad + at(k)) * L + 2 * q) =
        make_float4(re.x - im.y, im.x + re.y, re.z - im.w, im.z + re.w);
    if (!edge)
      *reinterpret_cast<float4*>(w + (z * npad + at(X - k)) * L + 2 * q) =
          make_float4(re.x + im.y, re.y - im.x, re.z + im.w, re.w - im.z);
  }
}

// the value at x times scale (1/X) meets the pass's op, as in
// x_stage_kernel; with FORWARD its result replaces the value
template <bool FORWARD, class Op>
__global__ void __launch_bounds__(kThreads)
    x_op_kernel(float2* w, long long Z, int X, int Y, long long npad, float scale,
                const Op op) {
  const int Q = Y / 4, L = Y / 2;
  LMVN_EACH(i, Z * X * Q) {
    const long long r = i / Q;  // z*X + x
    const int q = static_cast<int>(i % Q), x = static_cast<int>(r % X);
    float4* at = reinterpret_cast<float4*>(w + ((r / X) * npad + x) * L + 2 * q);
    const size_t vi = static_cast<size_t>(r) * Y + 4 * q;
    const typename Op::In in = op.load(vi);
    const float4 v = *at;
    const float4 res = op.apply(
        in, make_float4(v.x * scale, v.y * scale, v.z * scale, v.w * scale), vi);
    if (FORWARD) *at = res;
  }
}

// ------------------------------------------------------------ y stage
// w (groups, npad, kYLongRows): row g = group*kYLongRows + r, rows past
// valid zero.  The spectral side holds frequency split_freq(j) at j.

template <bool INV, class In>
__global__ void __launch_bounds__(kThreads)
    y_gather(float2* w, const In* __restrict__ i_re, const In* __restrict__ i_im,
             int Y, long long groups, long long valid, long long npad, At at,
             int R, int M) {
  constexpr int L = kYLongRows;
  LMVN_EACH(i, groups * L * Y) {
    const int r = static_cast<int>(i % L), j = static_cast<int>((i / L) % Y);
    const long long grp = i / L / Y, g = grp * L + r;
    float2 v = make_float2(0.f, 0.f);
    if (g < valid) v = make_float2(ld_one(i_re + g * Y + j), ld_one(i_im + g * Y + j));
    const long long e = INV ? at(split_freq(j, R, M)) : j;
    w[(grp * npad + e) * L + r] = v;
  }
}

// Forward: frequency split_freq(j) into column j, the pad rows (g >= valid)
// zero.  Inverse: y times scale (1/Y) into column y of the valid rows.
template <bool INV, class Out>
__global__ void __launch_bounds__(kThreads)
    y_scatter(Out* o_re, Out* o_im, const float2* __restrict__ w, int Y,
              long long rows, long long valid, long long npad, At at, int R,
              int M, float scale) {
  constexpr int L = kYLongRows;
  LMVN_EACH(i, rows * Y) {
    const int j = static_cast<int>(i % Y);
    const long long g = i / Y;
    float2 v = make_float2(0.f, 0.f);
    if (g < valid) {
      const long long e = INV ? j : at(split_freq(j, R, M));
      v = w[((g / L) * npad + e) * L + g % L];
      if (INV) v = make_float2(v.x * scale, v.y * scale);
    }
    st_one(o_re + i, v.x);
    st_one(o_im + i, v.y);
  }
}

// ------------------------------------------------------------ z stage
// w (Kx, npad, Y): column c of slice k, value z.  The spectral side holds
// frequency split_freq(j) in row j.

template <class S>
__global__ void __launch_bounds__(kThreads)
    z_gather(float2* w, const S* u_re, const S* u_im, int Z, int Y, long long Kx,
             long long npad) {
  LMVN_EACH(i, Kx * Z * Y) {
    const long long c = i % Y, r = i / Y;  // k*Z + z
    w[((r / Z) * npad + r % Z) * Y + c] = make_float2(ld_one(u_re + i), ld_one(u_im + i));
  }
}

template <class S>
__global__ void __launch_bounds__(kThreads)
    z_kmul(float2* w, const S* __restrict__ k_re, const S* __restrict__ k_im,
           float ksign, int Z, int Y, long long Kx, long long npad, At at, int R,
           int M) {
  LMVN_EACH(i, Kx * Z * Y) {
    const long long c = i % Y, r = i / Y;
    const int j = static_cast<int>(r % Z);
    float2* v = w + ((r / Z) * npad + at(split_freq(j, R, M))) * Y + c;
    *v = cmul(*v, make_float2(ld_one(k_re + i), ksign * ld_one(k_im + i)));
  }
}

// FWD_ONLY: frequency split_freq(j) into row j; else z times scale (1/Z)
// into row z.  Pad slices k >= Kx zero.
template <bool FWD_ONLY, class S>
__global__ void __launch_bounds__(kThreads)
    z_scatter(S* o_re, S* o_im, const float2* __restrict__ w, int Z, int Y,
              long long Kx, long long Kxp, long long npad, At at, int R, int M,
              float scale) {
  LMVN_EACH(i, Kxp * Z * Y) {
    const long long c = i % Y, r = i / Y, k = r / Z;
    const int j = static_cast<int>(r % Z);
    float2 v = make_float2(0.f, 0.f);
    if (k < Kx) {
      v = w[(k * npad + (FWD_ONLY ? at(split_freq(j, R, M)) : j)) * Y + c];
      if (!FWD_ONLY) v = make_float2(v.x * scale, v.y * scale);
    }
    st_one(o_re + i, v.x);
    st_one(o_im + i, v.y);
  }
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// ------------------------------------------------------------ stages

int x_forward_long(float* t_re, float* t_im, const float* xt, const LmvnAxis& a,
                   int Z, int Y, int Kx, float2* w, cudaStream_t s) {
  const long long np = npad(a);
  const int X = a.f.n;
  x_gather_real<<<grid(static_cast<long long>(Z) * X * (Y / 4)), kThreads, 0, s>>>(
      w, xt, Z, X, Y, np);
  int err = last_error();
  if (!err) err = long_fft<false>(w, a, Z, Y / 2, s);
  if (err) return err;
  x_scatter_half<<<grid(static_cast<long long>(Kx) * Z * (Y / 4)), kThreads, 0, s>>>(
      t_re, t_im, w, Z, X, Y, Kx, np, spectrum_at(a));
  return last_error();
}

template <bool FORWARD, class Op>
int x_stage_long(float* t_re, float* t_im, const LmvnAxis& a, int Z, int Y,
                 int Kx, const Op& op, float2* w, cudaStream_t s) {
  const long long np = npad(a);
  const int X = a.f.n;
  const At at = spectrum_at(a);
  const long long half = static_cast<long long>(Kx) * Z * (Y / 4);
  const long long vol = static_cast<long long>(Z) * X * (Y / 4);
  x_gather_half<<<grid(half), kThreads, 0, s>>>(w, t_re, t_im, Z, X, Y, Kx, np, at);
  int err = last_error();
  if (!err) err = long_fft<true>(w, a, Z, Y / 2, s);
  if (err) return err;
  x_op_kernel<FORWARD, Op><<<grid(vol), kThreads, 0, s>>>(
      w, Z, X, Y, np, 1.0f / static_cast<float>(X), op);
  err = last_error();
  if (!FORWARD || err) return err;
  err = long_fft<false>(w, a, Z, Y / 2, s);
  if (err) return err;
  x_scatter_half<<<grid(half), kThreads, 0, s>>>(t_re, t_im, w, Z, X, Y, Kx, np, at);
  return last_error();
}

template <bool INV, class Out, class In>
int y_stage_long(Out* o_re, Out* o_im, const In* i_re, const In* i_im,
                 const LmvnAxis& a, int rows, int valid, int R, int M,
                 float2* w, cudaStream_t s) {
  const long long np = npad(a);
  const int Y = a.f.n;
  const At at = spectrum_at(a);
  const long long groups = (valid + kYLongRows - 1) / kYLongRows;
  y_gather<INV, In><<<grid(groups * kYLongRows * Y), kThreads, 0, s>>>(
      w, i_re, i_im, Y, groups, valid, np, at, R, M);
  int err = last_error();
  if (!err) err = long_fft<INV>(w, a, groups, kYLongRows, s);
  if (err) return err;
  const long long out_rows = INV ? valid : rows;
  y_scatter<INV, Out><<<grid(out_rows * Y), kThreads, 0, s>>>(
      o_re, o_im, w, Y, out_rows, valid, np, at, R, M,
      INV ? 1.0f / static_cast<float>(Y) : 1.0f);
  return last_error();
}

template <bool FWD_ONLY, class S>
int z_stage_long(S* o_re, S* o_im, const S* u_re, const S* u_im, const S* k_re,
                 const S* k_im, bool conj_k, const LmvnAxis& a, int Y, int Kx,
                 int Kxp, int R, int M, float2* w, cudaStream_t s) {
  const long long np = npad(a);
  const int Z = a.f.n;
  const At at = spectrum_at(a);
  const long long values = static_cast<long long>(Kx) * Z * Y;
  z_gather<S><<<grid(values), kThreads, 0, s>>>(w, u_re, u_im, Z, Y, Kx, np);
  int err = last_error();
  if (!err) err = long_fft<false>(w, a, Kx, Y, s);
  if (!err && !FWD_ONLY) {
    z_kmul<S><<<grid(values), kThreads, 0, s>>>(w, k_re, k_im, conj_k ? -1.f : 1.f, Z,
                                                 Y, Kx, np, at, R, M);
    err = last_error();
    if (!err) err = long_fft<true>(w, a, Kx, Y, s);
  }
  if (err) return err;
  z_scatter<FWD_ONLY, S><<<grid(static_cast<long long>(Kxp) * Z * Y), kThreads, 0, s>>>(
      o_re, o_im, w, Z, Y, Kx, Kxp, np, at, R, M,
      FWD_ONLY ? 1.0f : 1.0f / static_cast<float>(Z));
  return last_error();
}

// the instantiations the passes of fused.cu call
template int x_stage_long<false, StoreOp>(float*, float*, const LmvnAxis&, int, int, int,
                                          const StoreOp&, float2*, cudaStream_t);
template int x_stage_long<true, QuotientOp>(float*, float*, const LmvnAxis&, int, int, int,
                                            const QuotientOp&, float2*, cudaStream_t);
template int x_stage_long<false, RlUpdateOp>(float*, float*, const LmvnAxis&, int, int, int,
                                             const RlUpdateOp&, float2*, cudaStream_t);
template int x_stage_long<true, RlUpdateOp>(float*, float*, const LmvnAxis&, int, int, int,
                                            const RlUpdateOp&, float2*, cudaStream_t);
#define LMVN_Y_LONG(INV, OUT, IN)                                                    \
  template int y_stage_long<INV, OUT, IN>(OUT*, OUT*, const IN*, const IN*,          \
                                          const LmvnAxis&, int, int, int, int, float2*, \
                                          cudaStream_t);
LMVN_Y_LONG(false, float, float)
LMVN_Y_LONG(false, __nv_bfloat16, float)
LMVN_Y_LONG(true, float, float)
LMVN_Y_LONG(true, float, __nv_bfloat16)
#define LMVN_Z_LONG(FWD_ONLY, S)                                                         \
  template int z_stage_long<FWD_ONLY, S>(S*, S*, const S*, const S*, const S*, const S*, \
                                         bool, const LmvnAxis&, int, int, int, int, int,  \
                                         float2*, cudaStream_t);
LMVN_Z_LONG(false, float)
LMVN_Z_LONG(true, float)
LMVN_Z_LONG(false, __nv_bfloat16)
LMVN_Z_LONG(true, __nv_bfloat16)

}  // namespace lmvn_fft
