/* abi_smoke — drives libmultiviewnative_torch.so from a pure C host (the
 * JNA scenario): the shared library must boot its own embedded interpreter,
 * run a 2-view deconvolution in place, and report device info.
 *
 * The port's copy of native/test/abi_smoke.c, with one change: with --gpu
 * it calls the GPU-named symbols (device 0) and fails if the host has no
 * card; without it, the cpu-named ones.  Since a failed call records an
 * error and leaves its buffers as they were, the smoke fails on any error
 * recorded.  Mirrors in spirit the reference's API-level smoke
 * usage (tests/test_cpu_asymm_convolve.cpp's C-ABI calls).  Run with
 * PYTHONPATH pointing at the repo root (and at torch's site-packages when
 * the embedded interpreter would not find them).
 */
#include "multiviewnative_tpu.h"

#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define N 8
#define K 3
#define VOL (N * N * N)
#define KVOL (K * K * K)

static void fill_gaussian(float* k) {
  double s = 0.0;
  for (int z = 0; z < K; ++z)
    for (int y = 0; y < K; ++y)
      for (int x = 0; x < K; ++x) {
        double r2 = (z - 1) * (z - 1) + (y - 1) * (y - 1) + (x - 1) * (x - 1);
        double v = exp(-r2 / 2.0);
        k[(z * K + y) * K + x] = (float)v;
        s += v;
      }
  for (int i = 0; i < KVOL; ++i) k[i] /= (float)s;
}

static int check_error(const char* what) {
  const char* err = mvn_tpu_last_error();
  if (err[0] != '\0') {
    fprintf(stderr, "%s recorded an error: %s\n", what, err);
    return 1;
  }
  return 0;
}

int main(int argc, char** argv) {
  int gpu = argc > 1 && strcmp(argv[1], "--gpu") == 0;
  if (mvn_tpu_initialize() != 0) {
    fprintf(stderr, "init failed: %s\n", mvn_tpu_last_error());
    return 1;
  }
  int devices = getNumDevicesCUDA();
  if (gpu) {
    if (devices == 0) {
      fprintf(stderr, "--gpu: no CUDA device\n");
      return 1;
    }
    char name[256];
    getNameDeviceCUDA(0, name);
    printf("devices=%d name=%s mem=%lld capability=%d.%d\n", devices, name,
           getMemDeviceCUDA(0), getCUDAcomputeCapabilityMajorVersion(0),
           getCUDAcomputeCapabilityMinorVersion(0));
  } else {
    printf("devices=%d\n", devices);
  }
  if (check_error("device queries")) return 1;

  int img_dims[3] = {N, N, N};
  int k_dims[3] = {K, K, K};

  static float images[2][VOL], weights[2][VOL], k1[2][KVOL], k2[2][KVOL];
  static float psi[VOL];
  for (int v = 0; v < 2; ++v) {
    fill_gaussian(k1[v]);
    for (int i = 0; i < KVOL; ++i) k2[v][i] = k1[v][KVOL - 1 - i];
    for (int i = 0; i < VOL; ++i) {
      images[v][i] = 100.0f + (float)((i * 7 + v * 13) % 50);
      weights[v][i] = 0.5f;
    }
  }
  for (int i = 0; i < VOL; ++i) psi[i] = 100.0f;

  struct view_data views[2];
  for (int v = 0; v < 2; ++v) {
    views[v].image_ = images[v];
    views[v].kernel1_ = k1[v];
    views[v].kernel2_ = k2[v];
    views[v].weights_ = weights[v];
    views[v].image_dims_ = img_dims;
    views[v].kernel1_dims_ = k_dims;
    views[v].kernel2_dims_ = k_dims;
    views[v].weights_dims_ = img_dims;
  }
  struct workspace ws;
  ws.data_ = views;
  ws.num_views_ = 2;
  ws.lambda_ = 0.006;
  ws.minValue_ = 1e-4f;
  ws.num_iterations_ = 2;

  if (gpu) {
    inplace_gpu_deconvolve(psi, ws, 0);
  } else {
    inplace_cpu_deconvolve(psi, ws, 1);
  }
  if (check_error("deconvolve")) return 1;

  double mean = 0.0;
  int finite = 1;
  for (int i = 0; i < VOL; ++i) {
    if (!isfinite((double)psi[i])) finite = 0;
    mean += psi[i];
  }
  mean /= VOL;
  printf("psi mean=%.3f finite=%d changed=%d\n", mean, finite,
         fabs(mean - 100.0) > 1e-3);

  /* single convolution with an identity kernel must be a no-op */
  static float im2[VOL];
  for (int i = 0; i < VOL; ++i) im2[i] = (float)i;
  static float ident[KVOL];
  memset(ident, 0, sizeof(ident));
  ident[13] = 1.0f; /* center of 3x3x3 */
  if (gpu) {
    inplace_gpu_convolution(im2, img_dims, ident, k_dims, 0);
  } else {
    inplace_cpu_convolution(im2, img_dims, ident, k_dims, 1);
  }
  if (check_error("convolution")) return 1;
  double err = 0.0;
  for (int i = 0; i < VOL; ++i) err += fabs(im2[i] - (double)i);
  printf("identity convolution L1 err=%.5f\n", err / VOL);

  mvn_tpu_finalize();
  printf("OK\n");
  return 0;
}
