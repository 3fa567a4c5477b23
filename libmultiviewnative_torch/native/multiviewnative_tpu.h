/* multiviewnative_tpu.h — C ABI for JNA/Fiji-style clients, as built by
 * libmultiviewnative_torch (libmultiviewnative_torch.so).
 *
 * The port's own copy of native/include/multiviewnative_tpu.h: the same
 * declarations, so that a host application switches between the JAX build
 * and this one by swapping the shared library.  Both match the reference
 * library's public surface (inc/multiviewnative.h:15-109): identical struct
 * layouts and function names.  The implementation (bridge.cpp beside this
 * file) hosts an embedded CPython interpreter and dispatches into
 * libmultiviewnative_torch.native_entry; psi/image buffers are mutated in
 * place exactly as the reference contract requires.
 *
 * Devices: the cpu-named entry points run on the CPU; the GPU-named ones
 * (and the single-step helpers) on CUDA device `device`.  Where that card
 * does not exist they record an error for mvn_tpu_last_error() and leave
 * every buffer untouched.
 *
 * Dims arrays are int[3] in (z, y, x) C order, matching the reference's
 * image_stack convention (inc/image_stack_utils.h:10-21).
 */
#ifndef MULTIVIEWNATIVE_TPU_H
#define MULTIVIEWNATIVE_TPU_H

#include <stddef.h>

typedef float imageType;

#ifdef __cplusplus
#define MVN_API extern "C"
#else
#define MVN_API
#endif

struct view_data {
  imageType* image_;
  imageType* kernel1_;
  imageType* kernel2_;
  imageType* weights_;

  int* image_dims_;
  int* kernel1_dims_;
  int* kernel2_dims_;
  int* weights_dims_;
};

struct workspace {
  struct view_data* data_;
  unsigned short num_views_;
  double lambda_;
  float minValue_;
  int num_iterations_;
};

/* full multi-view RL deconvolution; psi is read as the start estimate and
 * overwritten with the result.  nthreads is accepted for ABI parity and
 * ignored (PyTorch owns its CPU threads). */
MVN_API void inplace_cpu_deconvolve(imageType* psi, struct workspace input,
                                    int nthreads);

/* single 3D FFT convolution, image overwritten (circular boundary). */
MVN_API void inplace_cpu_convolution(imageType* im, int* imDim,
                                     imageType* kernel, int* kernelDim,
                                     int nthreads);

/* GPU-named entry points: the same operations on CUDA device `device`. */
MVN_API void inplace_gpu_deconvolve(imageType* psi, struct workspace input,
                                    int device);
MVN_API void inplace_gpu_convolution(imageType* im, int* imDim,
                                     imageType* kernel, int* kernelDim,
                                     int device);
MVN_API void convolution3DfftCUDAInPlace(imageType* im, int* imDim,
                                         imageType* kernel, int* kernelDim,
                                         int devCUDA);
/* _core variant of the legacy path (reference .h:79-84 operates on
 * device-resident pointers; here every pointer is a host pointer, so it is
 * the same operation). */
MVN_API void convolution3DfftCUDAInPlace_core(imageType* im, int* imDim,
                                              imageType* kernel,
                                              int* kernelDim, int devCUDA);

/* single-step helpers (reference .h:84-97), on CUDA device `device` */
MVN_API void compute_quotient(imageType* input, imageType* output, size_t size,
                              int device);
MVN_API void compute_final_values(imageType* image, imageType* integral,
                                  imageType* weight, size_t size,
                                  float minValue, double lambda, int device);
MVN_API void iterate_fft_plain(imageType* input, imageType* kernel,
                               imageType* output, int* input_dims,
                               int* kernel_dims, int device);
MVN_API void iterate_fft_tikhonov(imageType* input, imageType* kernel,
                                  imageType* output, int* input_dims,
                                  int* kernel_dims, size_t size,
                                  float minValue, double lambda, int device);

/* device queries (reference .h:99-109); no card: 0 devices */
MVN_API int selectDeviceWithHighestComputeCapability(void);
MVN_API int getNumDevicesCUDA(void);
MVN_API void getNameDeviceCUDA(int device, char* name); /* name: >=256 bytes */
MVN_API long long int getMemDeviceCUDA(int device);
MVN_API int getCUDAcomputeCapabilityMajorVersion(int device);
MVN_API int getCUDAcomputeCapabilityMinorVersion(int device);

/* Extras of both builds: explicit interpreter lifecycle for host
 * applications that want deterministic startup/teardown (optional: every
 * call above initializes lazily), and the last error recorded. */
MVN_API int mvn_tpu_initialize(void);
MVN_API void mvn_tpu_finalize(void);
MVN_API const char* mvn_tpu_last_error(void);

#endif /* MULTIVIEWNATIVE_TPU_H */
