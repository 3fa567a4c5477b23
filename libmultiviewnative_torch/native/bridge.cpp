/* bridge.cpp — the C ABI of libmultiviewnative_torch (libmultiviewnative_torch.so).
 *
 * The port's counterpart of native/src/bridge.cpp.  The reference
 * implements its C ABI with FFTW/cuFFT C++ underneath; this library keeps
 * the same ABI (multiviewnative_tpu.h beside this file) but hosts an
 * embedded CPython interpreter that runs the PyTorch engine: this file
 * handles interpreter lifecycle, GIL discipline, zero-copy address
 * marshaling and the device of each symbol;
 * libmultiviewnative_torch/native_entry.py wraps the raw pointers as numpy
 * arrays (in place) and dispatches into the flat API on that device.
 *
 * Devices: the cpu-named symbols name "cpu"; the GPU-named ones and the
 * single-step helpers name "cuda:<device>".  Where that card does not
 * exist, native_entry raises before touching a buffer: the error is
 * recorded and every buffer is left as it was.  Nothing falls back to the
 * CPU.
 *
 * Loading: inside a Python process (ctypes) the interpreter's symbols come
 * from the process, and the running interpreter is reused.  A pure C host
 * (a JVM through JNA) links libpython, and the first call starts an
 * interpreter.
 *
 * Threading: every entry point is safe to call from arbitrary native
 * threads (PyGILState_Ensure).  torch's current CUDA device is per thread,
 * so the device is always named explicitly.  Errors never cross the ABI:
 * they are recorded for mvn_tpu_last_error() and printed to stderr, and
 * outputs are left untouched (the reference's error style is exit(); this
 * keeps the host JVM alive).
 */

#include "multiviewnative_tpu.h"

#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>

namespace {

std::mutex g_init_mutex;
bool g_we_initialized = false;
std::mutex g_error_mutex;
std::string g_last_error;
/* stable buffer returned by mvn_tpu_last_error (the std::string may be
 * reallocated by a concurrent writer; callers get a snapshot) */
char g_error_snapshot[1024];

void set_last_error(const std::string& msg) {
  {
    std::lock_guard<std::mutex> lock(g_error_mutex);
    g_last_error = msg;
  }
  std::fprintf(stderr, "[multiviewnative_torch] %s\n", msg.c_str());
}

/* Ensure an interpreter exists.  If this library is loaded INTO a Python
 * process (ctypes), reuse it; otherwise (JNA/JVM host) start one.  Returns
 * 0 on success. */
int ensure_python() {
  std::lock_guard<std::mutex> lock(g_init_mutex);
  if (Py_IsInitialized()) return 0;
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  PyStatus status = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (PyStatus_Exception(status)) {
    set_last_error("failed to initialize embedded Python");
    return -1;
  }
  g_we_initialized = true;
  /* Release the GIL acquired by Py_Initialize so worker threads can take
   * it via PyGILState_Ensure. */
  PyEval_SaveThread();
  return 0;
}

/* RAII GIL holder for arbitrary native threads. */
class GilGuard {
 public:
  GilGuard() : state_(PyGILState_Ensure()) {}
  ~GilGuard() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

void record_py_error(const char* where) {
  PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
  PyErr_Fetch(&type, &value, &trace);
  std::string msg = std::string(where) + ": python error";
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      const char* utf8 = PyUnicode_AsUTF8(s);
      if (utf8) {
        msg += ": ";
        msg += utf8;
      } else {
        PyErr_Clear(); /* conversion failure must not clobber the original */
        msg += ": <unprintable exception>";
      }
      Py_DECREF(s);
    } else {
      PyErr_Clear();
    }
  }
  set_last_error(msg);
  PyErr_Restore(type, value, trace);
  PyErr_Print();
}

/* Call libmultiviewnative_torch.native_entry.<fn>(*args).  Steals the args
 * reference (which may be null after a failed build: the error is then
 * recorded).  Returns the result object (new ref) or nullptr. */
PyObject* call_entry(const char* fn, PyObject* args) {
  if (!args) {
    record_py_error(fn);
    return nullptr;
  }
  PyObject* mod = PyImport_ImportModule("libmultiviewnative_torch.native_entry");
  if (!mod) {
    record_py_error("import libmultiviewnative_torch.native_entry");
    Py_DECREF(args);
    return nullptr;
  }
  PyObject* f = PyObject_GetAttrString(mod, fn);
  Py_DECREF(mod);
  if (!f) {
    record_py_error(fn);
    Py_DECREF(args);
    return nullptr;
  }
  PyObject* res = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_DECREF(args);
  if (!res) record_py_error(fn);
  return res;
}

/* Call and drop the result (the entry points that write into buffers). */
void run_entry(const char* fn, PyObject* args) { Py_XDECREF(call_entry(fn, args)); }

PyObject* dims_tuple(const int* dims) {
  return Py_BuildValue("(iii)", dims[0], dims[1], dims[2]);
}

/* The device argument of native_entry: "cpu", or "cuda:<device>". */
PyObject* cpu_device() { return PyUnicode_FromString("cpu"); }
PyObject* cuda_device(int device) { return PyUnicode_FromFormat("cuda:%d", device); }

inline unsigned long long addr(const void* p) {
  return (unsigned long long)(uintptr_t)p;
}

/* Query returning a Python int (0 on error, with the error recorded). */
long long query_int(const char* fn, PyObject* args) {
  PyObject* res = call_entry(fn, args);
  long long n = res ? PyLong_AsLongLong(res) : 0;
  if (res && n == -1 && PyErr_Occurred()) {
    record_py_error(fn);
    n = 0;
  }
  Py_XDECREF(res);
  return n;
}

void deconvolve_on(const char* where, imageType* psi, const struct workspace& input,
                   PyObject* device) {
  if (!psi || input.num_views_ == 0 || input.data_ == nullptr) {
    set_last_error(std::string(where) + ": empty workspace");
    Py_XDECREF(device);
    return;
  }
  PyObject* views = PyList_New(input.num_views_);
  if (!views) {
    Py_XDECREF(device);
    record_py_error(where);
    return;
  }
  for (int v = 0; v < input.num_views_; ++v) {
    const view_data& d = input.data_[v];
    PyObject* item = Py_BuildValue(
        "(KNKNKNKN)", addr(d.image_), dims_tuple(d.image_dims_),
        addr(d.kernel1_), dims_tuple(d.kernel1_dims_), addr(d.kernel2_),
        dims_tuple(d.kernel2_dims_), addr(d.weights_),
        dims_tuple(d.weights_dims_));
    if (!item) {
      Py_DECREF(views);
      Py_XDECREF(device);
      record_py_error(where);
      return;
    }
    PyList_SET_ITEM(views, v, item);
  }
  /* psi shares the first view's image dims (reference semantics,
   * src/multiviewnative.cpp:180). */
  run_entry("inplace_deconvolve",
            Py_BuildValue("(KNNdfiN)", addr(psi), dims_tuple(input.data_[0].image_dims_),
                          views, input.lambda_, (double)input.minValue_,
                          input.num_iterations_, device));
}

void convolution_on(const char* where, imageType* im, int* imDim, imageType* kernel,
                    int* kernelDim, PyObject* device) {
  if (!im || !imDim || !kernel || !kernelDim) {
    set_last_error(std::string(where) + ": null argument");
    Py_XDECREF(device);
    return;
  }
  run_entry("inplace_convolution", Py_BuildValue("(KNKNN)", addr(im), dims_tuple(imDim),
                                                 addr(kernel), dims_tuple(kernelDim), device));
}

/* The card's own compute capability, major (which 0) or minor (which 1)
 * (the reference returns the CUDA properties, inc/cuda_helpers.cuh:70-82);
 * 0 with the error recorded where the card does not exist. */
int capability(int device, int which) {
  if (ensure_python()) return 0;
  GilGuard gil;
  PyObject* res = call_entry("get_compute_capability", Py_BuildValue("(i)", device));
  if (!res) return 0;
  int major = 0, minor = 0;
  if (!PyArg_ParseTuple(res, "ii", &major, &minor)) {
    record_py_error("getCUDAcomputeCapability");
  }
  Py_DECREF(res);
  return which ? minor : major;
}

}  // namespace

extern "C" {

int mvn_tpu_initialize(void) { return ensure_python(); }

void mvn_tpu_finalize(void) {
  std::lock_guard<std::mutex> lock(g_init_mutex);
  if (g_we_initialized && Py_IsInitialized()) {
    PyGILState_Ensure();
    Py_Finalize();
    g_we_initialized = false;
  }
}

const char* mvn_tpu_last_error(void) {
  std::lock_guard<std::mutex> lock(g_error_mutex);
  std::snprintf(g_error_snapshot, sizeof(g_error_snapshot), "%s", g_last_error.c_str());
  return g_error_snapshot;
}

void inplace_cpu_deconvolve(imageType* psi, struct workspace input, int nthreads) {
  (void)nthreads;
  if (ensure_python()) return;
  GilGuard gil;
  deconvolve_on("inplace_cpu_deconvolve", psi, input, cpu_device());
}

void inplace_gpu_deconvolve(imageType* psi, struct workspace input, int device) {
  if (ensure_python()) return;
  GilGuard gil;
  deconvolve_on("inplace_gpu_deconvolve", psi, input, cuda_device(device));
}

void inplace_cpu_convolution(imageType* im, int* imDim, imageType* kernel, int* kernelDim,
                             int nthreads) {
  (void)nthreads;
  if (ensure_python()) return;
  GilGuard gil;
  convolution_on("inplace_cpu_convolution", im, imDim, kernel, kernelDim, cpu_device());
}

void inplace_gpu_convolution(imageType* im, int* imDim, imageType* kernel, int* kernelDim,
                             int device) {
  if (ensure_python()) return;
  GilGuard gil;
  convolution_on("inplace_gpu_convolution", im, imDim, kernel, kernelDim, cuda_device(device));
}

void convolution3DfftCUDAInPlace(imageType* im, int* imDim, imageType* kernel, int* kernelDim,
                                 int devCUDA) {
  /* legacy Fiji entry point (reference src/multiviewnative.cu:199-238) */
  if (ensure_python()) return;
  GilGuard gil;
  convolution_on("convolution3DfftCUDAInPlace", im, imDim, kernel, kernelDim,
                 cuda_device(devCUDA));
}

void convolution3DfftCUDAInPlace_core(imageType* im, int* imDim, imageType* kernel,
                                      int* kernelDim, int devCUDA) {
  if (ensure_python()) return;
  GilGuard gil;
  convolution_on("convolution3DfftCUDAInPlace_core", im, imDim, kernel, kernelDim,
                 cuda_device(devCUDA));
}

void compute_quotient(imageType* input, imageType* output, size_t size, int device) {
  if (!input || !output) {
    set_last_error("compute_quotient: null argument");
    return;
  }
  if (ensure_python()) return;
  GilGuard gil;
  run_entry("compute_quotient", Py_BuildValue("(KKKN)", addr(input), addr(output),
                                              (unsigned long long)size, cuda_device(device)));
}

void compute_final_values(imageType* image, imageType* integral, imageType* weight,
                          size_t size, float minValue, double lambda, int device) {
  if (!image || !integral || !weight) {
    set_last_error("compute_final_values: null argument");
    return;
  }
  if (ensure_python()) return;
  GilGuard gil;
  run_entry("compute_final_values",
            Py_BuildValue("(KKKKfdN)", addr(image), addr(integral), addr(weight),
                          (unsigned long long)size, (double)minValue, lambda,
                          cuda_device(device)));
}

void iterate_fft_plain(imageType* input, imageType* kernel, imageType* output, int* input_dims,
                       int* kernel_dims, int device) {
  if (!input || !kernel || !output || !input_dims || !kernel_dims) {
    set_last_error("iterate_fft_plain: null argument");
    return;
  }
  if (ensure_python()) return;
  GilGuard gil;
  run_entry("iterate_fft_plain",
            Py_BuildValue("(KKKNNN)", addr(input), addr(kernel), addr(output),
                          dims_tuple(input_dims), dims_tuple(kernel_dims), cuda_device(device)));
}

void iterate_fft_tikhonov(imageType* input, imageType* kernel, imageType* output,
                          int* input_dims, int* kernel_dims, size_t size, float minValue,
                          double lambda, int device) {
  (void)size;
  if (!input || !kernel || !output || !input_dims || !kernel_dims) {
    set_last_error("iterate_fft_tikhonov: null argument");
    return;
  }
  if (ensure_python()) return;
  GilGuard gil;
  run_entry("iterate_fft_tikhonov",
            Py_BuildValue("(KKKNNfdN)", addr(input), addr(kernel), addr(output),
                          dims_tuple(input_dims), dims_tuple(kernel_dims), (double)minValue,
                          lambda, cuda_device(device)));
}

int getNumDevicesCUDA(void) {
  if (ensure_python()) return 0;
  GilGuard gil;
  return (int)query_int("get_num_devices", PyTuple_New(0));
}

void getNameDeviceCUDA(int device, char* name) {
  if (!name) return;
  name[0] = '\0';
  if (ensure_python()) return;
  GilGuard gil;
  PyObject* res = call_entry("get_device_name", Py_BuildValue("(i)", device));
  if (res) {
    const char* s = PyUnicode_AsUTF8(res);
    if (s) {
      std::strncpy(name, s, 255);
      name[255] = '\0';
    } else {
      record_py_error("getNameDeviceCUDA");
    }
    Py_DECREF(res);
  }
}

long long int getMemDeviceCUDA(int device) {
  if (ensure_python()) return 0;
  GilGuard gil;
  return query_int("get_device_mem", Py_BuildValue("(i)", device));
}

int selectDeviceWithHighestComputeCapability(void) {
  if (ensure_python()) return 0;
  GilGuard gil;
  return (int)query_int("select_device", PyTuple_New(0));
}

int getCUDAcomputeCapabilityMajorVersion(int device) { return capability(device, 0); }
int getCUDAcomputeCapabilityMinorVersion(int device) { return capability(device, 1); }

} /* extern "C" */
