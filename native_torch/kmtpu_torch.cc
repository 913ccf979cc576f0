/*
 * libKMTPU C ABI over the PyTorch/CUDA port (kmcuda_torch).
 *
 * The same exported symbols as native/kmtpu.cc, declared by the same
 * header (native/include/kmtpu.h): kmcuda's kmeans_cuda/knn_cuda
 * prototypes and the device-handle protocol (kmtpu_upload,
 * kmtpu_kmeans_device, kmtpu_knn_device, kmtpu_handle_shape, kmtpu_fetch,
 * kmtpu_release).  The library embeds one CPython interpreter per process,
 * imports kmcuda_torch.capi and forwards raw host pointers and handles to
 * it; the Python side wraps the pointers zero-copy with numpy and runs the
 * public API on the CUDA card (or on the CPU under KMTPU_PLATFORM=cpu).
 * The CUDA kernels build at the first call that needs them, inside that
 * call.
 */

#include <Python.h>

#include <cstdarg>
#include <cstdio>
#include <mutex>

#include "kmtpu.h"

namespace {

std::once_flag g_init;
PyObject *g_capi = nullptr;  // kmcuda_torch.capi, owned; set under the GIL

// Starts the interpreter unless the host process already runs one, then
// releases the GIL the starting thread holds, so that a call from any
// thread can take it.
void ensure_python() {
  std::call_once(g_init, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      PyEval_SaveThread();
    }
  });
}

class GilGuard {
 public:
  GilGuard() : state_(PyGILState_Ensure()) {}
  ~GilGuard() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

// kmcuda_torch.<name>(<args built from fmt>) under the GIL; a new
// reference, or nullptr with the Python error printed.
PyObject *call(const char *name, const char *fmt, ...) {
  if (g_capi == nullptr) {
    g_capi = PyImport_ImportModule("kmcuda_torch.capi");
    if (g_capi == nullptr) {
      PyErr_Print();
      std::fprintf(stderr,
                   "kmtpu: cannot import kmcuda_torch.capi; is the "
                   "repository on PYTHONPATH?\n");
      return nullptr;
    }
  }
  va_list va;
  va_start(va, fmt);
  PyObject *args = Py_VaBuildValue(fmt, va);
  va_end(va);
  PyObject *fn = args ? PyObject_GetAttrString(g_capi, name) : nullptr;
  PyObject *res = fn ? PyObject_CallObject(fn, args) : nullptr;
  Py_XDECREF(fn);
  Py_XDECREF(args);
  if (res == nullptr) {
    PyErr_Print();
  }
  return res;
}

// The KMTPUResult of a call that returns a bare int code.
KMTPUResult code_of(PyObject *res) {
  if (res == nullptr) {
    return kmtpuRuntimeError;
  }
  long code = PyLong_AsLong(res);
  Py_DECREF(res);
  if (code == -1 && PyErr_Occurred()) {
    PyErr_Print();
    return kmtpuRuntimeError;
  }
  return static_cast<KMTPUResult>(code);
}

// Parses a result tuple into the pointers after fmt; false (error
// printed) if it does not match.  Drops the reference either way.
bool parse(PyObject *res, const char *fmt, ...) {
  if (res == nullptr) {
    return false;
  }
  va_list va;
  va_start(va, fmt);
  int ok = PyArg_VaParse(res, fmt, va);
  va_end(va);
  Py_DECREF(res);
  if (!ok) {
    PyErr_Print();
  }
  return ok != 0;
}

uint32_t afkmc2_m(KMTPUInitMethod init, const void *init_params) {
  if (init == kmtpuInitMethodAFKMC2 && init_params != nullptr) {
    return *reinterpret_cast<const uint32_t *>(init_params);
  }
  return 0;
}

unsigned long long addr(const void *p) {
  return reinterpret_cast<unsigned long long>(p);
}

// device_ptrs >= 0 would hand raw CUDA pointers to the library; the
// device-resident path of this ABI is the handle protocol.
const char kNoDevicePointers[] =
    "kmtpu: device_ptrs >= 0 is not supported; pass host pointers, or keep "
    "data on the card with kmtpu_upload and the *_device calls\n";

}  // namespace

extern "C" {

KMTPUResult kmtpu_kmeans(
    KMTPUInitMethod init, const void *init_params, float tolerance,
    float yinyang_t, KMTPUDistanceMetric metric, uint32_t samples_size,
    uint16_t features_size, uint32_t clusters_size, uint32_t seed,
    uint32_t device, int32_t device_ptrs, int32_t fp16x2, int32_t verbosity,
    const float *samples, float *centroids, uint32_t *assignments,
    float *average_distance) {
  if (device_ptrs >= 0) {
    std::fputs(kNoDevicePointers, stderr);
    return kmtpuInvalidArguments;
  }
  if (samples == nullptr || centroids == nullptr || assignments == nullptr) {
    return kmtpuInvalidArguments;
  }
  ensure_python();
  GilGuard gil;
  int code = 0;
  double avg = 0.0;
  if (!parse(call("kmeans_from_pointers", "(IIddIIIIIIiiKKKi)",
                  static_cast<unsigned int>(init),
                  static_cast<unsigned int>(afkmc2_m(init, init_params)),
                  static_cast<double>(tolerance),
                  static_cast<double>(yinyang_t),
                  static_cast<unsigned int>(metric), samples_size,
                  static_cast<unsigned int>(features_size), clusters_size,
                  seed, device, static_cast<int>(fp16x2),
                  static_cast<int>(verbosity), addr(samples), addr(centroids),
                  addr(assignments), average_distance != nullptr ? 1 : 0),
             "id", &code, &avg)) {
    return kmtpuRuntimeError;
  }
  if (average_distance != nullptr && code == 0) {
    *average_distance = static_cast<float>(avg);
  }
  return static_cast<KMTPUResult>(code);
}

KMTPUResult kmtpu_knn(
    uint16_t k, KMTPUDistanceMetric metric, uint32_t samples_size,
    uint16_t features_size, uint32_t clusters_size, uint32_t device,
    int32_t device_ptrs, int32_t fp16x2, int32_t verbosity,
    const float *samples, const float *centroids,
    const uint32_t *assignments, uint32_t *neighbors) {
  if (device_ptrs >= 0) {
    std::fputs(kNoDevicePointers, stderr);
    return kmtpuInvalidArguments;
  }
  if (samples == nullptr || centroids == nullptr || assignments == nullptr ||
      neighbors == nullptr) {
    return kmtpuInvalidArguments;
  }
  ensure_python();
  GilGuard gil;
  return code_of(call("knn_from_pointers", "(IIIIIIiiKKKK)",
                      static_cast<unsigned int>(k),
                      static_cast<unsigned int>(metric), samples_size,
                      static_cast<unsigned int>(features_size),
                      clusters_size, device, static_cast<int>(fp16x2),
                      static_cast<int>(verbosity), addr(samples),
                      addr(centroids), addr(assignments), addr(neighbors)));
}

/* ---- device-handle protocol (see kmtpu.h) ------------------------- */

KMTPUResult kmtpu_upload(const void *data, uint32_t rows, uint32_t cols,
                         int32_t fp16x2, KMTPUHandle *handle) {
  if (data == nullptr || handle == nullptr || rows == 0 || cols == 0) {
    return kmtpuInvalidArguments;
  }
  ensure_python();
  GilGuard gil;
  int code = 0;
  long long h = 0;
  if (!parse(call("upload_from_pointer", "(KIIi)", addr(data), rows, cols,
                  static_cast<int>(fp16x2)),
             "iL", &code, &h)) {
    return kmtpuRuntimeError;
  }
  if (code == 0) {
    *handle = static_cast<KMTPUHandle>(h);
  }
  return static_cast<KMTPUResult>(code);
}

KMTPUResult kmtpu_handle_shape(KMTPUHandle handle, uint32_t *rows,
                               uint32_t *cols, uint32_t *itemsize) {
  ensure_python();
  GilGuard gil;
  int code = 0;
  unsigned int r = 0, c = 0, isz = 0;
  if (!parse(call("handle_shape", "(L)", static_cast<long long>(handle)),
             "iIII", &code, &r, &c, &isz)) {
    return kmtpuRuntimeError;
  }
  if (code == 0) {
    if (rows != nullptr) *rows = r;
    if (cols != nullptr) *cols = c;
    if (itemsize != nullptr) *itemsize = isz;
  }
  return static_cast<KMTPUResult>(code);
}

KMTPUResult kmtpu_fetch(KMTPUHandle handle, void *dst, uint64_t dst_size) {
  if (dst == nullptr) {
    return kmtpuInvalidArguments;
  }
  ensure_python();
  GilGuard gil;
  return code_of(call("fetch_to_pointer", "(LKK)",
                      static_cast<long long>(handle), addr(dst),
                      static_cast<unsigned long long>(dst_size)));
}

KMTPUResult kmtpu_release(KMTPUHandle handle) {
  ensure_python();
  GilGuard gil;
  return code_of(
      call("release_handle", "(L)", static_cast<long long>(handle)));
}

KMTPUResult kmtpu_kmeans_device(
    KMTPUInitMethod init, const void *init_params, float tolerance,
    float yinyang_t, KMTPUDistanceMetric metric, uint32_t clusters_size,
    uint32_t seed, uint32_t device, int32_t verbosity,
    KMTPUHandle samples, KMTPUHandle import_centroids,
    KMTPUHandle *centroids, KMTPUHandle *assignments,
    float *average_distance) {
  if (centroids == nullptr || assignments == nullptr || samples == 0) {
    return kmtpuInvalidArguments;
  }
  ensure_python();
  GilGuard gil;
  int code = 0;
  long long hc = 0, ha = 0;
  double avg = 0.0;
  if (!parse(call("kmeans_from_handles", "(IIddIIIIiLLi)",
                  static_cast<unsigned int>(init),
                  static_cast<unsigned int>(afkmc2_m(init, init_params)),
                  static_cast<double>(tolerance),
                  static_cast<double>(yinyang_t),
                  static_cast<unsigned int>(metric), clusters_size, seed,
                  device, static_cast<int>(verbosity),
                  static_cast<long long>(samples),
                  static_cast<long long>(import_centroids),
                  average_distance != nullptr ? 1 : 0),
             "iLLd", &code, &hc, &ha, &avg)) {
    return kmtpuRuntimeError;
  }
  if (code == 0) {
    *centroids = static_cast<KMTPUHandle>(hc);
    *assignments = static_cast<KMTPUHandle>(ha);
    if (average_distance != nullptr) {
      *average_distance = static_cast<float>(avg);
    }
  }
  return static_cast<KMTPUResult>(code);
}

KMTPUResult kmtpu_knn_device(
    uint16_t k, KMTPUDistanceMetric metric, uint32_t device,
    int32_t verbosity, KMTPUHandle samples, KMTPUHandle centroids,
    KMTPUHandle assignments, KMTPUHandle *neighbors) {
  if (neighbors == nullptr) {
    return kmtpuInvalidArguments;
  }
  ensure_python();
  GilGuard gil;
  int code = 0;
  long long hn = 0;
  if (!parse(call("knn_from_handles", "(IIIiLLL)",
                  static_cast<unsigned int>(k),
                  static_cast<unsigned int>(metric), device,
                  static_cast<int>(verbosity),
                  static_cast<long long>(samples),
                  static_cast<long long>(centroids),
                  static_cast<long long>(assignments)),
             "iL", &code, &hn)) {
    return kmtpuRuntimeError;
  }
  if (code == 0) {
    *neighbors = static_cast<KMTPUHandle>(hn);
  }
  return static_cast<KMTPUResult>(code);
}

/* kmcuda-compatible aliases */
KMTPUResult kmeans_cuda(
    KMTPUInitMethod init, const void *init_params, float tolerance,
    float yinyang_t, KMTPUDistanceMetric metric, uint32_t samples_size,
    uint16_t features_size, uint32_t clusters_size, uint32_t seed,
    uint32_t device, int32_t device_ptrs, int32_t fp16x2, int32_t verbosity,
    const float *samples, float *centroids, uint32_t *assignments,
    float *average_distance) {
  return kmtpu_kmeans(init, init_params, tolerance, yinyang_t, metric,
                      samples_size, features_size, clusters_size, seed,
                      device, device_ptrs, fp16x2, verbosity, samples,
                      centroids, assignments, average_distance);
}

KMTPUResult knn_cuda(
    uint16_t k, KMTPUDistanceMetric metric, uint32_t samples_size,
    uint16_t features_size, uint32_t clusters_size, uint32_t device,
    int32_t device_ptrs, int32_t fp16x2, int32_t verbosity,
    const float *samples, const float *centroids,
    const uint32_t *assignments, uint32_t *neighbors) {
  return kmtpu_knn(k, metric, samples_size, features_size, clusters_size,
                   device, device_ptrs, fp16x2, verbosity, samples,
                   centroids, assignments, neighbors);
}

}  // extern "C"
