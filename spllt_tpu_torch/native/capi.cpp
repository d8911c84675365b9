// C ABI of spllt_tpu_torch (include/spllt_tpu.h): embeds CPython and calls
// spllt_tpu_torch.capi.
//
// The solver is a Python/PyTorch package, so this library owns an embedded
// interpreter: each entry point takes the GIL, passes its raw pointers to
// Python as integers (spllt_tpu_torch/capi.py wraps them with ctypes and
// NumPy) and returns the int that the Python function returns, or -3 when
// Python raised (the traceback goes to stderr).
//
// Built by spllt_tpu_torch.numeric._build.build_capi():
//   g++ -O2 -shared -fPIC -std=c++17 capi.cpp -I<repo>/include \
//       $(python3-config --includes) $(python3-config --ldflags --embed)
// The embedded interpreter finds the package (and torch) through
// PYTHONPATH.

#include <Python.h>

#include <cstdarg>
#include <cstdint>
#include <cstdio>

#include "spllt_tpu.h"

namespace {

constexpr int kError = -3;

// the module, imported once (nullptr after a failed import, retried on the
// next call)
PyObject *capi_module() {
  static PyObject *mod = nullptr;
  if (!mod) {
    mod = PyImport_ImportModule("spllt_tpu_torch.capi");
    if (!mod) PyErr_Print();
  }
  return mod;
}

struct Gil {
  PyGILState_STATE st;
  Gil() : st(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(st); }
};

// Calls spllt_tpu_torch.capi.<name>(args built from fmt); returns the new
// reference to the result, or nullptr after printing the Python error.
PyObject *call(const char *name, const char *fmt, va_list ap) {
  PyObject *mod = capi_module();
  if (!mod) return nullptr;
  PyObject *fn = PyObject_GetAttrString(mod, name);
  PyObject *args = Py_VaBuildValue(fmt, ap);
  PyObject *res = (fn && args) ? PyObject_CallObject(fn, args) : nullptr;
  Py_XDECREF(fn);
  Py_XDECREF(args);
  if (!res) PyErr_Print();
  return res;
}

int call_int(const char *name, const char *fmt, ...) {
  Gil gil;
  va_list ap;
  va_start(ap, fmt);
  PyObject *res = call(name, fmt, ap);
  va_end(ap);
  if (!res) return kError;
  long rc = PyLong_AsLong(res);
  Py_DECREF(res);
  if (PyErr_Occurred()) {
    PyErr_Print();
    return kError;
  }
  return static_cast<int>(rc);
}

PyObject *call_obj(const char *name, const char *fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  PyObject *res = call(name, fmt, ap);
  va_end(ap);
  return res;
}

}  // namespace

extern "C" {

int spllt_tpu_init(void) {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    // give up the GIL that Py_InitializeEx holds, so Gil{} can take it
    PyEval_SaveThread();
  }
  Gil gil;
  return capi_module() ? 0 : kError;
}

int spllt_tpu_analyse(void **handle, const spllt_tpu_options_t *options,
                      int64_t n, const int64_t *ptr, const int64_t *row,
                      spllt_tpu_inform_t *inform) {
  if (spllt_tpu_init() != 0) return kError;
  const spllt_tpu_options_t defaults = SPLLT_TPU_OPTIONS_DEFAULT;
  const spllt_tpu_options_t *o = options ? options : &defaults;
  Gil gil;
  // analyse_c returns (handle, num_factor, num_flops, num_nodes)
  PyObject *res = call_obj(
      "analyse_c", "(LLLLiisssi)", (long long)n, (long long)(n + 1),
      (long long)(uintptr_t)ptr, (long long)(uintptr_t)row, o->nb, o->nemin,
      o->ordering, o->schedule, o->precision, o->refine);
  if (!res) return kError;
  long long h = 0;
  long long num_factor = 0, num_nodes = 0;
  double num_flops = 0.0;
  const int ok = PyArg_ParseTuple(res, "LLdL", &h, &num_factor, &num_flops,
                                  &num_nodes);
  Py_DECREF(res);
  if (!ok || h <= 0) {
    if (PyErr_Occurred()) PyErr_Print();
    return kError;
  }
  if (inform) {
    inform->num_factor = num_factor;
    inform->num_flops = num_flops;
    inform->num_nodes = num_nodes;
  }
  *handle = (void *)(uintptr_t)h;
  return 0;
}

int spllt_tpu_factor(void *handle, const double *val) {
  if (spllt_tpu_init() != 0) return kError;
  return call_int("factor_c", "(LL)", (long long)(uintptr_t)handle,
                  (long long)(uintptr_t)val);
}

int spllt_tpu_solve(void *handle, int nrhs, double *x, int job) {
  if (spllt_tpu_init() != 0) return kError;
  return call_int("solve_c", "(LiLi)", (long long)(uintptr_t)handle, nrhs,
                  (long long)(uintptr_t)x, job);
}

int spllt_tpu_free(void *handle) {
  if (!Py_IsInitialized()) return 0;
  return call_int("free_c", "(L)", (long long)(uintptr_t)handle);
}

void spllt_tpu_finalize(void) {
  // tearing down an interpreter that holds CUDA state is unreliable; the
  // process exit reclaims it, so only the streams are flushed
  fflush(stdout);
  fflush(stderr);
}

}  // extern "C"
