// Shared by every kernel library of the port. Each .cu file is built into a
// shared library of its own with a plain C interface (nvcc -shared, loaded
// with ctypes), so each library exports its own copy of this helper.
#pragma once

#include <cuda_runtime.h>

// Launch functions return cudaGetLastError() as an int; the Python wrapper
// turns a non-zero code into an exception with this text.
extern "C" const char* ideepcolor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
