// Shared by every kernel library of the port: each csrc/<name>.cu is built
// on its own into one shared library, and each exports this function so the
// Python side (ops/_build.py::check) can name a CUDA error code.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
