// Shared by every kernel library of the port: each csrc/<name>.cu is built
// on its own into one shared library, and each exports this function so the
// Python side (ops/_build.py::check) can name a CUDA error code; and the
// number of blocks of a kernel the card holds at once, by which the
// grid-stride and cluster-split kernels size their grids.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Blocks of `kernel` that the current device holds at once: its SM count
// times the blocks an SM takes at `threads` threads and `smem` bytes of
// dynamic shared memory.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err == cudaSuccess) *blocks = sms * per_sm;
  return err;
}
