// An empty kernel for Hopper (sm_90a): the launch floor of the card.
//
// Not a port of any TPU kernel and on no path of the package: a
// measurement.  Timed in a CUDA graph at a given grid and block size, it
// is the least time any kernel of that launch shape takes on the card,
// the yardstick for kernels whose work is far below one launch (the CNN
// path's M = 1 int8 GEMMs, chip_smoke.py's [kernels] table).

#include <cuda_runtime.h>

__global__ void launch_floor_kernel() {}

extern "C" int launch_floor_launch(int blocks, int threads, void* stream) {
  launch_floor_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
