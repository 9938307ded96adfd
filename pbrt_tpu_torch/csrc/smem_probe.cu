// Shared-memory capacity probe for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/kexp_run.py::exp_smem_probe.kern (Pallas),
// which allocates an n = kb * 256 float scratch in scalar memory, writes
// x[0, 0] to its first and x[0, 1] to its last word and returns x + s[n - 1]:
// it says whether a launch really gets that much fast memory. Here the
// scratch is one block's dynamic shared memory, asked for with
// cudaFuncAttributeMaxDynamicSharedMemorySize and the launch's dynamic size.
// The documented limit is 227 KB per block; the probe says what a launch
// gets, which bounds the node table that kexp_traverse.cu stages.
//
// What bounds it: nothing worth the name. One block reads and writes 4 KB;
// its time is the launch's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kElems = 8 * 128;

__global__ void smem_probe_kernel(const float* __restrict__ x,
                                  float* __restrict__ out, int n) {
  extern __shared__ float s[];
  if (threadIdx.x == 0) {
    s[0] = x[0];
    s[n - 1] = x[1];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kElems; i += kThreads) out[i] = x[i] + s[n - 1];
}

}  // namespace

// Asks for kb KB of dynamic shared memory and launches the probe on `stream`
// for the (8,128) float32 x. Returns the CUDA error code of the attribute
// call or of the launch (0 = success); a refused size launches nothing.
// Allocates nothing and does not synchronise.
extern "C" int smem_probe_launch(const float* x, float* out, int kb,
                                 void* stream) {
  if (kb < 1) return (int)cudaErrorInvalidValue;
  const int bytes = kb * 1024;
  cudaError_t err = cudaFuncSetAttribute(
      smem_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  smem_probe_kernel<<<1, kThreads, bytes, (cudaStream_t)stream>>>(x, out,
                                                                  kb * 256);
  return (int)cudaGetLastError();
}

extern "C" const char* smem_probe_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
