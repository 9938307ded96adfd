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
// What bounds it: nothing on the card. One block reads and writes 4 KB; its
// time is one launch's latency plus the host work around it. So the design
// keeps that host work small: the attribute is set by its own entry point,
// which the wrapper (tools/kexp_kernels.py::_probe_launch) calls only when
// the size differs from the last one granted on that device, and the launch
// is one pass of 256 threads that each read and write one float4 of the
// (8,128) array.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // one float4 of the (8,128) float32 each

__global__ void __launch_bounds__(kThreads)
    smem_probe_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                      int n) {
  extern __shared__ float s[];
  if (threadIdx.x == 0) {
    const float4 x0 = x[0];
    s[0] = x0.x;
    s[n - 1] = x0.y;
  }
  __syncthreads();
  const float a = s[n - 1];
  const float4 v = x[threadIdx.x];
  out[threadIdx.x] = make_float4(v.x + a, v.y + a, v.z + a, v.w + a);
}

}  // namespace

// Lets the probe's launches ask for up to kb KB of dynamic shared memory on
// the current device. Returns the CUDA error code (0 = granted).
extern "C" int smem_probe_set_size(int kb) {
  if (kb < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      smem_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kb * 1024);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// Launches the probe on `stream` with kb KB of dynamic shared memory for the
// (8,128) float32 x, 16-byte aligned. Returns the CUDA error code of the
// launch (0 = success). Allocates nothing and does not synchronise.
extern "C" int smem_probe_launch(const float* x, float* out, int kb,
                                 void* stream) {
  if (kb < 1) return (int)cudaErrorInvalidValue;
  smem_probe_kernel<<<1, kThreads, kb * 1024, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out),
      kb * 256);
  return (int)cudaGetLastError();
}

extern "C" const char* smem_probe_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
