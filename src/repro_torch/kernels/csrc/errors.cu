// Error text for the codes the kernels' C entry points return.
#include <cuda_runtime.h>

// flash_attention.cu returns 10000 plus the CUresult when libcuda refuses to
// encode a tensor map; every other code is a cudaError_t.
extern "C" const char* repro_cuda_error_string(int err) {
  if (err >= 10000) return "libcuda refused a TMA tensor map (cuTensorMapEncodeTiled; CUresult = code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
