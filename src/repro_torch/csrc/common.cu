// Error strings for the C entry points: each returns cudaGetLastError()
// right after its launch, and the Python wrapper raises with this text.
#include <cuda_runtime.h>

extern "C" const char* svc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The device this library's own CUDA runtime sees as current, or a
// negative error: the wrappers check once per card that it is the card
// PyTorch made current.
extern "C" int svc_current_device() {
  int d = -1;
  const cudaError_t err = cudaGetDevice(&d);
  return err == cudaSuccess ? d : -static_cast<int>(err);
}
