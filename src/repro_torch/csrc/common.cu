// Error strings for the C entry points: each returns cudaGetLastError()
// right after its launch, and the Python wrapper raises with this text.
#include <cuda_runtime.h>

extern "C" const char* svc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
