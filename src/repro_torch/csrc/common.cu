// Error strings for the C entry points: each returns cudaGetLastError()
// right after its launch, and the Python wrapper raises with this text.
// Then the runtime's host side that the wrappers share: the current card,
// mapped host memory and a stream's wait.
#include <cstdint>

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

// Page-locked host memory mapped into every card's address space: the
// staging pairs and result words that a wrapper shares with its kernel
// (kernels/_build.mapped).  Allocated here, by the library's own runtime,
// and not taken from PyTorch's pinned memory: the flags are then the
// ones asked for (Mapped, and Portable so that every card of the process
// may dereference it), the device address comes from the runtime that
// launches the kernels, and the block lives until the wrapper frees it,
// not until a tensor dies and PyTorch's caching host allocator hands the
// block to someone else.  With unified addressing the device address is
// the host address; it is asked for all the same.
extern "C" int svc_host_alloc(int64_t bytes, void** host, void** device) {
  *host = nullptr;
  *device = nullptr;
  cudaError_t err = cudaHostAlloc(host, static_cast<size_t>(bytes),
                                  cudaHostAllocMapped | cudaHostAllocPortable);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaHostGetDevicePointer(device, *host, 0);
  if (err != cudaSuccess) {
    cudaFreeHost(*host);
    *host = nullptr;
  }
  return static_cast<int>(err);
}

extern "C" int svc_host_free(void* host) { return static_cast<int>(cudaFreeHost(host)); }

// The host waits until every launch queued on `stream` so far has run:
// the one wait of a wrapper whose result lies in mapped host memory.
extern "C" int svc_stream_wait(void* stream) {
  return static_cast<int>(cudaStreamSynchronize(static_cast<cudaStream_t>(stream)));
}
