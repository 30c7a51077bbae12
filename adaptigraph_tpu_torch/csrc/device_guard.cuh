// Host code shared by the kernels' launchers: restores the calling thread's
// current CUDA device when the launcher returns. Each launcher selects the
// card it launches on with cudaSetDevice; without the restore, every later
// allocation on the default card in that thread (PyTorch's device="cuda")
// would land on the card of the last launch, as happens when one process
// drives the shards of a sharded solve or train step on several cards.
#pragma once

#include <cuda_runtime.h>

struct CurrentDeviceGuard {
  int prev = -1;
  CurrentDeviceGuard() {
    if (cudaGetDevice(&prev) != cudaSuccess) prev = -1;
  }
  ~CurrentDeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
  CurrentDeviceGuard(const CurrentDeviceGuard&) = delete;
  CurrentDeviceGuard& operator=(const CurrentDeviceGuard&) = delete;
};
