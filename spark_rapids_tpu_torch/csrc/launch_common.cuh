// Launch helpers shared by the kernels whose grids are sized to the card:
// K6 (join_probe.cu) and K15 (cross_expand.cu).
#pragma once

#include <cuda_runtime.h>

namespace launch {

// The current device's SM count, read once per device (132 on an H100 SXM
// when it cannot be read).
inline int sm_count() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = n > 0 ? n : 132;
  }
  return sms[dev];
}

}  // namespace launch
