// K4 — gather_plane: one int8 arena-plane value per record, widened to i32.
//
// Replaces ohm_tpu/ops/deposit_pallas.py:gather_plane.  Plain PyTorch
// version: ohm_tpu_torch/ops/gather_cuda.py gather_plane_reference; wrapper:
// gather_plane.
//
// out[i] = ids[i] < sentinel ? plane[ids[i]] : 0, one thread per record.
// The TPU kernel walks a sorted id stream slot by slot and turns the gather
// into int8 one-hot MXU matmuls, because the TPU's random gather is
// latency-bound.  Hopper gathers directly: the ids are ascending (the NDT
// miss phase sorts them), so neighbouring threads read neighbouring or
// equal bytes of the plane and most loads of a warp fall into a few
// sectors.  Sentinel ids (and any id outside [0, sentinel)) read 0.
//
// What bounds it on the H100: memory, 4 bytes read and 4 written per
// record plus the touched sectors of the plane (~1.5M records at the NDT
// shape, ~12 MB); the design is one coalesced pass and nothing else.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock) gather_plane_kernel(
    const signed char* __restrict__ plane, const int* __restrict__ ids, int n,
    int sentinel, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int id = ids[i];
  out[i] = (unsigned)id < (unsigned)sentinel ? (int)plane[id] : 0;
}

}  // namespace

extern "C" int ohm_gather_plane(const void* plane, const void* ids, int n,
                                int sentinel, void* out, void* stream) {
  if (n > 0) {
    gather_plane_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                          (cudaStream_t)stream>>>(
        (const signed char*)plane, (const int*)ids, n, sentinel, (int*)out);
  }
  return (int)cudaGetLastError();
}
