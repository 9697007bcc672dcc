// K2 — deposit and sweep: per-voxel hit/miss counts, then the occupancy
// update in place.
//
// Replaces ohm_tpu/ops/deposit_pallas.py:deposit_and_sweep (_deposit_core
// with _sweep_block).  Plain PyTorch version: ohm_tpu_torch/ops/
// deposit_cuda.py deposit_and_sweep_reference; wrapper: deposit_and_sweep.
//
// Two launches on the caller's stream:
//  1. deposit: one thread per (flat << 1 | hit) key; keys with
//     flat >= sentinel are skipped, the rest atomicAdd 1 into the hit or
//     miss plane (int32, zeroed by the wrapper).  Integer counts make the
//     result exact in any order, so the kernel needs no sorted input.
//  2. sweep: one thread per arena voxel in [0, capacity * V).  A voxel with
//     records gets the reference's occupancy update against its batch-start
//     value (kRfExcludeFree / Occupied / Unobserved, the one-sided clamp by
//     the sign of the total, saturated voxels kept); a voxel without
//     records is neither changed nor written.  Touched voxels are counted
//     with one __syncthreads_count and one atomicAdd a block.  The sentinel
//     element at capacity * V is never written.
//
// What bounds it on the H100: memory.  At the bench shape (512 slots x
// 32768 voxels) each count plane is 64 MiB: the wrapper's zeroing writes
// both, the sweep reads both, so about 3 x 64 MiB move per batch against a
// few MiB of keys and the touched voxels' occupancy.  The design does
// nothing cleverer yet: plain coalesced one-element-per-thread passes and
// no writes to untouched voxels.
//
// Exactness: counts are capped at 65535 before the multiply, and
// total = n_hit * hit + n_miss * miss rounds each product and the sum once
// (__fmul_rn / __fadd_rn, -fmad=false), as the reference does.  -0.0 marks
// an unobserved voxel; base is +0.0 there.
//
// K3 — the NDT deposit and sweep (ohm_deposit_and_sweep_ndt below).
// Replaces ohm_tpu/ops/deposit_pallas.py:deposit_and_sweep_ndt
// (_deposit_core with key2_sorted and delta_stream, _ndt_sweep_block).
// Plain PyTorch version: deposit_cuda.py deposit_and_sweep_ndt_reference.
// Up to three launches:
//  1. deposit: one thread per key of the walk stream and of the end/sample
//     stream (one launch over both), atomicAdd into the zeroed int32 hit
//     and miss planes, as K2.  The TPU kernel's bounds stream, which tells
//     its slot grid which slots are live, has no counterpart: the sweep
//     below tests each voxel.
//  2. sparse delta only: one thread per (flat << 1, value) record; a record
//     whose value has a nonzero bit pattern stores it into the zeroed f32
//     delta plane.  At most one such record per voxel, so a plain store
//     gives the reference's exact value with no atomics.  A dense delta
//     plane (NDT-TM) is read as it is.
//  3. sweep over every voxel: touched = counts > 0 or delta != 0;
//     total = (n_hit * hit + n_miss * miss) + delta with three roundings;
//     +inf is unobserved; the one-sided clamp by the sign of the total;
//     saturated voxels kept; no exclude flags.  The touched count comes
//     from the counts alone, as the reference's does.
// Bound by memory like K2, with the delta plane as a fourth 4-byte read.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
// ohm_tpu/core/rayflags.py RayFlag
constexpr int kExcludeUnobserved = 1 << 5;
constexpr int kExcludeFree = 1 << 6;
constexpr int kExcludeOccupied = 1 << 7;

struct SweepParams {
  int flags;
  float hit_value, miss_value, threshold;
  float min_value, max_value, saturation_min, saturation_max;
};

__global__ void __launch_bounds__(kBlock) deposit_counts_kernel(
    const int* __restrict__ keys, int n_keys, int sentinel,
    int* __restrict__ hit, int* __restrict__ miss) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_keys) return;
  const int k = keys[i];
  const int flat = k >> 1;
  if ((unsigned)flat < (unsigned)sentinel) {
    atomicAdd((k & 1) ? hit + flat : miss + flat, 1);
  }
}

__global__ void __launch_bounds__(kBlock) sweep_kernel(
    float* __restrict__ occ, const int* __restrict__ hit,
    const int* __restrict__ miss, int n_vox, SweepParams p,
    int* __restrict__ touched_count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool touched = false;
  if (i < n_vox) {
    const int h = hit[i];
    const int m = miss[i];
    touched = (h + m) > 0;
    if (touched) {
      const float x = occ[i];
      const float n_hit = fminf(__int2float_rn(h), 65535.0f);
      const float n_miss = fminf(__int2float_rn(m), 65535.0f);
      const bool unobs = x == 0.0f && (__float_as_uint(x) >> 31) != 0;
      float hit_eff = p.hit_value;
      float miss_eff = p.miss_value;
      if ((p.flags & kExcludeFree) && !unobs && x < p.threshold) {
        hit_eff = 0.0f;
        miss_eff = 0.0f;
      }
      if ((p.flags & kExcludeOccupied) && !unobs && x >= p.threshold) {
        hit_eff = 0.0f;
        miss_eff = 0.0f;
      }
      const float total =
          __fadd_rn(__fmul_rn(n_hit, hit_eff), __fmul_rn(n_miss, miss_eff));
      float value = __fadd_rn(unobs ? 0.0f : x, total);
      // Ternaries, not fminf/fmaxf: a NaN stays NaN, as in the reference.
      if (total > 0.0f) value = value > p.max_value ? p.max_value : value;
      if (total < 0.0f) value = value < p.min_value ? p.min_value : value;
      const bool saturated =
          !unobs && (x <= p.saturation_min || x >= p.saturation_max);
      const bool keep =
          saturated || ((p.flags & kExcludeUnobserved) && unobs);
      if (!keep) occ[i] = value;
    }
  }
  const int n = __syncthreads_count(touched);
  if (threadIdx.x == 0 && n != 0) atomicAdd(touched_count, n);
}

__global__ void __launch_bounds__(kBlock) deposit_two_streams_kernel(
    const int* __restrict__ keys_a, int n_a, const int* __restrict__ keys_b,
    int n_b, int sentinel, int* __restrict__ hit, int* __restrict__ miss) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_a + n_b) return;
  const int k = i < n_a ? keys_a[i] : keys_b[i - n_a];
  const int flat = k >> 1;
  if ((unsigned)flat < (unsigned)sentinel) {
    atomicAdd((k & 1) ? hit + flat : miss + flat, 1);
  }
}

__global__ void __launch_bounds__(kBlock) store_delta_kernel(
    const int* __restrict__ dkeys, const float* __restrict__ dvals, int n,
    int sentinel, float* __restrict__ plane) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int flat = dkeys[i] >> 1;
  const float d = dvals[i];
  if ((unsigned)flat < (unsigned)sentinel && __float_as_int(d) != 0) {
    plane[flat] = d;
  }
}

__global__ void __launch_bounds__(kBlock) ndt_sweep_kernel(
    float* __restrict__ occ, const int* __restrict__ hit,
    const int* __restrict__ miss, const float* __restrict__ delta, int n_vox,
    SweepParams p, int* __restrict__ touched_count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool counted = false;
  if (i < n_vox) {
    const int h = hit[i];
    const int m = miss[i];
    const float d = delta[i];
    counted = (h + m) > 0;
    if (counted || d != 0.0f) {
      const float x = occ[i];
      const float n_hit = fminf(__int2float_rn(h), 65535.0f);
      const float n_miss = fminf(__int2float_rn(m), 65535.0f);
      const bool unobs = x == __int_as_float(0x7f800000);  // +inf
      const float total = __fadd_rn(
          __fadd_rn(__fmul_rn(n_hit, p.hit_value), __fmul_rn(n_miss, p.miss_value)),
          d);
      float value = __fadd_rn(unobs ? 0.0f : x, total);
      if (total > 0.0f) value = value > p.max_value ? p.max_value : value;
      if (total < 0.0f) value = value < p.min_value ? p.min_value : value;
      const bool saturated =
          !unobs && (x <= p.saturation_min || x >= p.saturation_max);
      if (!saturated) occ[i] = value;
    }
  }
  const int n = __syncthreads_count(counted);
  if (threadIdx.x == 0 && n != 0) atomicAdd(touched_count, n);
}

}  // namespace

extern "C" int ohm_deposit_and_sweep(
    void* occupancy, const void* keys, int n_keys, void* hit, void* miss,
    int n_vox, int flags, float hit_value, float miss_value, float threshold,
    float min_value, float max_value, float saturation_min,
    float saturation_max, void* touched, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_keys > 0) {
    deposit_counts_kernel<<<(n_keys + kBlock - 1) / kBlock, kBlock, 0, s>>>(
        (const int*)keys, n_keys, n_vox, (int*)hit, (int*)miss);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_vox > 0) {
    const SweepParams p{flags,     hit_value, miss_value,     threshold,
                        min_value, max_value, saturation_min, saturation_max};
    sweep_kernel<<<(n_vox + kBlock - 1) / kBlock, kBlock, 0, s>>>(
        (float*)occupancy, (const int*)hit, (const int*)miss, n_vox, p,
        (int*)touched);
  }
  return (int)cudaGetLastError();
}

// delta: the dense f32 plane to read, or (when dkeys is not null) the zeroed
// plane that the sparse (dkeys, dvals) stream of n_delta records fills.
extern "C" int ohm_deposit_and_sweep_ndt(
    void* occupancy, const void* walk_keys, int n_walk, const void* end_keys,
    int n_end, const void* dkeys, const void* dvals, int n_delta, void* delta,
    void* hit, void* miss, int n_vox, float hit_value, float miss_value,
    float min_value, float max_value, float saturation_min,
    float saturation_max, void* touched, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_walk + n_end > 0) {
    deposit_two_streams_kernel<<<(n_walk + n_end + kBlock - 1) / kBlock,
                                 kBlock, 0, s>>>(
        (const int*)walk_keys, n_walk, (const int*)end_keys, n_end, n_vox,
        (int*)hit, (int*)miss);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (dkeys != nullptr && n_delta > 0) {
    store_delta_kernel<<<(n_delta + kBlock - 1) / kBlock, kBlock, 0, s>>>(
        (const int*)dkeys, (const float*)dvals, n_delta, n_vox, (float*)delta);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_vox > 0) {
    const SweepParams p{0,         hit_value, miss_value,     0.0f,
                        min_value, max_value, saturation_min, saturation_max};
    ndt_sweep_kernel<<<(n_vox + kBlock - 1) / kBlock, kBlock, 0, s>>>(
        (float*)occupancy, (const int*)hit, (const int*)miss,
        (const float*)delta, n_vox, p, (int*)touched);
  }
  return (int)cudaGetLastError();
}
