// P-B — the slot-grid deposit: per-voxel hit and miss counts of a sorted
// (flat << 1 | hit) key stream, counted slot by slot on chip, then the
// occupancy sweep of the counted voxels, in place.
//
// Replaces scripts/probe_deposit.py:pallas_deposit_build (its pallas_call).
// Plain PyTorch version: ohm_tpu_torch/ops/slotgrid_cuda.py
// slotgrid_deposit_reference; wrapper: slotgrid_deposit.
//
// The TPU kernel runs its grid over the arena's slots; each step DMAs the
// slot's chunk-aligned key windows into VMEM, builds one-hot hi/lo factors
// and deposits them with MXU matmuls into a (2 x 64, 512) f32 accumulator,
// 256 KB a slot.  A Hopper block has at most 227 KB of shared memory, and a
// one-hot matmul spends 2 x 64 x 512 multiply-adds a record where a count
// needs one add.  So here:
//
//  - One block per (slot, part): a part spans V / 4 = 8192 voxels of its
//    slot, and its two u32 count planes (hit, miss) take 64 KB of dynamic
//    shared memory, so three blocks fit an SM.  The record range of each
//    part comes from the caller (torch.searchsorted on keys >> 1 over the
//    part edges), as the TPU kernel's chunk ranges came from its scalar
//    prefetch.  A part without records returns at once (fused) or writes
//    zeros (unfused), the TPU kernel's passthrough.
//  - The deposit reads the part's records coalesced, four a thread per
//    step with the loads issued together.  Equal keys sit next to each
//    other in the sorted stream, and one voxel of the bench stream takes a
//    run of 37,230 misses: a shared-memory atomicAdd per record would
//    serialise on it.  Each warp first groups its lanes by key
//    (__match_any_sync), and one lane of each group adds the group's size.
//  - Records are counted only when their voxel lies in the block's part, as
//    the TPU kernel masks by slot, so a wrong range cannot write elsewhere
//    and nothing past slots * V is ever read or written.
//  - The sweep reads the two planes from shared memory and touches only
//    voxels with records: f32 total = n_hit * hit + n_miss * miss with each
//    product and the sum rounded once (__fmul_rn / __fadd_rn, -fmad=false),
//    base 0 where occ is +inf, the one-sided clamp by the sign of the total,
//    untouched voxels kept.  Unfused, it writes hit * 65536 + miss (rounded
//    the same way) to every voxel of the part.
//
// Counts are u32 and not capped: the reference's f32 accumulator is exact
// to 2^24, and so is the conversion here.
//
// What bounds it on the H100: memory, for the function: each key read once
// (5.0 MB at the bench shape) and each touched voxel read and written once
// (~5.1 MB).  In practice the part with the most records: its block runs
// alone through them (~100k records at the bench shape, 25% of the stream
// in one slot), so the grid waits on one SM.

#include <cuda_runtime.h>

namespace {

constexpr int kVShift = 15;
constexpr int kPartVox = (1 << kVShift) / 4;
constexpr int kBlock = 512;
constexpr int kUnroll = 4;
constexpr unsigned kSmemBytes = 2u * kPartVox * sizeof(unsigned);

struct SweepValues {
  float hit, miss, min_value, max_value;
};

__device__ __forceinline__ void count_record(int k, bool valid, int base,
                                             unsigned* hit, unsigned* miss) {
  const int flat = k >> 1;
  const bool in_part = valid && flat >= base && flat < base + kPartVox;
  // Lanes outside the part all vote -1, which no key is.
  const unsigned peers = __match_any_sync(0xffffffffu, in_part ? k : -1);
  const int lane = threadIdx.x & 31;
  if (in_part && lane == __ffs(peers) - 1) {
    atomicAdd(((k & 1) ? hit : miss) + (flat - base), (unsigned)__popc(peers));
  }
}

__global__ void __launch_bounds__(kBlock) slotgrid_kernel(
    const int* __restrict__ keys, const int* __restrict__ bounds,
    float* __restrict__ occ, SweepValues p, int fuse) {
  extern __shared__ __align__(16) unsigned planes[];
  unsigned* hit = planes;
  unsigned* miss = planes + kPartVox;
  const int part = blockIdx.x;
  const int r0 = bounds[part];
  const int r1 = bounds[part + 1];
  const int base = part * kPartVox;
  if (r1 <= r0) {
    if (!fuse) {
      for (int v = threadIdx.x; v < kPartVox; v += kBlock) occ[base + v] = 0.0f;
    }
    return;
  }
  uint4* zero4 = reinterpret_cast<uint4*>(planes);
  for (int i = threadIdx.x; i < 2 * kPartVox / 4; i += kBlock) {
    zero4[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // The loop bound is the same for every thread, so whole warps reach
  // __match_any_sync together.
  for (int at = r0; at < r1; at += kBlock * kUnroll) {
    int k[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int i = at + j * kBlock + threadIdx.x;
      k[j] = i < r1 ? keys[i] : 0;
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      count_record(k[j], at + j * kBlock + (int)threadIdx.x < r1, base, hit, miss);
    }
  }
  __syncthreads();

  for (int v = threadIdx.x; v < kPartVox; v += kBlock) {
    const unsigned h = hit[v];
    const unsigned m = miss[v];
    const float n_hit = __uint2float_rn(h);
    const float n_miss = __uint2float_rn(m);
    if (!fuse) {
      occ[base + v] = __fadd_rn(__fmul_rn(n_hit, 65536.0f), n_miss);
      continue;
    }
    if (h == 0u && m == 0u) continue;
    const float x = occ[base + v];
    const float total = __fadd_rn(__fmul_rn(n_hit, p.hit), __fmul_rn(n_miss, p.miss));
    const bool unobs = x == __int_as_float(0x7f800000);  // +inf
    float value = __fadd_rn(unobs ? 0.0f : x, total);
    // Ternaries, not fminf/fmaxf: a NaN stays NaN, as in the reference.
    if (total > 0.0f) value = value > p.max_value ? p.max_value : value;
    if (total < 0.0f) value = value < p.min_value ? p.min_value : value;
    occ[base + v] = value;
  }
}

}  // namespace

// bounds: i32[n_parts + 1], part = slot * 4 + quarter; occ: f32[>= n_parts *
// 8192], updated in place.
extern "C" int ohm_slotgrid_deposit(const void* keys, const void* bounds,
                                    int n_parts, void* occ, float hit_value,
                                    float miss_value, float min_value,
                                    float max_value, int fuse_sweep,
                                    void* stream) {
  if (n_parts <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      slotgrid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const SweepValues p{hit_value, miss_value, min_value, max_value};
  slotgrid_kernel<<<n_parts, kBlock, kSmemBytes, (cudaStream_t)stream>>>(
      (const int*)keys, (const int*)bounds, (float*)occ, p, fuse_sweep);
  return (int)cudaGetLastError();
}
