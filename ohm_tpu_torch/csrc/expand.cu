// K1 — the expand kernel: rank walk + slot resolve, one thread per record.
//
// Replaces ohm_tpu/ops/expand_pallas.py:expand_keys (Pallas kernel _kernel).
// Plain PyTorch version: ohm_tpu_torch/ops/expand_cuda.py
// expand_keys_reference; wrapper: expand_keys.
//
// Record j of ray r is the wall-crossing event (axis a = j / S, index
// k = j % S) at time t = e0[a] + k * dd[a].  Its event count on each other
// axis b is the rank of t in b's arithmetic sequence: an estimate
// floor((t - e0[b]) * inv[b]) - 3, then a binary advance by 4, 2, 1 in the
// masked-int domain bits(t) & ~3, and one step more for a tied event of a
// higher axis (ohm/LineWalkCompute.h walkSelectNextAxis).  The voxel is
// start + step_dir * counts; its bbox-relative region, packed 6 bits per
// axis, is matched against the ray's K candidates ((slot+1) << 18 | region;
// later candidates win).  The key is slot * V + local, or the sentinel for
// an invalid, unresolved or excluded-origin record.  Valid unresolved
// records are counted: one __syncthreads_count and one atomicAdd a block.
// With a voxel-plane output (``vox`` not null; the NDT path's with_vox),
// the record's absolute voxel is stored too, one i32 plane per axis
// [3][B][3S]: three more coalesced stores a record.
//
// What bounds it on the H100: integer and ALU work, ~60 dependent ops and a
// K-way compare per record, against 4 bytes written per record and a few
// dozen bytes read per ray (16 bytes written with the voxel planes);
// nothing is gathered or sorted.  The design keeps it there: the per-ray
// scalars are staged once per block in shared memory
// (every thread of the block belongs to the same ray), records map to
// consecutive threads, so key stores coalesce, and blockIdx.x runs over the
// rays, whose count can exceed gridDim.y's 65535.
//
// Exactness: every f32 product and sum is rounded separately (__fmul_rn /
// __fadd_rn, and the build passes -fmad=false), as the reference rounds
// them; __float2int_rd saturates and maps NaN to 0, as XLA's f32 -> i32
// cast does.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kMaxK = 32;  // ohm_tpu_torch/ops/expand_cuda.py MAX_K

__device__ __forceinline__ int masked_bits(float t) {
  return __float_as_int(t) & ~3;
}

// e0 + m * dd, product and sum each rounded once.
__device__ __forceinline__ float event_time(float e0, float dd, int m) {
  return __fadd_rn(e0, __fmul_rn(__int2float_rn(m), dd));
}

// fray f32[B,9]: e0[3] dd[3] inv[3].  iray i32[B,10+K]: start_abs[3]
// step_dir[3] n_ax[3] tcand[K] exclude.  gmeta i32[3]: bbox origin region.
__global__ void __launch_bounds__(kBlock) expand_keys_kernel(
    const float* __restrict__ fray, const int* __restrict__ iray,
    const int* __restrict__ gmeta, int* __restrict__ key,
    int* __restrict__ vox, int* __restrict__ missed, int B, int S, int K,
    int shift, int v, int sentinel, int exclude_origin) {
  __shared__ float sf[9];
  __shared__ int si[10 + kMaxK];
  __shared__ int sg[3];
  const int ray = blockIdx.x;
  const int iw = 10 + K;
  for (int c = threadIdx.x; c < 9; c += blockDim.x) {
    sf[c] = fray[(size_t)ray * 9 + c];
  }
  for (int c = threadIdx.x; c < iw; c += blockDim.x) {
    si[c] = iray[(size_t)ray * iw + c];
  }
  if (threadIdx.x < 3) sg[threadIdx.x] = gmeta[threadIdx.x];
  __syncthreads();

  const int W = 3 * S;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  bool count_miss = false;
  if (j < W) {
    const int a = j / S;
    const int k = j - a * S;
    const float t = event_time(sf[a], sf[3 + a], k);
    const int mt_a = masked_bits(t);
    int counts[3];
    for (int b = 0; b < 3; ++b) {
      if (b == a) {
        counts[b] = k;
        continue;
      }
      const float e0b = sf[b];
      const float ddb = sf[3 + b];
      const int nb = si[6 + b];
      const int est = __float2int_rd(__fmul_rn(__fsub_rn(t, e0b), sf[6 + b]));
      int c = (int)((unsigned)est - 3u);  // wraps in int32, as XLA's does
      c = min(max(c, 0), nb);
      for (int step = 4; step >= 1; step >>= 1) {
        const int m = c + (step - 1);
        if (m < nb && masked_bits(event_time(e0b, ddb, m)) < mt_a) c += step;
      }
      if (a < b && c < nb && masked_bits(event_time(e0b, ddb, c)) == mt_a) {
        c += 1;
      }
      counts[b] = c;
    }

    const int dim_mask = (1 << shift) - 1;
    int packed = 0;
    int local_idx = 0;
    bool in_box = true;
    for (int b = 0; b < 3; ++b) {
      const int abs_b = si[b] + si[3 + b] * counts[b];
      const int rel = (abs_b >> shift) - sg[b];
      packed |= (int)((unsigned)rel << (6 * b));
      in_box = in_box && rel >= 0 && rel < 64;
      local_idx |= (abs_b & dim_mask) << (shift * b);
      if (vox != nullptr) vox[((size_t)b * B + ray) * W + j] = abs_b;
    }
    if (!in_box) packed = -1;
    int slot = -1;
    for (int kk = 0; kk < K; ++kk) {
      const int cand = si[9 + kk];
      const int cand_slot = (cand >> 18) - 1;
      if ((cand & 0x3FFFF) == packed && cand_slot >= 0) slot = cand_slot;
    }
    const bool is_missed = slot < 0;
    const int flat = is_missed ? sentinel : slot * v + local_idx;

    bool valid = k < si[6 + a];
    if (exclude_origin && counts[0] == 0 && counts[1] == 0 && counts[2] == 0 &&
        si[9 + K] != 0) {
      valid = false;
    }
    key[(size_t)ray * W + j] = valid ? flat : sentinel;
    count_miss = valid && is_missed;
  }
  const int n = __syncthreads_count(count_miss);
  if (threadIdx.x == 0 && n != 0) atomicAdd(missed, n);
}

}  // namespace

// vox may be null (no voxel planes).
extern "C" int ohm_expand_keys(const void* fray, const void* iray,
                               const void* gmeta, void* key, void* vox,
                               void* missed, int B, int S, int K, int shift,
                               int v, int sentinel, int exclude_origin,
                               void* stream) {
  if (K < 0 || K > kMaxK) return (int)cudaErrorInvalidValue;
  if (B > 0 && S > 0) {
    const dim3 grid(B, (3 * S + kBlock - 1) / kBlock);
    expand_keys_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        (const float*)fray, (const int*)iray, (const int*)gmeta, (int*)key,
        (int*)vox, (int*)missed, B, S, K, shift, v, sentinel, exclude_origin);
  }
  return (int)cudaGetLastError();
}
