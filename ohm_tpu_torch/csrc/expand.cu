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
// [3][B][3S]: three more coalesced stores a record.  With a traversal output
// (``trav`` not null; the traversal layer's with_trav, replacing the Pallas
// kernel's trav output), the record stores t - enter, where enter is the
// latest earlier event over the axes: prev[b] = e0[b] + (counts[b] - 1) *
// dd[b] where counts[b] > 0, else 0, maxed own axis first, then the others
// ascending; an invalid record stores 0.  One more coalesced 4-byte store.
//
// The per-ray set-up runs in the kernel too (ops.ddawalk.init_walk +
// safe_inverse and ops.expand_cuda._prelude, which the reference computes
// in XLA before its kernel): it reads the unpacked batch's own tensors
// (ops.wire.unpack_batch; start_frac, direction and length as row-strided
// views of the wire's float block), threads 0-2 of each block compute their
// axis's sign, IEEE 1/direction (+-3.0e38 where direction is 0 or denormal,
// which XLA's comparisons read as 0; 0 where the length is not positive), e0 = (wall - start_frac) * inv, dd =
// |res * inv|, the crossings, step, n_ax and 1/dd into shared memory, and
// the first block of each ray writes its overflow flag and the end voxel's
// enter time, max over the axes of e0 + (n_ax - 1) * dd (0 where n_ax is
// 0), clamped at 0.  That max and clamp are ATen's CUDA maximum and clamp,
// as the plain version calls them: a NaN operand wins, the first first,
// otherwise fmaxf.  (Signed zeros never reach them: e0 + m * dd with
// m * dd >= +0 is never -0.)  The wrapper then issues no PyTorch op but
// its outputs' allocations; the C entry zeroes the missed count on the
// stream.
//
// What bounds it on the H100: integer and ALU work, ~60 dependent ops and a
// K-way compare per record, against 4 bytes written per record and a few
// dozen bytes read per ray (8 bytes with the traversal output, 16 with the
// voxel planes); nothing is gathered or sorted.  The design keeps it there:
// the per-ray scalars are staged once per block in shared memory (every
// thread of the block belongs to the same ray), records map to consecutive
// threads, so key stores coalesce, and blockIdx.x runs over the rays, whose
// count can exceed gridDim.y's 65535.
//
// Exactness: every f32 product and sum is rounded separately (__fmul_rn /
// __fadd_rn, and the build passes -fmad=false), as the reference rounds
// them; divisions are IEEE (__fdiv_rn); __float2int_rd saturates and maps
// NaN to 0, as XLA's f32 -> i32 cast does.  The max of the enter times is
// a compare and select that keeps the first operand on a tie, as the plain
// version (ops.ddawalk.max_keep_first) does: fmaxf may return either of
// +0.0 and -0.0, and enter is +-0 where a ray starts on a wall.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kMaxK = 32;  // ohm_tpu_torch/ops/expand_cuda.py MAX_K
constexpr float kBig = 3.0e38f;  // ops.ddawalk._BIG, "infinite" time
constexpr float kTiny = 1.17549435e-38f;  // ops.ddawalk._TINY, FLT_MIN
static_assert(kBlock == 128 && kMaxK <= 32, "the set-up's loads take four warps");

__device__ __forceinline__ int masked_bits(float t) {
  return __float_as_int(t) & ~3;
}

// e0 + m * dd, product and sum each rounded once.
__device__ __forceinline__ float event_time(float e0, float dd, int m) {
  return __fadd_rn(e0, __fmul_rn(__int2float_rn(m), dd));
}

// max(a, b), keeping a when the two compare equal.
__device__ __forceinline__ float max_keep_first(float a, float b) {
  return b > a ? b : a;
}

// ATen's CUDA maximum for floats (MaxMinElementwiseKernel.cu): a NaN operand
// is returned, the first one first; otherwise fmaxf.
__device__ __forceinline__ float aten_maximum(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

// ATen's CUDA clamp with a scalar lower bound (launch_clamp_scalar, Min):
// NaN is returned as it is; otherwise fmaxf(v, lo).
__device__ __forceinline__ float aten_clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// One block row per ray (blockIdx.x), records across blockIdx.y.  The
// per-ray set-up is ops.ddawalk.init_walk + safe_inverse and
// ops.expand_cuda._prelude, each product and sum rounded once in their
// order: threads 0-2 compute their axis into shared memory.
//   sf f32[9]: e0[3] dd[3] inv[3];  si i32[10 + K]: start_abs[3]
//   step_dir[3] n_ax[3] tcand[K] exclude;  sg i32[3]: bbox origin region.
__global__ void __launch_bounds__(kBlock) expand_keys_kernel(
    const float* __restrict__ start_frac, int sf_stride,
    const float* __restrict__ direction, int dir_stride,
    const float* __restrict__ length, int len_stride,
    const int* __restrict__ start_abs, const int* __restrict__ end_abs,
    const unsigned char* __restrict__ valid,
    const unsigned char* __restrict__ exclude_start,
    const int* __restrict__ tcand, const int* __restrict__ gmeta, float res,
    int* __restrict__ key, float* __restrict__ trav, int* __restrict__ vox,
    int* __restrict__ missed, unsigned char* __restrict__ overflow,
    float* __restrict__ end_enter, int S, int K, int shift, int v, int sentinel,
    int exclude_origin) {
  __shared__ float sf[9];
  __shared__ int si[10 + kMaxK];
  __shared__ int sg[3];
  __shared__ float slast[3];
  __shared__ int sover[3];
  const int ray = blockIdx.x;
  const int B = gridDim.x;
  const int tid = threadIdx.x;
  // The block's loads are spread over its four warps, so that their
  // latencies overlap (one warp's divergent branches would run one after
  // the other): warp 0 (threads 0-2) the set-up, warp 1 the candidates,
  // warp 2 the bbox origin, warp 3 the exclude flag.
  if (tid < 3) {
    const int a = tid;
    // Every load first, all in flight together.
    const float d = direction[(size_t)ray * dir_stride + a];
    const float len = length[(size_t)ray * len_stride];
    const float frac = start_frac[(size_t)ray * sf_stride + a];
    const int s = start_abs[(size_t)ray * 3 + a];
    const int e = end_abs[(size_t)ray * 3 + a];
    const bool ray_valid = valid[ray] != 0;
    // A denormal component compares as zero, as under XLA (NaN does not).
    const bool normal = !(fabsf(d) < kTiny);
    const bool sign = d < 0.0f && normal;
    // inv: IEEE 1/d; +-3.0e38 where d reads as 0; 0 where the length is not > 0.
    float inv = d != 0.0f && normal ? __fdiv_rn(1.0f, d) : (sign ? -kBig : kBig);
    if (!(len > 0.0f)) inv = 0.0f;
    const float half = __fmul_rn(0.5f, res);
    const float e0 = __fmul_rn(__fsub_rn(sign ? -half : half, frac), inv);
    const float dd = fabsf(__fmul_rn(res, inv));
    const int crossings = abs(e - s);
    const int n_ax = ray_valid ? min(crossings, S) : 0;
    sf[a] = e0;
    sf[3 + a] = dd;
    sf[6 + a] = dd > 0.0f ? __fdiv_rn(1.0f, dd) : 0.0f;
    si[a] = s;
    si[3 + a] = sign ? -1 : 1;
    si[6 + a] = n_ax;
    slast[a] = n_ax > 0 ? event_time(e0, dd, n_ax - 1) : 0.0f;
    sover[a] = crossings > S;
  } else if (tid >= 32 && tid < 32 + K) {
    si[9 + tid - 32] = tcand[(size_t)ray * K + tid - 32];
  } else if (tid >= 64 && tid < 67) {
    sg[tid - 64] = gmeta[tid - 64];
  } else if (tid == 96) {
    si[9 + K] = exclude_start[ray] != 0;
  }
  __syncthreads();
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    overflow[ray] = (unsigned char)(sover[0] | sover[1] | sover[2]);
    end_enter[ray] = aten_clamp_min(
        aten_maximum(aten_maximum(slast[0], slast[1]), slast[2]), 0.0f);
  }

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

    if (trav != nullptr) {
      float prev[3];
      for (int b = 0; b < 3; ++b) {
        prev[b] = counts[b] > 0 ? event_time(sf[b], sf[3 + b], counts[b] - 1)
                                : 0.0f;
      }
      const int o1 = a == 0 ? 1 : 0;  // the other axes, ascending
      const int o2 = a == 2 ? 1 : 2;
      const float enter =
          max_keep_first(max_keep_first(prev[a], prev[o1]), prev[o2]);
      trav[(size_t)ray * W + j] = valid ? __fsub_rn(t, enter) : 0.0f;
    }
  }
  const int n = __syncthreads_count(count_miss);
  if (threadIdx.x == 0 && n != 0) atomicAdd(missed, n);
}

}  // namespace

// trav may be null (no traversal output), and so may vox (no voxel planes).
// start_frac, direction and length are f32 rows of the given strides, each
// row's axes contiguous; start_abs, end_abs (i32[B,3]), valid and
// exclude_start (bool[B]) and tcand (i32[B,K]) are contiguous.  The missed
// count is zeroed here, on the stream, before the launch.
extern "C" int ohm_expand_keys(
    const void* start_frac, int sf_stride, const void* direction, int dir_stride,
    const void* length, int len_stride, const void* start_abs, const void* end_abs,
    const void* valid, const void* exclude_start, const void* tcand,
    const void* gmeta, float resolution, void* key, void* trav, void* vox,
    void* missed, void* overflow, void* end_enter, int B, int S, int K, int shift,
    int v, int sentinel, int exclude_origin, void* stream) {
  if (K < 0 || K > kMaxK || B < 0 || S < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t rc = cudaMemsetAsync(missed, 0, sizeof(int), (cudaStream_t)stream);
  if (rc != cudaSuccess) return (int)rc;
  if (B > 0) {
    // With S == 0 the rays still need their aux outputs: one block row.
    const dim3 grid(B, S > 0 ? (3 * S + kBlock - 1) / kBlock : 1);
    expand_keys_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        (const float*)start_frac, sf_stride, (const float*)direction, dir_stride,
        (const float*)length, len_stride, (const int*)start_abs, (const int*)end_abs,
        (const unsigned char*)valid, (const unsigned char*)exclude_start,
        (const int*)tcand, (const int*)gmeta, resolution, (int*)key, (float*)trav,
        (int*)vox, (int*)missed, (unsigned char*)overflow, (float*)end_enter, S, K,
        shift, v, sentinel, exclude_origin);
  }
  return (int)cudaGetLastError();
}
