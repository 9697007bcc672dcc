// P-B — the slot-grid deposit: per-voxel hit and miss counts of a sorted
// (flat << 1 | hit) key stream over n_slots slots of 32768 voxels, then the
// occupancy sweep of the counted voxels, in place.
//
// Replaces scripts/probe_deposit.py:pallas_deposit_build (its pallas_call).
// Plain PyTorch version: ohm_tpu_torch/ops/slotgrid_cuda.py
// slotgrid_deposit_reference; wrapper: slotgrid_deposit.
//
// The TPU kernel runs its grid over the arena's slots, because the MXU
// wants one slot's count plane in VMEM: each step DMAs the slot's key
// windows and deposits one-hot factors into a (2 x 64, 512) f32 plane by
// matmuls.  On the card the stream is already sorted, so a voxel's records
// form one run, its misses (flat << 1) before its hits (flat << 1 | 1), and
// its counts are run lengths.  So here:
//
//  - One launch, balanced by record, not by slot: each block takes a tile
//    of kTile keys, loaded coalesced in 16-byte vectors into shared memory,
//    with one halo key on each side.  A zipf-hot slot or voxel costs no
//    block more than any other.
//  - The record that ends its voxel's run owns the voxel (the next key's
//    flat differs, or it is the last key).  It reads its miss and hit counts
//    off positions: run starts inside the tile come from neighbour compares
//    and a block max-scan of start positions in shared memory.
//  - Only a run that crosses the tile's left edge, and ends in the tile,
//    searches back in global memory, once for the tile: warp 0 gallops
//    (its 32 lanes read 1, 2, 4, ... 2^30 keys back at once) and then
//    narrows the bracket 32 ways a step, so a run of L keys costs about
//    1 + log32(L) dependent reads, and the long_run stream's 70,144 equal
//    keys cost one search, not one block (K2's lower_from gallops one
//    thread at a time: ~2 log2 L reads).  Tiles wholly inside a run have
//    no owner and search nothing.
//  - The owner applies the probe's sweep (f32, each product and the sum
//    rounded once: __fmul_rn / __fadd_rn, -fmad=false; base 0 where occ is
//    +inf; the one-sided clamp by the sign of the total, as ternaries, so a
//    NaN stays NaN) and writes the voxel back.  Unfused, it writes
//    hit * 65536 + miss, after the C entry's memset of the n_slots * V
//    floats.
//  - Keys whose flat lies outside [0, n_slots * V) are skipped; nothing
//    past n_slots * V is read or written.
//
// Counts are exact integers, not capped (the reference's f32 accumulator
// is exact to 2^24), and each voxel has one owner fixed by the data: no
// atomics, and two runs give the same bits.
//
// What bounds it on the H100: memory.  Each key is read once (5.0 MB at the
// bench shape, plus one halo key a side and a tile) and each touched voxel
// read and written once (~5.1 MB); the scattered occupancy accesses land in
// 32-byte sectors, which set the floor this design can reach
// (chip_smoke.py's design_bound_ms counts them).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPer = 8;  // keys a thread
constexpr int kTile = kThreads * kPer;
constexpr int kWarps = kThreads / 32;

struct SweepValues {
  float hit, miss, min_value, max_value;
};

// The first position p <= hi with keys[p] >= target, given that the keys
// are sorted and keys[hi] >= target (hi itself is not read).  One whole
// warp calls it with the same arguments.
__device__ int warp_lower_from(const int* __restrict__ keys, int hi,
                               int target) {
  const int lane = threadIdx.x & 31;
  // Gallop: lane j reads hi - 2^j.  The lanes that find keys >= target are
  // a prefix (positions fall as j rises).
  const int back = lane < 31 ? (1 << lane) : 0;
  const bool ge = lane < 31 && back <= hi && keys[hi - back] >= target;
  const int m = __popc(__ballot_sync(0xffffffffu, ge));
  int lo = (m >= 31 || (1 << m) > hi) ? -1 : hi - (1 << m);
  if (m > 0) hi -= 1 << (m - 1);
  // keys[lo] < target (or lo == -1), keys[hi] >= target: narrow 32 ways.
  while (hi - lo > 1) {
    const int step = (hi - lo - 1 + 31) >> 5;
    const int p = lo + (lane + 1) * step;
    const bool g = p >= hi || keys[p] >= target;
    const int c = __popc(~__ballot_sync(0xffffffffu, g));  // a prefix of lanes
    const int base = lo;
    if (c > 0) lo = base + c * step;
    hi = min(hi, base + (c + 1) * step);
  }
  return hi;
}

__global__ void __launch_bounds__(kThreads) slotgrid_run_kernel(
    const int* __restrict__ keys, int n, int n_vox, float* __restrict__ occ,
    SweepValues p, int fuse) {
  // tile[4 + i] holds keys[base + i]; tile[3] and tile[4 + count] the halo.
  __shared__ __align__(16) int tile[kTile + 8];
  __shared__ int warp_v[kWarps], warp_k[kWarps];
  __shared__ int edge_run, edge_hit;
  const int base = blockIdx.x * kTile;
  const int count = min(kTile, n - base);
  for (int q = threadIdx.x; q < kTile / 4; q += kThreads) {
    const int i = 4 * q;
    if (i + 4 <= count) {
      *reinterpret_cast<int4*>(&tile[4 + i]) =
          __ldg(reinterpret_cast<const int4*>(keys + base + i));
    } else {
      for (int j = i; j < count && j < i + 4; ++j) tile[4 + j] = keys[base + j];
    }
  }
  if (threadIdx.x == 0) {
    tile[3] = base > 0 ? keys[base - 1] : 0;
    tile[4 + count] = base + count < n ? keys[base + count] : 0;
  }
  __syncthreads();

  // Each thread's kPer consecutive keys and their neighbours.  The owners
  // are known from the neighbour compares alone, so their occupancy reads
  // go out now, under the left-edge search, the scan and its barrier.
  const int i0 = kPer * threadIdx.x;
  int k[kPer];
  {
    const int4 a = *reinterpret_cast<const int4*>(&tile[4 + i0]);
    const int4 b = *reinterpret_cast<const int4*>(&tile[8 + i0]);
    k[0] = a.x; k[1] = a.y; k[2] = a.z; k[3] = a.w;
    k[4] = b.x; k[5] = b.y; k[6] = b.z; k[7] = b.w;
  }
  int flat[kPer];
  float x[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = i0 + j;
    const int next = j + 1 < kPer ? k[j + 1] : tile[4 + i0 + kPer];
    const int f = k[j] >> 1;
    const bool owner = i < count && (base + i == n - 1 || (next >> 1) != f) &&
                       (unsigned)f < (unsigned)n_vox;
    flat[j] = owner ? f : -1;
    x[j] = owner && fuse ? occ[f] : 0.0f;
  }

  // Warp 0: the run that crosses the left edge, if its owner is here.
  if (threadIdx.x < 32) {
    const int k0 = tile[4];
    const int f = k0 >> 1;
    const bool continues = base > 0 && (tile[3] >> 1) == f;
    const bool ends_here = (tile[4 + count - 1] >> 1) != f ||
                           base + count == n || (tile[4 + count] >> 1) != f;
    if (continues && ends_here && (unsigned)f < (unsigned)n_vox) {
      // A hit key run that crosses the edge needs its own start; else the
      // owners find their hit starts in the tile.
      const int hit_start = ((k0 & 1) && tile[3] == k0)
                                ? warp_lower_from(keys, base, k0)
                                : base;
      const int run_start = warp_lower_from(keys, hit_start, f << 1);
      if (threadIdx.x == 0) {
        edge_hit = hit_start;
        edge_run = run_start;
      }
    }
  }

  // Inclusive max-scan of the positions where a voxel run (sv) and a key
  // run (sk) start.
  int prev = tile[3 + i0];
  int sv[kPer], sk[kPer];
  int run_v = -1, run_k = -1;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int g = base + i0 + j;
    const bool first = g == 0;
    if (i0 + j < count) {
      if (first || (prev >> 1) != (k[j] >> 1)) run_v = i0 + j;
      if (first || prev != k[j]) run_k = i0 + j;
    }
    sv[j] = run_v;
    sk[j] = run_k;
    prev = k[j];
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl_v = run_v, incl_k = run_k;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int xv = __shfl_up_sync(0xffffffffu, incl_v, off);
    const int xk = __shfl_up_sync(0xffffffffu, incl_k, off);
    if (lane >= off) {
      incl_v = max(incl_v, xv);
      incl_k = max(incl_k, xk);
    }
  }
  int carry_v = __shfl_up_sync(0xffffffffu, incl_v, 1);
  int carry_k = __shfl_up_sync(0xffffffffu, incl_k, 1);
  if (lane == 0) carry_v = carry_k = -1;
  if (lane == 31) {
    warp_v[warp] = incl_v;
    warp_k[warp] = incl_k;
  }
  __syncthreads();
  for (int w = 0; w < warp; ++w) {
    carry_v = max(carry_v, warp_v[w]);
    carry_k = max(carry_k, warp_k[w]);
  }

  // The owners' counts.
  int h[kPer], m[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (flat[j] < 0) continue;
    const int g = base + i0 + j;
    const int vs = max(carry_v, sv[j]);
    const int run_start = vs >= 0 ? base + vs : edge_run;
    if (k[j] & 1) {
      const int ks = max(carry_k, sk[j]);
      const int hit_start = ks >= 0 ? base + ks : edge_hit;
      h[j] = g + 1 - hit_start;
      m[j] = hit_start - run_start;
    } else {
      h[j] = 0;
      m[j] = g + 1 - run_start;
    }
  }
  if (!fuse) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (flat[j] >= 0) {
        occ[flat[j]] = __fadd_rn(__fmul_rn(__int2float_rn(h[j]), 65536.0f),
                                 __int2float_rn(m[j]));
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (flat[j] < 0) continue;
    const float total = __fadd_rn(__fmul_rn(__int2float_rn(h[j]), p.hit),
                                  __fmul_rn(__int2float_rn(m[j]), p.miss));
    const bool unobs = x[j] == __int_as_float(0x7f800000);  // +inf
    float value = __fadd_rn(unobs ? 0.0f : x[j], total);
    // Ternaries, not fminf/fmaxf: a NaN stays NaN, as in the reference.
    if (total > 0.0f) value = value > p.max_value ? p.max_value : value;
    if (total < 0.0f) value = value < p.min_value ? p.min_value : value;
    occ[flat[j]] = value;
  }
}

}  // namespace

// keys: i32[n_keys], sorted, 16-byte aligned; occ: f32[>= n_vox], updated
// in place (n_vox = n_slots * 32768).  Fused: one launch; unfused: a memset
// of occ[0, n_vox) and one launch.
extern "C" int ohm_slotgrid_deposit(const void* keys, int n_keys, int n_vox,
                                    void* occ, float hit_value,
                                    float miss_value, float min_value,
                                    float max_value, int fuse_sweep,
                                    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (!fuse_sweep && n_vox > 0) {
    const cudaError_t err =
        cudaMemsetAsync(occ, 0, (size_t)n_vox * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_keys > 0) {
    const SweepValues p{hit_value, miss_value, min_value, max_value};
    slotgrid_run_kernel<<<(n_keys + kTile - 1) / kTile, kThreads, 0, s>>>(
        (const int*)keys, n_keys, n_vox, (float*)occ, p, fuse_sweep);
  }
  return (int)cudaGetLastError();
}
