// K2 — deposit and sweep: per-voxel hit/miss counts, then the occupancy
// update in place.
//
// Replaces ohm_tpu/ops/deposit_pallas.py:deposit_and_sweep (_deposit_core
// with _sweep_block).  Plain PyTorch version: ohm_tpu_torch/ops/
// deposit_cuda.py deposit_and_sweep_reference; wrapper: deposit_and_sweep.
//
// The key stream must be sorted ascending, as the TPU kernel's key_sorted
// is: a voxel's records then form one run, its misses (flat << 1) before
// its hits (flat << 1 | 1), and its counts are the lengths of two adjacent
// runs.  One launch, one thread per key: the record that ends its voxel's
// run (the next key's flat differs, or it is the last key) owns the voxel.
// It finds where the run starts and where its misses give way to its hits
// by galloping back from itself (1, 2, 4, ... keys) and a binary search in
// the last step, so a run of L keys costs about 2 log2 L reads, mostly from
// the L1/L2 lines its neighbours just read: no count plane, no atomic, and a
// hot voxel costs its owner no more than a few dozen reads.  The owner
// reads the voxel's batch-start value, applies the reference's update
// (kRfExcludeFree / Occupied / Unobserved, the one-sided clamp by the sign
// of the total, saturated voxels kept) and writes it back where it changes.
// Keys whose flat lies outside [0, sentinel) are skipped; the sentinel
// element is never written.  Touched voxels (the owners) are counted with
// one __syncthreads_count and one atomicAdd a block; the C entry zeroes the
// count on the stream first.
//
// What bounds it on the H100: memory.  Each key is read about once (twice
// at a block edge) and each touched voxel's occupancy read and written once:
// ~10.7 MB a batch on the occupancy box; nothing is read or written per
// arena voxel.  Not taken: the deposit probe's slot-grid kernel
// (csrc/slotgrid.cu), whose time is its largest part's block and which
// needs its part bounds searched first.
//
// Exactness: counts are capped at 65535 before the multiply, and
// total = n_hit * hit + n_miss * miss rounds each product and the sum once
// (__fmul_rn / __fadd_rn, -fmad=false), as the reference does.  -0.0 marks
// an unobserved voxel; base is +0.0 there.  The counts are integers and the
// owner is fixed by the data, so two runs give the same bits.
//
// K3 — the NDT deposit and sweep (ohm_deposit_and_sweep_ndt below).
// Replaces ohm_tpu/ops/deposit_pallas.py:deposit_and_sweep_ndt
// (_deposit_core with key2_sorted, bounds_key and delta_stream,
// _ndt_sweep_block).  Plain PyTorch version: deposit_cuda.py
// deposit_and_sweep_ndt_reference.  Two streams and a delta:
//  - the walk keys, as the NDT miss phase gives them: its sorted stream
//    with the Gaussian-handled records masked to the sentinel, and the same
//    stream unmasked (bounds; the reference kernel's bounds_key).  Within
//    each voxel's run of bounds the masked records form a prefix (the miss
//    phase applies the NDT math to the first records of a flagged voxel in
//    sorted order).  The record that ends a run of bounds owns its voxel;
//    K2's galloping searches give the run and its miss/hit split, and one
//    more galloping search the first unmasked record;
//  - the end/sample keys, in any order: a first launch counts them into a
//    small open-addressed table (2 slots or more a key, integer atomics,
//    exact in any order).  A run owner adds its voxel's entry; an entry
//    whose voxel has no run of bounds (a binary search) owns its voxel;
//  - the miss delta, either sparse (NDT-OM, NDT-TM): (flat << 1, value)
//    records sorted by id, at most one value with nonzero bits a voxel, at
//    its last record (the reference's contract, ohm_tpu/ops/
//    integrate_ndt.py:273-279), which an owner finds by a binary search; or
//    a dense f32 plane, read at the owner's voxel.  A delta record (or, for
//    the plane, a voxel) whose voxel no run and no entry owns sweeps it with
//    zero counts.  No mapper passes a plane: that pass over the arena is
//    off every path.
// The owner applies ndt_sweep: total = (n_hit * hit + n_miss * miss) +
// delta rounded three times, +inf unobserved, the one-sided clamp,
// saturated voxels kept, no exclude flags; a voxel with no count and a
// delta that compares equal to 0 (+0.0, -0.0) is left alone.  The touched
// count is the voxels with counts, as the reference's comes from its count
// planes.  Three device operations: the C entry zeroes the table and the
// count in one memset, then the two launches.
// Bound by memory like K2: the two key streams, the delta records and the
// touched voxels, read about once.  Two runs give the same bits: the table
// slot a voxel lands in depends on the order of the atomics, but its counts
// and its one owner do not.  Not taken: one sort of both streams and K2's
// kernel over it (no bounds, no table), which cost ~0.26 ms a call on the
// NDT-OM path, most of it the sort's own host work; the wrapper still
// sorts the walk keys when a caller gives no bounds.
//
// K6 — the TSDF pair deposit (ohm_tsdf_set_deposit below).
// Replaces ohm_tpu/ops/deposit_pallas.py:tsdf_set_deposit.  Plain PyTorch
// version: deposit_cuda.py tsdf_set_deposit_reference; wrapper:
// tsdf_set_deposit.  One thread per record: a record with an id below the
// sentinel and a weight > 0 stores its (weight, distance) pair into both
// planes at its id (the distance as a bit pattern, so -0.0 survives); every
// other record stores nothing.  The TPU kernel deposited the pairs through
// one-hot byte-plane matmuls per slot and then selected against the stored
// planes in a sweep; here the planes update in place, so voxels that no
// record deposits keep their pair without a sweep.  By contract at most one
// record per voxel carries w > 0 (the TSDF path's segment-last record), so
// the stores do not race.
// What bounds it on the H100: memory.  It reads each record's id, weight
// and distance (12 bytes) and writes 8 bytes per depositing record: ~15 MB
// at the TSDF bench shape (~1.2M records), no pass over the arena.

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

// The first position j <= hi with keys[j] >= target, given that every key
// from hi up to the caller's position is >= target (hi itself is not read):
// gallop back 1, 2, 4, ... keys, then a binary search in the last step.
__device__ __forceinline__ int lower_from(const int* __restrict__ keys, int hi,
                                          int target) {
  int lo = hi - 1;
  int step = 1;
  while (lo >= 0 && keys[lo] >= target) {
    hi = lo;
    step <<= 1;
    lo = hi - step;
  }
  if (lo < -1) lo = -1;
  // keys[lo] < target (or lo == -1); keys[hi] >= target.
  while (hi - lo > 1) {
    const int mid = lo + ((hi - lo) >> 1);
    if (keys[mid] < target) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return hi;
}

// The first position j in [0, n) with a[j] >= target, or n.
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int target) {
  int lo = 0;
  while (lo < n) {
    const int mid = lo + ((n - lo) >> 1);
    if (a[mid] < target) {
      lo = mid + 1;
    } else {
      n = mid;
    }
  }
  return lo;
}

// If record i of the sorted stream ends its voxel's run and the voxel lies
// in [0, sentinel): its flat id, and its hit and miss counts.  Else -1.
__device__ __forceinline__ int run_owner(const int* __restrict__ keys, int n,
                                         int i, int sentinel, int* n_hit,
                                         int* n_miss) {
  const int flat = keys[i] >> 1;
  if ((unsigned)flat >= (unsigned)sentinel) return -1;
  if (i + 1 < n && (keys[i + 1] >> 1) == flat) return -1;
  const int hit_start = lower_from(keys, i + 1, (flat << 1) | 1);
  const int run_start = lower_from(keys, hit_start, flat << 1);
  *n_hit = i + 1 - hit_start;
  *n_miss = hit_start - run_start;
  return flat;
}

__global__ void __launch_bounds__(kBlock) run_deposit_kernel(
    float* __restrict__ occ, const int* __restrict__ keys, int n_keys,
    int sentinel, SweepParams p, int* __restrict__ touched_count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int h = 0, m = 0;
  const int flat = i < n_keys ? run_owner(keys, n_keys, i, sentinel, &h, &m) : -1;
  if (flat >= 0) {
    const float x = occ[flat];
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
    const bool keep = saturated || ((p.flags & kExcludeUnobserved) && unobs);
    if (!keep) occ[flat] = value;
  }
  const int n = __syncthreads_count(flat >= 0);
  if (threadIdx.x == 0 && n != 0) atomicAdd(touched_count, n);
}

// ndt_sweep on one voxel with records or a delta.
__device__ __forceinline__ void ndt_update(float* __restrict__ occ, int flat,
                                           int h, int m, float d,
                                           const SweepParams& p) {
  const float x = occ[flat];
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
  if (!saturated) occ[flat] = value;
}

// The first j in [lo, hi) whose walk key is unmasked (walk[j] == bounds[j]),
// or hi, given that the masked records of [lo, hi) come first: a gallop
// back from hi, then a binary search.
__device__ __forceinline__ int first_unmasked(const int* __restrict__ walk,
                                              const int* __restrict__ bounds,
                                              int lo, int hi) {
  int j = hi - 1;
  int step = 1;
  while (j >= lo && walk[j] == bounds[j]) {
    hi = j;
    step <<= 1;
    j = hi - step;
  }
  int masked = j < lo ? lo - 1 : j;
  while (hi - masked > 1) {
    const int mid = masked + ((hi - masked) >> 1);
    if (walk[mid] == bounds[mid]) {
      hi = mid;
    } else {
      masked = mid;
    }
  }
  return hi;
}

// The end keys' table: n_slots (a power of two) voxel ids + 1 (0: empty),
// then their hit and their miss counts.
struct EndTable {
  int* key;
  int* hit;
  int* miss;
  int n_slots;
  int shift;  // 32 - log2(n_slots)
};

__device__ __forceinline__ int slot_of(const EndTable& t, int flat) {
  return (int)(((unsigned)flat * 2654435761u) >> t.shift) & (t.n_slots - 1);
}

__global__ void __launch_bounds__(kBlock) end_table_kernel(
    const int* __restrict__ end_keys, int n_end, int sentinel, EndTable t) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_end) return;
  const int k = end_keys[i];
  const int flat = k >> 1;
  if ((unsigned)flat >= (unsigned)sentinel) return;
  int s = slot_of(t, flat);
  while (true) {
    const int prev = atomicCAS(t.key + s, 0, flat + 1);
    if (prev == 0 || prev == flat + 1) break;
    s = (s + 1) & (t.n_slots - 1);
  }
  atomicAdd((k & 1) ? t.hit + s : t.miss + s, 1);
}

// The table slot holding ``flat``, or -1.
__device__ __forceinline__ int find_slot(const EndTable& t, int flat) {
  int s = slot_of(t, flat);
  while (true) {
    const int key = t.key[s];
    if (key == flat + 1) return s;
    if (key == 0) return -1;
    s = (s + 1) & (t.n_slots - 1);
  }
}

// Whether ``flat`` has a run in the sorted bounds stream.
__device__ __forceinline__ bool has_run(const int* __restrict__ bounds,
                                        int n, int flat) {
  const int at = lower_bound(bounds, n, flat << 1);
  return at < n && (bounds[at] >> 1) == flat;
}

// kDense: dvals is the f32 plane [sentinel] and the last threads run over
// its voxels (n_delta == sentinel, dkeys unused).  Else (dkeys, dvals) is
// the sparse stream of n_delta records.  Threads: the n_walk records of
// bounds, then the table's slots, then the delta records (or voxels).
template <bool kDense>
__global__ void __launch_bounds__(kBlock) ndt_run_deposit_kernel(
    float* __restrict__ occ, const int* __restrict__ walk,
    const int* __restrict__ bounds, int n_walk, EndTable t,
    const int* __restrict__ dkeys, const float* __restrict__ dvals,
    int n_delta, int sentinel, SweepParams p,
    int* __restrict__ touched_count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int flat = -1, h = 0, m = 0;
  float d = 0.0f;
  bool counted = false;
  if (i < n_walk) {
    int hb = 0, mb = 0;
    flat = run_owner(bounds, n_walk, (int)i, sentinel, &hb, &mb);
    if (flat >= 0) {
      // The run is [i + 1 - mb - hb, i], its hits from i + 1 - hb.
      const int run_start = (int)i + 1 - mb - hb;
      const int hit_start = (int)i + 1 - hb;
      const int fu = first_unmasked(walk, bounds, run_start, (int)i + 1);
      m = max(hit_start - fu, 0);
      h = (int)i + 1 - max(fu, hit_start);
      const int s = find_slot(t, flat);
      if (s >= 0) {
        h += t.hit[s];
        m += t.miss[s];
      }
    }
  } else if (i < (long long)n_walk + t.n_slots) {
    const int s = (int)(i - n_walk);
    const int key = t.key[s];
    if (key != 0 && !has_run(bounds, n_walk, key - 1)) {
      flat = key - 1;
      h = t.hit[s];
      m = t.miss[s];
    }
  } else if (i < (long long)n_walk + t.n_slots + n_delta) {
    const int j = (int)(i - n_walk - t.n_slots);
    const int f = kDense ? j : dkeys[j] >> 1;
    const float v = dvals[j];
    // A delta alone: where it compares unequal to 0 and no run and no
    // table entry has its voxel.
    if ((unsigned)f < (unsigned)sentinel && v != 0.0f &&
        !has_run(bounds, n_walk, f) && find_slot(t, f) < 0) {
      flat = f;
      d = v;
    }
  }
  if (flat >= 0 && i < (long long)n_walk + t.n_slots) {
    counted = h + m > 0;
    if (kDense) {
      d = dvals[flat];
    } else {
      // The voxel's last delta record: the one before the first of the
      // next voxel.
      const int j = lower_bound(dkeys, n_delta, (flat + 1) << 1) - 1;
      if (j >= 0 && (dkeys[j] >> 1) == flat) d = dvals[j];
    }
  }
  if (flat >= 0 && (h + m > 0 || d != 0.0f)) ndt_update(occ, flat, h, m, d, p);
  const int n = __syncthreads_count(counted);
  if (threadIdx.x == 0 && n != 0) atomicAdd(touched_count, n);
}

__global__ void __launch_bounds__(kBlock) tsdf_set_deposit_kernel(
    float* __restrict__ weight, unsigned* __restrict__ distance,
    const int* __restrict__ ids, const float* __restrict__ w,
    const unsigned* __restrict__ d, int n, int sentinel) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int id = ids[i];
  const float wi = w[i];
  if ((unsigned)id < (unsigned)sentinel && wi > 0.0f) {
    weight[id] = wi;
    distance[id] = d[i];
  }
}

}  // namespace

extern "C" int ohm_deposit_and_sweep(
    void* occupancy, const void* keys, int n_keys, int n_vox, int flags,
    float hit_value, float miss_value, float threshold, float min_value,
    float max_value, float saturation_min, float saturation_max,
    void* touched, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(touched, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (n_keys > 0) {
    const SweepParams p{flags,     hit_value, miss_value,     threshold,
                        min_value, max_value, saturation_min, saturation_max};
    run_deposit_kernel<<<(n_keys + kBlock - 1) / kBlock, kBlock, 0, s>>>(
        (float*)occupancy, (const int*)keys, n_keys, n_vox, p, (int*)touched);
  }
  return (int)cudaGetLastError();
}

// walk, bounds: the masked and unmasked walk streams (n_walk each; the
// same pointer twice for an unmasked sorted stream).  end_keys: n_end keys
// in any order.  scratch: int32[1 + 3 * n_slots], zeroed here; its first
// element is the touched count.  Sparse (dense == 0): the delta's keys
// dkeys, its values dvals and its length n_delta.  Dense: dvals is the
// plane [n_vox], dkeys and n_delta are not read.  (An empty tensor's
// pointer may be null, so the form is a flag of its own.)
extern "C" int ohm_deposit_and_sweep_ndt(
    void* occupancy, const void* walk, const void* bounds, int n_walk,
    const void* end_keys, int n_end, void* scratch, int log2_slots,
    const void* dkeys, const void* dvals, int n_delta, int dense, int n_vox,
    float hit_value, float miss_value, float min_value, float max_value,
    float saturation_min, float saturation_max, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_slots = 1 << log2_slots;
  int* touched = (int*)scratch;
  const EndTable t{touched + 1, touched + 1 + n_slots, touched + 1 + 2 * n_slots,
                   n_slots, 32 - log2_slots};
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(int) * (1 + 3 * (size_t)n_slots), s);
  if (err != cudaSuccess) return (int)err;
  if (n_end > 0) {
    end_table_kernel<<<(n_end + kBlock - 1) / kBlock, kBlock, 0, s>>>(
        (const int*)end_keys, n_end, n_vox, t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const SweepParams p{0,         hit_value, miss_value,     0.0f,
                      min_value, max_value, saturation_min, saturation_max};
  const long long n = (long long)n_walk + n_slots + (dense ? n_vox : n_delta);
  const int blocks = (int)((n + kBlock - 1) / kBlock);
  if (dense) {
    ndt_run_deposit_kernel<true><<<blocks, kBlock, 0, s>>>(
        (float*)occupancy, (const int*)walk, (const int*)bounds, n_walk, t,
        nullptr, (const float*)dvals, n_vox, n_vox, p, touched);
  } else {
    ndt_run_deposit_kernel<false><<<blocks, kBlock, 0, s>>>(
        (float*)occupancy, (const int*)walk, (const int*)bounds, n_walk, t,
        (const int*)dkeys, (const float*)dvals, n_delta, n_vox, p, touched);
  }
  return (int)cudaGetLastError();
}

extern "C" int ohm_tsdf_set_deposit(void* weight, void* distance,
                                    const void* ids, const void* w,
                                    const void* d, int n, int sentinel,
                                    void* stream) {
  if (n > 0) {
    tsdf_set_deposit_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                              (cudaStream_t)stream>>>(
        (float*)weight, (unsigned*)distance, (const int*)ids, (const float*)w,
        (const unsigned*)d, n, sentinel);
  }
  return (int)cudaGetLastError();
}
