// K5+K6 fused — the TSDF per-visit update (ohm_tsdf_visits below).
//
// Replaces the per-visit chain of ohm_tpu/ops/integrate_tsdf.py:300-404:
// the seed gather (deposit_pallas.py:gather_planes_f32), the blocked
// prefix sum of the visit weights (ops/blocked.py:77 segment_sums), the
// visit maps, the blocked affine-clamp composition (blocked.py:218
// segment_compose_affine_clamp), its application at each voxel's last
// record and the pair deposit (deposit_pallas.py:tsdf_set_deposit).  Plain
// PyTorch version: ohm_tpu_torch/ops/tsdf_cuda.py tsdf_visits_reference
// (K5's and K6's plain versions around ops/segments.py); wrapper:
// tsdf_visits.
//
// What it computes, over a record stream sorted by voxel id (the sentinel
// segment last): for each record the batch-start weight w0 of its voxel,
// the running weight w_run = w0 + segment_sums(w), the visit's map
// d -> clamp((d * wc + w * sdf) / (wc + w), -trunc, trunc) with
// wc = min(w_run - w, max_weight) (the identity where wc + w < near_zero),
// and the maps composed since the voxel's first record; at the voxel's last
// record, where w_run >= near_zero, the composed map applied to the stored
// distance d0 and min(w_run, max_weight) are stored in place, as K6 stores
// a record with w > 0.
//
// Bit identity with the plain version needs its order, which is
// blocked.py's: rows of 1024 records (padded with 0 / False for the sums,
// (1, 0, -3e38, 3e38) for the maps); inside a row log-shift levels for
// shift = 1 .. 512, each reading the previous level's values; across rows
// a log-shift carry over the row tails; then where(started, v,
// combine(carry, v)).  Every product, sum and quotient rounds on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn; the library builds with
// -fmad=false).  maximum / minimum / clamp are ATen's CUDA ones: a NaN
// operand is returned as it is (the first one first), otherwise fmaxf /
// fminf, whose -0.0 / +0.0 results do not depend on the operands' order.
// Two places use that freedom, with the same bits:
//   - segment_sums's segment-start maximum is a maximum over the row's
//     prefix: every NaN in it is the result of an f32 subtraction, which
//     the card gives as the one canonical NaN, so any order gives the
//     same maximum (warp shuffles, then the warps' maxima).  Whether a
//     record's segment has started, and where, is an OR: a ballot.
//   - the composition's clamps use max.NaN / min.NaN, which return the
//     canonical NaN: every NaN there is the result of an f32 product or
//     sum, so it is the canonical one as well.
//
// Design: one launch of one 1024-thread block a row, after one memset.
//   - Each block takes the next row from a counter, so every row before
//     it has been started by a resident block.
//   - In the row: the running sum (10 levels through shared memory), the
//     segment starts and the segment-start maximum, the running weight,
//     w0 at every record (K5's load; the ids ascend, so a warp's loads
//     share lines), the visit maps and their composition (10 levels; a
//     record stops combining once its segment has started in the row).
//   - Across rows: each row publishes its column of blocked.py's carry
//     table (its tail after each log-shift level over the rows, the sums'
//     and then the maps'), level by level (a release store of the count
//     of levels out, which readers acquire), and reads the level values of
//     the earlier rows it needs; a row in which a segment starts publishes
//     its whole column at once.  The carry into a row is the previous
//     row's last level.  Only a row whose first records continue a voxel
//     of an earlier row waits for it.
//   - A voxel whose first record lies in the row has all its records
//     there: its last record finishes and stores it (K6's store).  At most
//     one voxel a row began in an earlier row; thread 0 finishes it once
//     the previous row's maps carry is out, after every row holding its
//     records has published, that is, read w0.  No block stores a voxel
//     that another block still reads.
//
// What bounds it on the H100: the function needs ~8 bytes a record (id and
// w * sdf; 12 with non-uniform weights) and 16 bytes a touched voxel,
// ~21 MB or ~6 us at the TSDF bench shape (~1.2M records, ~0.74M voxels);
// the carry table adds ~0.3 MB.  The blocked order costs 10 levels of the
// running sum and 10 of the composition a row, each with a block barrier;
// on short voxel runs most warps stop combining after a few levels.

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 1024;             // ohm_tpu/ops/blocked.py's row width
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 3.0e38f;        // the maps' identity clamp
constexpr float kLowest = -3.0e38f;    // segment_sums' segment-start fill

struct Map {
  float a, b, lo, hi;
};

__device__ __forceinline__ Map identity_map() { return {1.0f, 0.0f, -kBig, kBig}; }

__device__ __forceinline__ Map to_map(float4 v) { return {v.x, v.y, v.z, v.w}; }

__device__ __forceinline__ float4 to_float4(const Map& m) {
  return make_float4(m.a, m.b, m.lo, m.hi);
}

// ATen's CUDA maximum for floats (MaxMinElementwiseKernel.cu).
__device__ __forceinline__ float aten_maximum(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

// ATen's CUDA clamp with a scalar upper bound (launch_clamp_scalar, Max).
__device__ __forceinline__ float aten_clamp_max(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}

// maximum / minimum of operands whose NaNs are all canonical (see above).
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// segments.py segment_compose_affine_clamp's combine: the map ``r`` after
// the map ``l``.
__device__ __forceinline__ Map combine(const Map& l, const Map& r) {
  Map o;
  o.a = __fmul_rn(l.a, r.a);
  o.b = __fadd_rn(__fmul_rn(r.a, l.b), r.b);
  o.lo = min_nan(max_nan(__fadd_rn(__fmul_rn(r.a, l.lo), r.b), r.lo), r.hi);
  o.hi = min_nan(max_nan(__fadd_rn(__fmul_rn(r.a, l.hi), r.b), r.lo), r.hi);
  return o;
}

struct Visits {
  const int* __restrict__ ids;
  const float* __restrict__ w;     // null: uniform, 1.0 where id != sentinel
  const float* __restrict__ wsdf;
  float* weight;                   // read and written by one launch: plain loads
  float* distance;
  int n, sentinel, levels;         // levels: the carry's log-shift levels + 1
  float trunc, max_weight, near_zero;
};

// The scratch (ohm_tsdf_visits lays it out): the row counter and the
// published levels of each row's two columns (zeroed before the launch),
// then the columns.
struct Scratch {
  unsigned* next_row;
  int* sums_ready;                 // [rows] levels of the sums' column out
  int* maps_ready;                 // [rows]
  int2* sums_col;                  // [rows * levels] (f32 bits, started)
  float4* maps_col;                // [rows * levels]
  int* maps_colr;                  // [rows * levels] started
};

struct Record {
  int id;
  bool valid, first, last;
  float w;
};

__device__ __forceinline__ Record load_record(const Visits& p, int i) {
  Record r;
  r.valid = i < p.n;
  r.id = r.valid ? __ldg(p.ids + i) : p.sentinel;
  r.first = r.valid && (i == 0 || __ldg(p.ids + i - 1) != r.id);
  r.last = r.valid && (i == p.n - 1 || __ldg(p.ids + i + 1) != r.id);
  r.w = !r.valid ? 0.0f : p.w ? __ldg(p.w + i) : (r.id != p.sentinel ? 1.0f : 0.0f);
  return r;
}

// Release ``count`` entries of a column (written by this thread): they are
// visible to any thread that acquires the count.
__device__ __forceinline__ void publish(int* ready, int count) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(ready), "r"(count) : "memory");
}

// Wait until a row has published ``count`` entries of a column.
__device__ __forceinline__ void await_levels(const int* ready, int count) {
  int seen;
  do {
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(seen) : "l"(ready) : "memory");
  } while (seen < count);
}

// Row x's column of the sums' carry table (blocked.py segment_sums's
// log-shift over the row tails): v = where(r, v, pv + v), r = r | pr with
// (pv, pr) the level's value at row x - shift, (0.0, False) before row 0.
__device__ void sums_column(const Visits& p, const Scratch& s, int x, float v, int r) {
  int2* col = s.sums_col + (size_t)x * p.levels;
  col[0] = make_int2(__float_as_int(v), r);
  for (int l = 1; l < p.levels && r; ++l) col[l] = col[0];
  publish(s.sums_ready + x, r ? p.levels : 1);
  for (int l = 1; l < p.levels && !r; ++l) {
    const int shift = 1 << (l - 1);
    if (x < shift) {
      v = __fadd_rn(0.0f, v);
    } else {
      await_levels(s.sums_ready + x - shift, l);
      const int2 e = __ldcg(s.sums_col + (size_t)(x - shift) * p.levels + l - 1);
      v = __fadd_rn(__int_as_float(e.x), v);
      r = e.y;
    }
    col[l] = make_int2(__float_as_int(v), r);
    if (r) {
      for (int k = l + 1; k < p.levels; ++k) col[k] = col[l];
      publish(s.sums_ready + x, p.levels);
    } else {
      publish(s.sums_ready + x, l + 1);
    }
  }
}

// Row x's column of the maps' carry table (segment_compose_affine_clamp's
// log-shift over the row tails): v = where(r, v, combine(shifted, v)),
// the identity map before row 0.
__device__ void maps_column(const Visits& p, const Scratch& s, int x, Map v, int r) {
  float4* col = s.maps_col + (size_t)x * p.levels;
  int* colr = s.maps_colr + (size_t)x * p.levels;
  for (int l = 0; l < (r ? p.levels : 1); ++l) {
    col[l] = to_float4(v);
    colr[l] = r;
  }
  publish(s.maps_ready + x, r ? p.levels : 1);
  for (int l = 1; l < p.levels && !r; ++l) {
    const int shift = 1 << (l - 1);
    if (x < shift) {
      v = combine(identity_map(), v);
    } else {
      await_levels(s.maps_ready + x - shift, l);
      const size_t at = (size_t)(x - shift) * p.levels + l - 1;
      v = combine(to_map(__ldcg(s.maps_col + at)), v);
      r = __ldcg(s.maps_colr + at);
    }
    for (int k = l; k < (r ? p.levels : l + 1); ++k) {
      col[k] = to_float4(v);
      colr[k] = r;
    }
    publish(s.maps_ready + x, r ? p.levels : l + 1);
  }
}

// The voxel's last record: where w_run >= near_zero, store
// (min(w_run, max_weight), the map applied to d0) as K6 stores a record
// with w > 0.  The caller has checked last and id != sentinel.
__device__ __forceinline__ void deposit_visit(const Visits& p, int id, const Map& m,
                                              float w_run, float d0) {
  if (!(w_run >= p.near_zero) || (unsigned)id >= (unsigned)p.sentinel) return;
  const float w_k = aten_clamp_max(w_run, p.max_weight);
  if (!(w_k > 0.0f)) return;
  p.weight[id] = w_k;
  p.distance[id] = min_nan(max_nan(__fadd_rn(__fmul_rn(m.a, d0), m.b), m.lo), m.hi);
}

__global__ void __launch_bounds__(kRow, 2) tsdf_visits_kernel(Visits p, Scratch s) {
  __shared__ float sv[2 * kRow];       // the running sum's levels
  __shared__ float4 sm[2 * kRow];      // the composition's levels
  __shared__ float warp_base[32];
  __shared__ int warp_first[32];
  __shared__ int row_s;
  __shared__ float tail_v, carry_s;
  __shared__ int tail_r, park_id;
  __shared__ float4 tail_m, park_m;
  __shared__ float park_w, park_d0;
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  if (j == 0) {
    row_s = (int)atomicAdd(s.next_row, 1u);
    park_id = -1;
  }
  __syncthreads();
  const int row = row_s;
  const int i = row * kRow + j;
  const Record r = load_record(p, i);
  // K5's loads, issued before the scans: the stored pair's bits where
  // 0 <= id < sentinel, else +0.0 (d0 only at a voxel's last record).
  const bool real = r.valid && (unsigned)r.id < (unsigned)p.sentinel;
  const float w0 = real ? p.weight[r.id] : 0.0f;
  const float d0 = real && r.last ? p.distance[r.id] : 0.0f;
  const float wsdf = r.valid ? __ldg(p.wsdf + i) : 0.0f;

  // segment_sums: the running sum, level by level.
  float c = r.w;
  int q = 0;
  for (int shift = 1; shift < kRow; shift <<= 1, q ^= 1) {
    sv[q * kRow + j] = c;
    __syncthreads();
    // The shift's +0.0 fill before the row's start: -0.0 becomes +0.0.
    c = __fadd_rn(c, j >= shift ? sv[q * kRow + j - shift] : 0.0f);
  }
  // The segment-start maximum and the row's last segment start at or
  // before j: inside the warp, then over the warps before it.
  float base = r.first ? __fsub_rn(c, r.w) : kLowest;
  for (int shift = 1; shift < 32; shift <<= 1) {
    const float x = __shfl_up_sync(kFull, base, shift);
    if (lane >= shift) base = aten_maximum(base, x);
  }
  const unsigned firsts = __ballot_sync(kFull, r.first) & (kFull >> (31 - lane));
  int start = firsts ? (warp << 5) + 31 - __clz(firsts) : -1;
  if (lane == 31) {
    warp_base[warp] = base;
    warp_first[warp] = start;
  }
  __syncthreads();
  if (warp == 0) {
    float b = warp_base[lane];
    int f = warp_first[lane];
    for (int shift = 1; shift < 32; shift <<= 1) {
      const float xb = __shfl_up_sync(kFull, b, shift);
      const int xf = __shfl_up_sync(kFull, f, shift);
      if (lane >= shift) {
        b = aten_maximum(b, xb);
        f = max(f, xf);
      }
    }
    warp_base[lane] = b;
    warp_first[lane] = f;
  }
  __syncthreads();
  if (warp > 0) {
    base = aten_maximum(base, warp_base[warp - 1]);
    if (start < 0) start = warp_first[warp - 1];
  }
  const bool started = start >= 0;
  const float local = __fsub_rn(c, base);
  if (j == kRow - 1) {
    tail_v = started ? local : c;
    tail_r = started;
  }
  __syncthreads();
  if (j == 0) {
    sums_column(p, s, row, tail_v, tail_r);
    // The carry, where the row's first records continue a segment.
    if (!started) {
      await_levels(s.sums_ready + row - 1, p.levels);
      carry_s = __int_as_float(__ldcg(s.sums_col + (size_t)row * p.levels - 1).x);
    }
  }
  __syncthreads();
  const float sum = started ? local : __fadd_rn(carry_s, c);

  // The visit maps.
  const float w_run = __fadd_rn(w0, sum);
  Map v = identity_map();
  if (r.valid) {
    const float wc_prev = aten_clamp_max(__fsub_rn(w_run, r.w), p.max_weight);
    const float new_w = __fadd_rn(wc_prev, r.w);
    if (new_w >= p.near_zero) {  // else the visit is skipped: the identity
      v = {__fdiv_rn(wc_prev, new_w), __fdiv_rn(wsdf, new_w), -p.trunc, p.trunc};
    }
  }
  // segment_compose_affine_clamp in the row: at the level of ``shift`` a
  // record keeps its map once its segment started within shift records.
  const int since_start = started ? j - start : kRow;
  q = 0;
  for (int shift = 1; shift < kRow; shift <<= 1, q ^= 1) {
    sm[q * kRow + j] = to_float4(v);
    __syncthreads();
    if (since_start >= shift) {
      v = combine(j >= shift ? to_map(sm[q * kRow + j - shift]) : identity_map(), v);
    }
  }
  if (j == kRow - 1) tail_m = to_float4(v);
  if (r.last && r.id != p.sentinel) {
    if (started) {
      deposit_visit(p, r.id, v, w_run, d0);
    } else {
      park_m = to_float4(v);
      park_w = w_run;
      park_id = r.id;
      park_d0 = d0;
    }
  }
  __syncthreads();
  if (j == 0) {
    maps_column(p, s, row, to_map(tail_m), tail_r);
    if (park_id >= 0) {
      await_levels(s.maps_ready + row - 1, p.levels);
      const Map carry = to_map(__ldcg(s.maps_col + (size_t)row * p.levels - 1));
      deposit_visit(p, park_id, combine(carry, to_map(park_m)), park_w, park_d0);
    }
  }
}

}  // namespace

// Scratch: 4 + 4 * ceil(rows / 2) + 7 * rows * levels 4-byte words, 16-byte
// aligned (tsdf_cuda.py _scratch_words): the counter and the ready counts
// first, zeroed by one memset, then the columns.  Device operations: one
// memset, one kernel.
extern "C" int ohm_tsdf_visits(void* weight, void* distance, const void* ids,
                               const void* w, const void* wsdf, int n, int sentinel,
                               float trunc, float max_weight, float near_zero,
                               void* scratch, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int rows = (n + kRow - 1) / kRow;
  int levels = 1;  // the carry's log-shift levels (shift < rows), plus its tail
  while ((1 << (levels - 1)) < rows) ++levels;
  const size_t head = 4 + 4 * (size_t)((rows + 1) / 2);  // words, a multiple of 4
  Scratch s;
  s.next_row = reinterpret_cast<unsigned*>(scratch);
  s.sums_ready = reinterpret_cast<int*>(s.next_row + 4);
  s.maps_ready = s.sums_ready + rows;
  s.maps_col = reinterpret_cast<float4*>(s.next_row + head);
  s.sums_col = reinterpret_cast<int2*>(s.maps_col + (size_t)rows * levels);
  s.maps_colr = reinterpret_cast<int*>(s.sums_col + (size_t)rows * levels);
  const Visits p{(const int*)ids, (const float*)w, (const float*)wsdf, (float*)weight,
                 (float*)distance, n, sentinel, levels, trunc, max_weight, near_zero};
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = cudaMemsetAsync(scratch, 0, head * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  tsdf_visits_kernel<<<rows, kRow, 0, st>>>(p, s);
  return (int)cudaGetLastError();
}
