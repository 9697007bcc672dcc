// P-A — five probes of the primitives a slot-grid deposit rests on, each a
// tiny kernel asking on Hopper what scripts/probe_deposit.py:probe_lowering
// asked Mosaic on the TPU (its five pallas_calls).  Plain PyTorch versions
// and wrappers: ohm_tpu_torch/ops/probes_cuda.py.
//
//  1. vmem_scatter_add  — f32 atomicAdd into a 128-float shared-memory row
//                         at 8 indices read from global memory.
//  2. take_along_axis   — an (8, 128) tile staged in shared memory; each
//                         thread reads tile[r][idx[r][c]].
//  3. dynamic_fori      — a loop whose trip count is read from device memory
//                         at run time.
//  4. dyn_offset_dma    — an asynchronous bulk copy global -> shared from a
//                         row offset read at run time: cp.async.bulk (TMA's
//                         1-D copy) completing on an mbarrier.
//  5. onehot_mxu_dot    — a one-hot product, (64 x N) . (512 x N)^T over N
//                         records, on the tensor cores (mma.sync m16n8k16,
//                         bf16 fragments built in registers, f32
//                         accumulate), spread over 16 blocks of 16 warps.
//
// Probes 1-4 are one block each and move a few KB: what bounds them on the
// H100 is launch latency, not bytes or operations, so chip_smoke.py times
// them beside an empty kernel (empty_probe), the launch floor.  The one-hot
// product's bound is its operations (2 x 64 x 512 a record on the tensor
// cores); its work is a 2-D histogram of the records, which
// torch.bincount also computes (timed beside it as its library call).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void scatter_add_probe(const int* __restrict__ idx, int n_idx,
                                  float* __restrict__ out) {
  __shared__ float row[128];
  row[threadIdx.x] = 0.0f;
  __syncthreads();
  if ((int)threadIdx.x < n_idx) atomicAdd(&row[idx[threadIdx.x] & 127], 1.0f);
  __syncthreads();
  out[threadIdx.x] = row[threadIdx.x];
}

__global__ void take_along_probe(const float* __restrict__ x,
                                 const int* __restrict__ idx,
                                 float* __restrict__ out) {
  __shared__ float tile[8][128];
  const int r = threadIdx.x >> 7;
  const int c = threadIdx.x & 127;
  tile[r][c] = x[threadIdx.x];
  __syncthreads();
  out[threadIdx.x] = tile[r][idx[threadIdx.x] & 127];
}

__global__ void dynamic_loop_probe(const int* __restrict__ n,
                                   int* __restrict__ out) {
  const int trips = *n;
  int acc = 0;
  for (int i = 0; i < trips; ++i) acc += i;
  *out = acc;
}

constexpr int kDmaRows = 4;
constexpr int kDmaCols = 128;
constexpr unsigned kDmaBytes = kDmaRows * kDmaCols * sizeof(float);

constexpr int kDmaThreads = kDmaRows * kDmaCols / 4;  // a float4 each

// Thread 0 sets up the mbarrier, reads the offset and issues the copy with
// no block barrier between them (the offset read and the copy are two
// dependent round trips, the probe's own cost); the others wait for the
// copy's bytes on the mbarrier, after one barrier that publishes whether a
// copy was issued.
__global__ void __launch_bounds__(kDmaThreads) bulk_copy_probe(
    const int* __restrict__ off, const float* __restrict__ src, int src_rows,
    float* __restrict__ out) {
  __shared__ __align__(128) float buf[kDmaRows * kDmaCols];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int copied;
  const uint32_t bar_addr = (uint32_t)__cvta_generic_to_shared(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_addr)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const int row = *off;
    copied = row >= 0 && row <= src_rows - kDmaRows;
    if (copied) {
      const uint32_t dst = (uint32_t)__cvta_generic_to_shared(buf);
      const float* from = src + (size_t)row * kDmaCols;
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar_addr),
          "r"(kDmaBytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(dst),
          "l"(from), "r"(kDmaBytes), "r"(bar_addr)
          : "memory");
    }
  }
  __syncthreads();
  float4* out4 = reinterpret_cast<float4*>(out);
  if (!copied) {  // no copy: the output differs from the plain version
    const float nan = __int_as_float(0x7fc00000);
    out4[threadIdx.x] = make_float4(nan, nan, nan, nan);
    return;
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar_addr)
        : "memory");
  }
  out4[threadIdx.x] = reinterpret_cast<const float4*>(buf)[threadIdx.x];
}

constexpr int kHi = 64;
constexpr int kLo = 512;
constexpr int kBands = kHi / 16;                       // 16-row bands
constexpr int kSplits = 4;                             // record splits a band
constexpr int kOnehotWarps = kBands * kSplits;         // 16
constexpr int kOnehotTiles = 4;                        // n8 tiles a warp
constexpr int kOnehotCols = 8 * kOnehotTiles;          // columns a block
constexpr int kOnehotBlocks = kLo / kOnehotCols;       // 16
constexpr int kStage = 2048;                           // records staged a pass

// Two bf16 one-hot elements in one register: 1.0 is 0x3f80; the element of
// the lower k index in the lower half.
__device__ __forceinline__ unsigned bf16_pair(bool lo, bool hi) {
  return (lo ? 0x3f80u : 0u) | (hi ? 0x3f800000u : 0u);
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const unsigned* a,
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out[h][l] = sum over records of (v >> 9 == h) * ((v & 511) == l), on the
// tensor cores: mma.sync m16n8k16, bf16 factors, f32 accumulate.  Block b
// owns columns [32 b, 32 b + 32), four n8 tiles; warp w the rows of band
// w % 4 ([16 (w % 4), + 16)) over every fourth 16-record step, from step
// w / 4, so four warps share a band's records and their partial sums meet
// in shared memory at the end (exact: integer-valued, in a fixed order).
// No one-hot matrix is staged: for each 16-record step a lane holds
// records 2t, 2t + 1, 2t + 8, 2t + 9 (t = lane % 4), which are the k
// indices of both its A and its B fragment elements, and it builds each
// element as a compare against its fragment's row (groupID = lane / 4, and
// + 8) or column (groupID).  The records are staged once a pass in shared
// memory (2 KB for the probe's 512).  Exact: 0/1 factors, at most
// n_records a cell, f32 accumulate.
__global__ void __launch_bounds__(kOnehotWarps * 32) onehot_mma_probe(
    const int* __restrict__ v, int n_records, float* __restrict__ out) {
  __shared__ __align__(16) int rec[kStage];
  // Partial sums of the splits 1-3, in the C fragment's lane order.
  __shared__ float part[kSplits - 1][kBands][kOnehotTiles * 4][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int band = warp % kBands;
  const int split = warp / kBands;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row = band * 16 + g;                       // A rows row, row + 8
  const int col = blockIdx.x * kOnehotCols + g;        // B column, + 8 a tile
  float acc[kOnehotTiles][4];
#pragma unroll
  for (int j = 0; j < kOnehotTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  for (int s0 = 0; s0 < n_records; s0 += kStage) {
    const int m = min(kStage, n_records - s0);  // a multiple of 16
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += blockDim.x) rec[i] = v[s0 + i];
    __syncthreads();
#pragma unroll 2
    for (int k0 = 16 * split; k0 < m; k0 += 16 * kSplits) {
      const int2 r0 = *reinterpret_cast<const int2*>(&rec[k0 + 2 * t]);
      const int2 r8 = *reinterpret_cast<const int2*>(&rec[k0 + 2 * t + 8]);
      const int h0 = r0.x >> 9, h1 = r0.y >> 9, h8 = r8.x >> 9, h9 = r8.y >> 9;
      const unsigned a[4] = {bf16_pair(h0 == row, h1 == row),
                             bf16_pair(h0 == row + 8, h1 == row + 8),
                             bf16_pair(h8 == row, h9 == row),
                             bf16_pair(h8 == row + 8, h9 == row + 8)};
      const int l0 = r0.x & (kLo - 1), l1 = r0.y & (kLo - 1);
      const int l8 = r8.x & (kLo - 1), l9 = r8.y & (kLo - 1);
#pragma unroll
      for (int j = 0; j < kOnehotTiles; ++j) {
        const int c = col + 8 * j;
        mma_bf16_16816(acc[j], a, bf16_pair(l0 == c, l1 == c), bf16_pair(l8 == c, l9 == c));
      }
    }
  }
  if (split > 0) {
#pragma unroll
    for (int j = 0; j < kOnehotTiles; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) part[split - 1][band][4 * j + r][lane] = acc[j][r];
  }
  __syncthreads();
  if (split > 0) return;
#pragma unroll
  for (int q = 0; q < kSplits - 1; ++q)
#pragma unroll
    for (int j = 0; j < kOnehotTiles; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = __fadd_rn(acc[j][r], part[q][band][4 * j + r][lane]);
  // C fragment: rows row and row + 8, columns 2t and 2t + 1 of each tile.
#pragma unroll
  for (int j = 0; j < kOnehotTiles; ++j) {
    const int c = blockIdx.x * kOnehotCols + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(out + row * kLo + c) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(out + (row + 8) * kLo + c) = make_float2(acc[j][2], acc[j][3]);
  }
}

// The launch floor: a kernel that does nothing, timed beside the probes.
__global__ void empty_probe() {}

}  // namespace

// idx: i32[n_idx <= 128] (values & 127); out: f32[128].
extern "C" int ohm_probe_scatter_add(const void* idx, int n_idx, void* out,
                                     void* stream) {
  scatter_add_probe<<<1, 128, 0, (cudaStream_t)stream>>>((const int*)idx,
                                                         n_idx, (float*)out);
  return (int)cudaGetLastError();
}

// x: f32[8, 128]; idx: i32[8, 128]; out: f32[8, 128].
extern "C" int ohm_probe_take_along(const void* x, const void* idx, void* out,
                                    void* stream) {
  take_along_probe<<<1, 8 * 128, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)idx, (float*)out);
  return (int)cudaGetLastError();
}

// n: i32[1] on the device; out: i32[1].
extern "C" int ohm_probe_dynamic_loop(const void* n, void* out, void* stream) {
  dynamic_loop_probe<<<1, 1, 0, (cudaStream_t)stream>>>((const int*)n,
                                                        (int*)out);
  return (int)cudaGetLastError();
}

// off: i32[1] on the device; src: f32[src_rows, 128], 16-byte aligned;
// out: f32[4, 128], 16-byte aligned.
extern "C" int ohm_probe_bulk_copy(const void* off, const void* src,
                                   int src_rows, void* out, void* stream) {
  bulk_copy_probe<<<1, kDmaThreads, 0, (cudaStream_t)stream>>>(
      (const int*)off, (const float*)src, src_rows, (float*)out);
  return (int)cudaGetLastError();
}

// v: i32[n_records], n_records a multiple of 16; out: f32[64, 512].
extern "C" int ohm_probe_onehot_mma(const void* v, int n_records, void* out,
                                    void* stream) {
  onehot_mma_probe<<<kOnehotBlocks, kOnehotWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int*)v, n_records, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int ohm_probe_empty(void* stream) {
  empty_probe<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
