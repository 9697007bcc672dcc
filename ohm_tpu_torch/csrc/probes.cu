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
//  5. onehot_mxu_dot    — one-hot bf16 factors (64 x 128 and 512 x 128 per
//                         128-record row, 4 rows) contracted over the records
//                         on the tensor cores (wmma bf16 16x16x16, f32
//                         accumulate).
//
// Each launch is one block and moves a few KB: what bounds them on the H100
// is launch latency, not bytes or operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

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

__global__ void bulk_copy_probe(const int* __restrict__ off,
                                const float* __restrict__ src, int src_rows,
                                float* __restrict__ out) {
  __shared__ __align__(128) float buf[kDmaRows * kDmaCols];
  __shared__ __align__(8) uint64_t bar;
  const uint32_t bar_addr = (uint32_t)__cvta_generic_to_shared(&bar);
  const int row = *off;
  const bool in_range = row >= 0 && row <= src_rows - kDmaRows;
  if (threadIdx.x == 0 && in_range) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_addr)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (!in_range) {  // no copy: the output differs from the plain version
    out[threadIdx.x] = __int_as_float(0x7fc00000);
    return;
  }
  if (threadIdx.x == 0) {
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
  out[threadIdx.x] = buf[threadIdx.x];
}

constexpr int kHi = 64;
constexpr int kLo = 512;
constexpr int kKChunk = 32;  // records staged per step
constexpr int kOnehotWarps = 16;

// out[h][l] = sum over records of (hi == h) * (lo == l).  Each of the 16
// warps owns one 16-row band (4 bands) and eight 16-column tiles (32 tile
// columns).  A step stages 32 records as A (64 x 32, row-major) and B^T
// (32 x 512, row-major) in bf16 and runs two k = 16 products a tile.
__global__ void __launch_bounds__(kOnehotWarps * 32) onehot_mma_probe(
    const int* __restrict__ v, int n_records, float* __restrict__ out) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 a[kHi * kKChunk];
  __shared__ __align__(32) __nv_bfloat16 bt[kKChunk * kLo];
  const int warp = threadIdx.x >> 5;
  const int band = warp >> 2;
  const int col0 = (warp & 3) * 8;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) wmma::fill_fragment(acc[t], 0.0f);
  const __nv_bfloat16 one = __float2bfloat16(1.0f);
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  for (int k0 = 0; k0 < n_records; k0 += kKChunk) {
    for (int e = threadIdx.x; e < kHi * kKChunk; e += blockDim.x) {
      const int h = e / kKChunk;
      const int r = k0 + e % kKChunk;
      a[e] = (r < n_records && (v[r] >> 9) == h) ? one : zero;
    }
    for (int e = threadIdx.x; e < kKChunk * kLo; e += blockDim.x) {
      const int r = k0 + e / kLo;
      const int l = e % kLo;
      bt[e] = (r < n_records && (v[r] & (kLo - 1)) == l) ? one : zero;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kKChunk / 16; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, a + band * 16 * kKChunk + ks * 16, kKChunk);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, bt + ks * 16 * kLo + (col0 + t) * 16, kLo);
        wmma::mma_sync(acc[t], fa, fb, acc[t]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    wmma::store_matrix_sync(out + band * 16 * kLo + (col0 + t) * 16, acc[t], kLo,
                            wmma::mem_row_major);
  }
}

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
// out: f32[4, 128].
extern "C" int ohm_probe_bulk_copy(const void* off, const void* src,
                                   int src_rows, void* out, void* stream) {
  bulk_copy_probe<<<1, kDmaRows * kDmaCols, 0, (cudaStream_t)stream>>>(
      (const int*)off, (const float*)src, src_rows, (float*)out);
  return (int)cudaGetLastError();
}

// v: i32[n_records], voxel indices in [0, 32768); out: f32[64, 512].
extern "C" int ohm_probe_onehot_mma(const void* v, int n_records, void* out,
                                    void* stream) {
  onehot_mma_probe<<<1, kOnehotWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int*)v, n_records, (float*)out);
  return (int)cudaGetLastError();
}
