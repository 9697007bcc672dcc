// K4 — gather_plane: one int8 arena-plane value per record, widened to i32;
// and its fused form for the NDT miss phase, gather_ndt_flags.
//
// Replaces ohm_tpu/ops/deposit_pallas.py:gather_plane.  Plain PyTorch
// versions: ohm_tpu_torch/ops/gather_cuda.py gather_plane_reference and
// gather_ndt_flags_reference; wrappers: gather_plane, gather_ndt_flags.
//
// out[i] = 0 <= ids[i] < sentinel ? value(ids[i]) : 0.  The TPU kernel walks
// a sorted id stream slot by slot and turns the gather into int8 one-hot MXU
// matmuls, because the TPU's random gather is latency-bound; that is also
// why the reference builds an arena-wide int8 flag plane first
// (ohm_tpu/ops/integrate_ndt.py:195-197, the Gaussian flag "gauss8").
// Hopper reads any word directly, so the NDT miss phase does not need the
// plane: gather_ndt_flags reads occupancy and mean_count at each id and
// computes the flag there,
//
//   flag = occupancy is not +inf && (mean_count >= threshold || mean_count < 0)
//
// with mean_count's u32 bits held in an int32 (a signed compare plus the
// < 0 term, as the plain version computes it).  NaN occupancy counts as
// observed.  gather_plane keeps the plane-reading value source.
//
// Design (one kernel body, templated on the value source):
//   - each thread takes kVecs vectors of four ids, 128-bit id loads and
//     128-bit output stores, loaded before any gather so that the loads of
//     one thread are in flight together, and a scalar tail for n % 4; ids
//     and out must be 16-byte aligned (the C entry refuses others, and the
//     wrappers raise on them: the miss phase's ids come from torch.sort and
//     the outputs from the caching allocator, both aligned);
//   - vectors are interleaved across the block, so neighbouring lanes read
//     neighbouring id vectors; the ids ascend (the miss phase sorts them),
//     so neighbouring lanes read the same or neighbouring words of the
//     planes and a warp's gathers fall into a few sectors;
//   - a vector whose four ids are all outside [0, sentinel) (the sorted
//     stream's sentinel tail) stores zeros without touching the planes;
//   - the grid is sized to the record count: 4 * kVecs records a thread.
//
// What bounds it on the H100: memory.  Per record a 4-byte id read and a
// 4-byte flag written, plus the touched words of the planes: one byte per
// distinct id (plane) or eight (occupancy and mean_count).  At the NDT-OM
// bench shape (~600k ids, 1024 slots) that is ~10 MB, ~3 us; the plane
// build it replaces read 268 MB and wrote 33 MB of the arena every batch.
//
// K5 — gather_planes_f32: two f32 arena planes gathered bit for bit over a
// record stream (ohm_gather_planes_f32 below).
//
// Replaces ohm_tpu/ops/deposit_pallas.py:gather_planes_f32.  Plain PyTorch
// version: gather_cuda.py gather_planes_f32_reference; wrapper:
// gather_planes_f32.  The TSDF per-visit path reads the batch-start
// (weight, distance) pair of every record's voxel with it.
//
// One thread per record: an id below the sentinel copies each channel's
// 32-bit word at that id, loaded and stored as a bit pattern, so -0.0,
// +-inf, NaN payloads and denormals survive; any other id writes +0.0.
// The TPU kernel split each f32 into four byte planes and gathered them
// through one-hot bf16 matmuls, because Mosaic lowers an f32 dot as
// single-pass bf16; Hopper loads the word directly.  The ids are ascending
// on the main path, so neighbouring threads read neighbouring or equal
// words of each plane.
//
// What bounds it on the H100: memory.  Per record it reads a 4-byte id and
// one 4-byte word per channel and writes one word per channel: about
// 4 + 8 + 8 = 20 bytes a record with two channels, ~24 MB at the TSDF
// bench shape (~1.2M records).  One coalesced pass, both channels per
// thread, so the id is read once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kVecs = 2;                   // id vectors a thread: 4 * kVecs records
constexpr unsigned kPosInf = 0x7F800000u;  // +inf's bits

// K4's value source: the int8 plane's byte, sign-extended.
struct PlaneSource {
  const signed char* __restrict__ plane;
  __device__ __forceinline__ int operator()(int id) const {
    return (int)__ldg(plane + id);
  }
};

// The NDT miss phase's Gaussian flag, read from the arena's own layers.
struct NdtFlagSource {
  const unsigned* __restrict__ occupancy;  // f32 bits
  const int* __restrict__ mean_count;      // u32 bits
  int threshold;
  __device__ __forceinline__ int operator()(int id) const {
    const unsigned occ = __ldg(occupancy + id);
    const int count = __ldg(mean_count + id);
    return (int)(occ != kPosInf && (count >= threshold || count < 0));
  }
};

template <class Src>
__device__ __forceinline__ int gather_one(const Src& src, int id, int sentinel) {
  return (unsigned)id < (unsigned)sentinel ? src(id) : 0;
}

__device__ __forceinline__ bool any_real(int4 id, int sentinel) {
  const unsigned s = (unsigned)sentinel;
  return (unsigned)id.x < s || (unsigned)id.y < s || (unsigned)id.z < s ||
         (unsigned)id.w < s;
}

// kVecs int4 vectors a thread, then the tail (n % 4) in the last block.
template <class Src>
__global__ void __launch_bounds__(kBlock) gather_ids_vec_kernel(
    const Src src, const int* __restrict__ ids, int n, int sentinel,
    int* __restrict__ out) {
  const int4* __restrict__ ids4 = reinterpret_cast<const int4*>(ids);
  int4* __restrict__ out4 = reinterpret_cast<int4*>(out);
  const int nvec = n >> 2;
  const int v0 = blockIdx.x * (kBlock * kVecs) + threadIdx.x;
  int4 id[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int v = v0 + i * kBlock;
    id[i] = v < nvec ? __ldg(ids4 + v) : make_int4(sentinel, sentinel, sentinel, sentinel);
  }
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int v = v0 + i * kBlock;
    if (v >= nvec) continue;
    int4 r = make_int4(0, 0, 0, 0);
    if (any_real(id[i], sentinel)) {
      r.x = gather_one(src, id[i].x, sentinel);
      r.y = gather_one(src, id[i].y, sentinel);
      r.z = gather_one(src, id[i].z, sentinel);
      r.w = gather_one(src, id[i].w, sentinel);
    }
    out4[v] = r;
  }
  if (blockIdx.x == gridDim.x - 1) {
    const int t = (nvec << 2) + (int)threadIdx.x;
    if (t < n) out[t] = gather_one(src, __ldg(ids + t), sentinel);
  }
}

template <class Src>
int launch_gather(const Src& src, const int* ids, int n, int sentinel, int* out,
                  cudaStream_t stream) {
  if ((((uintptr_t)ids | (uintptr_t)out) & 15) != 0) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const int nvec = n >> 2;
  const int per_block = kBlock * kVecs;
  const int blocks = nvec > 0 ? (nvec + per_block - 1) / per_block : 1;
  gather_ids_vec_kernel<Src><<<blocks, kBlock, 0, stream>>>(src, ids, n, sentinel, out);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kBlock) gather_planes_f32_kernel(
    const unsigned* __restrict__ plane0, const unsigned* __restrict__ plane1,
    const int* __restrict__ ids, int n, int sentinel,
    unsigned* __restrict__ out0, unsigned* __restrict__ out1) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int id = ids[i];
  const bool real = (unsigned)id < (unsigned)sentinel;
  out0[i] = real ? plane0[id] : 0u;
  out1[i] = real ? plane1[id] : 0u;
}

}  // namespace

extern "C" int ohm_gather_plane(const void* plane, const void* ids, int n,
                                int sentinel, void* out, void* stream) {
  return launch_gather(PlaneSource{(const signed char*)plane}, (const int*)ids, n,
                       sentinel, (int*)out, (cudaStream_t)stream);
}

extern "C" int ohm_gather_ndt_flags(const void* occupancy, const void* mean_count,
                                    const void* ids, int n, int threshold,
                                    int sentinel, void* out, void* stream) {
  return launch_gather(
      NdtFlagSource{(const unsigned*)occupancy, (const int*)mean_count, threshold},
      (const int*)ids, n, sentinel, (int*)out, (cudaStream_t)stream);
}

extern "C" int ohm_gather_planes_f32(const void* plane0, const void* plane1,
                                     const void* ids, int n, int sentinel,
                                     void* out0, void* out1, void* stream) {
  if (n > 0) {
    gather_planes_f32_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                               (cudaStream_t)stream>>>(
        (const unsigned*)plane0, (const unsigned*)plane1, (const int*)ids, n,
        sentinel, (unsigned*)out0, (unsigned*)out1);
  }
  return (int)cudaGetLastError();
}
