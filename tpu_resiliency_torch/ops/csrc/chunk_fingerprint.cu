// Per-chunk change fingerprint of one checkpoint shard.
//
// Replaces tpu_resiliency/checkpointing/async_ckpt/device_digest.py::
// _build_fp_fn (:129, the inner `fp` with `_as_lanes`), which is jitted
// XLA, not Pallas.  It computes exactly what that function computes:
//
// - Lanes: the shard's bytes in C order, as uint32.  4- and 8-byte dtypes
//   are a bitcast (an 8-byte element gives two lanes, in byte order);
//   2-byte dtypes (bf16 included) widen uint16 lanes, 1-byte dtypes and
//   bool widen uint8 lanes.
// - Mix: with g the lane's index over the whole shard (uint32, wrapping),
//   h = fmix32(lane ^ g * 0x9E3779B9), the murmur3 finalizer.
// - Sums: for each chunk of writer.chunk_grid(nbytes, chunk_bytes,
//   use_direct), with pos the lane's 1-based position in its chunk,
//   out[c] = (sum h, sum h * pos), both mod 2^32: uint32[n_chunks, 2].
//
// The grid is fixed by three integers passed by value: the lanes of a
// chunk, the lane at the direct/buffered boundary (chunks never straddle
// it) and the total lanes.  Chunks [0, n_low) tile [0, boundary), the rest
// tile [boundary, total), each as many chunk_lanes as fit.
//
// What bounds it on an H100: it reads the shard once (nbytes) and writes
// 8 bytes per chunk, a few integer operations per lane, so it is bound by
// bytes.  On the checkpoint path it runs once per leaf of the train state,
// 141 launches per save of the flagship model, most of them on leaves of
// a few KB, where the launch itself is the cost.
//
// Design (a first, simple one): a 2-D grid of (chunks, blocks per chunk);
// each thread walks its chunk with a block-stride loop of lane-width
// scalar loads (neighbouring threads read neighbouring lanes), the block
// reduces both sums with warp shuffles and one shared-memory step, and one
// thread adds them into the chunk's row with two atomicAdds.  Unsigned
// addition mod 2^32 is associative and commutative, so the result is
// bit-exact in any order.  The row is zeroed by cudaMemsetAsync on the
// same stream first.  Loads at the lane's own width are safe at any start
// offset; 16-byte loads would need a scalar peel as in quorum_max.cu.
//
// The entry takes the device index and makes it current only when it is
// not, enqueues on `stream`, does not synchronise, and returns
// cudaGetLastError() as an int: 0 when both operations were accepted.
//
// The library also carries the two host calls of the checkpoint's staging
// (tpurx_host_register / tpurx_host_unregister): page-locking the shared
// memory that device-to-host copies land in.  They are here, behind ctypes,
// because ctypes releases the GIL for the call, and page-locking a few
// hundred MB takes long enough that holding it would stall the training
// thread.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kPhi = 0x9E3779B9u;
constexpr uint32_t kMix1 = 0x85EBCA6Bu;
constexpr uint32_t kMix2 = 0xC2B2AE35u;

// Makes `device` current for the launch when it is not, and restores the
// previous device on scope exit.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    status_ = cudaGetDevice(&prev_);
    if (status_ == cudaSuccess && prev_ != device) {
      status_ = cudaSetDevice(device);
      switched_ = status_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) {
      cudaSetDevice(prev_);
    }
  }
  cudaError_t status() const { return status_; }

 private:
  int prev_ = -1;
  bool switched_ = false;
  cudaError_t status_;
};

__device__ __forceinline__ uint32_t mix(uint32_t lane, uint32_t g) {
  uint32_t h = lane ^ (g * kPhi);
  h ^= h >> 16;
  h *= kMix1;
  h ^= h >> 13;
  h *= kMix2;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  return v;
}

// Lane is uint8_t, uint16_t or uint32_t: the width of one lane in memory.
template <typename Lane>
__global__ void __launch_bounds__(kThreads)
    fingerprint_kernel(const Lane* __restrict__ x, int64_t chunk_lanes,
                       int64_t boundary, int64_t total, int64_t n_low,
                       uint32_t* __restrict__ out) {
  const int64_t chunk = blockIdx.x;
  int64_t start;
  int64_t end;
  if (chunk < n_low) {
    start = chunk * chunk_lanes;
    end = start + chunk_lanes < boundary ? start + chunk_lanes : boundary;
  } else {
    start = boundary + (chunk - n_low) * chunk_lanes;
    end = start + chunk_lanes < total ? start + chunk_lanes : total;
  }
  const int64_t len = end - start;
  const int64_t stride = static_cast<int64_t>(gridDim.y) * kThreads;
  uint32_t a = 0;
  uint32_t b = 0;
  for (int64_t i = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
       i < len; i += stride) {
    const int64_t g = start + i;
    const uint32_t h = mix(static_cast<uint32_t>(x[g]), static_cast<uint32_t>(g));
    a += h;
    b += h * static_cast<uint32_t>(i + 1);
  }
  a = warp_sum(a);
  b = warp_sum(b);

  __shared__ uint32_t part_a[kWarps];
  __shared__ uint32_t part_b[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    part_a[warp] = a;
    part_b[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = warp_sum(lane < kWarps ? part_a[lane] : 0u);
    b = warp_sum(lane < kWarps ? part_b[lane] : 0u);
    if (lane == 0) {
      atomicAdd(out + 2 * chunk, a);
      atomicAdd(out + 2 * chunk + 1, b);
    }
  }
}

}  // namespace

// x: total_lanes lanes of lane_bytes (1, 2 or 4) bytes on the device,
// aligned to lane_bytes; chunk_lanes >= 1; 0 <= boundary_lane <=
// total_lanes; n_chunks must equal the grid's chunk count (1 <= n_chunks
// < 2^31); 1 <= blocks_per_chunk <= 65535; out: 2 * n_chunks uint32 on
// the device, zeroed here on `stream` before the launch.
extern "C" int tpurx_chunk_fingerprint(const void* x, int lane_bytes,
                                       int64_t total_lanes, int64_t chunk_lanes,
                                       int64_t boundary_lane, int64_t n_chunks,
                                       int blocks_per_chunk, uint32_t* out,
                                       int device, void* stream) {
  if (chunk_lanes < 1 || boundary_lane < 0 || boundary_lane > total_lanes ||
      blocks_per_chunk < 1 || blocks_per_chunk > 65535 ||
      (lane_bytes != 1 && lane_bytes != 2 && lane_bytes != 4) ||
      (reinterpret_cast<uintptr_t>(x) % lane_bytes) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_low = (boundary_lane + chunk_lanes - 1) / chunk_lanes;
  const int64_t n_high =
      (total_lanes - boundary_lane + chunk_lanes - 1) / chunk_lanes;
  if (n_chunks != n_low + n_high || n_chunks < 1 || n_chunks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) {
    return static_cast<int>(guard.status());
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      cudaMemsetAsync(out, 0, sizeof(uint32_t) * 2 * n_chunks, s);
  if (rc != cudaSuccess) {
    return static_cast<int>(rc);
  }
  const dim3 grid(static_cast<unsigned>(n_chunks),
                  static_cast<unsigned>(blocks_per_chunk));
  switch (lane_bytes) {
    case 4:
      fingerprint_kernel<uint32_t><<<grid, kThreads, 0, s>>>(
          static_cast<const uint32_t*>(x), chunk_lanes, boundary_lane,
          total_lanes, n_low, out);
      break;
    case 2:
      fingerprint_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
          static_cast<const uint16_t*>(x), chunk_lanes, boundary_lane,
          total_lanes, n_low, out);
      break;
    default:
      fingerprint_kernel<uint8_t><<<grid, kThreads, 0, s>>>(
          static_cast<const uint8_t*>(x), chunk_lanes, boundary_lane,
          total_lanes, n_low, out);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

// Page-locks [ptr, ptr + bytes) for every CUDA context (portable), so that
// copies between it and any device run asynchronously.  Returns the
// cudaError_t as an int.
extern "C" int tpurx_host_register(void* ptr, size_t bytes) {
  return static_cast<int>(cudaHostRegister(ptr, bytes, cudaHostRegisterPortable));
}

// Undoes tpurx_host_register for the range that starts at `ptr`.
extern "C" int tpurx_host_unregister(void* ptr) {
  return static_cast<int>(cudaHostUnregister(ptr));
}
