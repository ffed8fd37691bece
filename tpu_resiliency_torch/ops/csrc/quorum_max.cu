// Quorum local max: the int32 max over this process's heartbeat ages.
//
// Replaces the Pallas kernel of tpu_resiliency/ops/quorum.py::make_local_max
// (inner `kernel`, `pl.pallas_call`).  The TPU version zero-pads the input
// to (8, 128) int32 tiles and writes a (1, 1) tile, so it computes
// max(max(x), 0).  This kernel computes max(x), the value of the reference's
// jnp.max branch.  The two agree on every input the quorum feeds them: the
// plain ages from `age_units` and the packed (age << 16) | dev values from
// `pack_age_device` are all non-negative.
//
// What bounds it on an H100: it reads 4 * n bytes and writes 4.  On the
// quorum path n is the number of devices this process drives, which is 1,
// so the only cost is the launch.  The design keeps that launch minimal:
// one block of 256 threads, a block-stride loop over n, a shuffle reduce in
// each warp and a shared-memory reduce across the eight warps.  Thread 0
// writes out[0], which is the all-reduce send buffer, so NCCL reads the
// result in place.  There are no atomics, so the result is deterministic.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int32_t warp_max(int32_t v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v = max(v, __shfl_down_sync(0xffffffffu, v, offset));
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
    local_max_i32_kernel(const int32_t* __restrict__ x, int64_t n,
                         int32_t* __restrict__ out) {
  int32_t m = INT_MIN;
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    m = max(m, x[i]);
  }
  m = warp_max(m);

  __shared__ int32_t per_warp[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    per_warp[warp] = m;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? per_warp[lane] : INT_MIN;
    m = warp_max(m);
    if (lane == 0) {
      out[0] = m;
    }
  }
}

}  // namespace

// x: n int32 values on the device (n > 0); out: one int32 on the device.
// Launches on `stream` and does not synchronise.  Returns cudaGetLastError()
// as an int: 0 when the launch was accepted.
extern "C" int tpurx_local_max_i32(const int32_t* x, int64_t n, int32_t* out,
                                   void* stream) {
  local_max_i32_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, out);
  return static_cast<int>(cudaGetLastError());
}
