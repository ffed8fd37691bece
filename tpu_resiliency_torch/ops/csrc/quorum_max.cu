// Quorum local max: the int32 max over this process's heartbeat ages.
//
// Replaces the Pallas kernel of tpu_resiliency/ops/quorum.py::make_local_max
// (inner `kernel`, `pl.pallas_call`).  The TPU version zero-pads the input
// to (8, 128) int32 tiles and writes a (1, 1) tile, so it computes
// max(max(x), 0).  These kernels compute max(x), the value of the
// reference's jnp.max branch.  The two agree on every input the quorum
// feeds them: the plain ages from `age_units` and the packed
// (age << 16) | dev values from `pack_age_device` are all non-negative.
// The result lands in out[0], the all-reduce send buffer, so NCCL reads it
// in place.
//
// What bounds it on an H100: it reads 4 * n bytes and writes 4.  On the
// quorum path n is the number of devices this process drives, which is 1,
// so the cost is the launch and the host work around it.  Two entries:
//
// - tpurx_local_max_i32_args (n <= kByValue): the ages travel in the
//   launch.  The host values are copied into a fixed-size parameter struct,
//   and one warp reduces it with one shuffle tree.  Kernel parameters are
//   captured when the launch is enqueued, so the host buffer may be freed
//   as soon as the call returns: no pinned staging, no host-to-device copy,
//   no event.  One launch in all.
// - tpurx_local_max_i32 (any n, ages already on the device): a grid of
//   blocks reads x with 16-byte (int4) loads in a grid-stride loop, four
//   loads in flight per thread.  The caller peels a scalar head up to the
//   first 16-byte boundary (a contiguous x[1:] starts 4 bytes off one) and
//   the kernel reads the scalar tail.  Each block reduces with warp
//   shuffles and one shared-memory step.
//
// The combine across blocks: with grid == 1 (every n up to one block's
// share, n = 1 included) the block writes out[0] directly.  With grid > 1
// the kernel is launched cooperatively (grid <= 2 blocks per SM, all of
// them resident): block 0 sets out[0] to INT_MIN, a grid barrier follows,
// and each block then folds its max in with an integer atomic max, which
// gives the same value in any order.  So every call is one launch that
// needs no scratch and no operation before it on the stream: a second pass
// over per-block partials would add a launch and an allocation per call,
// and a "last block done" counter shared across calls would be wrong,
// because the tick lane's stream and the step's stream launch this kernel
// concurrently on one device.  Nothing here is shared between calls.
//
// Each entry takes the device index and makes it current only when it is
// not (restoring the previous device afterwards), launches on `stream`,
// does not synchronise, and returns cudaGetLastError() as an int: 0 when
// the launch was accepted.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kByValue = 32;  // one warp, one lane per value

struct HostAges {
  int32_t v[kByValue];
};
static_assert(sizeof(HostAges) == 128, "well under the 4 KB parameter limit");

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

__device__ __forceinline__ int32_t warp_max(int32_t v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v = max(v, __shfl_down_sync(0xffffffffu, v, offset));
  }
  return v;
}

__device__ __forceinline__ int32_t max4(int4 q) {
  return max(max(q.x, q.y), max(q.z, q.w));
}

__global__ void __launch_bounds__(32)
    local_max_args_kernel(const __grid_constant__ HostAges ages, int32_t n,
                          int32_t* __restrict__ out) {
  int32_t m = static_cast<int32_t>(threadIdx.x) < n ? ages.v[threadIdx.x] : INT_MIN;
  m = warp_max(m);
  if (threadIdx.x == 0) {
    out[0] = m;
  }
}

// Elements [0, head) and [head + 4 * nvec, n) are read as scalars, the nvec
// int4 vectors between them with 16-byte loads; x + head is 16-byte aligned.
// With more than one block the launch must be cooperative.
__global__ void __launch_bounds__(kThreads)
    local_max_i32_kernel(const int32_t* __restrict__ x, int64_t n, int64_t head,
                         int64_t nvec, int32_t* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int32_t m = INT_MIN;
  if (t < head) {
    m = x[t];
  }
  const int4* __restrict__ v = reinterpret_cast<const int4*>(x + head);
  int64_t i = t;
  for (; i + 3 * stride < nvec; i += 4 * stride) {
    const int4 a = v[i];
    const int4 b = v[i + stride];
    const int4 c = v[i + 2 * stride];
    const int4 d = v[i + 3 * stride];
    m = max(m, max(max(max4(a), max4(b)), max(max4(c), max4(d))));
  }
  for (; i < nvec; i += stride) {
    m = max(m, max4(v[i]));
  }
  for (int64_t j = head + 4 * nvec + t; j < n; j += stride) {
    m = max(m, x[j]);
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
  }
  if (gridDim.x == 1) {
    if (threadIdx.x == 0) {
      out[0] = m;
    }
    return;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    out[0] = INT_MIN;
  }
  cooperative_groups::this_grid().sync();
  if (threadIdx.x == 0) {
    atomicMax(out, m);
  }
}

__global__ void empty_kernel() {}

}  // namespace

// host_ages: n int32 values in host memory (1 <= n <= 32), read before the
// call returns; out: one int32 on the device.
extern "C" int tpurx_local_max_i32_args(const int32_t* host_ages, int32_t n,
                                        int32_t* out, int device, void* stream) {
  if (n < 1 || n > kByValue) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  HostAges ages;
  std::memcpy(ages.v, host_ages, sizeof(int32_t) * static_cast<size_t>(n));
  DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) {
    return static_cast<int>(guard.status());
  }
  local_max_args_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      ages, n, out);
  return static_cast<int>(cudaGetLastError());
}

// x: n int32 values on the device (n > 0), x + head 16-byte aligned, with
// 0 <= head < 4 and head + 4 * nvec <= n; grid: blocks, at most two per SM;
// out: one int32 on the device.
extern "C" int tpurx_local_max_i32(const int32_t* x, int64_t n, int64_t head,
                                   int64_t nvec, int grid, int32_t* out,
                                   int device, void* stream) {
  if (n < 1 || head < 0 || head > 3 || nvec < 0 || head + 4 * nvec > n ||
      grid < 1 ||
      (nvec > 0 && (reinterpret_cast<uintptr_t>(x + head) & 15) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) {
    return static_cast<int>(guard.status());
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid == 1) {
    local_max_i32_kernel<<<1, kThreads, 0, s>>>(x, n, head, nvec, out);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&x, &n, &head, &nvec, &out};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(local_max_i32_kernel), dim3(grid),
      dim3(kThreads), args, 0, s);
  const cudaError_t last = cudaGetLastError();  // read and cleared either way
  return static_cast<int>(rc != cudaSuccess ? rc : last);
}

// An empty kernel through the same binding and device guard: the floor of
// one launch, the yardstick of the local max at n = 1.
extern "C" int tpurx_empty_launch(int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) {
    return static_cast<int>(guard.status());
  }
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
