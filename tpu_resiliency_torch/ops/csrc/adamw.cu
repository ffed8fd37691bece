// The AdamW update of the model step over every leaf, in one launch.
//
// Replaces no Pallas kernel.  The JAX step writes the update as plain array
// code (tpu_resiliency/models/transformer.py:208-215) under jax.jit (:243),
// and XLA fuses it into a pass over each leaf.  The eager port ran it as 21
// PyTorch operations per leaf (the gradient's cast, 15 arithmetic passes,
// three copies back into the state, the cast into the parameter): about
// 8,100 launches and 184 bytes of device traffic per parameter for GPT-2 XL's
// 387 leaves.  This kernel computes what that loop computes, bit for bit:
//
//   mu2 = b1*mu + (1-b1)*g                 (g the gradient, cast up to f32)
//   nu2 = b2*nu + (1-b2)*(g*g)
//   m2  = m - lr*((mu2/bc1) / (sqrt(nu2/bc2) + eps) + wd*m)
//
// with m the f32 master (or the parameter cast up, when there is none),
// written back into mu, nu, the master and the parameter (cast down by
// round-to-nearest-even).  Every operation is the round-to-nearest intrinsic
// of the loop's operation, in the loop's order, so nvcc contracts nothing
// into an FMA; the constants arrive as the f32 values PyTorch casts the
// Python doubles to; bc1 and bc2 are the f32 device scalars the step computes
// from its count, read once per block, so nothing syncs.
//
// What bounds it on an H100: bytes.  Per parameter it reads the gradient
// (bf16), mu, nu and the master (f32) and writes mu, nu, the master and the
// parameter: 28 B, about 30 flops.  GPT-2 XL's 1,556,764,800 parameters are
// 43.6 GB a step, 13.0 ms at 3.35 TB/s.
//
// Design:
//
// - One launch for up to kMaxLeaves leaves of one parameter dtype.  The
//   wrapper's leaf table (the five pointers, the element count, the vector
//   head, the first tile) travels by value as a __grid_constant__ parameter
//   (about 28 KB for 448 leaves; CUDA 12.1 and later take up to 32,764 B),
//   so the launch needs no host-to-device copy.
// - Tiles: each leaf is cut into tiles of kTileElems elements, numbered after
//   the previous leaf's.  A persistent grid (the SM count times the occupancy
//   the runtime reports) walks the tile index with a grid stride; a block
//   finds its tile's leaf by binary search over the table's first tiles.
//   Warps share nothing, so no barrier is needed.
// - Loads and stores with streaming hints (__ldcs / __stcs): a step touches
//   43.6 GB against a 50 MB L2 and reuses nothing (plain stores took twice
//   the time on an H100).  A thread moves vectors of eight elements: two
//   groups of four, 128 elements apart, so that every load and store of a
//   warp covers 512 contiguous bytes of f32 or 256 of bf16.  With eight
//   contiguous elements a thread each f32 load of a warp covered every
//   other 16 bytes of 1 KB, and the kernel reached 79.7% of the bound
//   against 84.4% so (one H100, one call; the same traffic with no
//   arithmetic 85.9%).  The
//   wrapper's head is the number of leading elements after which all five
//   pointers sit on 16-byte boundaries together; those and the tail after
//   the last whole vector are scalar.  A leaf whose pointers can never align
//   together (head -1) is all scalar.
//
// The entry takes the device index and makes it current only when it is
// not, enqueues on `stream`, does not synchronise, reports how many kernels
// it launched, and returns cudaGetLastError() as an int: 0 when every
// launch was accepted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                 // elements of one vector
constexpr int64_t kTileElems = 8192;    // 4 vectors a thread, 32 full chunks
constexpr int kMaxLeaves = 448;         // leaves per launch
constexpr int kTableCols = 8;           // int64 columns of the host's table

struct Leaf {
  const void* grad;   // the parameter's dtype
  void* param;
  float* mu;
  float* nu;
  float* master;      // null: the parameter is read up and written down
  int64_t n;          // elements
  int32_t head;       // scalar elements before the vectors; -1: all scalar
  int32_t unused;
};
static_assert(sizeof(Leaf) == 56, "one table row");

struct Table {
  int64_t tile0[kMaxLeaves];  // first tile of each leaf, non-decreasing
  Leaf leaf[kMaxLeaves];
  int64_t tile_end;      // one past this launch's last tile
  int32_t n;             // leaves in this launch
  int32_t unused;
};
static_assert(sizeof(Table) + 64 <= 32764,
              "kernel parameters are at most 32,764 B");

// The f32 values of the loop's Python constants, as PyTorch casts them.
struct Hyper {
  float b1, omb1, b2, omb2, eps, wd, lr;
};

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

// One element, in the eager loop's order of operations.
__device__ __forceinline__ void update(const Hyper& h, float bc1, float bc2,
                                       float g, float& mu, float& nu, float& m) {
  mu = __fadd_rn(__fmul_rn(h.b1, mu), __fmul_rn(h.omb1, g));
  nu = __fadd_rn(__fmul_rn(h.b2, nu), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  const float mu_hat = __fdiv_rn(mu, bc1);
  const float nu_hat = __fdiv_rn(nu, bc2);
  const float q = __fdiv_rn(mu_hat, __fadd_rn(__fsqrt_rn(nu_hat), h.eps));
  m = __fsub_rn(m, __fmul_rn(h.lr, __fadd_rn(q, __fmul_rn(h.wd, m))));
}

__device__ __forceinline__ float load1(const float* p, int64_t i) {
  return __ldcs(p + i);
}

__device__ __forceinline__ float load1(const __nv_bfloat16* p, int64_t i) {
  const unsigned short b = __ldcs(reinterpret_cast<const unsigned short*>(p) + i);
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

__device__ __forceinline__ void store1(float* p, int64_t i, float v) {
  __stcs(p + i, v);
}

__device__ __forceinline__ void store1(__nv_bfloat16* p, int64_t i, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p) + i,
         __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// Four elements from i on: one 16-byte access of f32, one 8-byte access of
// bf16, at an address aligned to its size.
__device__ __forceinline__ void load4(const float* p, int64_t i, float* v) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p + i));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, int64_t i, float* v) {
  const uint2 a = __ldcs(reinterpret_cast<const uint2*>(p + i));
  // element 2k is the low half of word k (little-endian)
  v[0] = __uint_as_float(a.x << 16);
  v[1] = __uint_as_float(a.x & 0xFFFF0000u);
  v[2] = __uint_as_float(a.y << 16);
  v[3] = __uint_as_float(a.y & 0xFFFF0000u);
}

__device__ __forceinline__ void store4(float* p, int64_t i, const float* v) {
  __stcs(reinterpret_cast<float4*>(p + i), make_float4(v[0], v[1], v[2], v[3]));
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, int64_t i, const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = __bfloat16_as_ushort(__float2bfloat16_rn(v[k]));
  }
  __stcs(reinterpret_cast<uint2*>(p + i), make_uint2(w[0] | (w[1] << 16), w[2] | (w[3] << 16)));
}

template <typename P>
__device__ __forceinline__ void scalar_step(const Leaf& leaf, const Hyper& h,
                                            float bc1, float bc2, int64_t i) {
  const P* grad = static_cast<const P*>(leaf.grad);
  P* param = static_cast<P*>(leaf.param);
  float mu = load1(leaf.mu, i);
  float nu = load1(leaf.nu, i);
  float m = leaf.master != nullptr ? load1(leaf.master, i) : load1(param, i);
  update(h, bc1, bc2, load1(grad, i), mu, nu, m);
  store1(leaf.mu, i, mu);
  store1(leaf.nu, i, nu);
  if (leaf.master != nullptr) {
    store1(leaf.master, i, m);
  }
  store1(param, i, m);
}

// One vector: the four elements from i on and the four from j on.  All its
// loads are issued before the first update.
template <typename P>
__device__ __forceinline__ void vector_step(const Leaf& leaf, const Hyper& h,
                                            float bc1, float bc2, int64_t i, int64_t j) {
  const P* grad = static_cast<const P*>(leaf.grad);
  P* param = static_cast<P*>(leaf.param);
  float g[kVec], mu[kVec], nu[kVec], m[kVec];
  load4(grad, i, g);
  load4(grad, j, g + 4);
  load4(leaf.mu, i, mu);
  load4(leaf.mu, j, mu + 4);
  load4(leaf.nu, i, nu);
  load4(leaf.nu, j, nu + 4);
  if (leaf.master != nullptr) {
    load4(leaf.master, i, m);
    load4(leaf.master, j, m + 4);
  } else {
    load4(param, i, m);
    load4(param, j, m + 4);
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    update(h, bc1, bc2, g[e], mu[e], nu[e], m[e]);
  }
  store4(leaf.mu, i, mu);
  store4(leaf.mu, j, mu + 4);
  store4(leaf.nu, i, nu);
  store4(leaf.nu, j, nu + 4);
  if (leaf.master != nullptr) {
    store4(leaf.master, i, m);
    store4(leaf.master, j, m + 4);
  }
  store4(param, i, m);
  store4(param, j, m + 4);
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
    tpurx_adamw_kernel(const __grid_constant__ Table table, Hyper h,
                       const float* __restrict__ bc1_ptr,
                       const float* __restrict__ bc2_ptr) {
  const float bc1 = *bc1_ptr;
  const float bc2 = *bc2_ptr;
  const int tid = threadIdx.x;
  for (int64_t t = table.tile0[0] + blockIdx.x; t < table.tile_end;
       t += gridDim.x) {
    // the leaf: the last one whose first tile is at or before t (an empty
    // leaf shares its first tile with the next and is passed over)
    int lo = 0;
    int hi = table.n - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (table.tile0[mid] <= t) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const Leaf& leaf = table.leaf[lo];
    const int64_t ts = (t - table.tile0[lo]) * kTileElems;
    const int64_t te = ts + kTileElems < leaf.n ? ts + kTileElems : leaf.n;
    // tiles start on multiples of kVec elements, so every tile's vectors
    // start `head` elements in
    const int64_t vs =
        leaf.head < 0 || ts + leaf.head > te ? te : ts + leaf.head;
    const int64_t nvec = (te - vs) / kVec;
    const int64_t ve = vs + nvec * kVec;
    for (int64_t i = ts + tid; i < vs; i += kThreads) {
      scalar_step<P>(leaf, h, bc1, bc2, i);
    }
    for (int64_t i = ve + tid; i < te; i += kThreads) {
      scalar_step<P>(leaf, h, bc1, bc2, i);
    }
    // in each full chunk of 32 vectors (256 elements) a warp's lanes take
    // elements 4l..4l+3 and 128+4l..128+4l+3, so each load of the warp reads
    // 512 (f32) or 256 (bf16) contiguous bytes; the vectors after the last
    // full chunk are eight contiguous elements each
    const int64_t nfull = nvec / 32 * 32;
    for (int64_t v = tid; v < nvec; v += kThreads) {
      const int64_t i = v < nfull ? vs + (v >> 5) * 256 + 4 * (v & 31) : vs + v * kVec;
      vector_step<P>(leaf, h, bc1, bc2, i, v < nfull ? i + 128 : i + 4);
    }
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Blocks of one instantiation an SM holds at once, asked of the runtime on
// the first launch only: the host's part of a step stays short.
template <typename P>
cudaError_t blocks_per_sm(int* out) {
  static std::atomic<int> cached{0};
  int n = cached.load(std::memory_order_relaxed);
  if (n == 0) {
    const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, tpurx_adamw_kernel<P>, kThreads, 0);
    if (rc != cudaSuccess) {
      return rc;
    }
    n = n > 0 ? n : 1;
    cached.store(n, std::memory_order_relaxed);
  }
  *out = n;
  return cudaSuccess;
}

// Launches leaves [first, first + n) of the host table (n <= kMaxLeaves) over
// tiles up to tile_end, on a grid of at most the blocks the card holds at
// once; nothing when they have no tile.  Sets *launched to 1 if it did.
template <typename P>
cudaError_t launch_group(const int64_t* table, int first, int n, int64_t tile_end,
                         int sms, const Hyper& h, const float* bc1,
                         const float* bc2, cudaStream_t s, int* launched) {
  *launched = 0;
  Table t;
  for (int i = 0; i < n; ++i) {
    const int64_t* r = table + static_cast<int64_t>(kTableCols) * (first + i);
    t.tile0[i] = r[7];
    t.leaf[i] = Leaf{reinterpret_cast<const void*>(r[0]), reinterpret_cast<void*>(r[1]),
                     reinterpret_cast<float*>(r[2]), reinterpret_cast<float*>(r[3]),
                     reinterpret_cast<float*>(r[4]), r[5], static_cast<int32_t>(r[6]),
                     0};
  }
  t.tile_end = tile_end;
  t.n = n;
  t.unused = 0;
  const int64_t tiles = tile_end - t.tile0[0];
  if (tiles == 0) {
    return cudaSuccess;  // only empty leaves: nothing to update
  }
  int per_sm = 0;
  cudaError_t rc = blocks_per_sm<P>(&per_sm);
  if (rc != cudaSuccess) {
    return rc;
  }
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  tpurx_adamw_kernel<P><<<grid, kThreads, 0, s>>>(t, h, bc1, bc2);
  rc = cudaGetLastError();
  *launched = rc == cudaSuccess;
  return rc;
}

template <typename P>
cudaError_t launch_all(const int64_t* table, int n_leaves, int64_t n_tiles, int sms,
                       const Hyper& h, const float* bc1, const float* bc2,
                       cudaStream_t s, int* launches) {
  for (int first = 0; first < n_leaves; first += kMaxLeaves) {
    const int n = n_leaves - first < kMaxLeaves ? n_leaves - first : kMaxLeaves;
    const int64_t tile_end =
        first + n < n_leaves ? table[static_cast<int64_t>(kTableCols) * (first + n) + 7]
                             : n_tiles;
    int launched = 0;
    const cudaError_t rc =
        launch_group<P>(table, first, n, tile_end, sms, h, bc1, bc2, s, &launched);
    *launches += launched;
    if (rc != cudaSuccess) {
      return rc;
    }
  }
  return cudaSuccess;
}

// Is row r's head right: -1, or the first element at which all five
// pointers (the master's when there is one) sit on 16-byte boundaries?
bool head_ok(const int64_t* r, int64_t item) {
  const int64_t head = r[6];
  if (head < -1 || head >= kVec) {
    return false;
  }
  if (head < 0) {
    return true;
  }
  const int64_t sizes[5] = {item, item, 4, 4, 4};
  for (int k = 0; k < 5; ++k) {
    if (r[k] != 0 && (r[k] + head * sizes[k]) % 16 != 0) {
      return false;
    }
  }
  return true;
}

}  // namespace

// table: n_leaves rows of kTableCols int64 on the host, as the wrapper
// writes them: (gradient, parameter, mu, nu, master or 0, elements, vector
// head, first tile).  Every leaf's parameter and gradient are bf16 when
// param_bf16 is 1, f32 when it is 0; mu, nu and the master are f32; every
// pointer is aligned to its element; a leaf's tiles (ceil(elements /
// kTileElems)) follow the previous leaf's and n_tiles is their total.  bc1
// and bc2 are f32 scalars on the device.  *launches is set to the kernels
// launched.
extern "C" int tpurx_adamw_batch(const int64_t* table, int n_leaves, int64_t n_tiles,
                                 int param_bf16, const float* bc1, const float* bc2,
                                 float b1, float omb1, float b2, float omb2, float eps,
                                 float wd, float lr, int device, void* stream,
                                 int* launches) {
  *launches = 0;
  if (n_leaves < 0 || (param_bf16 != 0 && param_bf16 != 1) || bc1 == nullptr ||
      bc2 == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t item = param_bf16 ? 2 : 4;
  int64_t tiles = 0;
  for (int i = 0; i < n_leaves; ++i) {
    const int64_t* r = table + static_cast<int64_t>(kTableCols) * i;
    const int64_t n = r[5];
    if (n < 0 || r[7] != tiles || !head_ok(r, item)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (n > 0 && (r[0] == 0 || r[1] == 0 || r[2] == 0 || r[3] == 0 ||
                  r[0] % item != 0 || r[1] % item != 0 || r[2] % 4 != 0 ||
                  r[3] % 4 != 0 || r[4] % 4 != 0)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    tiles += ceil_div(n, kTileElems);
  }
  if (tiles != n_tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) {
    return static_cast<int>(cudaSuccess);
  }
  DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) {
    return static_cast<int>(guard.status());
  }
  int sms = 0;
  cudaError_t rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc != cudaSuccess) {
    return static_cast<int>(rc);
  }
  const Hyper h{b1, omb1, b2, omb2, eps, wd, lr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  rc = param_bf16
           ? launch_all<__nv_bfloat16>(table, n_leaves, n_tiles, sms, h, bc1, bc2, s,
                                       launches)
           : launch_all<float>(table, n_leaves, n_tiles, sms, h, bc1, bc2, s, launches);
  if (rc != cudaSuccess) {
    return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}
