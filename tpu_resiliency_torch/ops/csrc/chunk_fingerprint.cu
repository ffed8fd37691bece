// Per-chunk change fingerprints of every owned leaf of a checkpoint save,
// in one launch.
//
// Replaces tpu_resiliency/checkpointing/async_ckpt/device_digest.py::
// _build_fp_fn (:129, the inner `fp` with `_as_lanes`), which is jitted
// XLA, not Pallas.  For each leaf it computes exactly what that function
// computes:
//
// - Lanes: the leaf's bytes in C order, as uint32.  4- and 8-byte dtypes
//   are a bitcast (an 8-byte element gives two lanes, in byte order);
//   2-byte dtypes (bf16 included) widen uint16 lanes, 1-byte dtypes and
//   bool widen uint8 lanes.
// - Mix: with g the lane's index over the whole leaf (uint32, wrapping),
//   h = fmix32(lane ^ g * 0x9E3779B9), the murmur3 finalizer.
// - Sums: for each chunk of writer.chunk_grid(nbytes, chunk_bytes,
//   use_direct), with pos the lane's 1-based position in its chunk,
//   (sum h, sum h * pos), both mod 2^32: one uint32[2] row per chunk.
//   Chunks [0, n_low) tile [0, boundary), the rest tile [boundary, total),
//   each as many chunk_lanes as fit, so no chunk straddles the
//   direct/buffered boundary.
//
// What bounds it on an H100: it reads every leaf once and writes 8 bytes
// per chunk, with about 14 integer operations per lane, so it is bound by
// bytes: 412,941,316 B for the flagship's 141-leaf train state, about
// 123 us at 3.35 TB/s.  A first design launched one kernel per leaf (141
// launches per save, a memset before each, most leaves a few KB, so the
// host's launch cost exceeded the work) and read each lane at its own
// width, which held even a single large leaf to 51-62% of the bound.
//
// Design:
//
// - One launch for up to kMaxLeaves leaves.  The wrapper's leaf table
//   (pointer, lane width, total lanes, chunk lanes, boundary lane, n_low,
//   first output row, first tile) travels by value as a __grid_constant__
//   parameter (about 14 KB for 256 leaves; CUDA 12.1 and later take up to
//   32,764 B), so the launch needs no host-to-device copy and no buffer
//   kept alive.  A longer list takes ceil(n / kMaxLeaves) launches; a list
//   of up to kFewLeaves leaves (a one-leaf call) takes a table of that
//   size, under 1 KB, so that the launch does not carry 14 KB of unused
//   rows through the launch queue.
// - Tiles: every chunk is cut into tiles of tile_bytes (64 KiB by default,
//   never straddling a chunk); a leaf's tiles are numbered after the
//   previous leaf's.  A persistent grid (the SM count times the occupancy
//   the runtime reports) walks the tile index with a grid stride; a block
//   finds its tile's leaf by binary search over the table's first tiles,
//   then the chunk and the tile's first position.  A tiny leaf (a norm
//   scale, the step count) is one tile: one iteration of some block.
// - 16-byte loads: each thread reads 16 bytes at a time (4 f32, 8 bf16 or
//   16 byte lanes), neighbouring threads on neighbouring addresses, four
//   loads in flight, over the tile's 16-byte-aligned interior; the head up
//   to the first 16-byte boundary and the tail after the last whole vector
//   (fewer than 16 bytes each) are read as scalars.  A leaf may start at
//   any lane offset.
// - Sums: each thread keeps its two uint32 sums; the block reduces them
//   with warp shuffles and one shared-memory step, and one thread adds
//   them into the chunk's row with two atomicAdds.  Unsigned addition mod
//   2^32 is associative and commutative, so the rows are bit-exact in any
//   order and on every run.  The whole output is zeroed by one
//   cudaMemsetAsync on the same stream first.
//
// The entry takes the device index and makes it current only when it is
// not, enqueues on `stream`, does not synchronise, reports how many
// kernels it launched, and returns cudaGetLastError() as an int: 0 when
// every operation was accepted.
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
constexpr int kUnroll = 4;        // 16-byte loads in flight per thread
constexpr int kMaxLeaves = 256;   // leaves per launch
constexpr int kFewLeaves = 16;    // leaves of the small table
constexpr int kTableCols = 8;     // int64 columns of the host's leaf table
constexpr uint32_t kPhi = 0x9E3779B9u;
constexpr uint32_t kMix1 = 0x85EBCA6Bu;
constexpr uint32_t kMix2 = 0xC2B2AE35u;

struct Leaf {
  const unsigned char* ptr;
  int64_t total;        // lanes
  int64_t chunk_lanes;
  int64_t boundary;     // first lane above the direct/buffered boundary
  int64_t row0;         // first output row
  int32_t n_low;        // chunks below the boundary
  int32_t lane_bytes;   // 1, 2 or 4
};
static_assert(sizeof(Leaf) == 48, "one table row");

template <int kRows>
struct Table {
  int64_t tile0[kRows];        // first tile of each leaf, non-decreasing
  Leaf leaf[kRows];
  int64_t tile_end;            // one past this launch's last tile
  int32_t tile_bytes;
  int32_t n;                   // leaves in this launch
};
static_assert(sizeof(Table<kMaxLeaves>) <= 32764,
              "kernel parameters are at most 32,764 B");
static_assert(sizeof(Table<kFewLeaves>) <= 4096, "under the 4 KB limit before CUDA 12.1");

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

// fmix32(lane ^ gphi), gphi = g * kPhi.
__device__ __forceinline__ uint32_t mix(uint32_t lane, uint32_t gphi) {
  uint32_t h = lane ^ gphi;
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

// Lane g of a leaf whose lanes are LB bytes wide, read at that width.
template <int LB>
__device__ __forceinline__ uint32_t scalar_lane(const unsigned char* p, int64_t g) {
  if (LB == 4) {
    return reinterpret_cast<const uint32_t*>(p)[g];
  } else if (LB == 2) {
    return reinterpret_cast<const uint16_t*>(p)[g];
  }
  return p[g];
}

// The lanes of one 16-byte vector whose first lane has index g (and
// position pos in its chunk), folded into a and b.
template <int LB>
__device__ __forceinline__ void vector_lanes(uint4 q, uint32_t g, uint32_t pos,
                                             uint32_t& a, uint32_t& b) {
  constexpr uint32_t kMask = LB == 4 ? 0xFFFFFFFFu : (1u << (8 * LB)) - 1u;
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  uint32_t gphi = g * kPhi;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int m = 0; m < 4 / LB; ++m) {
      const uint32_t lane = (w[k] >> (8 * LB * m)) & kMask;
      const uint32_t h = mix(lane, gphi);
      a += h;
      b += h * pos;
      gphi += kPhi;
      ++pos;
    }
  }
}

// This thread's share of lanes [ts, te) of a chunk that starts at lane cs.
template <int LB>
__device__ __forceinline__ void tile_sums(const unsigned char* p, int64_t ts,
                                          int64_t te, int64_t cs, uint32_t& a,
                                          uint32_t& b) {
  constexpr int kLanes = 16 / LB;  // lanes per vector
  const int tid = threadIdx.x;
  const uintptr_t start = reinterpret_cast<uintptr_t>(p) + ts * LB;
  int64_t head = static_cast<int64_t>((16 - (start & 15)) & 15) / LB;
  if (head > te - ts) {
    head = te - ts;
  }
  const int64_t vs = ts + head;
  const int nvec = static_cast<int>((te - vs) / kLanes);
  const int64_t ve = vs + static_cast<int64_t>(nvec) * kLanes;
  // scalar head and tail: fewer than kLanes lanes each
  if (tid < head) {
    const int64_t g = ts + tid;
    const uint32_t h = mix(scalar_lane<LB>(p, g), static_cast<uint32_t>(g) * kPhi);
    a += h;
    b += h * static_cast<uint32_t>(g - cs + 1);
  }
  if (tid < te - ve) {
    const int64_t g = ve + tid;
    const uint32_t h = mix(scalar_lane<LB>(p, g), static_cast<uint32_t>(g) * kPhi);
    a += h;
    b += h * static_cast<uint32_t>(g - cs + 1);
  }
  const uint4* vec = reinterpret_cast<const uint4*>(p + vs * LB);
  const uint32_t g0 = static_cast<uint32_t>(vs);
  const uint32_t pos0 = static_cast<uint32_t>(vs - cs + 1);
  for (int v0 = tid; v0 < nvec; v0 += kThreads * kUnroll) {
    uint4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * kThreads;
      if (v < nvec) {
        q[u] = __ldcs(vec + v);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * kThreads;
      if (v < nvec) {
        const uint32_t off = static_cast<uint32_t>(v) * kLanes;
        vector_lanes<LB>(q[u], g0 + off, pos0 + off, a, b);
      }
    }
  }
}

template <int kRows>
__global__ void __launch_bounds__(kThreads)
    fingerprint_tiles_kernel(const __grid_constant__ Table<kRows> table,
                             uint32_t* __restrict__ out) {
  __shared__ uint32_t part_a[kWarps];
  __shared__ uint32_t part_b[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
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
    const int lb = leaf.lane_bytes;
    const int64_t tile_lanes = table.tile_bytes / lb;
    const int64_t chunk = leaf.chunk_lanes;
    const int64_t per_chunk = (chunk + tile_lanes - 1) / tile_lanes;
    // tiles below the boundary: n_low - 1 whole chunks and the last one
    const int64_t tiles_low =
        leaf.n_low == 0
            ? 0
            : (leaf.n_low - 1) * per_chunk +
                  (leaf.boundary - (leaf.n_low - 1) * chunk + tile_lanes - 1) /
                      tile_lanes;
    const int64_t local = t - table.tile0[lo];
    int64_t c;
    int64_t cs;
    int64_t ce;
    int64_t sub;
    if (local < tiles_low) {
      c = local / per_chunk;
      sub = local - c * per_chunk;
      cs = c * chunk;
      ce = cs + chunk < leaf.boundary ? cs + chunk : leaf.boundary;
    } else {
      const int64_t u = local - tiles_low;
      const int64_t hc = u / per_chunk;
      sub = u - hc * per_chunk;
      c = leaf.n_low + hc;
      cs = leaf.boundary + hc * chunk;
      ce = cs + chunk < leaf.total ? cs + chunk : leaf.total;
    }
    const int64_t ts = cs + sub * tile_lanes;
    const int64_t te = ts + tile_lanes < ce ? ts + tile_lanes : ce;

    uint32_t a = 0;
    uint32_t b = 0;
    if (lb == 4) {
      tile_sums<4>(leaf.ptr, ts, te, cs, a, b);
    } else if (lb == 2) {
      tile_sums<2>(leaf.ptr, ts, te, cs, a, b);
    } else {
      tile_sums<1>(leaf.ptr, ts, te, cs, a, b);
    }
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      part_a[warp] = a;
      part_b[warp] = b;
    }
    __syncthreads();
    if (warp == 0) {
      a = warp_sum(lane < kWarps ? part_a[lane] : 0u);
      b = warp_sum(lane < kWarps ? part_b[lane] : 0u);
      if (lane == 0) {
        uint32_t* row = out + 2 * (leaf.row0 + c);
        atomicAdd(row, a);
        atomicAdd(row + 1, b);
      }
    }
    __syncthreads();  // the partials are rewritten by the next tile
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Launches leaves [first, first + n) of the host table (n <= kRows) over
// tiles up to tile_end, on a grid of at most the blocks the card holds at
// once; nothing when they have no tile.  Sets *launched to 1 if it did.
template <int kRows>
cudaError_t launch_group(const int64_t* table, int first, int n, int64_t tile_end,
                         int tile_bytes, int sms, uint32_t* out, cudaStream_t s,
                         int* launched) {
  *launched = 0;
  Table<kRows> t;
  for (int i = 0; i < n; ++i) {
    const int64_t* r = table + static_cast<int64_t>(kTableCols) * (first + i);
    t.tile0[i] = r[7];
    t.leaf[i] = Leaf{reinterpret_cast<const unsigned char*>(r[0]), r[2], r[3], r[4],
                     r[6], static_cast<int32_t>(r[5]), static_cast<int32_t>(r[1])};
  }
  t.tile_end = tile_end;
  t.tile_bytes = tile_bytes;
  t.n = n;
  const int64_t tiles = tile_end - t.tile0[0];
  if (tiles == 0) {
    return cudaSuccess;  // only empty leaves: nothing to read
  }
  int per_sm = 0;
  cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fingerprint_tiles_kernel<kRows>, kThreads, 0);
  if (rc != cudaSuccess) {
    return rc;
  }
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  fingerprint_tiles_kernel<kRows><<<grid, kThreads, 0, s>>>(t, out);
  rc = cudaGetLastError();
  *launched = rc == cudaSuccess;
  return rc;
}

}  // namespace

// table: n_leaves rows of kTableCols int64 on the host, as the wrapper's
// plan writes them: (data pointer, lane bytes, total lanes, chunk lanes,
// boundary lane, n_low, first row, first tile).  Each leaf's pointer is
// aligned to its lane width; its rows and tiles follow the previous
// leaf's; n_rows and n_tiles are the totals.  tile_bytes is a positive
// multiple of 16.  out: 2 * n_rows uint32 on the device, zeroed here on
// `stream` before the launches.  *launches is set to the kernels launched.
extern "C" int tpurx_chunk_fingerprint_batch(const int64_t* table, int n_leaves,
                                             int64_t n_rows, int64_t n_tiles,
                                             int tile_bytes, uint32_t* out,
                                             int device, void* stream,
                                             int* launches) {
  *launches = 0;
  if (n_leaves < 0 || tile_bytes < 16 || tile_bytes % 16 != 0 ||
      (n_rows > 0 && out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int64_t rows = 0;
  int64_t tiles = 0;
  for (int i = 0; i < n_leaves; ++i) {
    const int64_t* r = table + static_cast<int64_t>(kTableCols) * i;
    const int64_t lb = r[1];
    const int64_t total = r[2];
    const int64_t chunk = r[3];
    const int64_t boundary = r[4];
    if ((lb != 1 && lb != 2 && lb != 4) || r[0] % lb != 0 || chunk < 1 ||
        total < 0 || boundary < 0 || boundary > total ||
        (total > 0 && r[0] == 0) || r[5] != ceil_div(boundary, chunk) ||
        r[6] != rows || r[7] != tiles) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int64_t tile_lanes = tile_bytes / lb;
    const int64_t per_chunk = ceil_div(chunk, tile_lanes);
    const int64_t n_low = r[5];
    const int64_t high = total - boundary;
    const int64_t n_high = ceil_div(high, chunk);
    rows += n_low + n_high;
    if (n_low > 0) {
      tiles += (n_low - 1) * per_chunk +
               ceil_div(boundary - (n_low - 1) * chunk, tile_lanes);
    }
    if (n_high > 0) {
      tiles += (n_high - 1) * per_chunk +
               ceil_div(high - (n_high - 1) * chunk, tile_lanes);
    }
  }
  if (rows != n_rows || tiles != n_tiles || rows > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) {
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  rc = cudaMemsetAsync(out, 0, sizeof(uint32_t) * 2 * n_rows, s);
  if (rc != cudaSuccess) {
    return static_cast<int>(rc);
  }
  for (int first = 0; first < n_leaves; first += kMaxLeaves) {
    const int n = n_leaves - first < kMaxLeaves ? n_leaves - first : kMaxLeaves;
    const int64_t tile_end =
        first + n < n_leaves ? table[static_cast<int64_t>(kTableCols) * (first + n) + 7]
                             : n_tiles;
    int launched = 0;
    rc = n <= kFewLeaves
             ? launch_group<kFewLeaves>(table, first, n, tile_end, tile_bytes, sms,
                                        out, s, &launched)
             : launch_group<kMaxLeaves>(table, first, n, tile_end, tile_bytes, sms,
                                        out, s, &launched);
    *launches += launched;
    if (rc != cudaSuccess) {
      return static_cast<int>(rc);
    }
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
