// The backward of a row gather for Hopper (sm_90a): out[idx[i]] += grad[i].
//
// Replaces no Pallas kernel: the JAX package's gather backward
// (fountain_tpu/core/gather.py, a custom VJP) is a one-hot matmul for
// tables of up to 512 rows and XLA's scatter-add above, and no pallas_call
// does it. In the port it replaces index_add_, the backward of every
// index_select of a table that requires grad (core/gather.py gather_rows;
// the plain PyTorch version is gather.scatter_rows_plain).
//
// What it computes. grad is [n][c] f32, idx [n] int32 or int64, out [rows]
// [c] f32, zero-filled by the wrapper: each lane's row of grad is added to
// the output row its index names. Rows that several lanes share are summed
// in a fixed lane order within a warp, then added with float atomics whose
// order between warps is free, as index_add_'s is: the result equals
// index_add_'s to rounding.
//
// What bounds it. Bytes: the gradient rows and the indices read, the
// output written, N * (4c + 4) + rows * c * 4 over 3.35 TB/s, about 1.7 us
// for the flagship step's texel atlas (262,144 lanes, [131072][3]). The
// arithmetic is one add a byte or less. index_add_ took ~100x that bound
// there (~170 us a call), for two reasons this design answers:
// - Nearly every row is zero. The gathers run over every lane and a
//   select masks afterwards, so ~99% of the lanes' gradient rows are
//   exactly +-0 (1.1% non-zero into the atlas, 0.5% into the 13-row
//   texture value table, 2.2% into the 4-row shading table). A lane whose
//   row is all +-0 issues nothing. That is exact: the output starts at +0
//   and +0 + -0 = +0. NaN and inf compare unequal to 0, so they are added
//   and propagate as with index_add_.
// - The rest pile onto a few rows (coarse mip levels, texture id 0, one
//   material), and atomics to one address serialise. Within a warp,
//   __match_any_sync groups the non-zero lanes by index; the lowest lane
//   of a group sums the group's rows in lane order and issues one atomic a
//   column (a column whose sum is +-0 issues none).
// Where the whole output fits a shared-memory budget (the wrapper's
// SHARED_BYTES: the texture value and shading tables), each block sums
// into shared memory and flushes each non-zero entry with one global
// atomic; otherwise (the atlas) the merged rows go to global atomics
// (red.global.add.f32). Rows of at most 4 columns take one lane a thread.
// Wider rows (the 96-column shading table) are read by the whole warp: a
// warp's 32 rows as one contiguous run, 32 floats a step, for the zero
// test, and each group's rows in 32-column chunks for its sum.
//
// The kernel allocates nothing, does not synchronise and runs on the
// stream it is given, so a CUDA graph can capture it. It keeps counts only
// when given a stats pointer ([3] int64 on the device: lanes seen, lanes
// with a non-zero row, atomic adds issued into shared or global memory).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kAll = 0xffffffffu;
constexpr long long kMaxSharedBytes = 48 * 1024;  // no opt-in attribute
constexpr int kBlocksPerSmGlobal = 8;
constexpr int kBlocksPerSmShared = 2;  // each block flushes the whole table

// one atomic add of a group's column sum; a sum of +-0 adds nothing
template <bool kShared>
__device__ __forceinline__ void add_to(float* acc, float* out, long long e,
                                       float v, unsigned& atomics) {
  if (v == 0.0f) return;
  if (kShared) {
    atomicAdd(acc + e, v);
  } else {
    atomicAdd(out + e, v);  // result unused: compiles to red.global.add.f32
  }
  ++atomics;
}

template <typename I, bool kShared>
__global__ void __launch_bounds__(kThreads)
    scatter_rows_kernel(const float* __restrict__ grad,
                        const I* __restrict__ idx, long long n, int c,
                        long long rows, float* __restrict__ out,
                        unsigned long long* __restrict__ stats) {
  extern __shared__ float acc[];
  const long long cells = rows * c;
  if (kShared) {
    for (long long e = threadIdx.x; e < cells; e += blockDim.x) acc[e] = 0.0f;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long step = (long long)gridDim.x * blockDim.x;
  // a wide row's element e = j * c + k of a warp's 32 rows: where a
  // thread's next element (32 on) lies, as a step of rows and columns
  const int q = 32 / c, rem = 32 - q * c;
  unsigned seen = 0, nonzero = 0, atomics = 0;
  // one warp takes 32 consecutive lanes at a time; base is warp-uniform,
  // so every thread of a warp runs the same iterations
  for (long long base = warp * 32; base < n; base += step) {
    const long long i = base + lane;
    const bool valid = i < n;
    const int m = (int)(n - base < 32 ? n - base : 32);
    seen += valid;
    // 1. which of the 32 lanes have a non-zero row (NaN is non-zero)
    unsigned nz_mask;
    if (c <= 4) {
      bool any = false;
      if (valid) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k < c) any |= grad[i * c + k] != 0.0f;
        }
      }
      nz_mask = __ballot_sync(kAll, any);
    } else {
      // the 32 rows are one contiguous run: read it coalesced, 32 floats
      // a step, and mark the row of each non-zero element
      const float* run = grad + base * c;
      const int len = m * c;
      unsigned bits = 0;
      int j = lane / c, k = lane - (lane / c) * c;
#pragma unroll 8
      for (int e = lane; e < len; e += 32) {
        bits |= (unsigned)(run[e] != 0.0f) << j;
        j += q;
        k += rem;
        if (k >= c) {
          k -= c;
          ++j;
        }
      }
      nz_mask = __reduce_or_sync(kAll, bits);
    }
    if (nz_mask == 0) continue;
    const bool nz = (nz_mask >> lane) & 1u;
    nonzero += nz;
    const long long r = nz ? (long long)idx[i] : 0;
    if (nz && (r < 0 || r >= rows)) __trap();  // as index_add_'s assert
    // 2. group the non-zero lanes by index; a zero lane keys on itself
    const unsigned group = __match_any_sync(kAll, nz ? r : -1LL - lane);
    const bool leader = nz && __ffs(group) - 1 == lane;
    // 3. each group's sum, in lane order from 0, one atomic a column
    if (c <= 4) {
      if (leader) {
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
        for (unsigned rest = group; rest; rest &= rest - 1) {
          const float* row = grad + (base + __ffs(rest) - 1) * c;
          s0 += row[0];
          if (c > 1) s1 += row[1];
          if (c > 2) s2 += row[2];
          if (c > 3) s3 += row[3];
        }
        add_to<kShared>(acc, out, r * c, s0, atomics);
        if (c > 1) add_to<kShared>(acc, out, r * c + 1, s1, atomics);
        if (c > 2) add_to<kShared>(acc, out, r * c + 2, s2, atomics);
        if (c > 3) add_to<kShared>(acc, out, r * c + 3, s3, atomics);
      }
    } else {
      for (unsigned leaders = __ballot_sync(kAll, leader); leaders;
           leaders &= leaders - 1) {
        const int l = __ffs(leaders) - 1;
        const unsigned g = __shfl_sync(kAll, group, l);
        const long long row = __shfl_sync(kAll, r, l);
        for (int k = lane; k < c; k += 32) {
          float s = 0.0f;
          for (unsigned rest = g; rest; rest &= rest - 1) {
            s += grad[(base + __ffs(rest) - 1) * c + k];
          }
          add_to<kShared>(acc, out, row * c + k, s, atomics);
        }
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (long long e = threadIdx.x; e < cells; e += blockDim.x) {
      add_to<false>(acc, out, e, acc[e], atomics);
    }
  }
  if (stats != nullptr) {
    seen = __reduce_add_sync(kAll, seen);
    nonzero = __reduce_add_sync(kAll, nonzero);
    atomics = __reduce_add_sync(kAll, atomics);
    if (lane == 0) {
      atomicAdd(stats + 0, (unsigned long long)seen);
      atomicAdd(stats + 1, (unsigned long long)nonzero);
      atomicAdd(stats + 2, (unsigned long long)atomics);
    }
  }
}

// the four variants: index of 4 or 8 bytes, global or shared accumulation
template <typename I, bool kShared>
const void* variant() {
  return reinterpret_cast<const void*>(scatter_rows_kernel<I, kShared>);
}

const void* kernel_of(int idx_bytes, int shared) {
  if (idx_bytes == 4) return shared ? variant<int32_t, true>()
                                    : variant<int32_t, false>();
  if (idx_bytes == 8) return shared ? variant<int64_t, true>()
                                    : variant<int64_t, false>();
  return nullptr;
}

template <typename I>
void launch(bool shared, int blocks, size_t smem, cudaStream_t stream,
            const float* grad, const void* idx, long long n, int c,
            long long rows, float* out, unsigned long long* stats) {
  const I* ix = static_cast<const I*>(idx);
  if (shared) {
    scatter_rows_kernel<I, true><<<blocks, kThreads, smem, stream>>>(
        grad, ix, n, c, rows, out, stats);
  } else {
    scatter_rows_kernel<I, false><<<blocks, kThreads, 0, stream>>>(
        grad, ix, n, c, rows, out, stats);
  }
}

}  // namespace

extern "C" {

// out[idx[i]][:] += grad[i][:] for i < n. grad [n][c] f32 contiguous, idx
// [n] of idx_bytes (4 or 8) bytes, out [rows][c] f32 contiguous and zeroed,
// stats null or [3] int64 (added to). shared: accumulate in shared memory
// (rows * c * 4 bytes, at most 48 KB). sms: the card's SM count. Returns
// the cudaError_t of the launch.
int scatter_rows(const float* grad, const void* idx, int idx_bytes,
                 long long n, int c, long long rows, float* out,
                 long long* stats, int shared, int sms, void* stream) {
  if (n <= 0) return 0;
  const long long smem = shared ? rows * c * (long long)sizeof(float) : 0;
  if (c <= 0 || rows <= 0 || sms <= 0 || smem > kMaxSharedBytes
      || kernel_of(idx_bytes, shared) == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const long long want = (n + kThreads - 1) / kThreads;
  const long long most =
      (long long)sms * (shared ? kBlocksPerSmShared : kBlocksPerSmGlobal);
  const int blocks = (int)(want < most ? want : most);
  auto* st = reinterpret_cast<unsigned long long*>(stats);
  auto s = (cudaStream_t)stream;
  if (idx_bytes == 4) {
    launch<int32_t>(shared, blocks, (size_t)smem, s, grad, idx, n, c, rows,
                    out, st);
  } else {
    launch<int64_t>(shared, blocks, (size_t)smem, s, grad, idx, n, c, rows,
                    out, st);
  }
  return (int)cudaGetLastError();
}

// Build facts of one variant on the current device, whose module this
// loads: out = [registers per thread, static shared memory per block
// (bytes), local memory per thread (bytes, spills), thread blocks per SM
// (no dynamic shared memory), threads per block, SMs].
int scatter_rows_info(int idx_bytes, int shared, int* out) {
  const void* f = kernel_of(idx_bytes, shared);
  if (f == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, f);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, f, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = per_sm;
  out[4] = kThreads;
  out[5] = sms;
  return 0;
}

const char* scatter_rows_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
