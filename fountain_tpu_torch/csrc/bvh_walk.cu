// BVH walk for Hopper (sm_90a): closest hit and any hit.
//
// Replaces the JAX package's threaded-BVH walk, which it takes instead of
// the Pallas sweep on every backend but the TPU once a mesh has more faces
// than the dense budget (65,536):
//   bvh_walk_closest, bvh_walk_any <- bvh_intersect (fountain_tpu/geometry/
//   bvh.py:251-321, a jnp while_loop; no pallas_call).
// The plain PyTorch version is fountain_tpu_torch/geometry/bvh.py
// bvh_intersect; the wrapper is geometry/bvh_walk.py.
//
// What it computes. One thread walks one ray through the node rows of
// geometry.bvh.pack_nodes ([M][8] f32: min.xyz, max.xyz, then the miss
// link and first << 3 | count as int32 bit patterns, read here with
// __float_as_int and never converted), in DFS order: the slab test of the
// node (1 + 2 gamma(3) on t_far; NaN makes every comparison false); on a
// leaf hit, the Woop watertight test of its faces in slot order, each
// against the best t so far (the strict in-range test, so the first face
// in walk order wins a tie); node i + 1 after an interior hit, else the
// miss link. Any hit stops at the end of the leaf where a hit was found.
// A non-finite t_max becomes 3e38; a ray with t_max <= 0 can never be
// accepted (the in-range test needs t_scaled < det * t_max with t_scaled
// of det's sign), so it writes its miss without walking.
//
// Bits. Every operation is the plain version's, in its order: this file is
// built with -fmad=false (tri_sweep.SOURCES), so no a * b + c contracts
// into an FMA (the Veltkamp split of _two_prod is exact only when every
// product and sum rounds on its own), divisions are IEEE (no fast math),
// and min / max propagate NaN as torch.minimum / torch.maximum do.
//
// What bounds it. The work depends on the data: per ray, the node visits
// (26 FP32 operations of the slab test each) and the leaf slots tested
// (about 180 each: three compensated edge functions are most of it). The
// bytes are the rays, the results, and the node rows (32 B) and vertex
// rows (36 B) the rays touch; at 277,248 faces both tables (~4.4 MB and
// ~10 MB) sit in the 50 MB L2. Either bound is far below what a simple
// walk reaches: the walk is bound by latency (one dependent node load per
// step) and divergence (the lanes of a warp step through different nodes
// and leaves).
//
// What the design does about it. This first kernel is simple: one thread
// a ray, in the caller's lane order; the node row is two 16-byte read-only
// loads; __launch_bounds__ leaves the compiler every register it needs, so
// nothing spills. Ordering the rays, wider nodes or a near-child-first
// walk are later work (the last changes which face wins a tie).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kLeafSize = 4;      // geometry.bvh.LEAF_SIZE
constexpr float kSplit = 4097.0f;  // 2^12 + 1, the Veltkamp split of f32

// f32 constants of the plain version, rounded from Python floats by the
// wrapper: the slab test's 1 + 2 gamma(3) and the Woop bound's gammas
struct Consts {
  float slab_scale, g2, g3, g5;
};

// min / max that return NaN when either argument is NaN
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// (x, y, z) of a vector permuted so the ray's dominant axis is z:
// kz = 0: (y, z, x); kz = 1: (z, x, y); kz = 2: (x, y, z)
__device__ __forceinline__ void permute(int kz, float x, float y, float z,
                                        float& px, float& py, float& pz) {
  px = kz == 0 ? y : (kz == 1 ? z : x);
  py = kz == 0 ? z : (kz == 1 ? x : y);
  pz = kz == 0 ? x : (kz == 1 ? y : z);
}

// error-free product: a * b = p + e exactly
__device__ __forceinline__ void two_prod(float a, float b, float& p,
                                         float& e) {
  p = a * b;
  const float as = a * kSplit;
  const float a_hi = as - (as - a);
  const float a_lo = a - a_hi;
  const float bs = b * kSplit;
  const float b_hi = bs - (bs - b);
  const float b_lo = b - b_hi;
  e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo;
}

// compensated a * b - c * d
__device__ __forceinline__ float diff_of_products(float a, float b, float c,
                                                  float d) {
  float p1, e1, p2, e2;
  two_prod(a, b, p1, e1);
  two_prod(c, d, p2, e2);
  return (p1 - p2) + (e1 - e2);
}

struct Ray {
  float ox, oy, oz;   // origin, permuted
  float sx, sy, sz;   // shear
  int kz;
};

__device__ __forceinline__ void load_vertex(const float* __restrict__ v,
                                            const Ray& r, float& x, float& y,
                                            float& z) {
  float px, py, pz;
  permute(r.kz, __ldg(v), __ldg(v + 1), __ldg(v + 2), px, py, pz);
  x = px - r.ox;
  y = py - r.oy;
  z = pz - r.oz;
}

// The Woop test of one face (9 floats: p0, p1, p2) against t_lim:
// geometry.triangle.woop_intersect_v3 operation for operation.
__device__ __forceinline__ bool woop(const float* __restrict__ v,
                                     const Ray& r, float t_lim,
                                     const Consts& c, float& t) {
  float p0x, p0y, p0z, p1x, p1y, p1z, p2x, p2y, p2z;
  load_vertex(v, r, p0x, p0y, p0z);
  load_vertex(v + 3, r, p1x, p1y, p1z);
  load_vertex(v + 6, r, p2x, p2y, p2z);
  const float x0 = p0x + r.sx * p0z;
  const float y0 = p0y + r.sy * p0z;
  const float x1 = p1x + r.sx * p1z;
  const float y1 = p1y + r.sy * p1z;
  const float x2 = p2x + r.sx * p2z;
  const float y2 = p2y + r.sy * p2z;
  const float e0 = diff_of_products(x1, y2, y1, x2);
  const float e1 = diff_of_products(x2, y0, y2, x0);
  const float e2 = diff_of_products(x0, y1, y0, x1);
  const bool same_sign = (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) ||
                         (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f);
  const float det = e0 + e1 + e2;
  const float z0 = r.sz * p0z;
  const float z1 = r.sz * p1z;
  const float z2 = r.sz * p2z;
  const float t_scaled = e0 * z0 + e1 * z1 + e2 * z2;
  const bool in_range =
      det < 0.0f ? (t_scaled <= 0.0f && t_scaled > det * t_lim)
                 : (t_scaled >= 0.0f && t_scaled < det * t_lim);
  const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
  t = t_scaled * inv_det;
  const float max_zt = nmax(nmax(fabsf(z0), fabsf(z1)), fabsf(z2));
  const float max_xt = nmax(nmax(fabsf(x0), fabsf(x1)), fabsf(x2));
  const float max_yt = nmax(nmax(fabsf(y0), fabsf(y1)), fabsf(y2));
  const float delta_z = c.g3 * max_zt;
  const float delta_x = c.g5 * (max_xt + max_zt);
  const float delta_y = c.g5 * (max_yt + max_zt);
  const float delta_e = 2.0f * (c.g2 * max_xt * max_yt + delta_y * max_xt +
                                delta_x * max_yt);
  const float max_e = nmax(nmax(fabsf(e0), fabsf(e1)), fabsf(e2));
  const float delta_t = 3.0f * (c.g3 * max_e * max_zt + delta_e * max_zt +
                                delta_z * max_e) * fabsf(inv_det);
  return same_sign && det != 0.0f && in_range && t > delta_t;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
walk_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
            const float* __restrict__ oz, const float* __restrict__ dx,
            const float* __restrict__ dy, const float* __restrict__ dz,
            const float* __restrict__ t_max, int n,
            const float4* __restrict__ nodes, int m,
            const float* __restrict__ verts, int f, Consts c,
            float* __restrict__ t_out, int32_t* __restrict__ idx_out,
            uint8_t* __restrict__ occ_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float rox = ox[i], roy = oy[i], roz = oz[i];
  const float rdx = dx[i], rdy = dy[i], rdz = dz[i];
  const float tm = t_max[i];
  float t_best = isfinite(tm) ? tm : 3e38f;
  int i_best = 0;
  bool found = false;
  if (t_best > 0.0f) {
    const float ix = 1.0f / (rdx == 0.0f ? 1e-20f : rdx);
    const float iy = 1.0f / (rdy == 0.0f ? 1e-20f : rdy);
    const float iz = 1.0f / (rdz == 0.0f ? 1e-20f : rdz);
    const float ax = fabsf(rdx), ay = fabsf(rdy), az = fabsf(rdz);
    Ray r;
    r.kz = (ax >= ay && ax >= az) ? 0 : (ay >= az ? 1 : 2);
    permute(r.kz, rox, roy, roz, r.ox, r.oy, r.oz);
    float dtx, dty, dtz;
    permute(r.kz, rdx, rdy, rdz, dtx, dty, dtz);
    const float inv_dz = 1.0f / dtz;
    r.sx = -dtx * inv_dz;
    r.sy = -dty * inv_dz;
    r.sz = inv_dz;
    int ptr = 0;
    while (ptr < m) {
      const float4 a = __ldg(nodes + 2 * ptr);
      const float4 b = __ldg(nodes + 2 * ptr + 1);
      // a = (min.x, min.y, min.z, max.x), b = (max.y, max.z, miss, fc)
      const float t0x = (a.x - rox) * ix, t1x = (a.w - rox) * ix;
      const float t0y = (a.y - roy) * iy, t1y = (b.x - roy) * iy;
      const float t0z = (a.z - roz) * iz, t1z = (b.y - roz) * iz;
      const float t_near =
          nmax(nmax(nmin(t0x, t1x), nmin(t0y, t1y)), nmin(t0z, t1z));
      const float t_far =
          nmin(nmin(nmax(t0x, t1x), nmax(t0y, t1y)), nmax(t0z, t1z)) *
          c.slab_scale;
      const bool hit = t_near <= t_far && t_far > 0.0f && t_near < t_best;
      const int miss = __float_as_int(b.z);
      const int fc = __float_as_int(b.w);
      const int count = fc & 7;
      // a miss link always lies past its node; max() keeps a malformed
      // table from looping
      const int next = max(miss, ptr + 1);
      if (!hit) {
        ptr = next;
        continue;
      }
      if (count == 0) {
        ++ptr;
        continue;
      }
      const int first = fc >> 3;
#pragma unroll
      for (int s = 0; s < kLeafSize; ++s) {
        if (s < count) {
          const int fidx = min(first + s, f - 1);
          float t;
          if (woop(verts + 9 * (size_t)fidx, r, t_best, c, t)) {
            t_best = t;
            i_best = fidx;
            found = true;
          }
        }
      }
      ptr = next;
      if (kAnyHit && found) break;
    }
  }
  if (kAnyHit) {
    occ_out[i] = found ? 1 : 0;
  } else {
    t_out[i] = found ? t_best : __int_as_float(0x7f800000);
    idx_out[i] = found ? i_best : -1;
  }
}

template <bool kAnyHit>
int launch(const float* ox, const float* oy, const float* oz, const float* dx,
           const float* dy, const float* dz, const float* t_max, int n,
           const float* nodes, int m, const float* verts, int f,
           float slab_scale, float g2, float g3, float g5, float* t_out,
           int32_t* idx_out, uint8_t* occ_out, void* stream) {
  if (n <= 0) return 0;
  const Consts c{slab_scale, g2, g3, g5};
  const int grid = (n + kThreads - 1) / kThreads;
  walk_kernel<kAnyHit><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      ox, oy, oz, dx, dy, dz, t_max, n,
      reinterpret_cast<const float4*>(nodes), m, verts, f, c, t_out, idx_out,
      occ_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Closest hit: t_out = the hit's t (inf on a miss), idx_out = its face in
// leaf order (-1 on a miss). nodes is [m][8] f32 (16-byte aligned), verts
// [f][3][3] f32, rays are flat [n] f32 columns. Returns the cudaError_t
// of the launch.
int bvh_walk_closest(const float* ox, const float* oy, const float* oz,
                     const float* dx, const float* dy, const float* dz,
                     const float* t_max, int n, const float* nodes, int m,
                     const float* verts, int f, float slab_scale, float g2,
                     float g3, float g5, float* t_out, int32_t* idx_out,
                     void* stream) {
  return launch<false>(ox, oy, oz, dx, dy, dz, t_max, n, nodes, m, verts, f,
                       slab_scale, g2, g3, g5, t_out, idx_out, nullptr,
                       stream);
}

// Any hit: occ_out = 1 where some face is hit inside t_max.
int bvh_walk_any(const float* ox, const float* oy, const float* oz,
                 const float* dx, const float* dy, const float* dz,
                 const float* t_max, int n, const float* nodes, int m,
                 const float* verts, int f, float slab_scale, float g2,
                 float g3, float g5, uint8_t* occ_out, void* stream) {
  return launch<true>(ox, oy, oz, dx, dy, dz, t_max, n, nodes, m, verts, f,
                      slab_scale, g2, g3, g5, nullptr, nullptr, occ_out,
                      stream);
}

// Build facts of one kernel on the current device: out = [registers per
// thread, shared memory per block (bytes), local memory per thread (bytes,
// spills), thread blocks per SM, threads per block, SMs].
int bvh_walk_info(int any_hit, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = any_hit ? cudaFuncGetAttributes(&a, walk_kernel<true>)
                          : cudaFuncGetAttributes(&a, walk_kernel<false>);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = any_hit ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, walk_kernel<true>, kThreads, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, walk_kernel<false>, kThreads, 0);
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

const char* bvh_walk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
