// Triangle sweeps for Hopper (sm_90a): closest hit and any hit.
//
// Replaces the two Pallas TPU kernels of fountain_tpu/geometry/pallas_tri.py:
//   tri_sweep_closest  <- _kernel      (pallas_tri.py:247-307)
//   tri_sweep_any      <- _kernel_any  (pallas_tri.py:310-353)
// both reached through _sweep -> pl.pallas_call (pallas_tri.py:356-414).
//
// What it computes. One thread per ray walks the faces in 128-face blocks
// (LBVH leaf order, so a block is spatially tight) in ascending order. For
// each face it forms the four Moller-Trumbore quantities det, u*det, v*det,
// t*det as 10-term f32 FMA dots of the ray features R = [d, o x d, o, 1]
// with the face's 40 coefficients (the same f32 coefficients as
// tensor_tri.build_tri_features, computed in float64 on the host), then
// applies the watertight acceptance rule of pallas_tri._mt_block exactly:
//   adet > 1e-20, U >= -eps, V >= -eps, U + V <= adet + eps,
//   T > t_eps * adet, T < t_lim * adet        (eps = 1e-4 * adet,
//   U, V, T = u_num, v_num, t_num times sign(det), sign(0) = 0).
// Closest hit keeps a running (t, idx) with a strict '<', so the lowest face
// index wins a tie; any hit stops at the first accepted face. A lane whose
// cap t_cap <= t_eps (dead lanes carry t_cap < 0) writes a miss.
//
// What bounds it. Per (ray, face) pair: 40 FMAs plus ~16 epilogue
// operations, all FP32 on the CUDA cores, against 160 bytes of coefficients
// that every thread of a warp reads at the same address. So the sweep is
// bound by FP32 work over the candidate pairs, not by bytes: the rays and
// outputs are 32 bytes a ray, and a 5,120-face table is 800 KB.
//
// What the design does about it. It cuts pairs: before each block, every
// thread slab-tests its ray against the block's (widened) AABB -- with
// the running best t as the far limit for closest hit, the analogue of
// _precull's front-to-back gate. A thread block skips the face block when
// none of its threads needs it (__syncthreads_or); a thread that does not
// need it idles through the block while the others of its warp test it.
// Rays are taken in the caller's lane order: a Morton sort of the rays in
// the wrapper was tried and did not make the wave faster (chip_smoke.py
// phase 6 times both), so the simpler order stays.
// The coefficients of a needed block are staged once into shared memory
// (20 KB) and read as broadcast float4 loads. The cull is conservative: the
// AABBs are widened past the acceptance slack and both slab limits carry a
// 1e-4 relative margin, so it never drops a hit that the plain version
// (which has no cull) finds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockFaces = 128;
constexpr int kCoef = 40;            // floats per face
constexpr int kThreads = 128;        // rays per thread block
constexpr float kRelEps = 1e-4f;     // tensor_tri.REL_EPS

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
             const float* __restrict__ oz, const float* __restrict__ dx,
             const float* __restrict__ dy, const float* __restrict__ dz,
             const float* __restrict__ t_cap, int n,
             const float4* __restrict__ coef,
             const float* __restrict__ bounds, int n_blocks, float t_eps,
             float* __restrict__ t_out, int32_t* __restrict__ idx_out,
             uint8_t* __restrict__ occ_out) {
  __shared__ float4 s_coef[kBlockFaces * kCoef / 4];

  const int r = blockIdx.x * kThreads + threadIdx.x;
  float o[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f}, cap = -1.f;
  if (r < n) {
    o[0] = ox[r]; o[1] = oy[r]; o[2] = oz[r];
    d[0] = dx[r]; d[1] = dy[r]; d[2] = dz[r];
    cap = t_cap[r];
  }
  const bool live = cap > t_eps;

  // Ray features [d, o x d, o, 1]; the cross product is rounded exactly as
  // the plain version rounds it (no FMA contraction).
  float rf[10];
  rf[0] = d[0]; rf[1] = d[1]; rf[2] = d[2];
  rf[3] = __fsub_rn(__fmul_rn(o[1], d[2]), __fmul_rn(o[2], d[1]));
  rf[4] = __fsub_rn(__fmul_rn(o[2], d[0]), __fmul_rn(o[0], d[2]));
  rf[5] = __fsub_rn(__fmul_rn(o[0], d[1]), __fmul_rn(o[1], d[0]));
  rf[6] = o[0]; rf[7] = o[1]; rf[8] = o[2]; rf[9] = 1.f;
  float inv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) inv[a] = 1.f / (d[a] == 0.f ? 1e-20f : d[a]);

  float t_best = cap;
  int32_t best = -1;
  bool occluded = false;

  for (int b = 0; b < n_blocks; ++b) {
    const bool need = live && !(kAnyHit && occluded);
    if (!__syncthreads_or(need)) break;

    // Slab test against the block AABB (pallas_tri._precull).
    const float* bb = bounds + 8 * b;
    float t_near = -3.0e38f, t_far = 3.0e38f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float t0 = (__ldg(bb + a) - o[a]) * inv[a];
      const float t1 = (__ldg(bb + 3 + a) - o[a]) * inv[a];
      t_near = fmaxf(t_near, fminf(t0, t1));
      t_far = fminf(t_far, fmaxf(t0, t1));
    }
    const float t_lim = kAnyHit ? cap : t_best;
    const bool cand = need && (t_near <= t_far * 1.0001f) && (t_far > 0.f) &&
                      (t_near * 0.9999f < t_lim);
    if (!__syncthreads_or(cand)) continue;

    const float4* src = coef + (size_t)b * (kBlockFaces * kCoef / 4);
    for (int k = threadIdx.x; k < kBlockFaces * kCoef / 4; k += kThreads)
      s_coef[k] = __ldg(src + k);
    __syncthreads();

    if (cand) {
      for (int f = 0; f < kBlockFaces; ++f) {
        const float4* c = s_coef + f * (kCoef / 4);
        float det = 0.f, un = 0.f, vn = 0.f, tn = 0.f;
#pragma unroll
        for (int k = 0; k < 10; ++k) {
          const float4 q = c[k];
          det = fmaf(rf[k], q.x, det);
          un = fmaf(rf[k], q.y, un);
          vn = fmaf(rf[k], q.z, vn);
          tn = fmaf(rf[k], q.w, tn);
        }
        const float sg = det > 0.f ? 1.f : (det < 0.f ? -1.f : 0.f);
        const float adet = fabsf(det);
        const float U = __fmul_rn(un, sg);
        const float V = __fmul_rn(vn, sg);
        const float T = __fmul_rn(tn, sg);
        const float eps = __fmul_rn(kRelEps, adet);
        const float lim = kAnyHit ? cap : t_best;
        const bool valid = (adet > 1e-20f) && (U >= -eps) && (V >= -eps) &&
                           (__fadd_rn(U, V) <= __fadd_rn(adet, eps)) &&
                           (T > __fmul_rn(t_eps, adet)) &&
                           (T < __fmul_rn(lim, adet));
        if (valid) {
          if (kAnyHit) {
            occluded = true;
            break;
          }
          const float t = __fdiv_rn(T, adet == 0.f ? 1.f : adet);
          if (t < t_best) {
            t_best = t;
            best = b * kBlockFaces + f;
          }
        }
      }
    }
    __syncthreads();  // the next block's stage overwrites s_coef
  }

  if (r < n) {
    if (kAnyHit) {
      occ_out[r] = occluded ? 1 : 0;
    } else {
      t_out[r] = t_best;
      idx_out[r] = best;
    }
  }
}

template <bool kAnyHit>
int launch(const float* ox, const float* oy, const float* oz, const float* dx,
           const float* dy, const float* dz, const float* t_cap, int n,
           const float* coef, const float* bounds, int n_blocks, float t_eps, float* t_out, int32_t* idx_out,
           uint8_t* occ_out, void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + kThreads - 1) / kThreads;
  sweep_kernel<kAnyHit><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      ox, oy, oz, dx, dy, dz, t_cap, n,
      reinterpret_cast<const float4*>(coef), bounds, n_blocks, t_eps, t_out,
      idx_out, occ_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Closest hit: t_out = best t (t_cap on a miss), idx_out = face index in
// leaf order (-1 on a miss). Returns the cudaError_t of the launch.
int tri_sweep_closest(const float* ox, const float* oy, const float* oz,
                      const float* dx, const float* dy, const float* dz,
                      const float* t_cap, int n,
                      const float* coef, const float* bounds, int n_blocks,
                      float t_eps, float* t_out, int32_t* idx_out,
                      void* stream) {
  return launch<false>(ox, oy, oz, dx, dy, dz, t_cap, n, coef, bounds,
                       n_blocks, t_eps, t_out, idx_out, nullptr, stream);
}

// Any hit: occ_out = 1 where some face is hit inside (t_eps, t_cap).
int tri_sweep_any(const float* ox, const float* oy, const float* oz,
                  const float* dx, const float* dy, const float* dz,
                  const float* t_cap, int n,
                  const float* coef, const float* bounds, int n_blocks,
                  float t_eps, uint8_t* occ_out, void* stream) {
  return launch<true>(ox, oy, oz, dx, dy, dz, t_cap, n, coef, bounds,
                      n_blocks, t_eps, nullptr, nullptr, occ_out, stream);
}

const char* tri_sweep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
