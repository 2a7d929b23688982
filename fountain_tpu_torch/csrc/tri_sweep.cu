// Triangle sweeps for Hopper (sm_90a): closest hit and any hit.
//
// Replaces the two Pallas TPU kernels of fountain_tpu/geometry/pallas_tri.py:
//   tri_sweep_closest  <- _kernel      (pallas_tri.py:247-307)
//   tri_sweep_any      <- _kernel_any  (pallas_tri.py:310-353)
// both reached through _sweep -> pl.pallas_call (pallas_tri.py:356-414).
//
// What it computes. The faces come in 128-face blocks (LBVH leaf order, so a
// block is spatially tight) with a widened AABB each. For every (ray, face)
// pair the sweep forms the four Moller-Trumbore quantities det, u*det,
// v*det, t*det, the 10-term f32 dots of the ray features R = [d, o x d, o, 1]
// with the face's 10 x 4 coefficients (tensor_tri.build_tri_features,
// computed in float64 on the host), then applies the watertight acceptance
// rule of pallas_tri._mt_block exactly:
//   adet > 1e-20, U >= -eps, V >= -eps, U + V <= adet + eps,
//   T > t_eps * adet, T < t_lim * adet        (eps = 1e-4 * adet,
//   U, V, T = u_num, v_num, t_num times sign(det), sign(0) = 0).
// Closest hit: within a block every face is tested against the ray's best t
// from before the block, and the block's hits with t below it enter a
// lexicographic minimum of (t, face index), so the lowest face index wins
// a tie, within a block and (an earlier block having lower indices) across
// blocks: the plain version's running minimum with a strict '<' per chunk.
// Any hit: a ray is occluded once some face is accepted in (t_eps, t_cap).
// A lane whose cap t_cap <= t_eps (dead lanes carry t_cap < 0) writes a
// miss, and so does a ray with a non-finite feature (as in the plain
// version, where it turns the dots into NaN).
//
// What bounds it. 21 of a face's 40 coefficients are zero by construction
// (and t's three normal terms are det's negated, so 16 are distinct): a
// pair takes 4 multiplies, 14 FMAs and 1 add for the four quantities
// (det, u, v, t) and 5 multiplies or adds and 6 compares for the rule:
// 44 FP32 operations (an FMA counted as 2), all on the CUDA cores; rays
// and outputs are 32 bytes a ray and the 4,332-face table is 280 KB, so
// the sweep is bound by FP32 work over the pairs that the block cull lets
// through (a ray tests a block only when its slab test passes with its
// current limit), not by bytes. Tensor cores are not used on purpose: the
// results must equal the plain version's acceptance to the bit, and a TF32
// or bf16 split flips borderline hits.
//
// What the design does about it.
// 1. Only the work the function needs. Each pair runs the 19 multiplies,
//    FMAs and adds of the non-zero coefficients, in the 10-term dots'
//    order (a zero term adds an exact zero, so the bits are the dots'
//    bits), against a face table of 16 floats a face (SweepTable.coef).
// 2. Warp-cooperative pair tests. The pairs executed are the pairs the cull
//    lets through, and no lane idles on a block its ray does not need: for
//    each staged block the thread block lists the batch's rays whose slab
//    test passes (ballot + shared-memory append). Then each thread holds
//    one face's 16 coefficients in registers (thread i: face i % 128,
//    loaded once per block), and the two halves of the thread block walk
//    the even and the odd listed rays: a warp tests one ray against 32
//    consecutive faces (four warps cover the block's 128), reading the
//    ray's features as three broadcast float4 and its faces' coefficients
//    not at all. (One face a lane, not four: a face's coefficients stay in
//    registers for all of the block's rays, and the warps need no shuffle
//    reduction.) Every warp does the same work, one
//    chain of multiply-adds per pair. Accepted faces are rare, so instead of
//    a shuffle reduction per ray each accepting lane folds its (t, face) into
//    the ray's minimum with one 64-bit shared-memory atomicMin on the key
//    (bits of t) << 32 | face, which orders as (t, face) because t > 0.
//    The staged block is row-major ([row][face] float4, the table's own
//    layout), so a warp's loads of 32 consecutive faces' row hit
//    consecutive 16-byte words.
// 3. Asynchronous double-buffered staging. A block's coefficients are one
//    contiguous 8 KB run, so one thread stages it with a TMA bulk copy
//    (cp.async.bulk, completion on an mbarrier) into one of two
//    shared-memory stages: no registers or instructions of the other threads
//    go to the copy, and one instruction moves it (cp.async would need 512
//    16-byte copies from the whole block). The next needed block is chosen
//    and its copy issued before the current block is tested, with the limits
//    from before the current block: that is conservative, since a stage that
//    turns out not to be needed only costs a copy and the list re-checks
//    every ray against its current limit.
// 4. Persistent thread blocks with a live-ray queue. The grid is as many
//    thread blocks as fit on the card at once (occupancy x SMs); each claims
//    256-lane chunks of the input from a global counter (the launch's last
//    claim sets it back to zero, so the wrapper keeps one per stream and
//    launches nothing to clear it), writes dead lanes their
//    miss where it claims them and appends live lanes to a shared-memory
//    queue, and sweeps the queue once it holds at least 192 rays or the
//    input is exhausted. Shadow rays of a wave are ~11% live, so their
//    batches hold only live rays instead of riding along in mostly dead
//    ones; camera and bounce rays are nearly all live, and the same queue
//    costs them one ballot per chunk.
// The block cull runs a window of 8 blocks at a time: every queued ray
// slab-tests the window's boxes once, keeping one bit per block, and the
// union of the bits says which blocks to stage. Any hit lists a ray for a
// block from its bit alone (its limit t_cap does not change); closest hit
// re-tests the bit's rays against their best t when the block comes up.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockFaces = 128;
constexpr int kCoefF4 = 4;                      // float4 per face
constexpr int kStageF4 = kCoefF4 * kBlockFaces;  // float4 per staged block
constexpr int kStageBytes = kStageF4 * 16;      // 8,192
constexpr int kThreads = 256;       // a multiple of 128
constexpr int kSlots = kThreads / kBlockFaces;  // rays tested at once
constexpr int kChunk = kThreads;     // input lanes claimed at a time
constexpr int kFill = 192;           // sweep once the queue holds this many
constexpr int kQueue = kFill + kChunk - 1;
constexpr int kWindow = 8;           // blocks culled together (<= 8)
constexpr float kRelEps = 1e-4f;     // tensor_tri.REL_EPS
static_assert(kThreads % kBlockFaces == 0 && kWindow <= 8, "shape");

// A queued ray: features R[0..8] (R[9] = 1 is implicit) and its limit,
// laid out as three float4 so that a warp reads them as broadcasts.
struct __align__(16) Ray {
  float4 a;  // d.x, d.y, d.z, (o x d).x
  float4 b;  // (o x d).y, (o x d).z, o.x, o.y
  float4 c;  // o.z, lim (closest: best t before the block; any: t_cap), -, -
};

struct __align__(16) Smem {
  float4 stage[2][kStageF4];   // two stages of one block, [row][face]
  Ray ray[kQueue];
  unsigned long long key[kQueue];  // closest: bits(t) << 32 | face; any: hit
  float inv[3][kQueue];        // 1 / d for the slab test
  int32_t lane[kQueue];        // input lane of each queued ray
  int32_t cand[kQueue];        // rays whose slab test passes this block
  uint8_t bits[kQueue];        // the ray's slab tests in the cull window
  unsigned long long bar[2];   // one mbarrier per stage
  uint32_t win[3];             // window masks, rotating
  int n_cand[2];
  int n_queued;
  int chunk;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

// One thread: expect the block's bytes on `bar`, then start the bulk copy.
__device__ __forceinline__ void stage_block(float4* dst, const float4* src,
                                            unsigned long long* bar) {
  const uint32_t b = smem_u32(bar);
  // the stage was last read through the generic proxy; order those reads
  // before the async proxy's writes
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(b), "r"(kStageBytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
        "r"(kStageBytes), "r"(b)
      : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         uint32_t parity) {
  const uint32_t b = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p;\n"
        "  mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "  selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(b), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ unsigned long long hit_key(float t, int face) {
  return (static_cast<unsigned long long>(__float_as_uint(t)) << 32) |
         static_cast<uint32_t>(face);
}

// Slab test of queued ray j against a block's widened box, with the same
// 1e-4 margins as the cull counted by the bound (pallas_tri._precull).
__device__ __forceinline__ bool slab_hits(const Smem& s, int j,
                                          const float* bb, float lim) {
  const Ray& r = s.ray[j];
  const float o[3] = {r.b.z, r.b.w, r.c.x};
  float t_near = -3.0e38f, t_far = 3.0e38f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = (__ldg(bb + a) - o[a]) * s.inv[a][j];
    const float t1 = (__ldg(bb + 3 + a) - o[a]) * s.inv[a][j];
    t_near = fmaxf(t_near, fminf(t0, t1));
    t_far = fminf(t_far, fmaxf(t0, t1));
  }
  return (t_near <= t_far * 1.0001f) && (t_far > 0.f) &&
         (t_near * 0.9999f < lim);
}

template <bool kAnyHit>
__device__ __forceinline__ bool ray_active(const Smem& s, int j) {
  return !(kAnyHit && s.key[j]);
}

// The ray's limit: closest hit, the best t found so far; any hit, t_cap.
template <bool kAnyHit>
__device__ __forceinline__ float limit(const Smem& s, int j) {
  return kAnyHit ? s.ray[j].c.y
                 : __uint_as_float(static_cast<uint32_t>(s.key[j] >> 32));
}

// Slab-tests every active queued ray against blocks [b0, b0 + kWindow),
// keeps each ray's bits and returns their union (bit i: block b0 + i). A
// small batch spreads a ray's tests over up to kWindow threads. Uniform
// call (one __syncthreads); `round` rotates the three mask words so that a
// word is cleared two rounds before it is written again.
template <bool kAnyHit>
__device__ uint32_t window_mask(Smem& s, int qn, const float* bounds,
                                int n_blocks, int b0, uint32_t& round) {
  int per_ray = 1;  // threads per ray, a power of two (aligned in a warp)
  while (per_ray < kWindow && 2 * per_ray * qn <= kThreads) per_ray *= 2;
  const int sub = threadIdx.x % per_ray;
  uint32_t bits = 0;
  for (int j0 = 0; j0 < qn; j0 += kThreads / per_ray) {
    const int j = j0 + threadIdx.x / per_ray;
    uint32_t mine = 0;
    if (j < qn && ray_active<kAnyHit>(s, j)) {
      const float lim = limit<kAnyHit>(s, j);
      for (int i = sub; i < kWindow && b0 + i < n_blocks; i += per_ray)
        if (slab_hits(s, j, bounds + 8 * (b0 + i), lim)) mine |= 1u << i;
    }
    for (int off = 1; off < per_ray; off <<= 1)
      mine |= __shfl_xor_sync(0xffffffffu, mine, off);
    if (j < qn && sub == 0) s.bits[j] = static_cast<uint8_t>(mine);
    bits |= mine;
  }
  bits = __reduce_or_sync(0xffffffffu, bits);
  const uint32_t k = round % 3;
  if (threadIdx.x == 0) s.win[(k + 1) % 3] = 0;
  if ((threadIdx.x & 31) == 0 && bits) atomicOr(&s.win[k], bits);
  __syncthreads();
  ++round;
  return s.win[k];
}

// Walks the blocks some queued ray may need, a window of kWindow at a time.
template <bool kAnyHit>
struct BlockWalk {
  int base = -2 * kWindow;
  uint32_t mask = 0;

  // First block >= from in a window mask (uniform; may synchronise).
  __device__ int next(Smem& s, int qn, const float* bounds, int n_blocks,
                      int from, uint32_t& round) {
    while (from < n_blocks) {
      if (from >= base + kWindow) {
        base = from;
        mask = window_mask<kAnyHit>(s, qn, bounds, n_blocks, from, round);
      }
      const uint32_t rest = mask >> (from - base);
      if (rest) return from + __ffs(rest) - 1;
      from = base + kWindow;
    }
    return n_blocks;
  }
};

// The watertight acceptance rule, term for term as the plain version
// rounds it (no FMA contraction in the epilogue). On acceptance T and adet
// give the hit's t = T / adet. The plain version multiplies by sign(det);
// flipping the sign bit with det's gives the same U, V, T wherever
// det != 0, and where det is 0 (or NaN) adet > 1e-20 fails either way.
__device__ __forceinline__ bool accept(const float q[4], float lim,
                                       float t_eps, float& T, float& adet) {
  const float det = q[0];
  const uint32_t sg = __float_as_uint(det) & 0x80000000u;
  adet = fabsf(det);
  const float U = __uint_as_float(__float_as_uint(q[1]) ^ sg);
  const float V = __uint_as_float(__float_as_uint(q[2]) ^ sg);
  T = __uint_as_float(__float_as_uint(q[3]) ^ sg);
  const float eps = __fmul_rn(kRelEps, adet);
  return (adet > 1e-20f) && (U >= -eps) && (V >= -eps) &&
         (__fadd_rn(U, V) <= __fadd_rn(adet, eps)) &&
         (T > __fmul_rn(t_eps, adet)) && (T < __fmul_rn(lim, adet));
}

// This thread's face (index f of block b, coefficients w) against the
// listed rays slot, slot + kSlots, ... of cand[0 .. nc). The face's
// 16 coefficients are the non-zero ones of its 40 (tensor_tri's table):
//   w[0] = (-n, -k), w[1] = (w2, e2.x), w[2] = (e2.y, e2.z, -w1.x, -w1.y),
//   w[3] = (-w1.z, -e1)
// (det = -d.n, u = d.w2 + (o x d).e2, v = -d.w1 - (o x d).e1,
// t = o.n - k). Each quantity is the same FMA chain, in the same order, as
// the 10-term dot with the zero terms left out; for finite rays a zero term
// adds an exact zero, so the chains give the 10-term dots' bits.
template <bool kAnyHit>
__device__ __forceinline__ void test_face(Smem& s, const float4 (&w)[kCoefF4],
                                          int b, int f, int slot, int nc,
                                          float t_eps) {
#pragma unroll 4
  for (int c = slot; c < nc; c += kSlots) {
    const int j = s.cand[c];
    const Ray r = s.ray[j];
    // r.a = (d, (o x d).x), r.b = ((o x d).y, (o x d).z, o.x, o.y), r.c.x = o.z
    float q[4];
    q[0] = fmaf(r.a.z, w[0].z, fmaf(r.a.y, w[0].y, __fmul_rn(r.a.x, w[0].x)));
    q[1] = fmaf(r.b.y, w[2].y, fmaf(r.b.x, w[2].x, fmaf(r.a.w, w[1].w,
           fmaf(r.a.z, w[1].z, fmaf(r.a.y, w[1].y,
                                    __fmul_rn(r.a.x, w[1].x))))));
    q[2] = fmaf(r.b.y, w[3].w, fmaf(r.b.x, w[3].z, fmaf(r.a.w, w[3].y,
           fmaf(r.a.z, w[3].x, fmaf(r.a.y, w[2].w,
                                    __fmul_rn(r.a.x, w[2].z))))));
    q[3] = __fadd_rn(fmaf(r.c.x, -w[0].z, fmaf(r.b.w, -w[0].y,
                                               __fmul_rn(r.b.z, -w[0].x))),
                     w[0].w);
    float T, adet;
    if (accept(q, r.c.y, t_eps, T, adet)) {
      if constexpr (kAnyHit) {
        s.key[j] = 1;
      } else {
        const float t = __fdiv_rn(T, adet);
        if (t < r.c.y) atomicMin(&s.key[j], hit_key(t, b * kBlockFaces + f));
      }
    }
  }
}

// Sweeps the qn queued rays over the needed blocks. Uniform call. `st` and
// `phase` (bit i: parity of stage i's next completion) persist across
// batches, so the n_cand slot a batch starts with is always a cleared one.
template <bool kAnyHit>
__device__ void sweep_batch(Smem& s, int qn, const float4* __restrict__ coef,
                            const float* __restrict__ bounds, int n_blocks,
                            float t_eps, int& st, uint32_t& phase,
                            uint32_t& round) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int f = tid % kBlockFaces, slot = tid / kBlockFaces;
  BlockWalk<kAnyHit> walk;
  int b = walk.next(s, qn, bounds, n_blocks, 0, round);
  if (b < n_blocks && tid == 0)
    stage_block(s.stage[st], coef + (size_t)b * kStageF4, &s.bar[st]);
  while (b < n_blocks) {
    // rays that need block b: their window bit, and for closest hit the
    // slab test again with the best t found so far
    const uint32_t bit = 1u << (b - walk.base);
    for (int j0 = 0; j0 < qn; j0 += kThreads) {
      const int j = j0 + tid;
      bool cand = false;
      if (j < qn && (s.bits[j] & bit) && ray_active<kAnyHit>(s, j)) {
        if constexpr (kAnyHit) {
          cand = true;
        } else {
          const float lim = limit<kAnyHit>(s, j);
          s.ray[j].c.y = lim;  // the limit of this block's tests
          cand = slab_hits(s, j, bounds + 8 * b, lim);
        }
      }
      const unsigned m = __ballot_sync(0xffffffffu, cand);
      int at = 0;
      if (lane == 0 && m) at = atomicAdd(&s.n_cand[st], __popc(m));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (cand) s.cand[at + __popc(m & ((1u << lane) - 1u))] = j;
    }
    __syncthreads();
    const int nc = s.n_cand[st];
    // choose and stage the next block while this one is tested
    const int bn = walk.next(s, qn, bounds, n_blocks, b + 1, round);
    if (tid == 0) {
      s.n_cand[st ^ 1] = 0;
      if (bn < n_blocks)
        stage_block(s.stage[st ^ 1], coef + (size_t)bn * kStageF4,
                    &s.bar[st ^ 1]);
    }
    // (a stage nobody needs is waited for too, before it is reused)
    bar_wait(&s.bar[st], (phase >> st) & 1u);
    phase ^= 1u << st;
    if (nc) {
      float4 w[kCoefF4];
#pragma unroll
      for (int k = 0; k < kCoefF4; ++k)
        w[k] = s.stage[st][k * kBlockFaces + f];
      test_face<kAnyHit>(s, w, b, f, slot, nc, t_eps);
    }
    __syncthreads();  // stage st, the list and the keys are settled
    b = bn;
    st ^= 1;
  }
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads, 768 / kThreads)
sweep_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
             const float* __restrict__ oz, const float* __restrict__ dx,
             const float* __restrict__ dy, const float* __restrict__ dz,
             const float* __restrict__ t_cap, int n,
             const float4* __restrict__ coef,
             const float* __restrict__ bounds, int n_blocks, float t_eps,
             int* __restrict__ counter, float* __restrict__ t_out,
             int32_t* __restrict__ idx_out, uint8_t* __restrict__ occ_out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    bar_init(&s.bar[0]);
    bar_init(&s.bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    s.win[0] = s.win[1] = s.win[2] = 0;
    s.n_cand[0] = s.n_cand[1] = 0;
  }
  const int chunks = (n + kChunk - 1) / kChunk;
  int st = 0;
  uint32_t phase = 0, round = 0;
  bool more = true;
  for (;;) {
    // Fill the queue with live lanes; dead lanes get their miss here.
    if (tid == 0) s.n_queued = 0;
    __syncthreads();
    while (more && s.n_queued < kFill) {
      if (tid == 0) {
        // Every thread block claims until its first claim past the input,
        // so a launch makes exactly chunks + gridDim.x claims; the one that
        // gets the last number sets the counter back to zero for the next
        // launch (no claim can follow it).
        s.chunk = atomicAdd(counter, 1);
        if (s.chunk == chunks + (int)gridDim.x - 1) atomicExch(counter, 0);
      }
      __syncthreads();
      const long long base = (long long)s.chunk * kChunk;
      if (base >= n) {
        more = false;
        break;
      }
      const int r = (int)base + tid;
      float o[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f}, cap = -1.f;
      if (r < n) {
        o[0] = ox[r]; o[1] = oy[r]; o[2] = oz[r];
        d[0] = dx[r]; d[1] = dy[r]; d[2] = dz[r];
        cap = t_cap[r];
      }
      // ray features [d, o x d, o, 1]; the cross product is rounded
      // exactly as the plain version rounds it
      const float4 fa = make_float4(
          d[0], d[1], d[2],
          __fsub_rn(__fmul_rn(o[1], d[2]), __fmul_rn(o[2], d[1])));
      const float4 fb = make_float4(
          __fsub_rn(__fmul_rn(o[2], d[0]), __fmul_rn(o[0], d[2])),
          __fsub_rn(__fmul_rn(o[0], d[1]), __fmul_rn(o[1], d[0])), o[0],
          o[1]);
      // A non-finite feature makes the plain version's 10-term dots NaN
      // (its zero coefficients meet it), so such a ray hits nothing there;
      // it is a miss here too.
      const bool finite =
          isfinite(fa.x) && isfinite(fa.y) && isfinite(fa.z) &&
          isfinite(fa.w) && isfinite(fb.x) && isfinite(fb.y) &&
          isfinite(fb.z) && isfinite(fb.w) && isfinite(o[2]);
      const bool live = cap > t_eps && finite;
      if (r < n && !live) {
        if (kAnyHit) {
          occ_out[r] = 0;
        } else {
          t_out[r] = cap;
          idx_out[r] = -1;
        }
      }
      const unsigned m = __ballot_sync(0xffffffffu, live);
      int at = 0;
      if (lane == 0 && m) at = atomicAdd(&s.n_queued, __popc(m));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (live) {
        const int j = at + __popc(m & ((1u << lane) - 1u));
        Ray& q = s.ray[j];
        q.a = fa;
        q.b = fb;
        q.c = make_float4(o[2], cap, 0.f, 0.f);
#pragma unroll
        for (int a = 0; a < 3; ++a)
          s.inv[a][j] = 1.f / (d[a] == 0.f ? 1e-20f : d[a]);
        s.key[j] = kAnyHit ? 0ull : hit_key(cap, -1);
        s.lane[j] = r;
      }
      __syncthreads();
    }
    const int qn = s.n_queued;
    if (qn == 0) break;  // input exhausted (uniform)
    sweep_batch<kAnyHit>(s, qn, coef, bounds, n_blocks, t_eps, st, phase,
                         round);
    for (int j = tid; j < qn; j += kThreads) {
      const unsigned long long key = s.key[j];
      if (kAnyHit) {
        occ_out[s.lane[j]] = key ? 1 : 0;
      } else {
        t_out[s.lane[j]] = __uint_as_float(static_cast<uint32_t>(key >> 32));
        idx_out[s.lane[j]] = static_cast<int32_t>(key & 0xffffffffu);
      }
    }
    __syncthreads();  // the queue is refilled next
  }
}

// Thread blocks per SM and SMs of the current device. Sets the kernel's
// dynamic shared-memory limit first.
template <bool kAnyHit>
cudaError_t occupancy(int* per_sm, int* sms) {
  auto kern = sweep_kernel<kAnyHit>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
  if (e != cudaSuccess) return e;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, kThreads,
                                                       sizeof(Smem));
}

// Grid of one launch: the thread blocks that fit on the card at once, never
// more than there are chunks.
template <bool kAnyHit>
int launch(const float* ox, const float* oy, const float* oz, const float* dx,
           const float* dy, const float* dz, const float* t_cap, int n,
           const float* coef, const float* bounds, int n_blocks, float t_eps,
           int* counter, float* t_out, int32_t* idx_out, uint8_t* occ_out,
           void* stream) {
  if (n <= 0) return 0;
  static int grid_of[64] = {0};  // per device: occupancy x SMs
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (grid_of[dev] == 0) {
    int per_sm = 0, sms = 0;
    if ((e = occupancy<kAnyHit>(&per_sm, &sms)) != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid_of[dev] = per_sm * sms;
  }
  const int chunks = (n + kChunk - 1) / kChunk;
  const int grid = grid_of[dev] < chunks ? grid_of[dev] : chunks;
  sweep_kernel<kAnyHit><<<grid, kThreads, sizeof(Smem), (cudaStream_t)stream>>>(
      ox, oy, oz, dx, dy, dz, t_cap, n, reinterpret_cast<const float4*>(coef),
      bounds, n_blocks, t_eps, counter, t_out, idx_out, occ_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Closest hit: t_out = best t (t_cap on a miss), idx_out = face index in
// leaf order (-1 on a miss). coef is [n_blocks][4][128][4] f32 (each
// face's 16 non-zero coefficients as 4 rows of 4, row-major within each
// 128-face block; see tri_sweep._COMPACT), bounds [n_blocks][8]; counter
// is one int32, zero before the launch and again after it (the launch's
// last claim clears it), so launches that share one counter must be
// ordered, as on one stream. Returns the cudaError_t of the launch.
int tri_sweep_closest(const float* ox, const float* oy, const float* oz,
                      const float* dx, const float* dy, const float* dz,
                      const float* t_cap, int n, const float* coef,
                      const float* bounds, int n_blocks, float t_eps,
                      int* counter, float* t_out, int32_t* idx_out,
                      void* stream) {
  return launch<false>(ox, oy, oz, dx, dy, dz, t_cap, n, coef, bounds,
                       n_blocks, t_eps, counter, t_out, idx_out, nullptr,
                       stream);
}

// Any hit: occ_out = 1 where some face is hit inside (t_eps, t_cap).
int tri_sweep_any(const float* ox, const float* oy, const float* oz,
                  const float* dx, const float* dy, const float* dz,
                  const float* t_cap, int n, const float* coef,
                  const float* bounds, int n_blocks, float t_eps,
                  int* counter, uint8_t* occ_out, void* stream) {
  return launch<true>(ox, oy, oz, dx, dy, dz, t_cap, n, coef, bounds,
                      n_blocks, t_eps, counter, nullptr, nullptr, occ_out,
                      stream);
}

// Build facts of one kernel on the current device: out = [registers per
// thread, dynamic shared memory per block (bytes), local memory per thread
// (bytes, spills), thread blocks per SM, threads per block, SMs].
int tri_sweep_info(int any_hit, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = any_hit ? cudaFuncGetAttributes(&a, sweep_kernel<true>)
                          : cudaFuncGetAttributes(&a, sweep_kernel<false>);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, sms = 0;
  e = any_hit ? occupancy<true>(&per_sm, &sms) : occupancy<false>(&per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)sizeof(Smem);
  out[2] = (int)a.localSizeBytes;
  out[3] = per_sm;
  out[4] = kThreads;
  out[5] = sms;
  return 0;
}

const char* tri_sweep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
