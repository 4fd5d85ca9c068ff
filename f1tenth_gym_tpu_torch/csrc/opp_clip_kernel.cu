// Opponent clip: each agent's LiDAR scan clipped by the other agents' car
// boxes, for Hopper (sm_90a). K3.
//
// Replaces no TPU kernel. The racing step of both packages clips scans by
// opponents with ops/collision.py::ray_cast_opponents (laser_models.py:
// 249-346): the blocked-view window of every opponent, the ray/edge
// intersection of every beam in it, and the reference's collinear
// fallback, which K2 (overlay_kernel.cu, the port of the TPU's
// _overlay_kernel) leaves out. In eager PyTorch that pass is ~90 launches
// over a (scans, opponents, 4 edges, beams) broadcast; this kernel is one
// launch that computes the same function, bit for bit, in float32 and
// float64 (ops/opp_clip_kernel.py::opp_clip_plain is its plain version).
//
// Inputs are the step's own tensors: the states x (n, x_stride) after the
// iTTC zeroing (x, y and yaw read at their columns), every agent's box
// (n, 4, 2) from before it, the scans (n, B) and the scan angles (B,), for
// n = envs * agents scans in (env, agent) order. The kernel picks each
// agent's opponents itself: every other agent of its env, ascending.
//
// Arithmetic: ray_cast_opponents' formulas in its operation order, one
// IEEE operation per torch op. The window: atan2 of each vertex, the ego
// angle atan2(sin, cos), the +-2 pi wrap, the nearest beam by half-down
// rounding ceil(x - 1/2) on the increment scan_angles[1] - scan_angles[0],
// clamped to [0, B - 1], then min and max over the 4 vertices. The beam
// normal v3 by angle addition from cos/sin(theta) and cos/sin(angle +
// pi/2); denom = v2.v3, d1 = (v2 x v1) / denom, d2 = (v1.v3) / denom as
// true divisions; valid = |denom| > 0, d1 >= 0, 0 <= d2 <= 1; where
// |denom| <= 0 and |v2 x (va - o)| < 1e-8 the distance is min(|va - o|,
// |vb - o|). (va - o = -v1 exactly, so that cross product is -(v2 x v1)
// and the test reads |v2 x v1|.) Then the min over the edges, over the
// opponents whose window holds the beam, and with the scan; mins
// propagate NaN as torch's amin and minimum do. Built with -fmad=false
// and without fast math, so nothing is contracted and sin, cos, atan2,
// sqrt and division are the CUDA math library's, as in torch's kernels.
//
// What bounds it: bytes. Every scan is read once and written once, 2 x
// sizeof(T) a beam (32,768 float32 scans of 1080 beams: 283,115,520 B,
// 0.0845 ms at 3.35 TB/s); poses and boxes add under 1 %. The edge tests
// run only for beams inside a window: 19 % of the beams in the racing step
// on example_map, where an opponent right behind an ego (one scan in 9)
// opens a window over the whole scan.
//
// Design: one warp a scan, 8 warps a block, no block-wide sync. The
// opponents are taken in chunks of up to kOppChunk, whose constants fill
// the warp's shared memory; each further chunk reads the scan back from
// the output and clips it again, so the beams meet the opponents in the
// same ascending order and the bits do not change. Up to kOppChunk + 1
// agents (the racing step's 2 among them) an instantiation with one chunk
// runs: the loop over chunks costs 1.2 times the time and a resident
// block an SM where it is compiled in (H100, PERF.md).
//  1. Each lane starts the 16-byte load (streaming hint) of its first pack
//     of the scan (4 float32 or 2 float64 beams), so that it is in flight
//     during the prologue. Then one lane per (opponent, vertex) computes
//     the vertex's window index and its edge's constants (v1, v2, v2 x v1,
//     and the collinear fallback's distance, or inf where the edge is not
//     collinear with the scan origin) into the warp's shared memory; the
//     window's min and max over the 4 vertices come from two shuffles
//     between the 4 neighbouring lanes.
//  2. The lanes stride over the scan's packs. A pack that meets no window
//     is stored as it was loaded.
//     Inside a window each beam computes its normal and tests the 4 edges
//     with its running min, which starts at the scan: an edge whose d1
//     cannot lower it skips the division for d2, and one whose d1 is
//     certainly negative (signs apart, far from underflow) skips both, so
//     the min, and so the bits, are those of the full test.
// One pack a lane at a time, the in-window work inlined, ran fastest on
// the racing step's scans: 2 or 4 packs a lane unrolled took 1.3 and 2.5
// times as long (the in-window code grows with them), the in-window work
// out of line 1.1 times, the next pack's load issued ahead 1.09 times,
// and the first version, a block of scans behind one __syncthreads, 2.9
// times (H100 times in PERF.md).
// Scans whose beam count is not a multiple of the pack, or that are not
// 16-byte aligned, take the same path with scalar loads and stores.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kEdgeVals = 6;     // v1x, v1y, v2x, v2y, v2 x v1, fallback
constexpr int kOppChunk = 16;    // opponents whose constants a warp holds

// the CUDA math library's float and double functions, by overload
__device__ __forceinline__ float m_sin(float v) { return sinf(v); }
__device__ __forceinline__ double m_sin(double v) { return sin(v); }
__device__ __forceinline__ float m_cos(float v) { return cosf(v); }
__device__ __forceinline__ double m_cos(double v) { return cos(v); }
__device__ __forceinline__ float m_atan2(float y, float x) {
  return atan2f(y, x);
}
__device__ __forceinline__ double m_atan2(double y, double x) {
  return atan2(y, x);
}
__device__ __forceinline__ float m_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double m_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float m_ceil(float v) { return ceilf(v); }
__device__ __forceinline__ double m_ceil(double v) { return ceil(v); }
__device__ __forceinline__ float m_abs(float v) { return fabsf(v); }
__device__ __forceinline__ double m_abs(double v) { return fabs(v); }
__device__ __forceinline__ float m_min(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ double m_min(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float m_max(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double m_max(double a, double b) {
  return fmax(a, b);
}

template <typename T>
__device__ __forceinline__ bool is_nan(T v) {
  return v != v;
}

// torch's amin / amax step: NaN wins
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (is_nan(a) || a < b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (is_nan(a) || a > b) ? a : b;
}
// torch.minimum
template <typename T>
__device__ __forceinline__ T minimum(T a, T b) {
  return is_nan(a) ? a : (is_nan(b) ? b : m_min(a, b));
}

template <typename T>
struct Pack {
  static constexpr int kN = 16 / sizeof(T);
  union {
    uint4 raw;
    T v[kN];
  };
};

// The test that d1 = cross / denom is negative without dividing: signs
// apart and |cross| >= |denom| * kV. Then |d1| is at least 2^-100 (2^-1000
// for double) or, where the product underflows, the smallest nonzero T
// over 2^-26 (2^-22): far above the quotients that round to -0, which
// would pass d1 >= 0.
template <typename T>
struct Tiny;
template <>
struct Tiny<float> {
  static constexpr float kV = 0x1p-100f;
};
template <>
struct Tiny<double> {
  static constexpr double kV = 0x1p-1000;
};

// torch's amin step with the candidate first: a NaN candidate wins
template <typename T>
__device__ __forceinline__ T lower(T cur, T cand) {
  return (is_nan(cand) || cand < cur) ? cand : cur;
}

// The beams of pack p (beams q, q + 1, ...) inside one opponent's window
// [lo, hi], each lowered to its nearest hit on the opponent's 4 edges
// (constants eo). A beam's running min starts at its scan: an edge can
// only lower it, so a division whose quotient cannot is skipped.
template <typename T>
__device__ __forceinline__ Pack<T> clip_pack(Pack<T> p, int q, int lo,
                                             int hi, int beams, const T* eo,
                                             const T* __restrict__ angles,
                                             T ct, T st) {
  const T kHalfPi = static_cast<T>(1.5707963267948966);
#pragma unroll
  for (int kk = 0; kk < Pack<T>::kN; ++kk) {
    const int b = q + kk;
    T cur = p.v[kk];
    if (b >= beams || b < lo || b > hi || is_nan(cur)) continue;
    // the beam normal by angle addition
    const T ang = angles[b] + kHalfPi;
    const T ca = m_cos(ang), sa = m_sin(ang);
    const T v3x = ct * ca - st * sa, v3y = st * ca + ct * sa;
#pragma unroll
    for (int ed = 0; ed < 4; ++ed) {
      const T* e = eo + ed * kEdgeVals;
      const T denom = e[2] * v3x + e[3] * v3y;
      if (m_abs(denom) <= T(0)) {
        cur = lower(cur, e[5]);
        continue;
      }
      const T cross = e[4];
      // d1 < 0 for sure: signs apart, and no quotient that rounds to -0
      if ((cross < T(0)) != (denom < T(0)) && cross != T(0) &&
          m_abs(cross) >= m_abs(denom) * Tiny<T>::kV) {
        continue;
      }
      const T d1 = cross / denom;
      if (!(d1 >= T(0) && d1 < cur)) continue;
      const T d2 = (e[0] * v3x + e[1] * v3y) / denom;
      if (d2 >= T(0) && d2 <= T(1)) cur = d1;
    }
    p.v[kk] = cur;
  }
  return p;
}

template <typename T, bool kOneChunk>
__global__ void __launch_bounds__(kThreads)
opp_clip_kernel(const T* __restrict__ scans, const T* __restrict__ x,
                const T* __restrict__ verts, const T* __restrict__ angles,
                T* __restrict__ out, int n_scans, int agents, int beams,
                int x_stride, int ix, int iy, int iyaw, int chunk,
                int per_warp, int vec) {
  constexpr int W = Pack<T>::kN;  // beams a pack
  const T kInf = static_cast<T>(INFINITY);
  const T kPi = static_cast<T>(3.141592653589793);
  const T kTwoPi = static_cast<T>(6.283185307179586);
  const T kEps = static_cast<T>(1e-8);

  // the warp's constants of its scan's current chunk of opponents:
  // [chunk][4 edges][kEdgeVals], then cos and sin of the scan's yaw, then
  // [chunk] windows (lo, hi)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int opp = agents - 1;
  T* edge_s = reinterpret_cast<T*>(smem_raw + (threadIdx.x >> 5) * per_warp);
  T* trig_s = edge_s + chunk * 4 * kEdgeVals;
  int* win_s = reinterpret_cast<int*>(trig_s + 2);

  const int i = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);  // scan
  if (i >= n_scans) return;
  const int nq = (beams + W - 1) / W;  // packs a scan
  const T* src = scans + (size_t)i * beams;
  T* dst = out + (size_t)i * beams;
  // a pack of the scan (first chunk) or of the output (later chunks: the
  // lane reads back what it stored)
  auto load = [&](int item, bool first) {
    Pack<T> p;
    const int q = item * W;
    if (vec) {
      p.raw = first ? __ldcs(reinterpret_cast<const uint4*>(src + q))
                    : *reinterpret_cast<const uint4*>(dst + q);
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k) {
        p.v[k] = q + k < beams ? (first ? src[q + k] : dst[q + k]) : T(0);
      }
    }
    return p;
  };

  // the lane's first pack, in flight while the prologue runs
  Pack<T> pk;
  if (lane < nq) pk = load(lane, true);

  const int a = i % agents;
  const T* p = x + (size_t)i * x_stride;
  const T ox = p[ix], oy = p[iy], th = p[iyaw];
  const T a0 = angles[0];
  const T inc = angles[1] - angles[0];
  const T last = static_cast<T>(beams - 1);
  const int n_chunks = kOneChunk ? 1 : (opp + chunk - 1) / chunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * chunk;
    const int nc = min(chunk, opp - c0);  // opponents c0 .. c0 + nc - 1
    // every lane is done with the last chunk's constants
    if (c0 > 0) __syncwarp();

    // ---- 1. prologue: one lane per (opponent, vertex)
    for (int base = 0; base < nc * 4; base += 32) {  // uniform in the warp
      const int item = base + lane;
      const bool on = item < nc * 4;
      const int k = item & 3;
      T ind = 0;
      if (on) {
        const int o = c0 + (item >> 2);
        const int j = o < a ? o : o + 1;  // the o-th other agent, ascending
        const T* v = verts + (size_t)(i - a + j) * 8;
        const T vax = v[2 * k], vay = v[2 * k + 1];
        const T vbx = v[2 * ((k + 1) & 3)], vby = v[2 * ((k + 1) & 3) + 1];
        const T st = m_sin(th), ct = m_cos(th);

        // the vertex's nearest beam
        const T ego = m_atan2(st, ct);
        T diff = ego - m_atan2(vay - oy, vax - ox);
        diff = diff > kPi ? diff - kTwoPi : diff;
        diff = diff < -kPi ? diff + kTwoPi : diff;
        ind = m_ceil((-diff - a0) / inc - static_cast<T>(0.5));
        ind = is_nan(ind) ? ind : m_min(m_max(ind, T(0)), last);

        // the edge from this vertex to the next
        const T v1x = ox - vax, v1y = oy - vay;
        const T v2x = vbx - vax, v2y = vby - vay;
        const T cross = v2x * v1y - v2y * v1x;
        const T dax = v1x * v1x, day = v1y * v1y;
        const T dbx = (vbx - ox) * (vbx - ox), dby = (vby - oy) * (vby - oy);
        const T col = minimum(m_sqrt(dax + day), m_sqrt(dbx + dby));
        T* e = edge_s + item * kEdgeVals;
        e[0] = v1x;
        e[1] = v1y;
        e[2] = v2x;
        e[3] = v2y;
        e[4] = cross;
        e[5] = m_abs(cross) < kEps ? col : kInf;
        if (item == 0) {
          trig_s[0] = ct;
          trig_s[1] = st;
        }
      }
      // the window: min and max over the 4 vertices (neighbouring lanes)
      T lo = ind, hi = ind;
#pragma unroll
      for (int m = 1; m <= 2; m <<= 1) {
        lo = nan_min(lo, __shfl_xor_sync(0xffffffffu, lo, m));
        hi = nan_max(hi, __shfl_xor_sync(0xffffffffu, hi, m));
      }
      if (on && k == 0) {
        const bool empty = is_nan(lo) || is_nan(hi);  // no beam compares true
        win_s[2 * (item >> 2)] = empty ? 1 : static_cast<int>(lo);
        win_s[2 * (item >> 2) + 1] = empty ? 0 : static_cast<int>(hi);
      }
    }
    __syncwarp();
    const T ct = trig_s[0], st = trig_s[1];

    // ---- 2. clip the packs
    for (int item = lane; item < nq; item += 32) {
      if (item != lane || c0 > 0) pk = load(item, c0 == 0);
      const int q = item * W;
      for (int o = 0; o < nc; ++o) {
        const int lo = win_s[2 * o], hi = win_s[2 * o + 1];
        if (q + W - 1 >= lo && q <= hi) {
          pk = clip_pack(pk, q, lo, hi, beams, edge_s + o * 4 * kEdgeVals,
                         angles, ct, st);
        }
      }
      if (vec) {
        __stcs(reinterpret_cast<uint4*>(dst + q), pk.raw);
      } else {
#pragma unroll
        for (int kk = 0; kk < W; ++kk) {
          if (q + kk < beams) dst[q + kk] = pk.v[kk];
        }
      }
    }
  }
}

// the opponents a chunk, and the shared memory a warp for them
inline int chunk_of(int agents) {
  return agents - 1 < kOppChunk ? agents - 1 : kOppChunk;
}
template <typename T>
int per_warp_bytes(int agents) {
  return (chunk_of(agents) * (4 * kEdgeVals * (int)sizeof(T) + 8) +
          2 * (int)sizeof(T) + 15) / 16 * 16;
}

// the instantiation that a launch with this many agents runs
template <typename T>
auto kernel_for(int agents) {
  return agents - 1 <= kOppChunk ? opp_clip_kernel<T, true>
                                 : opp_clip_kernel<T, false>;
}

template <typename T>
int launch(const void* scans, const void* x, const void* verts,
           const void* angles, void* out, int n_scans, int agents, int beams,
           int x_stride, int ix, int iy, int iyaw, int vec, void* stream) {
  if (agents < 2 || beams < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_warp = per_warp_bytes<T>(agents);
  const int grid = (n_scans + kThreads / 32 - 1) / (kThreads / 32);
  const auto kernel = kernel_for<T>(agents);
  kernel<<<grid, kThreads, per_warp * (kThreads / 32),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(scans), static_cast<const T*>(x),
      static_cast<const T*>(verts), static_cast<const T*>(angles),
      static_cast<T*>(out), n_scans, agents, beams, x_stride, ix, iy, iyaw,
      chunk_of(agents), per_warp, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry, bound with ctypes. `f64`: the tensors are float64, else
// float32. `vec`: the beam count is a multiple of 16 / sizeof(T) and
// `scans` and `out` are 16-byte aligned, so 16-byte loads and stores are
// allowed. Launches on `stream` and returns cudaGetLastError() (0 =
// launched).
extern "C" int opp_clip(const void* scans, const void* x, const void* verts,
                        const void* angles, void* out, int n_scans,
                        int agents, int beams, int x_stride, int ix, int iy,
                        int iyaw, int f64, int vec, void* stream) {
  if (n_scans <= 0) return 0;
  return f64 ? launch<double>(scans, x, verts, angles, out, n_scans, agents,
                              beams, x_stride, ix, iy, iyaw, vec, stream)
             : launch<float>(scans, x, verts, angles, out, n_scans, agents,
                             beams, x_stride, ix, iy, iyaw, vec, stream);
}

// Resident blocks an SM holds of the launch opp_clip makes, with its grid
// size in blocks and its scans a block; -1 on error.
extern "C" int opp_clip_occupancy(int f64, int n_scans, int agents,
                                  int beams, int* grid_blocks,
                                  int* scans_per_block) {
  if (agents < 2 || beams < 2) return -1;
  const int smem = (f64 ? per_warp_bytes<double>(agents)
                        : per_warp_bytes<float>(agents)) * (kThreads / 32);
  int per_sm = 0;
  const cudaError_t err =
      f64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel_for<double>(agents), kThreads, smem)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel_for<float>(agents), kThreads, smem);
  if (err != cudaSuccess) return -1;
  *scans_per_block = kThreads / 32;
  *grid_blocks = (n_scans + kThreads / 32 - 1) / (kThreads / 32);
  return per_sm;
}
