// Culled ray/segment LiDAR sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel f1tenth_gym_tpu/ops/pallas_scan.py::_scan_kernel
// (K1). The host side (ops/scan_kernel.py) flattens the scan poses,
// computes the per-scan scalars and the beam-fan tables, and picks for
// every 8-scan subgroup a culled window block of the v9 pack (bid > 0) or
// the full table (bid == 0). This kernel then computes, for every
// (scan, beam),
//
//   range = min(1 / max(max_k s_k, 1e-9), max_range)
//
// where, for segment row k = [nx, ny, c, tx, ty, w, 0, 0] and beam
// direction d, s = (n.d) / (c - n.o) is the inverse range of the hit and
// the hit counts when 0 <= b <= s with b = (o.t + w) * s + t.d. A scan's
// rows are its subgroup's `ng` shared groups, then, on packs with split
// blocks, its own extras range [est, est + ecnt).
//
// Arithmetic: the formulas and their operation order are those of
// pallas_scan.py:238-250 (beam directions by angle addition against the
// cos/sin(n*beta) fan tables with the small-angle correction g) and
// :280-300 (hit test). Built with -fmad=false, the kernel matches its
// plain torch version (scan_kernel.py::sweep_plain) bit for bit. No FMA
// contraction: it would trade that gate for a tolerance.
//
// What bounds it. Testing every (beam, row) pair costs 14 operations a
// pair (10 multiply/add, min, compare, select, max); on the bench racing
// step that is 8192 scans x 1080 beams x 65.8 rows = 582 M pairs, an
// issue bound of 0.243 ms at the half rate left without FMA, which the
// first version of this kernel reached at 65 %. So the work itself has to
// shrink: a ray can pass the hit test only if its direction lies inside
// the arc that the segment subtends from the scan origin, and most rows
// subtend a small arc. On the bench step the skip keeps 11 % of the
// swept pairs, and 4 % of them hit (14 operations each: 0.005 ms), so the
// bound is the bytes: the output and each table row some scan sweeps,
// once (chip_smoke.py, phase kernel_timing): 36.1 MB, 0.0108 ms at
// 3.35 TB/s. On an H100 80GB HBM3 at a 700 W power limit the kernel took
// 0.091-0.096 ms there (0.36 ms for the first version of this kernel, in
// the same run of ab_kernels.py), 0.42 ms with the skip off: the fixed
// work of a block (loads, staging, two barriers a stage, the beam
// directions, the keep tests) now costs as much as the kept pairs.
//
// Design:
// * One block per (scan, group of beam chunks), one warp per chunk of
//   `chunk` contiguous beams (128 at 1080 beams: 9 warps, the last with
//   56 beams, 6.25 % of the lanes idle). Each lane holds 4 contiguous
//   beams and stores them with one float4.
// * Per-(scan, row) terms once a block: the rows stream through shared
//   memory in stages of kStage rows, double-buffered with cp.async (the
//   full tables of large maps take several stages); for each staged row
//   one thread computes 1/num, uo and the directions of the row's ends
//   from the origin, which all warps of the block then share.
// * Row skip by arc: a chunk's sector runs from its first beam's
//   direction to its last one's (the beam angle (floor(t) - k) * bin_to_rad
//   does not decrease along the fan, so the sector holds every beam of the
//   chunk), widened by delta on both sides. The lanes test 32 rows at once,
//   one a lane: a row is kept when its arc meets the widened sector
//   (two circular intervals, each under pi, meet iff one holds the
//   other's start). __ballot_sync gives the warp its kept rows, and it
//   runs the 4-beam hit test on those only, the same branch for all lanes.
//   A skipped pair's hit test cannot pass with s > 0, so it would add 0 to
//   a max that starts at 0: the result is unchanged, bit for bit.
// * Rows with t = 0 (padding, degenerate rows: n = 0, so s = 0) are
//   dropped; rows whose line passes within eps of the origin (this holds
//   the |num| < 1e-12 clamp too), or whose segment is longer than
//   SKIP_RATIO times that distance, are always kept.
// * Split-pack extras are just more rows of the scan's own block.
// * Occupancy: __launch_bounds__(512, 3) caps the registers at 42; ptxas
//   gives 40 (no spills) and 27,648 B of shared memory, so an SM holds
//   5 blocks of the main path's 9 warps (4 at the 55 registers ptxas
//   picks unbounded, measured slower): 12.4 waves over 8192 scans. Blocks
//   take unequal time (their kept rows differ), so the last partial wave
//   overlaps the others instead of running alone.
//
// Error budget behind delta, eps and the ratio (ops/scan_kernel.py:
// SKIP_DELTA, SKIP_EPS, SKIP_RATIO). The arc's ends are not rebuilt as
// points in map coordinates: they are the directions on which the hit
// test's own b = 0 and b = s hold (q0 . d = 0 and q1 . d = 0), computed
// from the same f32 num and uo that the hit test uses. The rounding of
// num and uo, which grows with the map's coordinates, is then shared by
// both tests and cannot part them, at any distance from the map's origin.
// What is left is relative (u = 2^-24): q0 and q1 are within ~2u in
// angle; the f32 hit test moves its b = 0 edge by <~ 7u rad and its b = s
// edge by <~ 12u (1 + L/dist) rad, with L the segment's length and
// dist = |num| its line's distance from the origin (the hit's parameter
// carries ~u of relative error, u L along the segment); the beam
// directions and the cross products of the sector test add <~ 4e-7 rad.
// Rows with dist < eps = 0.05 m (where the arc nears pi) or
// L > SKIP_RATIO dist (dist^2 |t|^2 < 1/SKIP_RATIO^2) are always kept, so
// on the rows the arc test decides, a pair that hits lies within
// 12u (1 + 1000) + 4e-7 ~= 7.2e-4 rad of the computed arc, and delta =
// 1e-3 rad (a quarter of a beam at 1080 beams) covers it. The budget
// assumes the table's rows as build_seg_table makes them (n = rot90(t)/|t|,
// which puts perp(q) on the side where s > 0). A warp whose chunk spans
// pi/2 or more (few beams over a wide fan) tests every row, and so does
// every warp when the caller passes skip = 0.
//
// Phase mask (the JAX kernel's debug mask, pallas_scan.py:323-330, :379):
// a template parameter. kDirs alone loads the scan's scalars, builds its
// beams' directions and its chunk's sector, and stores each beam's
// direction x-component; kSweep adds the row stream and stores the raw
// accumulator (the max inverse range, before the epilogue); kOut alone
// runs the epilogue on a zero accumulator (max_range everywhere). Work
// whose result a variant does not store goes into an empty asm statement,
// so that the compiler keeps it and the phase times measure it. The
// production variant (all three) has none of it and compiles as before.
// The subgroup size (scans that share one table choice) is a template
// parameter too, instantiated for 1, 2, 4, 8 and 16. The JAX kernel's EA
// (scans per Pallas program) has no counterpart: a launch here is one
// block per (scan, group of beam chunks).
//
// Not used, and why: tensor cores (the contraction has depth 2 in f32,
// and TF32 keeps ~10 bits: it would break the bit-exact gate and the
// ranges); TMA (a subgroup's table is ~2 KB at the main path, and copies
// are not what bounds the kernel).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kGroup = 8;        // rows per segment group
constexpr int kScal = 8;         // floats per scan scalar row
constexpr int kStage = 256;      // rows staged at a time
constexpr int kMaxWarps = 16;    // beam chunks (warps) per block
constexpr unsigned kFull = 0xffffffffu;

enum RowCode : int { kDrop = 0, kArc = 1, kKeep = 2 };
enum Phase : int { kDirs = 1, kSweep = 2, kOut = 4 };

struct Terms {                   // per (scan, row) of one stage
  float4 row[kStage];            // nx, ny, tx, ty
  float2 iu[kStage];             // 1/num, uo
  float4 arc[kStage];            // directions P, Q from the origin to the
                                 // row's ends, counter-clockwise from P to Q
  int code[kStage];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Copies rows [base, base + cnt) of the scan's row list (shared rows, then
// its extras from e0) into `dst`, 2 float4 a row.
__device__ __forceinline__ void issue_stage(float4* dst, const float* table,
                                            int base, int cnt, int n_shared,
                                            int e0) {
  for (int f = threadIdx.x; f < 2 * cnt; f += blockDim.x) {
    const int i = base + (f >> 1);
    const int g = i < n_shared ? i : e0 + (i - n_shared);
    cp_async16(dst + f, table + (size_t)g * 8 + 4 * (f & 1));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ float cross(float ux, float uy, float vx,
                                       float vy) {
  return ux * vy - uy * vx;
}

// v inside the counter-clockwise arc from p to q (under pi)
__device__ __forceinline__ bool in_arc(float vx, float vy, float4 pq) {
  return cross(pq.x, pq.y, vx, vy) >= 0.0f &&
         cross(vx, vy, pq.z, pq.w) >= 0.0f;
}

// keeps the work behind v, which a masked variant does not store
__device__ __forceinline__ void keep(float v) { asm volatile("" ::"f"(v)); }

__device__ __forceinline__ float hit(const float4 row, const float2 iu,
                                     float dx, float dy) {
  const float den = row.x * dx + row.y * dy;
  const float s = den * iu.x;
  const float ud = row.z * dx + row.w * dy;
  const float b = iu.y * s + ud;
  const float q = fminf(b, s - b);
  return q >= 0.0f ? s : 0.0f;
}

// at most 42 registers (3 blocks of the largest shape an SM): 5 blocks of
// the 9-warp main-path shape an SM instead of 4
template <int kPhases, int kSub>
__global__ void __launch_bounds__(32 * kMaxWarps, 3)
scan_sweep_kernel(const float* __restrict__ scal,
                  const float* __restrict__ fan,
                  const float* __restrict__ full,
                  const float* __restrict__ tabs, int kt_rows,
                  const int* __restrict__ bid, const int* __restrict__ ng,
                  const int* __restrict__ est, const int* __restrict__ ecnt,
                  int has_extras, float* __restrict__ out, int num_beams,
                  float inv_td, float bin_to_rad, int chunk, int skip,
                  float eps, float inv_ratio2, float cos_delta,
                  float sin_delta) {
  __shared__ Terms T;
  __shared__ float4 raw[2][2 * kStage];

  const int scan = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int c0 = (blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5)) * chunk;
  const bool chunk_ok = c0 < num_beams;   // warp-uniform

  const float* sc = scal + (size_t)scan * kScal;
  const float ox = sc[0], oy = sc[1];

  // the scan's rows: its subgroup's table, then its own extras (none
  // without the sweep phase)
  const int sub = scan / kSub;
  const int b = bid[sub];
  const float* table = b == 0 ? full : tabs + (size_t)(b - 1) * kt_rows * 8;
  const int n_shared = ng[sub] * kGroup;
  const int e0 = has_extras ? est[scan] * kGroup : 0;
  const int n_rows = (kPhases & kSweep) == 0
                         ? 0
                         : n_shared + (has_extras ? ecnt[scan] * kGroup : 0);
  if (n_rows > 0) {
    issue_stage(raw[0], table, 0, min(kStage, n_rows), n_shared, e0);
  }

  // beam directions (pallas_scan.py:238-250): theta-LUT bin
  // floor(ti0 + n*inc) mod theta_dis by angle addition, no trig
  const float ti0 = sc[2], inc = sc[3], ca = sc[4], sa = sc[5];
  const int beam0 = c0 + 4 * lane;
  float dx[4], dy[4], acc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int beam = beam0 + k;
    const bool ok = 4 * lane + k < chunk && beam < num_beams;
    const float fb = static_cast<float>(beam);
    const float cnb = ok ? fan[beam] : 1.0f;
    const float snb = ok ? fan[num_beams + beam] : 0.0f;
    const float t = ti0 + fb * inc;
    const float kk = floorf(t * inv_td);
    const float g = (t - floorf(t) + kk) * bin_to_rad;
    const float cg = 1.0f - 0.5f * g * g;
    const float cos_t = ca * cnb - sa * snb;
    const float sin_t = sa * cnb + ca * snb;
    dx[k] = cos_t * cg + sin_t * g;
    dy[k] = sin_t * cg - cos_t * g;
    acc[k] = 0.0f;
  }

  // the chunk's sector: its first beam's direction turned back by delta to
  // its last beam's turned on by delta
  const int last = min(chunk, num_beams - c0) - 1;
  const int kl = last & 3;
  const float lx = kl == 0 ? dx[0] : kl == 1 ? dx[1] : kl == 2 ? dx[2] : dx[3];
  const float ly = kl == 0 ? dy[0] : kl == 1 ? dy[1] : kl == 2 ? dy[2] : dy[3];
  const float f0x = __shfl_sync(kFull, dx[0], 0);
  const float f0y = __shfl_sync(kFull, dy[0], 0);
  const float f1x = __shfl_sync(kFull, lx, max(last, 0) >> 2);
  const float f1y = __shfl_sync(kFull, ly, max(last, 0) >> 2);
  // skip only where the chunk spans less than pi/2 (so the widened sector
  // stays under pi): not where few beams cover a wide fan
  const bool skip_here = skip && f0x * f1x + f0y * f1y > 0.0f &&
                         cross(f0x, f0y, f1x, f1y) >= 0.0f;
  const float s0x = f0x * cos_delta + f0y * sin_delta;
  const float s0y = f0y * cos_delta - f0x * sin_delta;
  const float4 sector = make_float4(s0x, s0y, f1x * cos_delta - f1y * sin_delta,
                                    f1y * cos_delta + f1x * sin_delta);

  if constexpr ((kPhases & kSweep) == 0) {
    // no row stream: keep the sector (and, where nothing stores them, the
    // directions) that the sweep would have used
    keep(sector.x);
    keep(sector.y);
    keep(sector.z);
    keep(sector.w);
    keep(skip_here ? 1.0f : 0.0f);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr ((kPhases & kOut) != 0) keep(dx[k]);
      keep(dy[k]);
    }
  }

  int buf = 0;
  for (int base = 0; base < n_rows; base += kStage) {
    const int cnt = min(kStage, n_rows - base);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // this stage's rows have landed; the last sweep is done

    // per-(scan, row) terms, once for all warps of the block
    for (int r = threadIdx.x; r < cnt; r += blockDim.x) {
      const float4 a = raw[buf][2 * r];      // nx, ny, c, tx
      const float4 v = raw[buf][2 * r + 1];  // ty, w, 0, 0
      float num = a.z - ox * a.x - oy * a.y;
      const float dist = fabsf(num);
      // |num| < 1e-12 m: the scan origin sits on the wall line
      num = dist < 1e-12f ? 1e-12f : num;
      T.row[r] = make_float4(a.x, a.y, a.w, v.x);
      const float uo = ox * a.w + oy * v.x + v.y;
      T.iu[r] = make_float2(1.0f / num, uo);
      const float t2 = a.w * a.w + v.x * v.x;
      int code = kArc;
      float4 pq = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (t2 == 0.0f) {
        code = kDrop;
      } else if (dist < eps || dist * dist * t2 < inv_ratio2) {
        code = kKeep;
      } else {
        // the hit test's own b = 0 and b = s lines: the beam toward the
        // row's end u = 0 (u = 1) is perpendicular to q0 = uo n + num t
        // (q1 = (uo - 1) n + num t), and n = rot90(t) / |t| puts perp(q)
        // on the side where s > 0; num < 0 runs counter-clockwise
        const float q0x = uo * a.x + num * a.w, q0y = uo * a.y + num * v.x;
        const float um1 = uo - 1.0f;
        const float q1x = um1 * a.x + num * a.w, q1y = um1 * a.y + num * v.x;
        pq = num < 0.0f ? make_float4(-q0y, q0x, -q1y, q1x)
                        : make_float4(-q1y, q1x, -q0y, q0x);
      }
      T.arc[r] = pq;
      T.code[r] = code;
    }
    if (base + kStage < n_rows) {
      issue_stage(raw[buf ^ 1], table, base + kStage,
                  min(kStage, n_rows - base - kStage), n_shared, e0);
    }
    __syncthreads();  // terms ready

    if (chunk_ok) {
      for (int r0 = 0; r0 < cnt; r0 += 32) {
        const int r = r0 + lane;
        bool keep = r < cnt;
        if (keep && skip_here) {
          const int code = T.code[r];
          if (code == kArc) {
            const float4 pq = T.arc[r];
            keep = in_arc(sector.x, sector.y, pq) || in_arc(pq.x, pq.y, sector);
          } else {
            keep = code == kKeep;
          }
        }
        unsigned m = __ballot_sync(kFull, keep);
        while (m) {
          const int j = r0 + __ffs(m) - 1;
          m &= m - 1;
          const float4 row = T.row[j];
          const float2 iu = T.iu[j];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[k] = fmaxf(acc[k], hit(row, iu, dx[k], dy[k]));
          }
        }
      }
    }
    buf ^= 1;
  }

  if (!chunk_ok) return;
  const float maxr = sc[6];
  float res[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr ((kPhases & kOut) != 0) {
      res[k] = fminf(1.0f / fmaxf(acc[k], 1e-9f), maxr);
    } else if constexpr ((kPhases & kSweep) != 0) {
      res[k] = acc[k];   // the raw accumulator
    } else {
      res[k] = dx[k];    // the beam's direction, x-component
    }
  }
  float* dst = out + (size_t)scan * num_beams + beam0;
  const int n_here = min(4, min(chunk - 4 * lane, num_beams - beam0));
  if (n_here == 4 && (num_beams & 3) == 0) {
    *reinterpret_cast<float4*>(dst) = make_float4(res[0], res[1], res[2], res[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < n_here) dst[k] = res[k];
    }
  }
}

using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, int, const int*, const int*,
                        const int*, const int*, int, float*, int, float,
                        float, int, int, float, float, float, float);

template <int kPhases>
Kernel kernel_for_sub(int sub) {
  switch (sub) {
    case 1: return scan_sweep_kernel<kPhases, 1>;
    case 2: return scan_sweep_kernel<kPhases, 2>;
    case 4: return scan_sweep_kernel<kPhases, 4>;
    case 8: return scan_sweep_kernel<kPhases, 8>;
    case 16: return scan_sweep_kernel<kPhases, 16>;
    default: return nullptr;
  }
}

// the instantiation of phase mask `phases` (kDirs | kSweep | kOut bits,
// kDirs set) and subgroup size `sub`; null when there is none
Kernel kernel_for(int phases, int sub) {
  switch (phases) {
    case kDirs: return kernel_for_sub<kDirs>(sub);
    case kDirs | kSweep: return kernel_for_sub<kDirs | kSweep>(sub);
    case kDirs | kOut: return kernel_for_sub<kDirs | kOut>(sub);
    case kDirs | kSweep | kOut: return kernel_for_sub<kDirs | kSweep | kOut>(sub);
    default: return nullptr;
  }
}

}  // namespace

// Plain C entry, bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = launched). `chunk` (a multiple of 4, at most 128)
// beams a warp, `warps` chunks a block; `phases` the phase mask (7 in
// production), `sub` the scans of a subgroup (1, 2, 4, 8 or 16).
extern "C" int scan_sweep(const float* scal, const float* fan,
                          const float* full, const float* tabs, int kt_rows,
                          const int* bid, const int* ng, const int* est,
                          const int* ecnt, int has_extras, float* out,
                          int n_scans, int num_beams, float inv_td,
                          float bin_to_rad, int chunk, int warps, int skip,
                          float eps, float inv_ratio2, float cos_delta,
                          float sin_delta, int phases, int sub, void* stream) {
  const Kernel kernel = kernel_for(phases, sub);
  if (kernel == nullptr || chunk <= 0 || chunk > 128 || chunk % 4 ||
      warps <= 0 || warps > kMaxWarps || n_scans % sub) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_chunks = (num_beams + chunk - 1) / chunk;
  const dim3 grid(n_scans, (n_chunks + warps - 1) / warps);
  kernel<<<grid, 32 * warps, 0, static_cast<cudaStream_t>(stream)>>>(
      scal, fan, full, tabs, kt_rows, bid, ng, est, ecnt, has_extras, out,
      num_beams, inv_td, bin_to_rad, chunk, skip, eps, inv_ratio2, cos_delta,
      sin_delta);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks an SM holds of the launch scan_sweep makes, and its grid
// size in blocks (`grid_blocks`); -1 on error.
extern "C" int scan_sweep_occupancy(int n_scans, int num_beams, int chunk,
                                    int warps, int phases, int sub,
                                    int* grid_blocks) {
  const Kernel kernel = kernel_for(phases, sub);
  int per_sm = 0;
  if (kernel == nullptr || warps <= 0 || warps > kMaxWarps || chunk <= 0 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    32 * warps, 0) !=
          cudaSuccess) {
    return -1;
  }
  const int n_chunks = (num_beams + chunk - 1) / chunk;
  *grid_blocks = n_scans * ((n_chunks + warps - 1) / warps);
  return per_sm;
}
