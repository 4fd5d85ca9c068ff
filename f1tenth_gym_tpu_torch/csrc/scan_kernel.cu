// Culled ray/segment LiDAR sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel f1tenth_gym_tpu/ops/pallas_scan.py::_scan_kernel.
// The host side (ops/scan_kernel.py) flattens the scan poses, computes the
// per-scan scalars and the beam-fan tables, and picks for every 8-scan
// subgroup a culled window block of the v9 pack (bid > 0) or the full
// table (bid == 0). This kernel then computes, for every (scan, beam),
//
//   range = min(1 / max(max_k s_k, 1e-9), max_range)
//
// where, for segment row k = [nx, ny, c, tx, ty, w, 0, 0] and beam
// direction d, s = (n.d) / (c - n.o) is the inverse range of the hit and
// the hit counts when 0 <= b <= s with b = (o.t + w) * s + t.d.
// Rows swept: the subgroup's `ng` shared groups of its table, then, on
// packs with split blocks, each scan's own extras range [est, est + ecnt).
//
// Arithmetic: the formulas and their operation order are those of
// pallas_scan.py:238-250 (beam directions by angle addition against the
// cos/sin(n*beta) fan tables with the small-angle correction g) and
// :280-300 (hit test). Built with -fmad=false, the kernel matches its
// plain torch version (scan_kernel.py::sweep_plain) bit for bit.
//
// Bound on the H100: per (beam, row) the test costs 14 operations (10
// multiply/add, min, compare, select, max) and no memory traffic, since
// the rows and the per-(scan, row) terms sit in shared memory. On the
// bench racing step the culled tables give a mean of 8.23 swept groups
// (65.8 rows) a scan, so 8192 scans x 1080 beams x 65.8 rows x 14 =
// 8.15 G operations: 0.122 ms at 67 TFLOP/s of float32 outside the tensor
// cores, 0.243 ms at the half rate left without FMA, which the bit-exact
// build gives up. The kernel is bound by operations: its output (35 MB
// written once) needs ~0.01 ms of memory time. chip_smoke.py measured
// 0.377 ms on an H100 80GB HBM3 at a 700 W power limit.
//
// Design, simple first: one block per (8-scan subgroup, 128-beam tile).
// A block streams its table through shared memory in chunks of 256 rows;
// for each chunk every thread loads one row and computes the row's
// 1/num and uo for the 8 scans once (so the division is amortised over
// all beams), then each thread sweeps the chunk for its 4 (scan, beam)
// items, keeping the running max in registers. Warps share one scan and
// one row at a time, so shared-memory reads are broadcasts. Chunked
// streaming keeps shared memory at ~21 KB whatever the table size.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kGroup = 8;     // rows per segment group
constexpr int kSub = 8;       // scans per subgroup (one table choice)
constexpr int kThreads = 256;
constexpr int kBeams = 128;   // beams per block
constexpr int kScanStride = kThreads / kBeams;        // 2
constexpr int kItems = kSub / kScanStride;            // 4 scans per thread
constexpr int kChunk = kThreads;                      // rows per stage
constexpr int kScal = 8;      // floats per scan scalar row

struct Stage {
  float4 row[kChunk];         // nx, ny, tx, ty
  float2 iu[kSub][kChunk];    // 1/num, uo per (scan, row)
};

// Loads rows [row0, row0 + n) of `table` and computes the per-(scan, row)
// terms for scans [s_lo, s_hi) into slots [0, s_hi - s_lo).
__device__ __forceinline__ void stage_rows(Stage& st, const float* table,
                                           int row0, int n, const float* ox,
                                           const float* oy, int s_lo,
                                           int s_hi) {
  const int r = threadIdx.x;
  if (r < n) {
    const float4* src =
        reinterpret_cast<const float4*>(table + (size_t)(row0 + r) * 8);
    const float4 a = src[0];  // nx, ny, c, tx
    const float4 b = src[1];  // ty, w, 0, 0
    st.row[r] = make_float4(a.x, a.y, a.w, b.x);
    for (int s = s_lo; s < s_hi; ++s) {
      float num = a.z - ox[s] * a.x - oy[s] * a.y;
      // |num| < 1e-12 m: the scan origin sits on the wall line
      num = fabsf(num) < 1e-12f ? 1e-12f : num;
      const float inv = 1.0f / num;
      const float uo = ox[s] * a.w + oy[s] * b.x + b.y;
      st.iu[s - s_lo][r] = make_float2(inv, uo);
    }
  }
}

__device__ __forceinline__ float hit(const float4 row, const float2 iu,
                                     float dx, float dy) {
  const float den = row.x * dx + row.y * dy;
  const float s = den * iu.x;
  const float ud = row.z * dx + row.w * dy;
  const float b = iu.y * s + ud;
  const float q = fminf(b, s - b);
  return q >= 0.0f ? s : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
scan_sweep_kernel(const float* __restrict__ scal,
                  const float* __restrict__ fan,
                  const float* __restrict__ full,
                  const float* __restrict__ tabs, int kt_rows,
                  const int* __restrict__ bid, const int* __restrict__ ng,
                  const int* __restrict__ est, const int* __restrict__ ecnt,
                  int has_extras, float* __restrict__ out, int num_beams,
                  float inv_td, float bin_to_rad) {
  __shared__ Stage st;
  __shared__ float s_ox[kSub], s_oy[kSub];

  const int sub = blockIdx.x;
  const int scan0 = sub * kSub;
  const int tid = threadIdx.x;
  const int soff = tid / kBeams;  // this thread's scans: soff + 2 * j
  const int beam = blockIdx.y * kBeams + tid % kBeams;
  const bool beam_ok = beam < num_beams;

  if (tid < kSub) {
    s_ox[tid] = scal[(scan0 + tid) * kScal + 0];
    s_oy[tid] = scal[(scan0 + tid) * kScal + 1];
  }

  // beam directions (pallas_scan.py:238-250): theta-LUT bin
  // floor(ti0 + n*inc) mod theta_dis by angle addition, no trig
  const float fb = static_cast<float>(beam);
  const float cnb = beam_ok ? fan[beam] : 1.0f;
  const float snb = beam_ok ? fan[num_beams + beam] : 0.0f;
  float dx[kItems], dy[kItems], acc[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const float* sc = scal + (scan0 + soff + kScanStride * j) * kScal;
    const float ti0 = sc[2], inc = sc[3], ca = sc[4], sa = sc[5];
    const float t = ti0 + fb * inc;
    const float k = floorf(t * inv_td);
    const float g = (t - floorf(t) + k) * bin_to_rad;
    const float cg = 1.0f - 0.5f * g * g;
    const float cos_t = ca * cnb - sa * snb;
    const float sin_t = sa * cnb + ca * snb;
    dx[j] = cos_t * cg + sin_t * g;
    dy[j] = sin_t * cg - cos_t * g;
    acc[j] = 0.0f;
  }
  __syncthreads();  // s_ox / s_oy

  const int b = bid[sub];
  const float* table = b == 0 ? full : tabs + (size_t)(b - 1) * kt_rows * 8;

  // shared part: the subgroup's ng groups, all 8 scans
  const int rows = ng[sub] * kGroup;
  for (int base = 0; base < rows; base += kChunk) {
    const int n = min(kChunk, rows - base);
    stage_rows(st, table, base, n, s_ox, s_oy, 0, kSub);
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < n; ++r) {
      const float4 row = st.row[r];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const float2 iu = st.iu[soff + kScanStride * j][r];
        acc[j] = fmaxf(acc[j], hit(row, iu, dx[j], dy[j]));
      }
    }
    __syncthreads();
  }

  // per-scan extras of split blocks: scan s sweeps its own range only
  if (has_extras) {
    for (int s = 0; s < kSub; ++s) {
      const int e0 = est[scan0 + s] * kGroup;
      const int en = ecnt[scan0 + s] * kGroup;
      for (int base = 0; base < en; base += kChunk) {
        const int n = min(kChunk, en - base);
        stage_rows(st, table, e0 + base, n, s_ox, s_oy, s, s + 1);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          if (soff + kScanStride * j == s) {
            for (int r = 0; r < n; ++r) {
              acc[j] = fmaxf(acc[j], hit(st.row[r], st.iu[0][r], dx[j], dy[j]));
            }
          }
        }
        __syncthreads();
      }
    }
  }

  if (beam_ok) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int scan = scan0 + soff + kScanStride * j;
      const float maxr = scal[scan * kScal + 6];
      out[(size_t)scan * num_beams + beam] =
          fminf(1.0f / fmaxf(acc[j], 1e-9f), maxr);
    }
  }
}

}  // namespace

// Plain C entry, bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int scan_sweep(const float* scal, const float* fan,
                          const float* full, const float* tabs, int kt_rows,
                          const int* bid, const int* ng, const int* est,
                          const int* ecnt, int has_extras, float* out,
                          int n_sub, int num_beams, float inv_td,
                          float bin_to_rad, void* stream) {
  const dim3 grid(n_sub, (num_beams + kBeams - 1) / kBeams);
  scan_sweep_kernel<<<grid, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      scal, fan, full, tabs, kt_rows, bid, ng, est, ecnt, has_extras, out,
      num_beams, inv_td, bin_to_rad);
  return static_cast<int>(cudaGetLastError());
}
