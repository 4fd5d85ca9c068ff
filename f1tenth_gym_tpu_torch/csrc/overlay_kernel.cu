// Opponent overlay: clip LiDAR scans by the opponents' car boxes, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel f1tenth_gym_tpu/ops/pallas_scan.py::_overlay_kernel
// (K2). The host side (ops/overlay_kernel.py::prepare_overlay) gives every
// scan its opponents' box edges as rows [nx, ny, c, tx, ty, w, lo, hi]: the
// edge in the segment-table format of the wall sweep, and the opponent's
// blocked-view beam window [lo, hi] in the last two slots, 4 * O rows a
// scan for O opponents. This kernel computes, for every (scan, beam)
// with beam direction d = (cos, sin)(theta0 + n * inc) by angle addition,
//
//   out = min(scan, 1 / max(smax, 1e-9)) where smax > 0, else scan,
//
// where smax is the largest inverse range s = (n.d) / (c - n.o) over the
// rows whose window holds the beam and whose hit test passes:
// b = (o.t + w) * s + t.d, 0 <= b <= s. There is no collinear fallback,
// as in the TPU kernel.
//
// Arithmetic: the formulas and their operation order are those of
// pallas_scan.py:772-808 (num8, inv, uo, dx/dy, den, s, b, q). Built with
// -fmad=false, the kernel equals its plain torch version
// (overlay_kernel.py::overlay_plain) bit for bit. The TPU kernel takes
// the running min group by group; one max over all rows gives the same
// bits, since 1/x is monotone under IEEE rounding. The min of the hit
// test is written as two compares and the final min as a select, so that
// a NaN propagates as torch.minimum propagates it.
//
// What bounds it: bytes. The kernel reads every scan once and writes it
// once (2 x 4 B a beam) plus 32 B of row a box edge; the hit test runs
// only for the beams inside an opponent's window (~50 of 1080 for a car
// 1-2 m away). At the probe's shape, 8192 scans x 1080 beams with one
// opponent, that is 71,967,168 B, 0.0215 ms at 3.35 TB/s. A plain copy of
// the scans moves the same bytes, so it is the floor the kernel can reach;
// chip_smoke.py times both.
//
// Design, a streaming kernel: one thread for each 4 beams of a scan (a
// float4 of 16 B: 270 a 1080-beam scan), neighbouring threads on
// neighbouring addresses, over all scans at once; the grid is as wide as
// the data, so the card keeps enough loads in flight to stream at the
// memory's rate. The scan's float4 is loaded first, with the streaming
// cache hint (each byte is read once). A thread then reads its scan's
// windows (32 B a row, from L1: the ~67 threads of a scan read the same
// rows) and runs the hit test only where its float4 meets a window; a
// float4 outside every window is stored as it was loaded. Inside a
// window the beam directions are computed once for the 4 beams and
// reused for every row, and the clip takes one division a beam at the
// end. Stores are float4 with the streaming hint.
//
// An earlier version gave each scan one warp, which loaded the rows once
// and broadcast them with __shfl_sync. It kept a scan's whole 4,320 B in
// registers (107 a thread) and ran each window's hit tests on the dozen
// lanes whose beams lay in it, one after the other: both cost more than
// the L1 reads of the rows that this layout repeats.
//
// Scans whose beam count is not a multiple of 4, or that are not 16-byte
// aligned, take the same path with scalar loads and stores. Any number of
// rows a scan: each thread reads every row's window, so the time grows
// with the opponents.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float& at(float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads)
overlay_kernel(const float* __restrict__ scans,
               const float* __restrict__ rows,
               const float* __restrict__ scal,
               const float* __restrict__ fan, float* __restrict__ out,
               int n_scans, int num_beams, int n_rows, int vec4) {
  const int nq = (num_beams + 3) >> 2;  // float4 a scan
  const long long item = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (item >= (long long)n_scans * nq) return;
  const int scan = static_cast<int>(item / nq);
  const int q = 4 * static_cast<int>(item - (long long)scan * nq);
  const float* src = scans + (size_t)scan * num_beams;
  float* dst = out + (size_t)scan * num_beams;

  // the scan first
  float4 v;
  if (vec4) {
    v = __ldcs(reinterpret_cast<const float4*>(src + q));
  } else {
    v.x = src[q];
    v.y = q + 1 < num_beams ? src[q + 1] : 0.0f;
    v.z = q + 2 < num_beams ? src[q + 2] : 0.0f;
    v.w = q + 3 < num_beams ? src[q + 3] : 0.0f;
  }

  const float4* rsrc =
      reinterpret_cast<const float4*>(rows + (size_t)scan * n_rows * 8);
  const float fq = static_cast<float>(q);
  float ox = 0.0f, oy = 0.0f;
  float dx[4], dy[4], smax[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  bool dirs = false;
  for (int r = 0; r < n_rows; ++r) {
    const float4 b = rsrc[2 * r + 1];  // ty, w, lo, hi
    if (fq + 3.0f < b.z || fq > b.w) continue;  // no beam here in the window
    if (!dirs) {
      ox = scal[scan * 4 + 0];
      oy = scal[scan * 4 + 1];
      const float ca = scal[scan * 4 + 2];
      const float sa = scal[scan * 4 + 3];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int beam = min(q + k, num_beams - 1);
        const float cnb = fan[beam];
        const float snb = fan[num_beams + beam];
        dx[k] = ca * cnb - sa * snb;
        dy[k] = sa * cnb + ca * snb;
      }
      dirs = true;
    }
    const float4 a = rsrc[2 * r];      // nx, ny, c, tx
    float num = a.z - ox * a.x - oy * a.y;
    // |num| < 1e-12 m: the scan origin sits on the edge's line
    num = fabsf(num) < 1e-12f ? 1e-12f : num;
    const float inv = 1.0f / num;
    const float uo = ox * a.w + oy * b.x + b.y;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float fb = static_cast<float>(q + k);
      if (q + k >= num_beams || !(fb >= b.z && fb <= b.w)) continue;
      const float den = a.x * dx[k] + a.y * dy[k];
      const float s = den * inv;
      const float hb = uo * s + a.w * dx[k] + b.x * dy[k];
      if (hb >= 0.0f && s - hb >= 0.0f) smax[k] = fmaxf(smax[k], s);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (smax[k] > 0.0f) {
      const float clip = 1.0f / fmaxf(smax[k], 1e-9f);
      at(v, k) = clip < at(v, k) ? clip : at(v, k);
    }
  }

  if (vec4) {
    __stcs(reinterpret_cast<float4*>(dst + q), v);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (q + k < num_beams) dst[q + k] = at(v, k);
    }
  }
}

}  // namespace

// Plain C entry, bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = launched). `vec4`: the beam count is a multiple
// of 4 and `scans` and `out` are 16-byte aligned, so float4 loads and
// stores are allowed.
extern "C" int overlay_clip(const float* scans, const float* rows,
                            const float* scal, const float* fan, float* out,
                            int n_scans, int num_beams, int n_rows, int vec4,
                            void* stream) {
  const long long items = (long long)n_scans * ((num_beams + 3) >> 2);
  const long long grid = (items + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  overlay_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      scans, rows, scal, fan, out, n_scans, num_beams, n_rows, vec4);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks an SM holds of the launch overlay_clip makes, and its
// grid size in blocks (`grid_blocks`); -1 on error.
extern "C" int overlay_clip_occupancy(int n_scans, int num_beams,
                                      int* grid_blocks) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, overlay_kernel, kThreads, 0) != cudaSuccess) {
    return -1;
  }
  const long long items = (long long)n_scans * ((num_beams + 3) >> 2);
  *grid_blocks = static_cast<int>((items + kThreads - 1) / kThreads);
  return per_sm;
}
