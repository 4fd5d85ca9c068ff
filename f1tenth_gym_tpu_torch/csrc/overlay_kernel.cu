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
// Bound on the H100: bytes. The kernel reads every scan once and writes it
// once (2 x 4 B a beam) plus 128 B of rows a scan for one opponent; the hit
// test runs only for the few beams inside an opponent's window (an
// opponent subtends tens of beams of 1080). At the probe's shape, 8192
// scans x 1080 beams, that is ~72 MB, ~0.0215 ms at 3.35 TB/s.
//
// Design, simple first: one block per (scan, 128-beam tile), one thread per
// beam. The block's threads load the scan's rows into shared memory and
// compute each row's 1/num and uo once; then every thread reads its scan
// value (coalesced), tests its beam against each row's window, runs the
// hit test only inside it, and writes its value.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // beams per block
constexpr int kRowFloats = 8;

__global__ void __launch_bounds__(kThreads)
overlay_kernel(const float* __restrict__ scans,
               const float* __restrict__ rows,
               const float* __restrict__ scal,
               const float* __restrict__ fan, float* __restrict__ out,
               int num_beams, int n_rows) {
  // per row: (nx, ny, tx, ty) and (1/num, uo, lo, hi)
  extern __shared__ float4 sh[];
  const int scan = blockIdx.x;
  const float ox = scal[scan * 4 + 0];
  const float oy = scal[scan * 4 + 1];
  const float ca = scal[scan * 4 + 2];
  const float sa = scal[scan * 4 + 3];

  const float4* src =
      reinterpret_cast<const float4*>(rows + (size_t)scan * n_rows * kRowFloats);
  for (int r = threadIdx.x; r < n_rows; r += kThreads) {
    const float4 a = src[2 * r];      // nx, ny, c, tx
    const float4 b = src[2 * r + 1];  // ty, w, lo, hi
    float num = a.z - ox * a.x - oy * a.y;
    // |num| < 1e-12 m: the scan origin sits on the edge's line
    num = fabsf(num) < 1e-12f ? 1e-12f : num;
    const float inv = 1.0f / num;
    const float uo = ox * a.w + oy * b.x + b.y;
    sh[2 * r] = make_float4(a.x, a.y, a.w, b.x);
    sh[2 * r + 1] = make_float4(inv, uo, b.z, b.w);
  }
  __syncthreads();

  const int beam = blockIdx.y * kThreads + threadIdx.x;
  if (beam >= num_beams) return;
  const size_t at = (size_t)scan * num_beams + beam;
  const float cur = scans[at];
  const float fb = static_cast<float>(beam);
  const float cnb = fan[beam];
  const float snb = fan[num_beams + beam];
  const float dx = ca * cnb - sa * snb;
  const float dy = sa * cnb + ca * snb;

  float smax = 0.0f;
  for (int r = 0; r < n_rows; ++r) {
    const float4 g = sh[2 * r + 1];
    if (fb >= g.z && fb <= g.w) {
      const float4 e = sh[2 * r];
      const float den = e.x * dx + e.y * dy;
      const float s = den * g.x;
      const float b = g.y * s + e.z * dx + e.w * dy;
      if (b >= 0.0f && s - b >= 0.0f) smax = fmaxf(smax, s);
    }
  }
  float v = cur;
  if (smax > 0.0f) {
    const float clip = 1.0f / fmaxf(smax, 1e-9f);
    v = clip < cur ? clip : cur;
  }
  out[at] = v;
}

}  // namespace

// Plain C entry, bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int overlay_clip(const float* scans, const float* rows,
                            const float* scal, const float* fan, float* out,
                            int n_scans, int num_beams, int n_rows,
                            void* stream) {
  const dim3 grid(n_scans, (num_beams + kThreads - 1) / kThreads);
  const size_t smem = (size_t)n_rows * 2 * sizeof(float4);
  overlay_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      scans, rows, scal, fan, out, num_beams, n_rows);
  return static_cast<int>(cudaGetLastError());
}
