"""Random closed-loop track generation.

Port of ``f1tenth_gym_tpu/tracks/trackgen.py`` (the reference's
CarRacing-derived generator, unittest/random_trackgen.py:56-223): random
checkpoints, a Fourier-smoothed closed centerline, the corridor between
its +-width/2 offsets rasterized free, and a map png/yaml plus a raceline
csv in the reference's ``s_m; x_m; y_m; psi_rad; kappa_radpm; vx_mps;
ax_mps2`` schema with a curvature-limited speed profile.

The geometry is the JAX package's numpy code, copied; the corridor is
filled with ``tracks/raster.py::fill_poly`` (``cv2.fillPoly`` pixel for
pixel) and the files are written with ``utils/image_io.py``'s writers
(Pillow's and PyYAML's output), so the port needs neither cv2, Pillow nor
PyYAML. ``random_track_map_data`` builds a MapData in memory.

    python -m f1tenth_gym_tpu_torch.tracks.trackgen --seed 0 --n-maps 3 --out-dir maps
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from f1tenth_gym_tpu_torch.tracks.raster import fill_poly
from f1tenth_gym_tpu_torch.utils.image_io import write_map_yaml, write_png


def _fourier_smooth_closed(points: np.ndarray, keep: int, n_out: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Low-pass a closed 2D polygon: keep `keep` harmonics, resample n_out.

    Returns (curve (n_out, 2), curvature (n_out,)) with curvature computed
    analytically from the truncated Fourier series (kappa =
    Im(conj(z') z'') / |z'|^3), so no finite-difference noise.
    """
    z = points[:, 0] + 1j * points[:, 1]
    Z = np.fft.fft(z) / len(z)
    n = len(z)
    k = min(keep, n // 2 - 1)
    # harmonics m in [-k, k]; coefficient of e^{i m t}
    ms = np.concatenate([np.arange(0, k + 1), np.arange(-k, 0)])
    coefs = np.concatenate([Z[: k + 1], Z[-k:]])
    t = np.linspace(0.0, 2 * np.pi, n_out, endpoint=False)
    basis = np.exp(1j * np.outer(t, ms))  # (n_out, 2k+1)
    z_out = basis @ coefs
    dz = basis @ (1j * ms * coefs)
    ddz = basis @ (-(ms ** 2) * coefs)
    speed = np.abs(dz)
    kappa = np.imag(np.conj(dz) * ddz) / np.maximum(speed ** 3, 1e-9)
    curve = np.stack([z_out.real, z_out.imag], axis=1)
    return curve, kappa


def _curvature(center: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Heading, curvature, and arc length of a closed polyline."""
    d = np.roll(center, -1, axis=0) - center
    seg = np.linalg.norm(d, axis=1)
    psi = np.arctan2(d[:, 1], d[:, 0])
    dpsi = np.diff(np.unwrap(np.concatenate([psi, psi[:1]])))
    kappa = dpsi / np.maximum(seg, 1e-9)
    s = np.concatenate([[0.0], np.cumsum(seg)[:-1]])
    return psi, kappa, s


def generate_centerline(
    rng: np.random.Generator,
    n_checkpoints: int = 16,
    mean_radius: float = 12.0,
    radius_jitter: float = 0.45,
    track_width: float = 3.2,
    n_points: int = 600,
    max_tries: int = 50,
) -> np.ndarray:
    """Random smooth closed centerline whose inner offset stays simple."""
    for _ in range(max_tries):
        # uniformly spaced angles with jitter keep the FFT parameterization
        # well-behaved (sorted-random angles cluster and create cusps)
        base = np.linspace(0, 2 * np.pi, n_checkpoints, endpoint=False)
        ang = base + rng.uniform(-0.3, 0.3, n_checkpoints) * (
            2 * np.pi / n_checkpoints
        )
        rad = mean_radius * (1.0 + radius_jitter * rng.uniform(-1, 1, n_checkpoints))
        pts = np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=1)
        center, kappa = _fourier_smooth_closed(pts, keep=5, n_out=n_points)
        # inner wall self-intersects when |kappa| >= 2/track_width
        if np.max(np.abs(kappa)) < 1.6 / track_width:
            return center
    raise RuntimeError("could not generate a valid track; relax parameters")


def speed_profile(kappa: np.ndarray, v_max: float = 8.0, a_lat: float = 6.0,
                  v_min: float = 1.5) -> np.ndarray:
    """Curvature-limited speed: v = sqrt(a_lat / |kappa|), clamped."""
    v = np.sqrt(a_lat / np.maximum(np.abs(kappa), 1e-6))
    return np.clip(v, v_min, v_max)


def rasterize_track(
    center: np.ndarray,
    track_width: float,
    resolution: float = 0.0625,
    margin: float = 2.0,
    wall_px: int = 2,  # kept for API compat; solid walls ignore it
) -> Tuple[np.ndarray, float, Tuple[float, float, float]]:
    """Rasterize the track corridor -> (bitmap, resolution, origin).

    Only the corridor (between the inner and outer wall polylines) is free
    (255); everything else, outside the outer wall and the inner island,
    is solid wall (0), so the contour tracer emits one boundary per wall
    face the LiDAR can see. Row 0 is the world's bottom edge.
    """
    d = np.roll(center, -1, axis=0) - center
    normals = np.stack([-d[:, 1], d[:, 0]], axis=1)
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-9)
    inner = center - normals * (track_width / 2.0)
    outer = center + normals * (track_width / 2.0)

    lo = np.minimum(inner.min(0), outer.min(0)) - margin
    hi = np.maximum(inner.max(0), outer.max(0)) + margin
    size_px = np.ceil((hi - lo) / resolution).astype(int)
    w_px, h_px = int(size_px[0]), int(size_px[1])

    # all wall; carve the corridor free, re-fill the inner island
    canvas = np.zeros((h_px, w_px), dtype=np.uint8)

    def to_px(poly):
        return np.round((poly - lo) / resolution).astype(np.int32)

    def signed_area(poly):
        x, y = poly[:, 0], poly[:, 1]
        return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))

    # the centerline's winding decides which offset ring is the bigger
    # polygon: fill the bigger one free, then re-fill the island solid
    big, small = ((outer, inner)
                  if abs(signed_area(outer)) >= abs(signed_area(inner))
                  else (inner, outer))
    fill_poly(canvas, to_px(big), 255)
    fill_poly(canvas, to_px(small), 0)
    origin = (float(lo[0]), float(lo[1]), 0.0)
    return canvas.astype(np.float64), resolution, origin


def random_track_map_data(seed: int = 0, dtype=torch.float32, device=None,
                          **kwargs):
    """Fully in-memory random track -> (MapData on ``device``, waypoints
    (N, 3) [x, y, v]). ``kwargs`` go to ``generate_centerline``
    (``track_width`` also to the raster)."""
    from f1tenth_gym_tpu_torch.utils.map_loader import make_map_data

    rng = np.random.default_rng(seed)
    width = kwargs.pop("track_width", 3.2)
    center = generate_centerline(rng, track_width=width, **kwargs)
    bitmap, res, origin = rasterize_track(center, width)
    _, kappa, _ = _curvature(center)
    v = speed_profile(kappa)
    wpts = np.concatenate([center, v[:, None]], axis=1)
    md = make_map_data(bitmap, res, origin, dtype=dtype, device=device)
    return md, wpts


def save_track(
    out_dir: str,
    name: str,
    center: np.ndarray,
    track_width: float,
    resolution: float = 0.0625,
):
    """Emit <name>.png / <name>.yaml / <name>_centerline.csv (reference
    convert_track analogue, unittest/random_trackgen.py:175-223). Returns
    the csv's path."""
    bitmap, res, origin = rasterize_track(center, track_width, resolution)
    os.makedirs(out_dir, exist_ok=True)
    # the loader flips top-bottom on read, so store flipped
    write_png(os.path.join(out_dir, f"{name}.png"),
              np.flipud(bitmap).astype(np.uint8))
    write_map_yaml(os.path.join(out_dir, f"{name}.yaml"), {
        "image": f"{name}.png",
        "resolution": res,
        "origin": list(origin),
        "negate": 0,
        "occupied_thresh": 0.45,
        "free_thresh": 0.196,
    })
    psi, kappa, s = _curvature(center)
    v = speed_profile(kappa)
    ax = np.gradient(v ** 2) / 2.0  # d(v^2/2)/ds
    csv_path = os.path.join(out_dir, f"{name}_centerline.csv")
    with open(csv_path, "w") as f:
        f.write("# generated by f1tenth_gym_tpu.tracks.trackgen\n# \n")
        f.write("# s_m; x_m; y_m; psi_rad; kappa_radpm; vx_mps; ax_mps2\n")
        for i in range(center.shape[0]):
            f.write(
                f"{s[i]:.7f}; {center[i,0]:.7f}; {center[i,1]:.7f}; "
                f"{psi[i]:.7f}; {kappa[i]:.7f}; {v[i]:.7f}; {ax[i]:.7f}\n"
            )
    return csv_path


def main(argv=None):
    """CLI: python -m f1tenth_gym_tpu_torch.tracks.trackgen --seed 0 --n-maps 3 --out-dir maps"""
    import argparse

    p = argparse.ArgumentParser(description="random track generator")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--n-maps", type=int, default=1)
    p.add_argument("--out-dir", type=str, default="generated_maps")
    p.add_argument("--track-width", type=float, default=3.2)
    args = p.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    for i in range(args.n_maps):
        center = generate_centerline(rng, track_width=args.track_width)
        save_track(args.out_dir, f"map{i}", center, args.track_width)
        print(f"wrote {args.out_dir}/map{i}.(png|yaml|_centerline.csv)")


if __name__ == "__main__":
    main()
