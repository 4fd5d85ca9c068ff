"""Decoupled host-side visualization (pygame).

Port of ``f1tenth_gym_tpu/render/renderer.py``, the counterpart of the
reference's pyglet/OpenGL EnvRenderer (rendering.py:50-336): rendering
never touches the device loop, it draws host snapshots (``render_obs``).
Map raster background, per-car rectangles, ego highlight, camera follow
and zoom/pan (mouse wheel / drag), lap-time overlay, FPS display, user
render callbacks, and an ``rgb_array`` mode for headless frames. pygame is
imported when a renderer is built, never when this module is imported;
the map is read with the port's own readers.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


class EnvRenderer:
    """Pygame window (or offscreen surface) drawing the race state."""

    def __init__(
        self,
        width: int = 1000,
        height: int = 800,
        headless: bool = False,
        car_length: float = 0.58,
        car_width: float = 0.31,
    ):
        if headless:
            os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
        import pygame

        self.pygame = pygame
        pygame.init()
        self.width = width
        self.height = height
        if headless:
            self.screen = pygame.Surface((width, height))
        else:
            self.screen = pygame.display.set_mode((width, height))
            pygame.display.set_caption("f1tenth_gym_tpu_torch")
        self.headless = headless
        self.font = pygame.font.Font(None, 24)
        self.clock = pygame.time.Clock()

        self.car_length = car_length
        self.car_width = car_width

        # camera: meters-per-pixel scale + world center
        self.scale = 0.05
        self.center = np.array([0.0, 0.0])
        self.follow_ego = True
        self._drag = None

        self.map_surface: Optional["pygame.Surface"] = None
        self.map_origin = (0.0, 0.0)
        self.map_resolution = 1.0
        self.obs = None
        self.batch_poses = None  # optional (E, A, 3) ghost poses
        self.extra_points = []   # user callbacks can append (N,2) arrays + color

    # ------------------------------------------------------------- map
    def update_map(self, map_path: str, map_ext: str):
        from f1tenth_gym_tpu_torch.utils.map_loader import (
            load_map_image,
            load_map_yaml,
        )

        if not map_path.endswith(".yaml"):
            map_path = map_path + ".yaml"
        resolution, origin, _ = load_map_yaml(map_path)
        bitmap = load_map_image(os.path.splitext(map_path)[0] + map_ext)
        self.set_map_bitmap(bitmap, resolution, origin)

    def set_map_bitmap(self, bitmap: np.ndarray, resolution: float, origin):
        """bitmap: (H, W), 0 = obstacle, >0 = free, row 0 = world bottom."""
        pygame = self.pygame
        h, w = bitmap.shape
        rgb = np.zeros((w, h, 3), dtype=np.uint8)
        free = (bitmap.T > 0)
        rgb[free] = (235, 235, 235)
        rgb[~free] = (40, 40, 40)
        self.map_surface = pygame.surfarray.make_surface(rgb)
        self.map_origin = (origin[0], origin[1])
        self.map_resolution = resolution

    # ------------------------------------------------------------- camera
    def world_to_screen(self, xy: np.ndarray) -> np.ndarray:
        rel = (np.asarray(xy) - self.center) / self.scale
        sx = rel[..., 0] + self.width / 2.0
        sy = self.height / 2.0 - rel[..., 1]
        return np.stack([sx, sy], axis=-1)

    def handle_events(self):
        if self.headless:
            return
        pygame = self.pygame
        for ev in pygame.event.get():
            if ev.type == pygame.QUIT:
                raise KeyboardInterrupt("renderer window closed")
            elif ev.type == pygame.MOUSEWHEEL:
                self.scale *= 0.9 if ev.y > 0 else 1.1
            elif ev.type == pygame.MOUSEBUTTONDOWN and ev.button == 1:
                self._drag = np.array(ev.pos)
                self.follow_ego = False
            elif ev.type == pygame.MOUSEBUTTONUP and ev.button == 1:
                self._drag = None
            elif ev.type == pygame.MOUSEMOTION and self._drag is not None:
                delta = np.array(ev.pos) - self._drag
                self.center -= np.array([delta[0], -delta[1]]) * self.scale
                self._drag = np.array(ev.pos)
            elif ev.type == pygame.KEYDOWN and ev.key == pygame.K_f:
                self.follow_ego = True

    # ------------------------------------------------------------- state
    def update_obs(self, render_obs):
        self.obs = render_obs
        if self.follow_ego and render_obs is not None:
            ego = render_obs.get("ego_idx", 0)
            self.center = np.array(
                [render_obs["poses_x"][ego], render_obs["poses_y"][ego]]
            )

    def update_batch(self, poses_exa3: np.ndarray, max_envs: int = 128):
        """Optionally draw a cloud of batched-env cars (ghosts)."""
        self.batch_poses = np.asarray(poses_exa3)[:max_envs]

    # ------------------------------------------------------------- draw
    def _draw_map(self):
        if self.map_surface is None:
            return
        pygame = self.pygame
        w_px = self.map_surface.get_width()
        h_px = self.map_surface.get_height()
        # world rect of the map
        x0, y0 = self.map_origin
        scale_px = self.map_resolution / self.scale
        top_left = self.world_to_screen(
            np.array([x0, y0 + h_px * self.map_resolution])
        )
        size = (int(w_px * scale_px), int(h_px * scale_px))
        if size[0] <= 0 or size[1] <= 0:
            return
        scaled = pygame.transform.scale(self.map_surface, size)
        scaled = pygame.transform.flip(scaled, False, True)
        self.screen.blit(scaled, top_left)

    def _draw_car(self, x, y, theta, color):
        pygame = self.pygame
        L, W = self.car_length, self.car_width
        c, s = np.cos(theta), np.sin(theta)
        corners = np.array(
            [[-L / 2, W / 2], [-L / 2, -W / 2], [L / 2, -W / 2], [L / 2, W / 2]]
        )
        world = np.stack(
            [x + corners[:, 0] * c - corners[:, 1] * s,
             y + corners[:, 0] * s + corners[:, 1] * c],
            axis=-1,
        )
        pts = self.world_to_screen(world)
        pygame.draw.polygon(self.screen, color, pts.tolist())
        # heading tick
        tip = self.world_to_screen(np.array([x + L * 0.6 * c, y + L * 0.6 * s]))
        base = self.world_to_screen(np.array([x, y]))
        pygame.draw.line(self.screen, color, base.tolist(), tip.tolist(), 2)

    def draw_points(self, points_xy: np.ndarray, color=(183, 193, 222), size=2):
        """For user render callbacks (e.g. waypoint overlays)."""
        pts = self.world_to_screen(np.asarray(points_xy))
        for p in pts:
            self.pygame.draw.circle(self.screen, color, p.tolist(), size)

    def draw(self, return_array: bool = False):
        pygame = self.pygame
        self.handle_events()
        self.screen.fill((70, 70, 70))
        self._draw_map()

        if self.batch_poses is not None:
            for env_poses in self.batch_poses:
                for a in range(env_poses.shape[0]):
                    self._draw_car(*env_poses[a], color=(120, 160, 200))

        if self.obs is not None:
            ego = self.obs.get("ego_idx", 0)
            n = len(self.obs["poses_x"])
            for i in range(n):
                color = (200, 40, 40) if i == ego else (40, 80, 200)
                self._draw_car(
                    self.obs["poses_x"][i], self.obs["poses_y"][i],
                    self.obs["poses_theta"][i], color,
                )
            lap_text = (
                f"t={float(np.max(self.obs['lap_times'])):.2f}s  "
                f"laps={np.asarray(self.obs['lap_counts']).astype(int).tolist()}  "
                f"fps={self.clock.get_fps():.0f}"
            )
            self.screen.blit(
                self.font.render(lap_text, True, (255, 255, 255)), (10, 10)
            )

        if not self.headless:
            pygame.display.flip()
        self.clock.tick()
        if return_array:
            return np.transpose(
                pygame.surfarray.array3d(self.screen), (1, 0, 2)
            )
        return None

    def close(self):
        self.pygame.quit()
