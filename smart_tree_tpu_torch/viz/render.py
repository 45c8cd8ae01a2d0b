"""Offscreen rendering (counterpart of `smart_tree_tpu/viz/render.py`): a small
software point-splat renderer (orthographic look-at, far-to-near splats via
numpy), good enough for training captures and quick visual checks. PIL is
imported only where a PNG is written."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """3x4 world->camera matrix."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    f = target - eye
    f = f / np.linalg.norm(f)
    r = np.cross(f, np.asarray(up, np.float64))
    r = r / (np.linalg.norm(r) + 1e-12)
    u = np.cross(r, f)
    rot = np.stack([r, u, f])
    return np.concatenate([rot, (-rot @ eye)[:, None]], axis=1)


class Renderer:
    """Persistent renderer with a `capture` API."""

    def __init__(self, width: int = 960, height: int = 540):
        self.width = width
        self.height = height

    def capture(
        self,
        xyz: np.ndarray,
        rgb: np.ndarray | None = None,
        eye=None,
        target=None,
        point_size: int = 1,
    ) -> np.ndarray:
        """Render points to an RGB uint8 array [H,W,3]."""
        xyz = np.asarray(xyz, np.float64)
        finite = np.isfinite(xyz).all(axis=1)
        if not finite.all():
            xyz = xyz[finite]
            if rgb is not None:
                rgb = np.asarray(rgb)[finite]
        if len(xyz) == 0:
            return np.full((self.height, self.width, 3), 255, np.uint8)
        if rgb is None:
            rgb = np.full_like(xyz, 0.7)
        rgb8 = np.clip(np.asarray(rgb) * 255, 0, 255).astype(np.uint8)
        centre = xyz.mean(axis=0) if target is None else np.asarray(target)
        extent = float(np.max(xyz.max(0) - xyz.min(0))) + 1e-6
        if eye is None:
            eye = centre + np.asarray([0.0, 0.35 * extent, 1.6 * extent])
        m = look_at(eye, centre)
        cam = xyz @ m[:, :3].T + m[:, 3]
        # orthographic fit
        scale = 0.9 * min(self.width, self.height) / extent
        px = (cam[:, 0] * scale + self.width / 2).astype(int)
        py = (self.height / 2 - cam[:, 1] * scale).astype(int)
        z = cam[:, 2]
        ok = (px >= 0) & (px < self.width) & (py >= 0) & (py < self.height)
        img = np.full((self.height, self.width, 3), 255, np.uint8)
        zbuf = np.full((self.height, self.width), np.inf)
        order = np.argsort(-z[ok])  # far first; near overwrites
        pxo, pyo, co = px[ok][order], py[ok][order], rgb8[ok][order]
        for dy in range(-point_size + 1, point_size):
            for dx in range(-point_size + 1, point_size):
                qx = np.clip(pxo + dx, 0, self.width - 1)
                qy = np.clip(pyo + dy, 0, self.height - 1)
                img[qy, qx] = co
        return img

    def capture_to_file(self, path: Path, xyz, rgb=None, **kw) -> None:
        from PIL import Image

        Image.fromarray(self.capture(xyz, rgb, **kw)).save(path)


def render_labelled_cloud(cloud, cmap, renderer: Renderer | None = None):
    """rgb view, segmentation view and medial-point view of a labelled
    cloud. Returns a list of uint8 images."""
    r = renderer or Renderer()
    xyz = np.asarray(cloud.xyz)
    images = [r.capture(xyz, np.asarray(cloud.rgb) if cloud.rgb is not None else None)]
    if cloud.class_l is not None:
        seg = np.asarray(cmap)[np.asarray(cloud.class_l).reshape(-1).astype(int)]
        images.append(r.capture(xyz, seg))
    if cloud.medial_vector is not None:
        images.append(r.capture(np.asarray(cloud.medial_pts), None))
    return images
