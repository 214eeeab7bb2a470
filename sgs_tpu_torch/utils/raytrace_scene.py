"""Ray-traced procedural dataset with a non-Gaussian ground truth. Port of
`sgs_tpu/utils/raytrace_scene.py`.

A checkerboard ground plane and a 3x3 grid of textured, occluding spheres,
Lambertian shading with a point light and hard shadows, ray-traced in
vectorised numpy on the host (as in the JAX package; no device), written
as a Blender-format dataset (PNGs through `data/png.py`) with a noisy
surface-sample `points3d.ply` (`data/ply.py`). The cameras only carry the
matrices, so they are built on the CPU. numpy's transcendental functions
may differ by an ulp between hosts, which can flip a byte of an image.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from sgs_tpu_torch.data.ply import save_point_cloud_ply
from sgs_tpu_torch.data.png import write_png
from sgs_tpu_torch.utils.toy_scene import camera_from_c2w, circle_pose, to_u8


def _value_noise(u, v, seed=0, octaves=3):
    """Cheap tileable value noise in [0,1] for texture detail."""
    rng = np.random.default_rng(seed)
    out = np.zeros_like(u)
    amp, freq = 1.0, 4.0
    norm = 0.0
    for o in range(octaves):
        gsz = int(freq) + 2
        grid = rng.random((gsz, gsz))
        x = (u % 1.0) * freq
        y = (v % 1.0) * freq
        x0 = np.floor(x).astype(int)
        y0 = np.floor(y).astype(int)
        fx = x - x0
        fy = y - y0
        fx = fx * fx * (3 - 2 * fx)
        fy = fy * fy * (3 - 2 * fy)
        n = (
            grid[x0, y0] * (1 - fx) * (1 - fy)
            + grid[x0 + 1, y0] * fx * (1 - fy)
            + grid[x0, y0 + 1] * (1 - fx) * fy
            + grid[x0 + 1, y0 + 1] * fx * fy
        )
        out += amp * n
        norm += amp
        amp *= 0.5
        freq *= 2.0
    return out / norm


class SphereScene:
    """A fixed scene: ground plane at y=-0.8 (the circle_pose cameras render
    world -y at the image bottom) + a 3x3 grid of spheres resting on it with
    varied radii/colors/texture, lit by a point light with hard shadows."""

    def __init__(self, seed: int = 0):
        rng = np.random.default_rng(seed)
        xs = [-0.85, 0.0, 0.85]
        centers, radii, colors, tex = [], [], [], []
        for i, cx in enumerate(xs):
            for j, cz in enumerate(xs):
                r = 0.22 + 0.16 * rng.random()
                centers.append([cx + rng.normal() * 0.08, -0.8 + r, cz + rng.normal() * 0.08])
                radii.append(r)
                colors.append(rng.uniform(0.15, 0.95, 3))
                tex.append(rng.integers(0, 3))  # 0 plain, 1 stripes, 2 noisy
        self.centers = np.array(centers)
        self.radii = np.array(radii)
        self.colors = np.array(colors)
        self.tex = np.array(tex)
        self.light = np.array([2.5, 3.0, 1.5])  # above the scene
        self.plane_y = -0.8

    def _sphere_hit(self, o, d):
        """Nearest sphere hit: returns (t, idx) with t=inf for misses."""
        oc = o[:, None, :] - self.centers[None, :, :]  # (P, S, 3)
        b = np.einsum("psk,pk->ps", oc, d)
        c = np.einsum("psk,psk->ps", oc, oc) - self.radii[None, :] ** 2
        disc = b * b - c
        hit = disc > 0
        sq = np.sqrt(np.maximum(disc, 0.0))
        t0 = -b - sq
        t = np.where(hit & (t0 > 1e-4), t0, np.inf)
        idx = np.argmin(t, axis=1)
        tmin = t[np.arange(t.shape[0]), idx]
        return tmin, idx

    def _shadow(self, p):
        """1 if the light is visible from p, else 0.25 ambient."""
        to_l = self.light[None, :] - p
        dist = np.linalg.norm(to_l, axis=-1, keepdims=True)
        d = to_l / dist
        t, _ = self._sphere_hit(p, d)
        lit = t > dist[:, 0]
        return np.where(lit, 1.0, 0.25)

    def _sphere_color(self, p, idx):
        rel = (p - self.centers[idx]) / self.radii[idx][:, None]
        base = self.colors[idx].copy()
        phi = np.arctan2(rel[:, 2], rel[:, 0])
        theta = np.arccos(np.clip(rel[:, 1], -1, 1))
        stripes = 0.5 + 0.5 * np.sign(np.sin(phi * 6.0))
        noise = _value_noise(phi / (2 * np.pi) + 0.5, theta / np.pi, seed=7)
        mod = np.ones(len(p))
        is_stripe = self.tex[idx] == 1
        is_noise = self.tex[idx] == 2
        mod = np.where(is_stripe, 0.55 + 0.45 * stripes, mod)
        mod = np.where(is_noise, 0.55 + 0.55 * noise, mod)
        return base * mod[:, None]

    def _plane_color(self, p):
        checker = ((np.floor(p[:, 0] * 2.5) + np.floor(p[:, 2] * 2.5)) % 2).astype(
            np.float64
        )
        noise = _value_noise(p[:, 0] * 0.25 + 0.5, p[:, 2] * 0.25 + 0.5, seed=3)
        col = np.stack(
            [
                0.25 + 0.55 * checker,
                0.30 + 0.40 * checker * (0.6 + 0.4 * noise),
                0.35 + 0.25 * (1 - checker),
            ],
            axis=1,
        )
        return col * (0.75 + 0.25 * noise[:, None])

    def render(self, camera) -> np.ndarray:
        """(3, H, W) float image for a Camera. The pixel directions are
        float32, as the JAX package's (its f32 tanfov promotes them)."""
        H, W = camera.image_height, camera.image_width
        # camera-to-world from the Camera's stored world-to-view (f32)
        w2c = camera.world_view_transform.detach().cpu().numpy().T  # row-major 4x4
        c2w = np.linalg.inv(w2c)
        o = c2w[:3, 3]
        i, j = np.meshgrid(np.arange(W), np.arange(H))
        tanx = np.float32(camera.tanfovx.item())
        tany = np.float32(camera.tanfovy.item())
        x = ((i + 0.5 - W / 2) / (W / 2)).astype(np.float32) * tanx
        y = ((j + 0.5 - H / 2) / (H / 2)).astype(np.float32) * tany
        dirs_cam = np.stack([x, y, np.ones_like(x)], axis=-1).reshape(-1, 3)
        d = dirs_cam @ c2w[:3, :3].T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        origins = np.broadcast_to(o, d.shape).copy()

        # sphere intersections
        t_s, idx = self._sphere_hit(origins, d)
        # plane y = plane_y (only from above, i.e. ray pointing +y)
        denom = d[:, 1]
        t_p = np.where(np.abs(denom) > 1e-6, (self.plane_y - o[1]) / denom, np.inf)
        t_p = np.where(t_p > 1e-4, t_p, np.inf)
        p_plane = origins + t_p[:, None] * d
        in_extent = (np.abs(p_plane[:, 0]) < 3.2) & (np.abs(p_plane[:, 2]) < 3.2)
        t_p = np.where(in_extent, t_p, np.inf)

        sky = np.array([0.62, 0.73, 0.92])
        img = np.broadcast_to(sky, d.shape).copy()

        hit_sphere = t_s < t_p
        hit_plane = (~hit_sphere) & np.isfinite(t_p)

        if hit_sphere.any():
            ps = origins[hit_sphere] + t_s[hit_sphere, None] * d[hit_sphere]
            si = idx[hit_sphere]
            n = (ps - self.centers[si]) / self.radii[si][:, None]
            to_l = self.light[None, :] - ps
            to_l /= np.linalg.norm(to_l, axis=-1, keepdims=True)
            lam = np.clip(np.einsum("pk,pk->p", n, to_l), 0.0, 1.0)
            shade = self._shadow(ps + n * 1e-3)
            col = self._sphere_color(ps, si)
            img[hit_sphere] = col * (0.25 + 0.75 * lam * shade)[:, None]

        if hit_plane.any():
            pp = p_plane[hit_plane]
            n = np.array([0.0, 1.0, 0.0])
            to_l = self.light[None, :] - pp
            to_l /= np.linalg.norm(to_l, axis=-1, keepdims=True)
            lam = np.clip(to_l @ np.array([0, 1.0, 0.0]), 0.0, 1.0)
            shade = self._shadow(pp + n * 1e-3)
            col = self._plane_color(pp)
            img[hit_plane] = col * (0.3 + 0.7 * lam * shade)[:, None]

        return np.clip(img.reshape(H, W, 3).transpose(2, 0, 1), 0.0, 1.0)


def make_raytraced_dataset(
    out_dir: str,
    n_train: int = 48,
    n_test: int = 8,
    width: int = 400,
    height: int = 400,
    seed: int = 0,
    fovx: float = math.radians(55.0),
    n_init_points: int = 5_000,
) -> None:
    """Blender-format dataset + points3d.npy init cloud (surface samples
    with noise, mimicking a sparse SfM cloud)."""
    scene = SphereScene(seed)
    for split, count, offset in (("train", n_train, 0.0), ("test", n_test, 0.131)):
        frames = []
        split_dir = os.path.join(out_dir, split)
        os.makedirs(split_dir, exist_ok=True)
        for i in range(count):
            theta = 2 * math.pi * i / count + offset
            # two interleaved heights for vertical parallax
            h = 0.4 if i % 2 == 0 else 1.3
            c2w = circle_pose(theta, radius=3.4, height=h)
            cam = camera_from_c2w(c2w, fovx, width, height, device="cpu")
            write_png(os.path.join(split_dir, f"r_{i}.png"), to_u8(scene.render(cam)))
            c2w_gl = c2w.copy()
            c2w_gl[:3, 1:3] *= -1
            frames.append(
                {"file_path": f"./{split}/r_{i}", "transform_matrix": c2w_gl.tolist()}
            )
        with open(os.path.join(out_dir, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": fovx, "frames": frames}, f)

    # noisy surface samples as the init cloud (SfM stand-in)
    rng = np.random.default_rng(seed + 17)
    n_sph = n_init_points // 2
    si = rng.integers(0, len(scene.radii), n_sph)
    nrm = rng.normal(size=(n_sph, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    sph_pts = scene.centers[si] + nrm * scene.radii[si][:, None]
    n_pl = n_init_points - n_sph
    pl_pts = np.stack(
        [
            rng.uniform(-3.0, 3.0, n_pl),
            np.full(n_pl, scene.plane_y),
            rng.uniform(-3.0, 3.0, n_pl),
        ],
        axis=1,
    )
    pts = np.concatenate([sph_pts, pl_pts]) + rng.normal(
        size=(n_init_points, 3)
    ) * 0.01
    cols = np.full((n_init_points, 3), 128, np.uint8)
    save_point_cloud_ply(
        os.path.join(out_dir, "points3d.ply"), pts.astype(np.float32), cols
    )
