"""The forward-raster experiments' scene: 100,000 random Gaussians at
SH degree 3 seen at 1920x1080, binned by rect, packed into rows. Port of
`scripts/exp_fwd.py::build_inputs`, with the same draws from
`np.random.default_rng(seed)` in the same order.

`build_scene` returns the packed rows and row maps (`ops/rows.py`), the
tile schedule, and Kernel A's arguments for the same bins
(`render/tiled.py::kernel_args`), so each variant can be held to Kernel A.
`width`, `height` and `n` let the tests run it small.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sgs_tpu_torch.core.camera import Camera
from sgs_tpu_torch.core.projection import TILE, focal2fov, fov2focal
from sgs_tpu_torch.models.gaussians import GaussianModel
from sgs_tpu_torch.ops import rows
from sgs_tpu_torch.render.pipeline import project_and_shade
from sgs_tpu_torch.render.tiled import bin_gaussians, kernel_args

N_GAUSSIANS = 100_000
WIDTH, HEIGHT = 1920, 1080
SH_DEGREE = 3
# the packing is rounded to whole steps of the largest krows the
# variants take, so every variant reads the same rows
KROWS_MAX = 32


def scene_model(n: int, seed: int, device) -> GaussianModel:
    """The script's pool: points N(0, 0.6^2), colours U(0, 1), isotropic
    scales from a fixed neighbour distance, then random log-scales in
    [-5.2, -3.6] and opacity logits in [-1, 4]."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * 0.6).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    model = GaussianModel.from_pcd(pts, cols, SH_DEGREE, capacity=n,
                                   knn_dist2=np.full((n,), 1e-4, np.float32), device=device)
    log_s = rng.uniform(-5.2, -3.6, (n, 3)).astype(np.float32)
    opac_logit = rng.uniform(-1.0, 4.0, (n, 1)).astype(np.float32)
    model.scaling[:] = torch.as_tensor(log_s, device=model.device)
    model.opacity[:] = torch.as_tensor(opac_logit, device=model.device)
    return model


def scene_camera(width: int, height: int, device) -> Camera:
    """Identity rotation, camera at z = 4.5, 60 degrees of horizontal FoV."""
    fovx = math.radians(60)
    fovy = focal2fov(fov2focal(fovx, width), height)
    return Camera.from_Rt(np.eye(3), np.array([0.0, 0.0, 4.5]), fovx, fovy, width, height,
                          device=device)


def build_scene(width: int = WIDTH, height: int = HEIGHT, n: int = N_GAUSSIANS, seed: int = 0,
                device="cuda") -> dict:
    """Project, shade, bin by rect and pack. Returns a dict with `proj`
    (mean2d, depth, conic, radius, rgb, opacity, valid), `bins`, `attr`
    (the (M+1, REC) records), the packing of `rows.pack_rows`, `packed_fm`
    (the same rows field-major), `schedule`, `num_tiles`, `tiles_x`,
    `tiles_y`, `kernel_a` (Kernel A's arguments) and the sizes."""
    model = scene_model(n, seed, device)
    cam = scene_camera(width, height, model.device)
    p = project_and_shade(cam, model.render_inputs(SH_DEGREE))
    out = pack(p, width, height)
    out.update(proj=p, width=width, height=height,
               kernel_a=kernel_args(out["bins"], p["mean2d"], p["conic"], p["opacity"], p["rgb"],
                                    width, height))
    return out


def pack(p: dict, width: int, height: int) -> dict:
    """Bin projected Gaussians (mean2d, conic, opacity, depth, radius,
    valid, rgb) by rect and pack them into rows: `rows.pack_rows`' dict
    with `bins`, `attr`, `packed_fm`, `schedule`, `num_tiles`, `tiles_x`,
    `tiles_y`, `instances` and `n_gaussians`."""
    bins = bin_gaussians(p["mean2d"], p["conic"], p["opacity"], p["depth"], p["radius"],
                         p["valid"], width, height, tight=False)
    attr = rows.attr_records(p["mean2d"], p["conic"], p["rgb"], p["opacity"], bins["point_list"])
    out = rows.pack_rows(attr, bins["tile_start"], bins["tile_end"], KROWS_MAX)
    out.update(bins=bins, attr=attr, packed_fm=rows.field_major(out["packed"]),
               schedule=bins["schedule"], num_tiles=bins["tile_start"].shape[0],
               tiles_x=bins["tiles_x"], tiles_y=bins["tiles_y"],
               instances=int(bins["point_list"].shape[0]), n_gaussians=p["mean2d"].shape[0])
    return out


def tensor_digest(*xs) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes: two
    runs that print the same digest held the same values."""
    import hashlib

    h = hashlib.sha256()
    for x in xs:
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def digest(sc: dict) -> str:
    """The scene's packed rows, tile rows and schedule as one digest."""
    return tensor_digest(sc["packed"], sc["chunk_row_start"], sc["n_chunks"], sc["schedule"])


# Tiles of `edge_scene` by kind and rows: the ring's edges (tiles of 1 row
# back to back, 33 and 40 rows, more than the 32 rows of the deepest ring),
# an empty tile, a tile whose pixels all saturate in the middle of its first
# row ("wall"), and a tile whose top half saturates in its first row while
# the bottom half walks on ("half": its warps 0-3 hold no live pixel in the
# rows after). The other tiles take 1 or 2 rows of random Gaussians.
EDGE_TILES = [("random", 1), ("random", 0), ("faint", 40), ("random", 1), ("wall", 3),
              ("half", 4), ("random", 2), ("faint", 33)]
EDGE_TILES_X, EDGE_TILES_Y = 20, 15


def _edge_tile(rng, kind: str, n_rows: int, x0: float, y0: float):
    """(m, 9) records x, y, conic a, b, c, opacity, r, g, b of one tile of
    `edge_scene`, depth-ordered; a last row is partly filled."""
    m = max(n_rows * rows.CHUNK - int(rng.integers(0, 20)), 0) if n_rows else 0
    if kind == "wall" or kind == "half":
        m = n_rows * rows.CHUNK
    rec = np.zeros((m, 9), np.float32)
    rec[:, 6:9] = rng.uniform(0, 1, (m, 3))
    rec[:, 0] = x0 + rng.uniform(-4, 20, m)
    rec[:, 1] = y0 + rng.uniform(-4, 20, m)
    l1, l2, th = rng.uniform(0.005, 0.5, m), rng.uniform(0.005, 0.5, m), rng.uniform(0, np.pi, m)
    c, s = np.cos(th), np.sin(th)
    rec[:, 2], rec[:, 3], rec[:, 4] = l1 * c * c + l2 * s * s, (l1 - l2) * s * c, l1 * s * s + l2 * c * c
    rec[:, 5] = rng.uniform(0.05, 0.99, m) if kind != "faint" else rng.uniform(0.0005, 0.004, m)
    if kind == "wall":  # flat: alpha 0.95 at every pixel, saturated at the 4th instance
        rec[:, 2:5] = (1e-9, 0.0, 1e-9)
        rec[:, 5] = 0.95
    if kind == "half":  # first row: 8 instances on each of pixel rows 0-7, flat along x
        k = np.arange(rows.CHUNK)
        rec[: rows.CHUNK, 1] = y0 + (k % 8)
        rec[: rows.CHUNK, 2:5] = (1e-9, 0.0, 2.0)
        rec[: rows.CHUNK, 5] = 0.95
    return rec


def edge_scene(device, seed: int = 0) -> dict:
    """A 320x240 view of synthetic tiles (`EDGE_TILES` first, then 1 or 2
    rows of random Gaussians each) packed into rows like `pack`'s, for the
    kernels' edge cases: the keys of `pack` that Kernels E, F and G and
    their plain versions read."""
    rng = np.random.default_rng(seed)
    num_tiles = EDGE_TILES_X * EDGE_TILES_Y
    kinds = EDGE_TILES + [("random", 1 + i % 2) for i in range(num_tiles - len(EDGE_TILES))]
    recs = [_edge_tile(rng, kind, n, (t % EDGE_TILES_X) * TILE, (t // EDGE_TILES_X) * TILE)
            for t, (kind, n) in enumerate(kinds)]
    counts = torch.tensor([len(r) for r in recs], dtype=torch.int32)
    attr = torch.zeros((int(counts.sum()) + 1, rows.REC), dtype=torch.float32)
    attr[:-1, :9] = torch.as_tensor(np.concatenate(recs))
    attr[:, 9] = torch.arange(attr.shape[0], dtype=torch.float32)
    end = torch.cumsum(counts, 0).to(torch.int32)
    out = rows.pack_rows(attr.to(device), (end - counts).to(device), end.to(device), KROWS_MAX)
    nch = out["n_chunks"]
    out.update(packed_fm=rows.field_major(out["packed"]), num_tiles=num_tiles, tiles_x=EDGE_TILES_X,
               tiles_y=EDGE_TILES_Y, n_gaussians=attr.shape[0] - 1,
               schedule=torch.argsort(nch.cpu(), descending=True, stable=True).to(torch.int32).to(device))
    return out


def sizes(sc: dict) -> dict:
    """Instances, rows, slots and the bytes of the packed rows and of the
    per-row state ((rows, 256, 8) f32) of a scene."""
    slots = sc["max_rows"] * rows.CHUNK
    return {"instances": sc["instances"], "rows_used": sc["rows_used"], "max_rows": sc["max_rows"],
            "slots": slots, "packed_bytes": slots * rows.REC * 4,
            "state_bytes": sc["max_rows"] * rows.TILE_PIXELS * 8 * 4}


def kernel_a_tiles(color, t_final, n_contrib, tiles_x: int, tiles_y: int):
    """Kernel A's images -> (T, 3, 256), (T, 256), (T, 256) in the tiles'
    pixel order (pixels past the image edge hold NaN)."""
    def tiles(img):
        c, h, w = img.shape
        full = torch.full((c, tiles_y * TILE, tiles_x * TILE), float("nan"),
                          dtype=torch.float32, device=img.device)
        full[:, :h, :w] = img.to(torch.float32)
        full = full.reshape(c, tiles_y, TILE, tiles_x, TILE).permute(1, 3, 0, 2, 4)
        return full.reshape(tiles_y * tiles_x, c, TILE * TILE)
    return tiles(color), tiles(t_final[None])[:, 0], tiles(n_contrib[None])[:, 0]


def a_reference(sc: dict) -> tuple:
    """Kernel A on the scene's bins, as (T, 3, 256), (T, 256), (T, 256)."""
    from sgs_tpu_torch.ops import flat_raster

    color, t_final, n_contrib = flat_raster.rasterize_tiles(*sc["kernel_a"])
    return kernel_a_tiles(color, t_final, n_contrib, sc["tiles_x"], sc["tiles_y"])


def compare_with_a(sc: dict, ref: tuple, colors, t_final, last_slot, near) -> dict:
    """A variant's per-tile colors (T, 3, 256), t_final and last_contrib
    (1-based padded-slot positions) against Kernel A's (`a_reference`) on
    the non-empty tiles' pixels inside the image. last_contrib becomes a
    position in the tile's list first (minus chunk_row_start * CHUNK where
    it is > 0). Returns the max |err| of each off the pixels `near` the
    cut, the same over all those pixels, and the count of pixels near it."""
    ref_c, ref_t, ref_n = ref
    start = (sc["chunk_row_start"].to(torch.float32) * rows.CHUNK)[:, None]
    last = torch.where(last_slot > 0, last_slot - start, last_slot)
    keep = (sc["n_chunks"] > 0)[:, None] & ~torch.isnan(ref_t)
    errs = {"color": (colors - ref_c).abs().amax(dim=1), "t_final": (t_final - ref_t).abs(),
            "last_contrib": (last - ref_n).abs()}
    out = {"near_cut_pixels": int((keep & near).sum())}
    for k, e in errs.items():
        out[k] = float(e[keep & ~near].max()) if bool((keep & ~near).any()) else 0.0
        out[k + "_all"] = float(e[keep].max()) if bool(keep.any()) else 0.0
    return out


def device_ms(fn, dev, reps: int = 20):
    """Device ms of `fn` on the card (the card asleep while the host
    enqueues; `tools/ssim_times.py::time_ms`); None on the CPU."""
    if dev.type != "cuda":
        return None
    from sgs_tpu_torch.tools.ssim_times import time_ms

    return time_ms(fn, reps)


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:9.4f} ms"


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True,
        ).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "card: none (nvidia-smi not available)"


def describe(sc: dict, seed: int) -> None:
    """Print the scene's size, instances, rows and bytes."""
    sz = sizes(sc)
    print(f"{sc['width']}x{sc['height']}, {sc['n_gaussians']} Gaussians (seed {seed}), "
          f"{sc['num_tiles']} tiles: {sz['instances']} instances, rows_used {sz['rows_used']}, "
          f"max_rows {sz['max_rows']}, packed rows {sz['packed_bytes']} B, "
          f"per-row state {sz['state_bytes']} B", flush=True)


def references(sc: dict) -> tuple:
    """Kernel A's tiles (`a_reference`) and the pixels at a cut
    (`exp_forward.near_cut`) of a scene, which the variants are held to."""
    from sgs_tpu_torch.ops import exp_forward

    near = exp_forward.near_cut(sc["packed_fm"], sc["chunk_row_start"], sc["n_chunks"], sc["tiles_x"])
    return a_reference(sc), near


def cli_scene(description: str, argv) -> tuple:
    """Parse the experiment CLIs' common options, build the kernels the
    card needs and the scene. Returns (device, scene)."""
    import argparse

    from sgs_tpu_torch.core.device import resolve_device
    from sgs_tpu_torch.ops import build, exp_forward, flat_raster

    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--height", type=int, default=HEIGHT)
    ap.add_argument("--n", type=int, default=N_GAUSSIANS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(None if argv is None else [str(a) for a in argv])
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        build.build_all([flat_raster.KERNEL, exp_forward.KERNEL])
    sc = build_scene(args.width, args.height, args.n, args.seed, dev)
    describe(sc, args.seed)
    return dev, sc
