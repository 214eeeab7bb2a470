"""Port parity of the forward-raster experiments on the CPU: the row
packing (`sgs_tpu_torch/ops/rows.py`), the scene builder
(`tools/exp_scene.py`) and the plain versions of Kernels E, F and G
(`ops/exp_forward.py`) against the JAX package and the scripts' own Pallas
kernels (`scripts/exp_fwd.py`, `exp_fwd2.py`, `exp_transposed.py`).

The scripts predate today's `flat_raster.py`, so three test-side changes
make their kernels run, none of which edits a script or the package:
`pallas_call` is patched to interpret mode (the scripts import `pl`
inside the functions that build the kernels, so the patch reaches them),
`flat_raster.OUT_COLS` (gone from the package) is set to 8, and E's
field-major rows are `pack_rows`' rows transposed per row
(`rows.field_major`). Tolerances: colours and t_final within 3e-5, the
package's image bar (XLA's exp and Pallas's dot differ from PyTorch's in
the last bits); last_contrib equal off the pixels at a cut
(`exp_forward.near_cut`)."""

import functools
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from sgs_tpu.core import sh as jsh
from sgs_tpu.core import transforms as jtr
from sgs_tpu.core.camera import Camera as JaxCamera
from sgs_tpu.core.projection import project_gaussians as jax_project
from sgs_tpu.core.projection import ALPHA_MAX, ALPHA_MIN
from sgs_tpu.models.gaussians import GaussianPool
from sgs_tpu.ops.pallas import flat_raster as fr
from sgs_tpu.render import tiled as jtiled
from sgs_tpu_torch.ops import exp_forward as ef
from sgs_tpu_torch.ops import rows
from sgs_tpu_torch.tools import exp_fwd, exp_fwd2, exp_scene, exp_transposed, scan_ablation

torch.set_num_threads(1)
SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
IMAGE_ATOL = 3e-5


@pytest.fixture(scope="module")
def scripts():
    """The three experiment scripts, importable, with their Pallas kernels
    in interpret mode and the constant they still import."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(SCRIPTS))
        mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        mp.setattr(fr, "OUT_COLS", 8, raising=False)
        import exp_fwd as s_fwd
        import exp_fwd2 as s_fwd2
        import exp_transposed as s_tr
        yield s_fwd, s_fwd2, s_tr
        for name in ("exp_fwd", "exp_fwd2", "exp_transposed"):
            sys.modules.pop(name, None)


@pytest.fixture(scope="module")
def scene():
    """64x48 with 300 Gaussians: 12 tiles, some empty, 14 rows."""
    sc = exp_scene.build_scene(64, 48, 300, seed=0, device="cpu")
    assert int((sc["n_chunks"] == 0).sum()) > 0, "the scene should have an empty tile"
    return sc


def _j(t):
    return jnp.asarray(t.numpy())


def _script_args(sc):
    return (_j(sc["row_tile"]), _j(sc["row_first"]), _j(sc["chunk_row_start"]), _j(sc["n_chunks"]))


def _port_args(sc):
    return (sc["chunk_row_start"], sc["n_chunks"], sc["schedule"], sc["tiles_x"])


def _near(sc):
    return ef.near_cut(sc["packed_fm"], sc["chunk_row_start"], sc["n_chunks"], sc["tiles_x"]).numpy()


@pytest.mark.parametrize("size", [(128, 96, 3000), (200, 120, 6000)])
def test_pack_rows_matches_jax(size):
    """ops/rows.py on the port's rect binning against JAX _build_instances
    + _attr_records + pack_rows on the same projected Gaussians: exactly
    equal over the used rows."""
    w, h, n = size
    sc = exp_scene.build_scene(w, h, n, seed=1, device="cpu")
    assert int((sc["n_chunks"] == 0).sum()) > 0, "the scene should have an empty tile"
    p = sc["proj"]
    m2, dep, con, rad, rgb, op = (_j(p[k]) for k in ("mean2d", "depth", "conic", "radius", "rgb",
                                                      "opacity"))
    valid = rad > 0
    total = int(jtiled.instance_count(m2, rad, valid, w, h))
    assert total == sc["instances"]
    tile_s, gi_s, order, _, nt, _, _ = jtiled._build_instances(m2, dep, rad, valid, w, h, total + 64)
    attr = jtiled._attr_records(m2, con, rgb, op, order, gi_s)
    out = fr.pack_rows(attr, tile_s, int(nt), sc["max_rows"])
    used = sc["rows_used"]
    assert int(out[8]) == used
    names = ["packed", "windows", "row_tile", "row_first", "row_last", "chunk_row_start",
             "n_chunks", "tile_start"]
    for name, want in zip(names, out):
        got = sc[name].numpy()
        want = np.asarray(want)
        if name == "packed":
            got, want = got[: used * rows.CHUNK], want[: used * rows.CHUNK]
        elif name in ("windows", "row_tile", "row_first", "row_last"):
            got, want = got[:used], want[:used]
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_row_maps_past_the_used_rows(scene):
    """Rows past rows_used belong to no tile; each tile's first and last
    rows are flagged once."""
    used, mr, t = scene["rows_used"], scene["max_rows"], scene["num_tiles"]
    assert mr % exp_scene.KROWS_MAX == 0 and mr >= used
    assert (scene["row_tile"][used:] == t).all() and not scene["row_first"][used:].any()
    nonempty = int((scene["n_chunks"] > 0).sum())
    assert int(scene["row_first"].sum()) == nonempty == int(scene["row_last"][:used].sum())
    assert rows.num_rows(1000, 12) == -(-(1000 // 64 + 12) // 8) * 8
    counts = (scene["bins"]["tile_end"] - scene["bins"]["tile_start"]).long()
    tile_sorted = torch.repeat_interleave(torch.arange(t), counts)
    start, end = rows.tile_ranges(tile_sorted, t)
    assert torch.equal(start, scene["bins"]["tile_start"]) and torch.equal(end, scene["bins"]["tile_end"])


def test_scene_matches_jax():
    """exp_scene's projection and shading against the JAX functions that
    `build_inputs` calls, op by op, on the same draws: the bars of
    tests/test_torch_core.py (1e-6, radii equal)."""
    w, h, n, seed = 96, 64, 500, 3
    sc = exp_scene.build_scene(w, h, n, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * 0.6).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    pool = GaussianPool.from_pcd(pts, cols, 3, capacity=n,
                                 knn_dist2=np.full((n,), 1e-4, np.float32))
    log_s = rng.uniform(-5.2, -3.6, (n, 3)).astype(np.float32)
    opac_logit = rng.uniform(-1.0, 4.0, (n, 1)).astype(np.float32)
    pool = pool.replace(scaling=jnp.asarray(log_s), opacity=jnp.asarray(opac_logit))
    fovx = math.radians(60)
    from sgs_tpu.core.projection import focal2fov, fov2focal
    fovy = focal2fov(fov2focal(fovx, w), h)
    cam = JaxCamera.from_Rt(np.eye(3), np.array([0.0, 0.0, 4.5]), fovx, fovy, w, h)
    with jax.disable_jit():
        inp = pool.render_inputs(3)
        cov = jtr.build_covariance(inp.scales, inp.rotations, 1.0)
        proj = jax_project(inp.means3d, cov, cam.world_view_transform, cam.full_proj_transform,
                           cam.tanfovx, cam.tanfovy, w, h)
        dirs = inp.means3d - cam.camera_center[None, :]
        dirs = dirs / jnp.maximum(jnp.linalg.norm(dirs, axis=-1, keepdims=True), 1e-12)
        rgb = jsh.sh_to_rgb_clamped(3, inp.shs, dirs)
    p = sc["proj"]
    np.testing.assert_array_equal(p["radius"].numpy(), np.asarray(proj["radius"]))
    vis = np.asarray(proj["radius"]) > 0
    assert vis.sum() > n // 4
    for key, want in (("mean2d", proj["mean2d"]), ("depth", proj["depth"]),
                      ("conic", proj["conic"]), ("rgb", rgb), ("opacity", inp.opacities[:, 0])):
        np.testing.assert_allclose(p[key].numpy()[vis], np.asarray(want)[vis], atol=1e-6, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("krows,mode", [(8, "hs"), (32, "hs"), (8, "mxu"), (8, "nocp")])
def test_kernel_e_matches_script(scripts, scene, krows, mode):
    """E's plain version against exp_fwd.py::make_variant in interpret
    mode, on field-major rows, over the non-empty tiles."""
    s_fwd = scripts[0]
    want = np.asarray(s_fwd.make_variant(krows, mode)(
        _j(scene["packed_fm"]), *_script_args(scene), num_tiles=scene["num_tiles"],
        tiles_x=scene["tiles_x"]))
    got = ef.exp_forward(scene["packed_fm"], *_port_args(scene), mode, krows).numpy()
    keep = (scene["n_chunks"] > 0).numpy()
    got, want = got[keep], want[keep]
    np.testing.assert_allclose(got[..., 0:5], want[..., 0:5], atol=IMAGE_ATOL, rtol=0)
    off = ~_near(scene)[keep]
    np.testing.assert_array_equal(got[..., 5][off], want[..., 5][off])


@pytest.mark.parametrize("mode", ["hs", "mxu"])
def test_kernel_g_matches_script(scripts, scene, mode):
    """G's plain version against exp_transposed.py::make_transposed in
    interpret mode, on pack_rows' instance-major rows as they are, every
    tile (empty tiles masked by both)."""
    s_tr = scripts[2]
    want = [np.asarray(x) for x in s_tr.make_transposed(mode, 8)(
        _j(scene["packed"]), *_script_args(scene), num_tiles=scene["num_tiles"],
        tiles_x=scene["tiles_x"])]
    got = [x.numpy() for x in ef.exp_transposed(scene["packed"], *_port_args(scene), mode)]
    np.testing.assert_allclose(got[0], want[0], atol=IMAGE_ATOL, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=IMAGE_ATOL, rtol=0)
    off = ~_near(scene)
    np.testing.assert_array_equal(got[2][off], want[2][off])


def test_kernel_g_equals_e_transposed(scene):
    """G computes E's function on the other layout: the same bits."""
    fm_rows = ef.forward_rows(scene["packed_fm"], *_port_args(scene), "hs")
    im_rows = ef.transposed_rows(scene["packed"], *_port_args(scene), "hs")
    assert torch.equal(im_rows, fm_rows.transpose(1, 2))


@pytest.mark.parametrize("out_cols", [8, 1])
def test_kernel_f_alpha_matches_formula(scene, out_cols):
    """F's alpha plain version against exp_fwd2.py's alpha formula
    (`:53-65`) evaluated with JAX ops on the same rows: column 0 of each
    row is the sum over the tile's rows so far of the row's 64 alphas; the
    other columns and the rows past the last tile's are zero."""
    got = ef.ablation_rows(scene["packed_fm"], *_port_args(scene), "alpha", 8, out_cols).numpy()
    assert got.shape == (scene["max_rows"], 256, out_cols)
    fm = jnp.asarray(scene["packed_fm"].numpy()).reshape(-1, rows.REC, rows.CHUNK)
    p = jnp.arange(256)
    lx, ly = (p % 16).astype(jnp.float32), (p // 16).astype(jnp.float32)
    want = np.zeros_like(got)
    crs, nch = scene["chunk_row_start"].tolist(), scene["n_chunks"].tolist()
    for t in range(scene["num_tiles"]):
        px = float((t % scene["tiles_x"]) * 16) + lx
        py = float((t // scene["tiles_x"]) * 16) + ly
        acc = jnp.zeros((256,), jnp.float32)
        for r in range(crs[t], crs[t] + nch[t]):
            rec = fm[r]
            dx = rec[0][None, :] - px[:, None]
            dy = rec[1][None, :] - py[:, None]
            power = -0.5 * (rec[2] * dx * dx + rec[4] * dy * dy) - rec[3] * dx * dy
            alpha = jnp.minimum(ALPHA_MAX, rec[5] * jnp.exp(power))
            a = jnp.where((power <= 0.0) & (alpha >= ALPHA_MIN), alpha, 0.0)
            acc = acc + jnp.sum(a, axis=1)
            want[r, :, 0] = np.asarray(acc)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert float(np.abs(got[:, :, 0]).max()) > 0.1
    np.testing.assert_array_equal(
        ef.exp_ablation(scene["packed_fm"], *_port_args(scene), "alpha", 8, out_cols).numpy(), got[0])


@pytest.mark.parametrize("mode", ["empty", "outonly"])
def test_kernel_f_state_only_ablations_are_zero(scene, mode):
    got = ef.ablation_rows(scene["packed_fm"], *_port_args(scene), mode, 8, 8)
    assert got.shape == (scene["max_rows"], 256, 8) and not got.any()


@pytest.mark.parametrize("mode", ["hs", "mxu"])
def test_variants_match_kernel_a(scene, mode):
    """E and G against Kernel A's plain version on the same bins, with
    last_contrib turned into positions in the tiles' lists."""
    ref = exp_scene.a_reference(scene)
    near = torch.as_tensor(_near(scene))
    out = ef.exp_forward(scene["packed_fm"], *_port_args(scene), mode)
    err_e = exp_scene.compare_with_a(scene, ref, out[:, :, 0:3].transpose(1, 2), out[:, :, 4],
                                     out[:, :, 5], near)
    err_g = exp_scene.compare_with_a(scene, ref, *ef.exp_transposed(scene["packed"],
                                                                    *_port_args(scene), mode), near)
    for err in (err_e, err_g):
        assert err["color"] <= IMAGE_ATOL and err["t_final"] <= IMAGE_ATOL, err
        assert err["last_contrib"] == 0, err


def test_near_cut_marks_a_pixel_at_the_cut():
    """A tile whose one Gaussian brings a pixel's transmittance to the cut
    (a stack of equal alphas) is marked; the others are not."""
    n = 3
    rec = torch.zeros((n + 1, rows.REC))
    rec[:n, 0:2] = 8.0  # at the centre of tile 0
    rec[:n, 2] = rec[:n, 4] = 1e-9  # flat: alpha = opacity at every pixel
    rec[:n, 5] = 1.0 - 10 ** (-4 / 3)  # three layers: t = 1e-4 exactly (in real numbers)
    rec[:n, 9] = torch.arange(n, dtype=torch.float32)
    rec[n, 9] = n
    pk = rows.pack_rows(rec, torch.tensor([0, n], dtype=torch.int32),
                        torch.tensor([n, n], dtype=torch.int32))
    near = ef.near_cut(rows.field_major(pk["packed"]), pk["chunk_row_start"], pk["n_chunks"], 2)
    assert near[0].all() and not near[1].any()


def test_pairs_count_live_lanes(scene):
    assert ef.pairs(scene["windows"], scene["proj"]["mean2d"].shape[0]) == 256 * scene["instances"]
    walked = torch.zeros(scene["max_rows"], dtype=torch.bool)
    assert ef.pairs(scene["windows"], scene["proj"]["mean2d"].shape[0], walked) == 0


def test_wrappers_refuse_bad_inputs(scene):
    args = _port_args(scene)
    with pytest.raises(ValueError):
        ef.exp_forward(scene["packed"], *args)  # instance-major rows to E
    with pytest.raises(ValueError):
        ef.exp_transposed(scene["packed_fm"], *args)  # field-major rows to G
    with pytest.raises(ValueError):
        ef.exp_forward(scene["packed_fm"].double(), *args)
    with pytest.raises(ValueError):
        ef.exp_forward(scene["packed_fm"], args[0].long(), *args[1:])
    with pytest.raises(ValueError):
        ef.exp_forward(scene["packed_fm"], *args, mode="alpha")
    with pytest.raises(ValueError):
        ef.exp_ablation(scene["packed_fm"], *args, mode="hs")
    with pytest.raises(ValueError):
        ef.exp_forward(scene["packed_fm"], *args, krows=16)


def test_cpu_wrappers_launch_nothing(scene):
    before = (ef.KERNEL.launches, ef.E.launches, ef.F.launches, ef.G.launches)
    ef.exp_forward(scene["packed_fm"], *_port_args(scene))
    ef.exp_ablation(scene["packed_fm"], *_port_args(scene))
    ef.exp_transposed(scene["packed"], *_port_args(scene))
    assert (ef.KERNEL.launches, ef.E.launches, ef.F.launches, ef.G.launches) == before


@pytest.mark.parametrize("cli", [exp_fwd, exp_fwd2, exp_transposed])
def test_cli_runs_on_the_cpu(cli, capsys):
    """Each CLI at a small size on the CPU: its lines, "not measured" for
    device times, and every non-ablation variant within the image bar of
    Kernel A."""
    results = cli.main(["--width", 64, "--height", 48, "--n", 300, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "64x48, 300 Gaussians" in out and "not measured" in out
    assert all(r["ms"] is None for r in results)
    errs = [r["err"] for r in results if "err" in r]
    assert len(errs) == {exp_fwd: 4, exp_fwd2: 0, exp_transposed: 2}[cli]
    for err in errs:
        assert err["color"] <= IMAGE_ATOL and err["t_final"] <= IMAGE_ATOL
        assert err["last_contrib"] == 0


def test_error_site_names_row_pixel_and_vote():
    """The diagnosis of a failed mxu check: the largest error off the
    pixels at a cut, its row, tile and pixel, and the rows whose skip vote
    differs between the two states."""
    want = torch.zeros((4, 256, 8))
    want[:, :, 3] = 0.5
    got = want.clone()
    got[1, :, 3] = 0.0  # every pixel saturated: row 2's vote flips
    got[2, 5, 0] = 1.0
    got[3, 9, 1] = 2.0  # larger, but pixel 9 is at a cut
    near = torch.zeros((1, 256), dtype=torch.bool)
    near[0, 9] = True
    row_tile = torch.tensor([0, 0, 0, 0], dtype=torch.int32)
    site = ef.error_site(got, want, row_tile, torch.tensor([0], dtype=torch.int32), near)
    assert (site["row"], site["pixel"], site["column"], site["tile"]) == (2, 5, 0, 0)
    assert site["err"] == 1.0 and site["near_cut"] is False and site["tile_near_cut_pixels"] == 1
    assert site["vote_differs_rows"] == [2]


def test_scene_digest_is_deterministic(scene):
    """The digest that phase 8 of chip_smoke.py prints: the same scene built
    twice from its seed gives the same digest; another seed or one changed
    value gives another."""
    again = exp_scene.build_scene(64, 48, 300, seed=0, device="cpu")
    assert exp_scene.digest(again) == exp_scene.digest(scene)
    assert exp_scene.digest(exp_scene.build_scene(64, 48, 300, seed=1, device="cpu")) != exp_scene.digest(scene)
    again["packed"][5, 2] += 1.0
    assert exp_scene.digest(again) != exp_scene.digest(scene)


def test_edge_scene_holds_its_edge_cases():
    """The kernels' edge scene on the plain versions: the tiles of
    `EDGE_TILES` hold their rows; the saturated tile's rows after its
    first are skipped; in the half-saturated tile's rows after its first,
    warps 0-3 (pixel rows 0-7) hold no live pixel and the others do; the
    dead-warp count agrees with the plain scan's walked rows."""
    sc = exp_scene.edge_scene("cpu")
    assert sc["n_chunks"][: len(exp_scene.EDGE_TILES)].tolist() == [n for _, n in exp_scene.EDGE_TILES]
    args = (sc["chunk_row_start"], sc["n_chunks"], sc["schedule"], sc["tiles_x"])
    out = ef.forward_rows(sc["packed_fm"], *args, "hs")
    _, info = ef.scan_plain(sc["packed_fm"], *args[:2], sc["tiles_x"], "hs")
    dead = ef.dead_warps(out, sc["row_first"], sc["row_tile"], sc["num_tiles"])
    assert dead["rows_walked"] == int(info["walked"].sum()) == sc["rows_used"] - 2
    wall, half = (int(sc["chunk_row_start"][t]) for t in (4, 5))
    assert not info["walked"][wall + 1] and not info["walked"][wall + 2]
    live = (out[half: half + 3, :, 3] >= 1e-4).view(3, 8, 32).any(dim=2)
    assert not live[:, :4].any() and live[:, 4:].all()
    assert dead["dead_warps"] >= 12
    assert torch.equal(ef.transposed_rows(sc["packed"], *args, "hs"), out.transpose(1, 2))


def test_scan_ablation_runs_on_the_cpu(capsys):
    """The ablation CLI at a small size on the CPU: one line per scan
    instantiation with "not measured" for every time, and the dead-warp
    count from the plain version."""
    res = scan_ablation.main(["--width", 64, "--height", 48, "--n", 300, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "64x48, 300 Gaussians" in out and "not measured" in out
    assert len(res["rows"]) == 2 * len(scan_ablation.INSTANCES) == 18
    assert all(r["committed_ms"] == "not measured" for r in res["rows"])
    alpha = [r for r in res["rows"] if r["mode"] == "alpha"]
    assert {(r["krows"], r["out_cols"]) for r in alpha} == {(8, 8), (8, 1), (32, 8), (32, 1)}
    assert all(r[f"{n}_ms"] == "not measured" for r in alpha for n in scan_ablation.ALPHA_VARIANTS)
    assert not any(f"{n}_ms" in r for r in res["rows"] if r["mode"] != "alpha" for n in scan_ablation.ALPHA_VARIANTS)
    assert 0 < res["far"]["far"] < res["far"]["slot_warps"]
    assert res["dead_warps"]["rows_walked"] > 0 and 0.0 <= res["dead_warps"]["share"] <= 1.0
    bal = res["balance"]
    assert bal["snake_max_over_mean"] >= bal["greedy_max_over_mean"] >= 1.0


def test_block_balance_counts_walked_rows():
    """The snake and greedy assignments of `scan_ablation.block_balance` on
    a hand-made schedule: tiles of 4, 3, 2 and 1 walked rows over two
    blocks; the snake gives 4 + 1 and 3 + 2, the greedy the same."""
    row_tile = torch.tensor([0, 0, 0, 0, 1, 1, 1, 2, 2, 3, 4])
    sc = {"num_tiles": 4, "row_tile": row_tile, "schedule": torch.tensor([0, 1, 2, 3], dtype=torch.int32)}
    bal = scan_ablation.block_balance(sc, row_tile < 4, 2)
    assert bal["mean_walked_rows"] == 5.0
    assert bal["snake_max_over_mean"] == 1.0 and bal["greedy_max_over_mean"] == 1.0
    bal = scan_ablation.block_balance(sc, row_tile < 4, 3)
    assert bal["snake_max_over_mean"] == 4.0 / (10 / 3) and bal["greedy_max_over_mean"] == 4.0 / (10 / 3)


def test_alpha_variants_apply_to_the_committed_source():
    """Each of F alpha's variants finds its committed text (the build would
    refuse it otherwise) and changes the source."""
    committed = scan_ablation.SOURCE.read_text()
    for name in [*scan_ablation.VARIANTS, *scan_ablation.ALPHA_VARIANTS]:
        assert scan_ablation.variant_source(name).read_text() != committed, name


def _far_by_hand(sc, warp_pixels):
    recs = sc["packed_fm"].view(-1, rows.REC, rows.CHUNK)
    far = total = 0
    for r in range(sc["rows_used"]):
        t = int(sc["row_tile"][r])
        px = (t % sc["tiles_x"]) * 16 + torch.arange(256) % 16
        py = (t // sc["tiles_x"]) * 16 + torch.arange(256) // 16
        rec = recs[r]
        dx = rec[0][None, :] - px.float()[:, None]
        dy = rec[1][None, :] - py.float()[:, None]
        power = -0.5 * (rec[2] * dx * dx + rec[4] * dy * dy) - rec[3] * dx * dy
        threshold = torch.log(torch.full_like(rec[5], ALPHA_MIN) / rec[5]) - ef.FAR_MARGIN
        is_far = (power < threshold).view(256 // warp_pixels, warp_pixels, rows.CHUNK).all(dim=1)
        far, total = far + int(is_far.sum()), total + is_far.numel()
    return far, total


@pytest.mark.parametrize("warp_pixels", [64, 32])
def test_far_records_counts_by_hand(scene, warp_pixels):
    """`far_records` against a row-by-row count, in steps that split the
    rows unevenly; the padding slots (opacity 0) are always far."""
    got = ef.far_records(scene["packed_fm"], scene["row_tile"], scene["tiles_x"], scene["num_tiles"],
                         warp_pixels, rows_per_step=5)
    far, total = _far_by_hand(scene, warp_pixels)
    assert (got["far"], got["slot_warps"]) == (far, total) and 0 < far < total
    pad = int((scene["windows"][: scene["rows_used"]] >= scene["n_gaussians"]).sum())
    assert far >= pad * (256 // warp_pixels)


def test_far_threshold_leaves_no_alpha():
    """Below the far threshold the alpha is 0 with room to spare: at the
    largest f32 power below ln(1/255 / op) - FAR_MARGIN, op * exp(power)
    stays under 1/255 by more than the exp's and the product's rounding,
    for opacities from 1e-6 to 1 (the sentinel's 0 gives an infinite
    threshold: its alpha is 0 at any power)."""
    op = torch.logspace(-6, 0, 200_001, dtype=torch.float32)
    threshold = torch.log(torch.full_like(op, ALPHA_MIN) / op) - ef.FAR_MARGIN
    power = torch.nextafter(threshold, torch.full_like(threshold, -float("inf")))
    alpha = op * torch.exp(power)
    assert float((alpha / ALPHA_MIN).max()) < 1.0 - 0.9 * ef.FAR_MARGIN
