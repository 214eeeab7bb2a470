"""`sgs_tpu_torch/tools/flagship_long_run.py` on the CPU.

- Its JAX constants equal the JAX run's files: the reports of
  `runs/flagship_r5.log` (test numbers also in `losses.tsv`), the
  iterations of the guard's warnings there, the checkpoint layout of
  `runs/flagship_r5/chkpnt15000.npz`, and the configuration in `cfg_args`
  and `opt_args`.
- Its statistics of JAX's states (`JAX_STATS`) equal those computed from
  `runs/resume3000.npz` and `runs/flagship_r5/chkpnt*.npz`, the per-view
  test PSNR of the 13,000 checkpoint (JAX's reference there) included.
- A start packed for the card's machine (`--pack_starts`) unpacks to the
  same checkpoint.
- Its parsing and comparison run on a 30-iteration toy run with
  `--device cpu` (three reports, a densify, the state statistics, the
  checkpoint reloaded and its one step's report equal to the last one),
  and `--report` on that run's checkpoint repeats its last test report;
  `--start jax_procedure` replays JAX's break on the toy scene, with JAX's
  reduction (`--reduction jax_prefix`).
"""

import ast
import os
import re

import numpy as np
import pytest
import torch

from sgs_tpu_torch.data.ply import save_point_cloud_ply
from sgs_tpu_torch.tools import flagship_long_run as lr
from sgs_tpu_torch.utils.toy_scene import make_blender_dataset

torch.set_num_threads(2)
RUN = os.path.join(lr.ROOT, "runs", "flagship_r5")


def _namespace(path):
    text = open(path).read().strip()
    assert text.startswith("Namespace(") and text.endswith(")")
    tree = ast.parse(text, mode="eval").body
    return {kw.arg: ast.literal_eval(kw.value) for kw in tree.keywords}


def test_jax_constants_equal_the_run_files():
    rows = [ln.split("\t") for ln in open(os.path.join(RUN, "losses.tsv")).read().split("\n")[1:] if ln]
    assert {int(r[0]): (float(r[1]), float(r[2]), int(r[3])) for r in rows} == {
        it: (v[0], v[1], v[4]) for it, v in lr.JAX_REPORTS.items()}
    log = open(os.path.join(lr.ROOT, "runs", "flagship_r5.log")).read()
    parsed = lr.parse_log(log)
    assert {it: (r["test_l1"], r["test_psnr"], r["train_l1"], r["train_psnr"], r["gaussians"])
            for it, r in parsed["reports"].items()} == lr.JAX_REPORTS
    assert tuple(it for it, _ in parsed["guard"]) == lr.JAX_GUARD_ITERS
    assert len(re.findall(r"non-finite gradient elements zeroed", log)) == len(lr.JAX_GUARD_ITERS) == 39
    layout = lr.checkpoint_layout(os.path.join(RUN, "chkpnt15000.npz"))
    assert lr.layout_mismatches(layout) == []
    cfg, opt = _namespace(os.path.join(RUN, "cfg_args")), _namespace(os.path.join(RUN, "opt_args"))
    assert (cfg["sh_degree"], cfg["resolution"], cfg["white_background"], cfg["eval"]) == (3, -1, False, True)
    assert lr.CFG_ARGS == ["--sh_degree", "3", "-r", "-1", "--eval"]
    assert (opt["iterations"], opt["densify_until_iter"], opt["position_lr_max_steps"]) == (
        lr.ITERATIONS, lr.DENSIFY_UNTIL, lr.ITERATIONS)
    assert lr.TEST_ITERATIONS == tuple(sorted(lr.JAX_REPORTS))


@pytest.mark.parametrize("iteration", [3000, 7000, 10000, 13000, 15000])
def test_jax_stats_equal_the_checkpoints(iteration):
    path = lr.START_FILES["resume3000"] if iteration == 3000 else os.path.join(RUN, f"chkpnt{iteration}.npz")
    z = np.load(path)
    want = lr.JAX_STATS[iteration]
    got = lr.state_stats(z)
    for base in ("resume3000", "chkpnt10000"):
        if base == "chkpnt10000" and iteration < 10000:
            assert all(base not in want[f"d_{f}"] for f in lr.FIELDS)
            continue
        d = lr.state_stats(z, np.load(lr.START_FILES[base]))
        got.update({f"d_{f}": {**got.get(f"d_{f}", {}), base: d[f"d_{f}"]} for f in lr.FIELDS})
    for k, v in got.items():
        assert want[k] == v, k
    assert want["alive"] == int(z["alive"].sum()) and len(want["test_psnr_per_view"]) == 8
    np.testing.assert_allclose(np.mean(want["test_psnr_per_view"]), want["test_psnr"], rtol=1e-12)
    if iteration in lr.JAX_REPORTS and iteration != 7000:  # 7,000's checkpoint is past its densify
        assert abs(want["test_psnr"] - lr.JAX_REPORTS[iteration][1]) < 5e-4
    if iteration == 13000:  # JAX's reference for the chkpnt10000 start: its per-view PSNR (the
        # CPU's thread count moves the image's sums in the last bits)
        views = lr.per_view_psnr(path, str(lr.SCENE), "cpu")
        np.testing.assert_allclose([p for p, _ in views], want["test_psnr_per_view"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(np.mean([l1 for _, l1 in views]), want["test_l1"], rtol=1e-5)


def test_packed_start_unpacks_to_the_checkpoint(tmp_path):
    from sgs_tpu_torch.models.gaussians import DensifyStats, GaussianModel
    from sgs_tpu_torch.train.checkpoint import save_checkpoint
    from sgs_tpu_torch.train.loop import TrainState
    from sgs_tpu_torch.train.optim import AdamState

    rng = np.random.default_rng(3)
    model = GaussianModel.empty(64, 3, "cpu")
    alive = torch.from_numpy(rng.random(64) < 0.6)
    for f in lr.FIELDS:
        x = getattr(model, f)
        x[alive] = torch.from_numpy(rng.normal(size=(int(alive.sum()),) + tuple(x.shape[1:])).astype(np.float32))
    model.alive = alive
    moments = lambda: {f: torch.where(alive.reshape((-1,) + (1,) * (getattr(model, f).dim() - 1)),  # noqa: E731
                                      torch.rand_like(getattr(model, f)), 0.0) for f in lr.FIELDS}
    adam = AdamState(mu=moments(), nu=moments(), step={f: 17 for f in lr.FIELDS})
    stats = DensifyStats.zeros(64, "cpu")
    stats.denom[alive] = 3.0
    src, packed, back = tmp_path / "src.npz", tmp_path / "packed.npz", tmp_path / "back.npz"
    save_checkpoint(str(src), TrainState(model=model, adam=adam, stats=stats), 3000, 3, 4.5)
    lr.pack_start(str(src), str(packed))
    lr.unpack_start(str(packed), str(back))
    a, b = np.load(src), np.load(back)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_layout_mismatch_is_reported():
    want = {k: (s, d) for k, (s, d) in lr.JAX_CHECKPOINT.items()}
    assert lr.layout_mismatches(want) == []
    bad = dict(want, param_xyz=((4,), "float32"), alive=((), "float32"))
    del bad["denom"]
    assert len(lr.layout_mismatches(bad)) == 3


@pytest.fixture(scope="module")
def toy_scene(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("toyscene"))
    make_blender_dataset(out, n_train=6, n_test=2, width=32, height=32, n_gaussians=50, seed=5,
                         white_background=False, device="cpu")
    rng = np.random.default_rng(1)
    save_point_cloud_ply(f"{out}/points3d.ply", (rng.random((200, 3)) * 2 - 1).astype(np.float32),
                         rng.integers(0, 256, (200, 3)).astype(np.uint8))
    return out


def test_toy_run_parses_compares_and_reloads(toy_scene, tmp_path, capsys):
    res = lr.main(["--scene", toy_scene, "--out", str(tmp_path / "model"), "--iterations", "30",
                   "--densify_until_iter", "25", "--test_iterations", "10", "20", "30",
                   "--device", "cpu", "--densify_from_iter", "10", "--densification_interval", "10",
                   "--json", str(tmp_path / "out.json")])
    printed = capsys.readouterr().out
    assert [r["iteration"] for r in res["reports"]] == [10, 20, 30]
    assert [r["jax_iteration"] for r in res["reports"]] == [7000, 10000, 15000]
    for r in res["reports"]:
        assert np.isfinite([r["test_psnr"], r["train_psnr"], r["test_l1"], r["train_l1"]]).all()
        assert r["d_test_psnr"] == r["test_psnr"] - lr.JAX_REPORTS[r["jax_iteration"]][1]
        assert r["gaussians"] > 0
    assert "psnr_ok" not in res["reports"][0] and "psnr_ok" in res["reports"][2]
    assert res["bars_met"] is False  # a 32x32 toy is not the flagship
    assert res["trained"]["iterations"] == 30 and res["trained"]["it_per_s"] > 0
    assert res["peak_device_bytes"] is None and "not measured" in printed
    assert res["checkpoint_layout_ok"], res["checkpoint_layout_mismatches"]
    assert res["reload_equal"] and res["reload_report"]["test_psnr"] == res["reports"][2]["test_psnr"]
    # the state beside JAX's at each report: no start state before 3,000, so no d_<field>
    for r in res["reports"]:
        assert r["stats"]["alive"] > 0 and len(r["stats"]["test_psnr_per_view"]) == 2
        assert set(r["jax_stats"]) >= {"alive", "nu_xyz", "opacity_over_half", "median_max_scale"}
        assert "d_xyz" not in r["stats"]
    assert res["first_departure"]["iteration"] == 10
    assert [w["to"] for w in res["densify_windows"]] == [10, 20, 30]
    assert sum(w["steps"] for w in res["densify_windows"]) == 1
    assert (tmp_path / "model" / "chkpnt30.npz").exists()
    assert (tmp_path / "model" / "point_cloud" / "iteration_30" / "point_cloud.ply").exists()
    assert not (tmp_path / "model" / "chkpnt10.npz").exists()
    assert "densify:" in (tmp_path / "model" / "train.log").read_text()
    assert lr.json.loads(printed.strip().split("\n")[-1]) == lr.json.loads((tmp_path / "out.json").read_text())
    # --report: the checkpoint's test views through training_report, as the run reported them
    again = lr.main(["--scene", toy_scene, "--device", "cpu", "--report", str(tmp_path / "model" / "chkpnt30.npz")])
    last = res["reports"][2]
    assert again["reports"][0]["iteration"] == 30
    assert (again["reports"][0]["test_psnr"], again["reports"][0]["gaussians"]) == (last["test_psnr"], last["gaussians"])


def test_toy_jax_procedure(toy_scene, tmp_path):
    """The break of JAX's run replayed: 12 iterations with the PLY at 12, a
    checkpoint rebuilt from it (fresh Adam, zero statistics), then the
    resume to 30; the statistics measure from the rebuilt state."""
    res = lr.main(["--scene", toy_scene, "--out", str(tmp_path / "model"), "--start", "jax_procedure",
                   "--resume_iteration", "12", "--iterations", "30", "--densify_until_iter", "25",
                   "--test_iterations", "15", "20", "30", "--device", "cpu", "--densify_from_iter", "5",
                   "--densification_interval", "5", "--reduction", "jax_prefix"])
    rebuilt = np.load(tmp_path / "model" / "resume12.npz")
    assert int(rebuilt["iteration"]) == 12 and int(rebuilt["adam_step_xyz"]) == 0
    assert not rebuilt["adam_nu_xyz"].any() and not rebuilt["denom"].any()
    assert (tmp_path / "model" / "first" / "point_cloud" / "iteration_12" / "point_cloud.ply").exists()
    assert res["start"] == "jax_procedure" and res["reduction"] == "jax_prefix"
    assert [r["iteration"] for r in res["reports"]] == [15, 20, 30]
    assert all("d_xyz" in r["stats"] and r["stats"]["d_xyz"] > 0 for r in res["reports"])
    assert res["reload_equal"] and res["checkpoint_layout_ok"]
