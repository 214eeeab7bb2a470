"""`sgs_tpu_torch/tools/flagship_long_run.py` on the CPU.

- Its JAX constants equal the JAX run's files: the reports of
  `runs/flagship_r5.log` (test numbers also in `losses.tsv`), the
  iterations of the guard's warnings there, the checkpoint layout of
  `runs/flagship_r5/chkpnt15000.npz`, and the configuration in `cfg_args`
  and `opt_args`.
- Its parsing and comparison run on a 30-iteration toy run with
  `--device cpu` (three reports, a densify, the checkpoint reloaded and
  its one step's report equal to the last one), and `--report` on that
  run's checkpoint repeats its last test report.
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
