"""`python -m sgs_tpu_torch.tools.resume_from_ply` against the repository's
`scripts/make_resume_ckpt.py` on the same PLY and scene: the two
checkpoints hold the same keys, shapes, dtypes and values, key by key
(the capacity rule, the fresh Adam, the zero statistics, the SH degree of
the schedule and the scene's spatial_lr_scale), with the default capacity
and with one given; and the port's trainer resumes from it."""

import os
import sys

import numpy as np
import pytest
import torch

from sgs_tpu_torch.data.ply import load_gaussian_ply, save_gaussian_ply
from sgs_tpu_torch.tools import resume_from_ply

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from sgs_tpu.utils.toy_scene import make_blender_dataset
    from sgs_tpu_torch.data.ply import save_point_cloud_ply

    root = tmp_path_factory.mktemp("resume")
    scene = str(root / "scene")
    make_blender_dataset(scene, n_train=4, n_test=2, width=24, height=24, n_gaussians=30, seed=3)
    rng = np.random.default_rng(4)
    save_point_cloud_ply(f"{scene}/points3d.ply", (rng.random((100, 3)) - 0.5).astype(np.float32),
                         rng.integers(0, 256, (100, 3)).astype(np.uint8))
    arrays = load_gaussian_ply(os.path.join(ROOT, "assets", "flagship", "point_cloud.ply"), 3)
    keep = np.sort(rng.choice(arrays["xyz"].shape[0], 700, replace=False))
    ply = str(root / "snapshot.ply")
    save_gaussian_ply(ply, *(arrays[k][keep] for k in ("xyz", "features_dc", "features_rest",
                                                       "opacity", "scaling", "rotation")))
    return scene, ply, root


def _jax_script(argv, monkeypatch):
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import make_resume_ckpt
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(sys, "argv", ["make_resume_ckpt.py", *argv])
    make_resume_ckpt.main()


@pytest.mark.parametrize("iteration,extra", [(3000, []), (1500, ["3", "8192"]), (500, ["2"])])
def test_checkpoint_equals_make_resume_ckpt(inputs, tmp_path, monkeypatch, iteration, extra):
    scene, ply, _ = inputs
    sh = int(extra[0]) if extra else 3
    if sh != 3:
        arrays = load_gaussian_ply(ply, 3)
        k = (sh + 1) ** 2 - 1
        ply = str(tmp_path / "sh.ply")
        save_gaussian_ply(ply, arrays["xyz"], arrays["features_dc"], arrays["features_rest"][:, :k],
                          arrays["opacity"], arrays["scaling"], arrays["rotation"])
    want_path, got_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    _jax_script([ply, scene, str(iteration), want_path, *extra], monkeypatch)
    info = resume_from_ply.main([ply, scene, str(iteration), got_path, *extra])
    want, got = np.load(want_path), np.load(got_path)
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert info["capacity"] == (int(extra[1]) if len(extra) > 1 else 4096)
    assert int(got["active_sh_degree"]) == min(sh, iteration // 1000)


def test_trainer_resumes_from_it(inputs, tmp_path):
    from sgs_tpu_torch.train.__main__ import main

    scene, ply, _ = inputs
    out = str(tmp_path / "resume.npz")
    resume_from_ply.main([ply, scene, "3000", out])
    model = tmp_path / "model"
    main(["-s", scene, "-m", str(model), "--eval", "--device", "cpu", "--quiet", "--start_checkpoint",
          out, "--iterations", "3010", "--test_iterations", "3010", "--checkpoint_iterations", "3010"])
    z = np.load(str(model / "chkpnt3010.npz"))
    assert int(z["iteration"]) == 3010
    assert int(z["adam_step_xyz"]) == 9  # no update on the last iteration
    assert len((model / "losses.tsv").read_text().splitlines()) == 2
