"""The port's CLIs take the JAX CLIs' command lines.

- `python -m sgs_tpu_torch.train` parses every option string of the
  repository's `train.py` to the same value, `python -m
  sgs_tpu_torch.train_lgm` every one of `train_lgm.py` and `python -m
  sgs_tpu_torch.render` every one of `render.py`. The JAX parsers are
  captured from `train.main`, `train_lgm.main` and `render.main`
  themselves.
- The render CLI merges the model flags over the persisted cfg_args as
  `sgs_tpu.utils.config.get_combined_args` does (mirroring
  tests/test_eval_tools.py's cfg_args-only and --no-<flag> cases), renders
  through `Scene(load_iteration, shuffle=False)`, so with `eval` False no
  test set is written, and accepts `full_eval.py`'s render argv.
- --detect_anomaly and --profile_dir of the training CLI take effect.

Exact comparisons throughout: these are parsed values and file lists.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

import render as jax_render
import train as jax_train
import train_lgm as jax_train_lgm
from sgs_tpu.data.ply import load_gaussian_ply, save_gaussian_ply
from sgs_tpu.utils import config as jax_config
from sgs_tpu_torch.data.ply import save_point_cloud_ply
from sgs_tpu_torch.data.png import read_png
from sgs_tpu_torch.render import cli as render_cli
from sgs_tpu_torch import train_lgm as train_lgm_cli
from sgs_tpu_torch.train import __main__ as train_cli
from sgs_tpu_torch.utils import config
from test_torch_cli import ROOT, make_small_scene

torch.set_num_threads(1)
ITERATION = 7000


class _Captured(Exception):
    pass


def _jax_parser(module, argv, monkeypatch):
    """The ArgumentParser that `module.main(argv)` builds, captured at its
    parse_args call."""
    original = argparse.ArgumentParser.parse_args

    def capture(self, *args, **kwargs):
        raise _Captured(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Captured) as got:
        module.main(argv)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", original)
    return got.value.args[0]


def _sample_argv(action, option):
    if action.nargs == 0:
        return [option]
    value = {int: "3", float: "0.5"}.get(action.type, "x")
    return [option, value]


def _assert_same_options(jax_parser, port_parser):
    checked = 0
    for action in jax_parser._actions:
        if isinstance(action, argparse._HelpAction):
            continue
        for option in action.option_strings:
            argv = _sample_argv(action, option)
            want = getattr(jax_parser.parse_args(argv), action.dest)
            got = getattr(port_parser.parse_args(argv), action.dest)
            assert got == want, (option, got, want)
            checked += 1
    return checked


def test_train_cli_accepts_every_train_py_option(monkeypatch):
    jax_parser = _jax_parser(jax_train, ["-s", "/x"], monkeypatch)
    checked = _assert_same_options(jax_parser, train_cli.build_parser())
    for flag in ("--debug_from", "--detect_anomaly", "--profile_dir", "--no-eval", "-w", "-r"):
        assert any(flag in a.option_strings for a in jax_parser._actions), flag
    assert checked > 50


def test_train_lgm_cli_accepts_every_train_lgm_py_option(monkeypatch):
    jax_parser = _jax_parser(jax_train_lgm, ["-s", "/x"], monkeypatch)
    checked = _assert_same_options(jax_parser, train_lgm_cli.build_parser())
    for flag in ("--downsample_init", "--latent_size", "--hidden_size", "--gaussians_per_structure",
                 "--use_positional_embedding", "--debug_latent", "--start_checkpoint"):
        assert any(flag in a.option_strings for a in jax_parser._actions), flag
    assert checked > 50
    defaults = jax_parser.parse_args([])
    port_defaults = train_lgm_cli.build_parser().parse_args([])
    for action in jax_parser._actions:
        # data_device names the JAX package's device ("tpu"); the port's is "cuda"
        if not isinstance(action, argparse._HelpAction) and action.dest != "data_device":
            assert getattr(port_defaults, action.dest) == getattr(defaults, action.dest), action.dest


def test_render_cli_accepts_every_render_py_option(monkeypatch):
    jax_parser = _jax_parser(jax_render, ["-m", "/x"], monkeypatch)
    checked = _assert_same_options(jax_parser, render_cli.build_parser())
    assert checked > 25


@pytest.fixture
def trained(tmp_path):
    """A model directory as training leaves it: cfg_args (eval True, black
    background) and point_cloud/iteration_7000 holding a 3,000-Gaussian
    subset of the flagship, over a 2 + 2-view 100x100 scene."""
    scene_dir = tmp_path / "scene"
    make_small_scene(scene_dir)
    arrays = load_gaussian_ply(os.path.join(ROOT, "assets", "flagship", "point_cloud.ply"), 3)
    keep = np.sort(np.random.default_rng(2).choice(arrays["xyz"].shape[0], 3000, replace=False))
    sub = {k: v[keep] for k, v in arrays.items()}
    model = tmp_path / "model"
    ply = model / "point_cloud" / f"iteration_{ITERATION}" / "point_cloud.ply"
    ply.parent.mkdir(parents=True)
    save_gaussian_ply(str(ply), sub["xyz"], sub["features_dc"], sub["features_rest"],
                      sub["opacity"], sub["scaling"], sub["rotation"])
    config.save_cfg_args(str(model), config.ModelParams(source_path=str(scene_dir),
                                                        model_path=str(model), eval=True))
    return scene_dir, model


def _pngs(model, split):
    d = model / split / f"ours_{ITERATION}" / "renders"
    return sorted(os.listdir(d)) if d.exists() else []


def test_render_cfg_args_merge_matches_jax(trained):
    """`-m` alone recovers source_path, eval and white_background from
    cfg_args; a flag given overrides it; --no-eval turns off a persisted
    True. The port's merge equals the JAX package's on every case."""
    scene_dir, model = trained
    jax_parser = argparse.ArgumentParser()
    jax_config.add_dataclass_args(jax_parser, jax_config.ModelParams, "Loading", sentinel=True)
    port_parser = argparse.ArgumentParser()
    config.add_dataclass_args(port_parser, config.ModelParams, "Loading", sentinel=True)
    cases = [["-m", str(model)], ["-m", str(model), "-s", "/elsewhere"],
             ["--model_path", str(model), "--no-eval"], ["--model_path", str(model), "-w", "--eval"]]
    for argv in cases:
        want = jax_config.extract_dataclass(
            jax_config.ModelParams, jax_config.get_combined_args(jax_parser, argv))
        got = config.extract_dataclass(config.ModelParams, config.get_combined_args(port_parser, argv))
        for field in ("source_path", "model_path", "eval", "white_background", "resolution",
                      "sh_degree"):
            assert getattr(got, field) == getattr(want, field), (argv, field)
    merged = config.get_combined_args(port_parser, ["-m", str(model)])
    got = config.extract_dataclass(config.ModelParams, merged)
    assert got.source_path == str(scene_dir) and got.eval is True and got.white_background is False


def test_render_full_eval_argv(trained, capsys):
    """full_eval.py's render argv: the test split at --iteration, quietly."""
    scene_dir, model = trained
    argv = ["--iteration", str(ITERATION), "-s", str(scene_dir), "-m", str(model),
            "--quiet", "--eval", "--skip_train"]
    render_cli.main(argv + ["--device", "cpu"])
    assert _pngs(model, "test") == ["00000.png", "00001.png"]
    assert not (model / "train").exists()
    assert capsys.readouterr().out == f"Rendering {model}\n"


def test_render_from_cfg_args_alone(trained):
    _, model = trained
    render_cli.main(["-m", str(model), "--skip_train", "--device", "cpu"])
    assert _pngs(model, "test") == ["00000.png", "00001.png"]


@pytest.mark.parametrize("how", ["flag", "cfg_args"])
def test_render_without_eval_renders_no_test_set(trained, how):
    """eval False merges the test views into train (Scene, as JAX's
    readers.py does), so the test set is empty."""
    scene_dir, model = trained
    argv = ["-m", str(model), "--device", "cpu"]
    if how == "flag":
        argv.append("--no-eval")
    else:
        config.save_cfg_args(str(model), config.ModelParams(source_path=str(scene_dir),
                                                            model_path=str(model), eval=False))
    render_cli.main(argv)
    assert _pngs(model, "train") == [f"{i:05d}.png" for i in range(4)]
    assert _pngs(model, "test") == []


def test_render_refuses_the_reference_rasterizer(trained):
    """The render CLI refuses the rasterizers it does not run, the tiled one
    without tight culling; `--rasterizer reference` (the oracle, which the
    port now runs) renders the test set to the tiled path's PNGs within one
    8-bit level."""
    _, model = trained
    with pytest.raises(NotImplementedError, match="tiled rasterizer"):
        render_cli.main(["-m", str(model), "--no-tight_culling", "--device", "cpu"])
    render_cli.main(["-m", str(model), "--skip_train", "--device", "cpu"])
    tiled = [read_png(str(p)) for p in sorted((model / "test").glob("ours_*/renders/*.png"))]
    render_cli.main(["-m", str(model), "--rasterizer", "reference", "--skip_train", "--device", "cpu"])
    oracle = [read_png(str(p)) for p in sorted((model / "test").glob("ours_*/renders/*.png"))]
    assert len(oracle) == len(tiled) == 2
    for a, b in zip(oracle, tiled):
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


def test_train_detect_anomaly_and_profile_dir(tmp_path):
    scene_dir = tmp_path / "scene"
    make_small_scene(scene_dir)
    rng = np.random.default_rng(0)
    save_point_cloud_ply(str(scene_dir / "points3d.ply"),
                         (rng.random((300, 3)) * 2.6 - 1.3).astype(np.float32),
                         rng.integers(0, 256, (300, 3)).astype(np.uint8))
    model, trace_dir = tmp_path / "model", tmp_path / "trace"
    seen = []
    from sgs_tpu_torch.train import trainer

    real = trainer.training

    def spy(*args, **kwargs):
        seen.append(torch.is_anomaly_enabled())
        return real(*args, **kwargs)

    try:
        trainer.training = spy
        train_cli.main(["-s", str(scene_dir), "-m", str(model), "--device", "cpu",
                        "--iterations", "2", "--test_iterations", "-1", "--checkpoint_iterations",
                        "-1", "--debug_from", "0", "--detect_anomaly", "--profile_dir",
                        str(trace_dir)])
    finally:
        trainer.training = real
        torch.autograd.set_detect_anomaly(False)
    assert seen == [True]
    trace = json.loads((trace_dir / "trace.json").read_text())
    assert trace["traceEvents"]
    assert (model / "point_cloud" / "iteration_2" / "point_cloud.ply").exists()
