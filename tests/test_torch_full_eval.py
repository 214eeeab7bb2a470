"""The port's `full_eval` drives the port's CLIs with the repository's
`full_eval.py` argv.

Mirrors tests/test_eval_tools.py::test_full_eval_metrics_only: with the
subprocess call recorded in both packages, every argv list of the port
equals JAX's with `-m sgs_tpu_torch.train`, `-m sgs_tpu_torch.render` and
`-m sgs_tpu_torch.metrics` in place of train.py, render.py and
metrics.py, in the same order, for the metrics-only path, each stage
alone and the whole run; without the dataset flags both refuse to train
or render.
"""

import pytest

import full_eval as jax_full_eval
from sgs_tpu_torch import full_eval

SCRIPTS = {"train.py": ["-m", "sgs_tpu_torch.train"], "render.py": ["-m", "sgs_tpu_torch.render"],
           "metrics.py": ["-m", "sgs_tpu_torch.metrics"]}
DATASETS = ["-m360", "/data/m360", "-tat", "/data/tat", "--deepblending", "/data/db"]


def _calls(module, argv, monkeypatch):
    calls = []
    monkeypatch.setattr(module, "run", lambda cmd: calls.append(list(cmd)))
    module.main(argv)
    return calls


@pytest.mark.parametrize("flags", [
    ["--skip_training", "--skip_rendering"],
    ["--skip_training", "--skip_metrics"] + DATASETS,
    ["--skip_rendering", "--skip_metrics"] + DATASETS,
    DATASETS,
])
def test_argv_equals_jax(flags, tmp_path, monkeypatch):
    argv = flags + ["--output_path", str(tmp_path)]
    want = [[c[0], *SCRIPTS[c[1]], *c[2:]] for c in _calls(jax_full_eval, argv, monkeypatch)]
    got = _calls(full_eval, argv, monkeypatch)
    assert got == want and len(got) > 0
    if flags[:2] == ["--skip_training", "--skip_rendering"]:
        assert len(got) == 1 and len(got[0]) == 4 + 13
        assert got[0][3] == "-m" and got[0][4:] == [f"{tmp_path}/{s}" for s in full_eval.mipnerf360_outdoor_scenes
                                                    + full_eval.mipnerf360_indoor_scenes
                                                    + full_eval.tanks_and_temples_scenes
                                                    + full_eval.deep_blending_scenes]


def test_dataset_flags_required(monkeypatch):
    for module in (jax_full_eval, full_eval):
        with pytest.raises(SystemExit):
            _calls(module, ["--skip_metrics"], monkeypatch)
