"""Batch driver: Zero123/Objaverse training from each object's mesh with
the structure frozen, through the port's training CLI.

    ZERO123_MANIFEST=<uid_to_objects.json> ZERO123_VIEWS=<views root> \
        python -m sgs_tpu_torch.train_zero123

Counterpart of the repository's `train_zero123.py`: the same variables and
defaults, and for every (uid, glb) of the manifest the same command line
(--freeze_xyz, no densification, white background, 30,000 iterations, the
model in output_zero123/<uid>), run as `python -m sgs_tpu_torch.train`.
`python -m sgs_tpu_torch.train_zero123_2` is the variant without
--freeze_xyz. Nothing runs at import.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import List

DEFAULT_MANIFEST = "/mnt/data/datasets/objaverse/uid_to_objects.json"
DEFAULT_VIEWS = "/mnt/data/datasets/zero123/views_release_10000"


def train_argv(source: str, glb_path: str, model_path: str, freeze_xyz: bool = True,
               iterations: int = 30_000) -> List[str]:
    """The training CLI's arguments for one object."""
    return ["-s", source, "--iterations", str(iterations), *(["--freeze_xyz"] if freeze_xyz else []),
            "--densify_until_iter", "-1", "--no_tqdm", "--eval", "--model_path", model_path,
            "--obj_path", glb_path, "--white_background"]


def commands(freeze_xyz: bool = True) -> List[List[str]]:
    """One training command line per object of the manifest."""
    json_path = os.environ.get("ZERO123_MANIFEST", DEFAULT_MANIFEST)
    views_root = os.environ.get("ZERO123_VIEWS", DEFAULT_VIEWS)
    with open(json_path) as f:
        objects = list(json.load(f).items())
    out_root = "output_zero123" if freeze_xyz else "output_zero123_no_freeze"
    return [[sys.executable, "-m", "sgs_tpu_torch.train",
             *train_argv(f"{views_root}/{uid}", glb_path, f"{out_root}/{uid}", freeze_xyz)]
            for uid, glb_path in objects]


def main(freeze_xyz: bool = True) -> None:
    for cmd in commands(freeze_xyz):
        subprocess.run(cmd, check=False)


if __name__ == "__main__":
    main()
