"""Full benchmark evaluation: train, render (at 7,000 and 30,000) and score
the MipNeRF360, Tanks&Temples and DeepBlending scenes. Port of the
repository's `full_eval.py`.

    python -m sgs_tpu_torch.full_eval [--skip_training] [--skip_rendering] [--skip_metrics]
        [--output_path ./eval] [-m360 <dir> -tat <dir> -db <dir>]

The same scene lists, flags and argv as `full_eval.py`, each stage a
subprocess of the port's CLI in place of the script: `python -m
sgs_tpu_torch.train`, `python -m sgs_tpu_torch.render` and `python -m
sgs_tpu_torch.metrics`. The dataset flags are required unless both
training and rendering are skipped; then only the metrics run, over
<output_path>/<scene> for the 13 scenes.
"""

from __future__ import annotations

import subprocess
import sys
from argparse import ArgumentParser

mipnerf360_outdoor_scenes = ["bicycle", "flowers", "garden", "stump", "treehill"]
mipnerf360_indoor_scenes = ["room", "counter", "kitchen", "bonsai"]
tanks_and_temples_scenes = ["truck", "train"]
deep_blending_scenes = ["drjohnson", "playroom"]

TRAIN = ["-m", "sgs_tpu_torch.train"]
RENDER = ["-m", "sgs_tpu_torch.render"]
METRICS = ["-m", "sgs_tpu_torch.metrics"]


def run(cmd) -> None:
    print("+", " ".join(cmd))
    subprocess.run(cmd, check=True)


def main(argv=None) -> None:
    parser = ArgumentParser(description="Full evaluation script parameters (PyTorch/CUDA port)")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--output_path", default="./eval")
    args, _ = parser.parse_known_args(argv)

    all_scenes = (mipnerf360_outdoor_scenes + mipnerf360_indoor_scenes
                  + tanks_and_temples_scenes + deep_blending_scenes)

    if not args.skip_training or not args.skip_rendering:
        parser.add_argument("--mipnerf360", "-m360", required=True, type=str)
        parser.add_argument("--tanksandtemples", "-tat", required=True, type=str)
        parser.add_argument("--deepblending", "-db", required=True, type=str)
        args = parser.parse_args(argv)

    py = sys.executable

    if not args.skip_training:
        common = ["--quiet", "--eval", "--test_iterations", "-1"]
        for scene in mipnerf360_outdoor_scenes:
            run([py, *TRAIN, "-s", f"{args.mipnerf360}/{scene}", "-i", "images_4",
                 "-m", f"{args.output_path}/{scene}"] + common)
        for scene in mipnerf360_indoor_scenes:
            run([py, *TRAIN, "-s", f"{args.mipnerf360}/{scene}", "-i", "images_2",
                 "-m", f"{args.output_path}/{scene}"] + common)
        for scene in tanks_and_temples_scenes:
            run([py, *TRAIN, "-s", f"{args.tanksandtemples}/{scene}",
                 "-m", f"{args.output_path}/{scene}"] + common)
        for scene in deep_blending_scenes:
            run([py, *TRAIN, "-s", f"{args.deepblending}/{scene}",
                 "-m", f"{args.output_path}/{scene}"] + common)

    if not args.skip_rendering:
        all_sources = ([f"{args.mipnerf360}/{s}" for s in mipnerf360_outdoor_scenes]
                       + [f"{args.mipnerf360}/{s}" for s in mipnerf360_indoor_scenes]
                       + [f"{args.tanksandtemples}/{s}" for s in tanks_and_temples_scenes]
                       + [f"{args.deepblending}/{s}" for s in deep_blending_scenes])
        common = ["--quiet", "--eval", "--skip_train"]
        for scene, source in zip(all_scenes, all_sources):
            for iteration in ("7000", "30000"):
                run([py, *RENDER, "--iteration", iteration, "-s", source,
                     "-m", f"{args.output_path}/{scene}"] + common)

    if not args.skip_metrics:
        run([py, *METRICS, "-m"] + [f"{args.output_path}/{s}" for s in all_scenes])


if __name__ == "__main__":
    main(sys.argv[1:])
