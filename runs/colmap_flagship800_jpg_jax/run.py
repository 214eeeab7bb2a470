"""The JAX package's render.py and metrics.py on the JPEG COLMAP flagship.

    JAX_PLATFORMS=cpu python runs/colmap_flagship800_jpg_jax/run.py <workdir>

Copies data/colmap_flagship800_jpg (56 quality-95 4:2:0 JPEGs, PIL decodes
them) to <workdir>/scene (the reader writes points3D.ply into sparse/0),
places the trained flagship (assets/flagship/point_cloud.ply) as
iteration 15000 of <workdir>/model_full, and runs

    python render.py --iteration 15000 -s <scene> -m <model_full> --quiet --eval --skip_train
    python metrics.py -m <model_full>

then writes the commands and their output (run.log) and the model's
per_view.json and results.json beside this script, as
runs/colmap_flagship800_jax/ holds them for the PNG copy.
"""

import os
import platform
import resource
import shutil
import subprocess
import sys
import time
from datetime import datetime, timezone

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))


def main(work: str) -> None:
    import jax
    import numpy as np
    import PIL

    scene, model = os.path.join(work, "scene"), os.path.join(work, "model_full")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "data", "colmap_flagship800_jpg"), scene)
    snap = os.path.join(model, "point_cloud", "iteration_15000")
    os.makedirs(snap)
    shutil.copyfile(os.path.join(REPO, "assets", "flagship", "point_cloud.ply"),
                    os.path.join(snap, "point_cloud.ply"))
    commit = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=REPO, capture_output=True,
                            text=True).stdout.strip()
    log = [f"# {datetime.now(timezone.utc).strftime('%Y-%m-%dT%H:%M:%SZ')} python "
           f"{platform.python_version()} jax {jax.__version__} numpy {np.__version__} Pillow "
           f"{PIL.__version__} on {os.cpu_count()} CPU cores, commit {commit}",
           "$ cp -r data/colmap_flagship800_jpg <scene>",
           "$ cp assets/flagship/point_cloud.ply <model_full>/point_cloud/iteration_15000/point_cloud.ply"]
    for cmd in (["render.py", "--iteration", "15000", "-s", scene, "-m", model, "--quiet", "--eval",
                 "--skip_train"], ["metrics.py", "-m", model]):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, *cmd], cwd=REPO, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        rss = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss // 1024
        shown = " ".join(cmd).replace(scene, "<scene>").replace(model, "<model_full>")
        text = (res.stdout + res.stderr).rstrip().replace(scene, "<scene>").replace(model, "<model_full>")
        log += [f"$ python {shown}", text,
                f"  [rc {res.returncode}, {wall:.1f} s, max RSS {rss} MB]"]
        if res.returncode:
            break
    out = os.path.join(HERE, "model_full")
    os.makedirs(out, exist_ok=True)
    for name in ("per_view.json", "results.json"):
        if os.path.exists(os.path.join(model, name)):
            shutil.copyfile(os.path.join(model, name), os.path.join(out, name))
    with open(os.path.join(HERE, "run.log"), "w") as f:
        f.write("\n".join(log) + "\n")


if __name__ == "__main__":
    main(sys.argv[1])
