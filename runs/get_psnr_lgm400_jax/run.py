"""The JAX package's get_psnr.py on the committed LGM snapshot, both routes.

    JAX_PLATFORMS=cpu python runs/get_psnr_lgm400_jax/run.py <workdir>

Writes the two inputs from assets/lgm/point_cloud.ply with the JAX package
(<workdir>/vec.npy by `sgs_tpu.models.vectorized.vectorized`, shape
columns then appearance columns; <workdir>/snapshot.npz by
`sgs_tpu.train.checkpoint.save_checkpoint`, the snapshot in a fresh pool
with Adam zeroed at iteration 3000), then runs

    python get_psnr.py -s data/lgm400 -m <workdir>/<route> --eval --sh_degree 0
        --start_checkpoint <input>

for the two routes side by side, and writes the commands, their output and
each route's losses.tsv beside this script (run.log, vec/losses.tsv,
npz/losses.tsv). get_psnr.py renders every view with the O(N*P) oracle
(`training_report`'s default mode "reference").
"""

import os
import platform
import shutil
import subprocess
import sys
import time
from datetime import datetime, timezone

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)

PLY = "assets/lgm/point_cloud.ply"
ITERATION = 3000
SH_DEGREE = 0


def write_inputs(work: str) -> dict:
    import jax

    from sgs_tpu.data.ply import load_gaussian_ply
    from sgs_tpu.data.scene import pool_from_arrays
    from sgs_tpu.models.gaussians import DensifyStats
    from sgs_tpu.models.vectorized import vectorized
    from sgs_tpu.train.checkpoint import save_checkpoint
    from sgs_tpu.train.loop import TrainState
    from sgs_tpu.train.optim import AdamState

    pool = pool_from_arrays(load_gaussian_ply(os.path.join(REPO, PLY), SH_DEGREE), SH_DEGREE)
    shape_p, app_p = vectorized(pool)
    vec = os.path.join(work, "vec.npy")
    np.save(vec, np.concatenate([shape_p, app_p], axis=1))
    npz = os.path.join(work, "snapshot.npz")
    state = TrainState(pool=pool, adam=AdamState.init(pool.params()),
                       stats=DensifyStats.zeros(pool.capacity))
    save_checkpoint(npz, state, ITERATION, SH_DEGREE, 1.0)
    return {"vec": vec, "npz": npz, "jax": jax.__version__,
            "vec_shape": np.load(vec).shape, "capacity": pool.capacity}


def main(work: str) -> None:
    os.makedirs(work, exist_ok=True)
    inputs = write_inputs(work)
    commit = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=REPO, capture_output=True,
                            text=True).stdout.strip()
    log = [f"# {datetime.now(timezone.utc).strftime('%Y-%m-%dT%H:%M:%SZ')} python "
           f"{platform.python_version()} jax {inputs['jax']} numpy {np.__version__} on "
           f"{os.cpu_count()} CPU cores, commit {commit}",
           f"# inputs from {PLY}: <vec> = vectorized(pool) as one {inputs['vec_shape']} array; "
           f"<npz> = save_checkpoint of the pool (capacity {inputs['capacity']}), iteration "
           f"{ITERATION}, active_sh_degree {SH_DEGREE}"]
    procs = {}
    for route in ("vec", "npz"):
        out = os.path.join(work, route)
        cmd = [sys.executable, "get_psnr.py", "-s", "data/lgm400", "-m", out, "--eval",
               "--sh_degree", str(SH_DEGREE), "--start_checkpoint", inputs[route]]
        logf = open(os.path.join(work, f"{route}.log"), "w")
        procs[route] = (cmd, logf, time.perf_counter(),
                        subprocess.Popen(cmd, cwd=REPO, stdout=logf, stderr=subprocess.STDOUT))
    for route, (cmd, logf, t0, p) in procs.items():
        _, status, usage = os.wait4(p.pid, 0)
        p.returncode = os.waitstatus_to_exitcode(status)
        wall = time.perf_counter() - t0
        logf.close()
        log.append("$ python " + " ".join(cmd[1:]).replace(work, "<work>"))
        with open(os.path.join(work, f"{route}.log")) as f:
            log += [ln.rstrip("\n") for ln in f if ln.strip()]
        log.append(f"  [rc {p.returncode}, {wall:.1f} s, max RSS {usage.ru_maxrss // 1024} MB]")
        os.makedirs(os.path.join(HERE, route), exist_ok=True)
        shutil.copyfile(os.path.join(work, route, "losses.tsv"), os.path.join(HERE, route, "losses.tsv"))
    with open(os.path.join(HERE, "run.log"), "w") as f:
        f.write("\n".join(log) + "\n")


if __name__ == "__main__":
    main(os.path.abspath(sys.argv[1]))
