"""The flagship's full training schedule through the port's train CLI,
beside the JAX package's run of the same schedule.

    python -m sgs_tpu_torch.tools.flagship_long_run [--start S] [--reduction R]
        [--out DIR] [--seed N] [--json FILE]

Runs `python -m sgs_tpu_torch.train -s data/flagship800 --eval` in this
process with `runs/flagship_r5`'s configuration (cfg_args: SH degree 3, a
black background, `-r -1`; opt_args: `--iterations 15000
--densify_until_iter 7500 --position_lr_max_steps 15000`), test reports at
7000, 10000 and 15000, and a PLY and a checkpoint at 15000, written to
`--out` (by default a new directory under the temporary directory).

JAX's reference run was not one run of that schedule
(`assets/flagship/README.md`): it stopped at 3,000, and its PLY there
(written before that iteration's densify and opacity reset) became
`runs/resume3000.npz` through `scripts/make_resume_ckpt.py` (fresh Adam,
zero statistics), from which it ran 3,001-15,000. `--start` says where the
port starts:

- `points3d` (the default): iteration 0 from the scene's points3d.ply, the
  schedule without a break (the reset at 3,000 included);
- `resume3000`: JAX's `runs/resume3000.npz` (the like-for-like run);
- `chkpnt10000`: JAX's `runs/flagship_r5/chkpnt10000.npz`, reports at
  13000 and 15000 (JAX's 13,000 numbers are its checkpoint's, through the
  port's report);
- `jax_procedure`: JAX's procedure replayed: 3,000 iterations from
  points3d.ply with the PLY at 3,000, a checkpoint rebuilt from that PLY
  (`tools/resume_from_ply.py`), then the resume to 15,000.

`runs/` is not copied to the card's machine: `--pack_starts` writes the
two JAX start states, their alive rows only, compressed, to
`checkout/starts/` (ignored by git), and the tool reads a start from
`runs/` when it is there and from `checkout/starts/` otherwise.

`--reduction jax_prefix` trains with the JAX package's per-Gaussian
gradient reduction in place of Kernel C's (`tools/jax_reduction.py`): a
measurement of what that arithmetic does to training, not the port's path.

After the run the tool prints each report's test and train L1 and PSNR and
Gaussian count beside JAX's, the guard's firings, the densify counts
(the trainer's `densify:` lines, summed per window between reports), it/s
by the trainer's `Trained` line, the wall time and the peak device memory.
At each report it also loads the state there (a checkpoint written at the
report and removed after) and prints per field, beside the same numbers of
JAX's checkpoint at that iteration (`JAX_STATS`): the mean |change| of the
parameters since the start state (over slots alive at both), the mean Adam
nu of the alive slots, the shares of opacities above 0.5 and below 0.005,
the median of the largest scale, the alive count and the per-view test
PSNR; then the statistic that departs from JAX's the most at the first
report where any departs by more than `DEPART` (relative). Then it
reloads the last checkpoint through the CLI's `--start_checkpoint` and
takes one step past it (the last iteration, so no update): its report
must equal the run's last; holds the checkpoint's layout to JAX's; and
judges the bars: test PSNR within `PSNR_BAR_DB` of JAX's at the barred
reports (10000 and 15000; 15000 for `chkpnt10000`) and the count there
within `COUNT_BAR`.

`--report CKPT [CKPT ...]` trains nothing: it prints each checkpoint's
test report through the trainer's own `training_report` (JAX's
`runs/flagship_r5/chkpnt*.npz` load as they are), one JSON line.

The runs share the initial points and the flags, not the random bits:
the port's densify draws from a `torch.Generator` and `--seed` seeds it
and the camera order. JAX's numbers are constants here because `runs/`
is not copied to the card's machine; `tests/test_torch_flagship_long_run.py`
holds them to `runs/flagship_r5/losses.tsv`, `runs/flagship_r5.log`, the
checkpoints and `runs/resume3000.npz`. Reports are paired with JAX's in
order, so a short run with as many `--test_iterations` (arguments the tool
does not know go to the train CLI, e.g. `--device cpu`) exercises the
same parsing and comparison. The last line printed is one JSON object of
everything measured, also written to `--json`.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
SCENE = ROOT / "data" / "flagship800"

# runs/flagship_r5/cfg_args and opt_args (the flags that differ from the CLI's defaults)
CFG_ARGS = ["--sh_degree", "3", "-r", "-1", "--eval"]
ITERATIONS = 15000
DENSIFY_UNTIL = 7500
TEST_ITERATIONS = (7000, 10000, 15000)
RESUME_ITERATION = 3000

# runs/flagship_r5.log: (test L1, test PSNR, train L1, train PSNR, Gaussians) per report
JAX_REPORTS = {
    7000: (0.053467267483938485, 25.246003031730652, 0.007162733562290668, 35.67732315063476, 157379),
    10000: (0.044475023285485804, 28.60275411605835, 0.0031199111882597207, 38.71206604003906, 161809),
    15000: (0.045198182051535696, 28.607290506362915, 0.002859825249761343, 39.27986740112305, 161809),
}
# runs/flagship_r5.log: the iterations of the guard's warnings
JAX_GUARD_ITERS = (
    13083, 13243, 13547, 13645, 13818, 13861, 13886, 13910, 14004, 14074, 14105, 14119, 14193,
    14271, 14355, 14369, 14379, 14382, 14439, 14458, 14570, 14639, 14649, 14670, 14703, 14706,
    14707, 14745, 14761, 14763, 14848, 14849, 14853, 14857, 14867, 14892, 14902, 14932, 14986,
)
# runs/flagship_r5/chkpnt15000.npz: key -> (shape past the pool dimension, dtype); None: a scalar
_POOL = {
    "xyz": (3,), "features_dc": (1, 3), "features_rest": (15, 3), "scaling": (3,), "rotation": (4,),
    "opacity": (1,),
}
FIELDS = tuple(_POOL)
JAX_CHECKPOINT = {
    **{f"{kind}_{f}": (shape, "float32") for f, shape in _POOL.items() for kind in ("param", "adam_mu", "adam_nu")},
    **{f"adam_step_{f}": (None, "int32") for f in _POOL},
    "alive": ((), "bool"), "xyz_gradient_accum": ((1,), "float32"), "denom": ((1,), "float32"),
    "max_radii2d": ((), "float32"), "iteration": (None, "int64"), "active_sh_degree": (None, "int64"),
    "max_sh_degree": (None, "int64"), "spatial_lr_scale": (None, "float64"),
}
# state_stats of JAX's states (runs/resume3000.npz, runs/flagship_r5/chkpnt*.npz); "d_<field>"
# is keyed by the start state it is measured from; per-view test PSNR through the port's
# training_report on the CPU (tiled)
JAX_STATS = {
    3000: {
        "alive": 114488,
        "test_psnr": 30.51258945465088,
        "test_l1": 0.019811082805972546,
        "opacity_over_half": 0.6318129410942631,
        "opacity_under_min": 0.0010830829431905528,
        "median_max_scale": 0.02503035927146665,
        "nu_xyz": 0.0,
        "nu_features_dc": 0.0,
        "nu_features_rest": 0.0,
        "nu_scaling": 0.0,
        "nu_rotation": 0.0,
        "nu_opacity": 0.0,
        "d_xyz": {"resume3000": 0.0},
        "d_features_dc": {"resume3000": 0.0},
        "d_features_rest": {"resume3000": 0.0},
        "d_scaling": {"resume3000": 0.0},
        "d_rotation": {"resume3000": 0.0},
        "d_opacity": {"resume3000": 0.0},
        "test_psnr_per_view": [20.129779815673828, 36.54651641845703, 23.36329460144043, 36.2047004699707, 21.38035011291504, 36.261802673339844, 33.6103515625, 36.603919982910156],
    },
    7000: {
        "alive": 158303,
        "test_psnr": 25.269001483917236,
        "test_l1": 0.04616416268981993,
        "opacity_over_half": 0.5102682829763175,
        "opacity_under_min": 0.0,
        "median_max_scale": 0.02228768598355708,
        "nu_xyz": 1.6616169923642744e-09,
        "nu_features_dc": 4.928329296494192e-11,
        "nu_features_rest": 4.928328873318493e-11,
        "nu_scaling": 4.4924621242373274e-11,
        "nu_rotation": 1.4322524241094946e-09,
        "nu_opacity": 3.298062743572978e-13,
        "d_xyz": {"resume3000": 0.1634136677644639},
        "d_features_dc": {"resume3000": 0.22885790082183724},
        "d_features_rest": {"resume3000": 0.011464527180581314},
        "d_scaling": {"resume3000": 0.4349679049046848},
        "d_rotation": {"resume3000": 0.059414839164637995},
        "d_opacity": {"resume3000": 5.639964486464616},
        "test_psnr_per_view": [15.58000373840332, 32.0731315612793, 13.754337310791016, 31.581422805786133, 20.772560119628906, 29.343690872192383, 22.89238166809082, 36.154483795166016],
    },
    10000: {
        "alive": 161809,
        "test_psnr": 28.603107690811157,
        "test_l1": 0.04447513463674113,
        "opacity_over_half": 0.5485479794078203,
        "opacity_under_min": 0.011383792001680994,
        "median_max_scale": 0.021843657563969516,
        "nu_xyz": 1.0988400520347015e-09,
        "nu_features_dc": 1.815443289600825e-10,
        "nu_features_rest": 1.8154433281089042e-10,
        "nu_scaling": 1.2819259001468953e-11,
        "nu_rotation": 2.9738750854883933e-10,
        "nu_opacity": 1.5388553527691392e-13,
        "d_xyz": {"resume3000": 0.16453208952106727, "chkpnt10000": 0.0},
        "d_features_dc": {"resume3000": 0.25673761996419986, "chkpnt10000": 0.0},
        "d_features_rest": {"resume3000": 0.01466006528137759, "chkpnt10000": 0.0},
        "d_scaling": {"resume3000": 0.4663297858281371, "chkpnt10000": 0.0},
        "d_rotation": {"resume3000": 0.06270822773394363, "chkpnt10000": 0.0},
        "d_opacity": {"resume3000": 5.3683552034337385, "chkpnt10000": 0.0},
        "test_psnr_per_view": [13.320711135864258, 38.39297866821289, 13.356964111328125, 38.305946350097656, 28.146556854248047, 38.329246520996094, 20.381256103515625, 38.59120178222656],
    },
    13000: {
        "alive": 161809,
        "test_psnr": 28.349860548973083,
        "test_l1": 0.04675412335200235,
        "opacity_over_half": 0.5838117780840374,
        "opacity_under_min": 0.02460926153675012,
        "median_max_scale": 0.021766228155492864,
        "nu_xyz": 7.451736790412596e-10,
        "nu_features_dc": 2.3074321529935692e-10,
        "nu_features_rest": 2.3074320360413425e-10,
        "nu_scaling": 1.9246564386561422e-11,
        "nu_rotation": 2.108610152811603e-10,
        "nu_opacity": 6.875834151556453e-14,
        "d_xyz": {"resume3000": 0.16483241565289777, "chkpnt10000": 0.000979726705134362},
        "d_features_dc": {"resume3000": 0.28091024219987754, "chkpnt10000": 0.06323390304735871},
        "d_features_rest": {"resume3000": 0.017842936817372965, "chkpnt10000": 0.006957162992489433},
        "d_scaling": {"resume3000": 0.5181181322421691, "chkpnt10000": 0.12194418732154108},
        "d_rotation": {"resume3000": 0.0684227710384101, "chkpnt10000": 0.02000890499741207},
        "d_opacity": {"resume3000": 5.240248020916964, "chkpnt10000": 1.053207956876592},
        "test_psnr_per_view": [13.25303840637207, 38.81950378417969, 12.654105186462402, 38.66023254394531, 24.287944793701172, 38.75901794433594, 21.459386825561523, 38.90565490722656],
    },
    15000: {
        "alive": 161809,
        "test_psnr": 28.607102870941162,
        "test_l1": 0.04519830926437862,
        "opacity_over_half": 0.600862745582755,
        "opacity_under_min": 0.03626497908027366,
        "median_max_scale": 0.021612232981817494,
        "nu_xyz": 6.367756263617271e-10,
        "nu_features_dc": 2.678899825912937e-10,
        "nu_features_rest": 2.67889991296994e-10,
        "nu_scaling": 3.0185972762713174e-12,
        "nu_rotation": 1.4328278508362888e-10,
        "nu_opacity": 5.935814506865848e-14,
        "d_xyz": {"resume3000": 0.16493215557873156, "chkpnt10000": 0.001260679287776236},
        "d_features_dc": {"resume3000": 0.2941864908703522, "chkpnt10000": 0.09197961032801572},
        "d_features_rest": {"resume3000": 0.019828733329882723, "chkpnt10000": 0.010587849238999789},
        "d_scaling": {"resume3000": 0.566270372041832, "chkpnt10000": 0.19872293679105},
        "d_rotation": {"resume3000": 0.07516266526003838, "chkpnt10000": 0.03265473434533308},
        "d_opacity": {"resume3000": 5.212334438081675, "chkpnt10000": 1.663061935603416},
        "test_psnr_per_view": [13.52629280090332, 38.948890686035156, 12.423234939575195, 38.889976501464844, 24.582111358642578, 38.978004455566406, 22.536182403564453, 38.972129821777344],
    },
}
PSNR_BAR_DB = 0.5
COUNT_BAR = 0.10
DEPART = 0.10
STARTS = ("points3d", "resume3000", "chkpnt10000", "jax_procedure")
START_FILES = {"resume3000": ROOT / "runs" / "resume3000.npz",
               "chkpnt10000": ROOT / "runs" / "flagship_r5" / "chkpnt10000.npz"}
PACKED_DIR = ROOT / "checkout" / "starts"
# per start: the JAX iterations its reports pair with, and which of them the bars apply to
START_REPORTS = {"points3d": (TEST_ITERATIONS, (1, 2)), "resume3000": (TEST_ITERATIONS, (1, 2)),
                 "jax_procedure": (TEST_ITERATIONS, (1, 2)), "chkpnt10000": ((13000, 15000), (1,))}

STAMP = re.compile(r" \[\d\d/\d\d \d\d:\d\d:\d\d\]$")
REPORT = re.compile(r"\[ITER (\d+)\] Evaluating (test|train): L1 (\S+) PSNR (\S+)")
COUNT = re.compile(r"# of Gaussians: (\d+)")
GUARD = re.compile(r"\[ITER (\d+)\] WARNING: (\d+) non-finite gradient elements zeroed")
TRAINED = re.compile(r"Trained (\d+) iterations in (\S+)s \((\S+) it/s\)")
DENSIFY = re.compile(r"\[ITER (\d+)\] densify: (\d+) cloned, (\d+) split, (\d+) pruned, (\d+) alive")


class _Tee(io.TextIOBase):
    """Writes to a stream and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        self.out.write(s)
        return len(s)

    def flush(self):
        self.out.flush()


def run_train(argv) -> str:
    """The train CLI in this process; returns what it printed, stamps removed."""
    from sgs_tpu_torch.train.__main__ import main

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        main([str(a) for a in argv])
    return "\n".join(STAMP.sub("", ln) for ln in tee.buf.getvalue().split("\n"))


def parse_log(text: str) -> dict:
    """Reports {iteration: {test_l1, test_psnr, train_l1, train_psnr,
    gaussians}}, the guard's [(iteration, elements)], the densify steps
    [(iteration, cloned, split, pruned, alive)] and the `Trained` line."""
    reports: dict = {}
    guard, densify, trained = [], [], None
    lines = text.split("\n")
    for i, ln in enumerate(lines):
        m = REPORT.search(ln)
        if m:
            it, split = int(m.group(1)), m.group(2)
            r = reports.setdefault(it, {})
            r[f"{split}_l1"], r[f"{split}_psnr"] = float(m.group(3)), float(m.group(4))
            for nxt in lines[i + 1:i + 3]:
                c = COUNT.search(nxt)
                if c:
                    r["gaussians"] = int(c.group(1))
                    break
            continue
        m = GUARD.search(ln)
        if m:
            guard.append((int(m.group(1)), int(m.group(2))))
            continue
        m = DENSIFY.search(ln)
        if m:
            densify.append(tuple(int(g) for g in m.groups()))
            continue
        m = TRAINED.search(ln)
        if m:
            trained = {"iterations": int(m.group(1)), "seconds": float(m.group(2)),
                       "it_per_s": float(m.group(3))}
    return {"reports": reports, "guard": guard, "densify": densify, "trained": trained}


def jax_reference(iteration: int) -> tuple:
    """(test L1, test PSNR, train L1 or None, train PSNR or None,
    Gaussians) of JAX's run at `iteration`: its log's report, or its
    checkpoint's numbers in JAX_STATS."""
    if iteration in JAX_REPORTS:
        return JAX_REPORTS[iteration]
    s = JAX_STATS[iteration]
    return (s["test_l1"], s["test_psnr"], None, None, s["alive"])


def compare(reports: dict, jax_iterations, barred) -> dict:
    """The run's reports against JAX's, paired in order, and the bars."""
    ours, theirs = sorted(reports), sorted(jax_iterations)
    if len(ours) != len(theirs):
        raise ValueError(f"{len(ours)} reports, JAX has {len(theirs)}")
    rows, ok = [], True
    for k, (it, jit) in enumerate(zip(ours, theirs)):
        r = reports[it]
        j_l1, j_psnr, j_tl1, j_tpsnr, j_n = jax_reference(jit)
        row = {"iteration": it, "jax_iteration": jit, **r,
               "jax_test_l1": j_l1, "jax_test_psnr": j_psnr, "jax_train_l1": j_tl1,
               "jax_train_psnr": j_tpsnr, "jax_gaussians": j_n,
               "d_test_psnr": r["test_psnr"] - j_psnr, "count_ratio": r["gaussians"] / j_n}
        if k in barred:
            row["psnr_ok"] = abs(row["d_test_psnr"]) <= PSNR_BAR_DB
            row["count_ok"] = abs(row["count_ratio"] - 1.0) <= COUNT_BAR
            ok = ok and row["psnr_ok"] and row["count_ok"]
        rows.append(row)
    return {"rows": rows, "bars_met": ok}


def checkpoint_layout(path: str) -> dict:
    """Each key's shape past the pool dimension (None for a scalar) and dtype."""
    z = np.load(path, allow_pickle=False)
    return {k: (None if z[k].ndim == 0 else tuple(z[k].shape[1:]), str(z[k].dtype)) for k in z.files}


def layout_mismatches(layout: dict) -> list:
    want = {k: (None if s is None else tuple(s), d) for k, (s, d) in JAX_CHECKPOINT.items()}
    return [f"{k}: {layout.get(k)} != {want.get(k)}" for k in sorted(set(layout) | set(want))
            if layout.get(k) != want.get(k)]


def device_line(dev: torch.device) -> str:
    if dev.type != "cuda":
        return f"cpu (no card: {dev})"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


# ------------------------------------------------------------ state statistics

def state_stats(z, start=None) -> dict:
    """Statistics of a checkpoint's arrays (`z`, the npz layout): alive
    count; per field the mean Adam nu of the alive slots and, with a start
    state, the mean |param - start param| over slots alive in both; the
    shares of opacities above 0.5 and below 0.005; the median of each alive
    Gaussian's largest scale."""
    alive = np.asarray(z["alive"], bool)
    out = {"alive": int(alive.sum())}
    both = None
    if start is not None:
        n = min(alive.shape[0], start["alive"].shape[0])
        both = alive[:n] & np.asarray(start["alive"], bool)[:n]
    for f in FIELDS:
        out[f"nu_{f}"] = float(np.asarray(z[f"adam_nu_{f}"], np.float64)[alive].mean())
        if both is not None:
            n = both.shape[0]
            d = np.abs(np.asarray(z[f"param_{f}"][:n], np.float64) - np.asarray(start[f"param_{f}"][:n], np.float64))
            out[f"d_{f}"] = float(d[both].mean())
    op = 1.0 / (1.0 + np.exp(-np.asarray(z["param_opacity"], np.float64)[alive, 0]))
    out["opacity_over_half"] = float((op > 0.5).mean())
    out["opacity_under_min"] = float((op < 0.005).mean())
    out["median_max_scale"] = float(np.median(np.exp(np.asarray(z["param_scaling"], np.float64)[alive].max(axis=1))))
    return out


def per_view_psnr(path: str, scene: str, device: str) -> list:
    """Each test view's PSNR of a checkpoint through `training_report`'s
    render (tiled), in the scene's test order."""
    from sgs_tpu_torch.ops.ssim import l1_loss, psnr
    from sgs_tpu_torch.train import checkpoint as ckpt
    from sgs_tpu_torch.train.loop import eval_render

    views = test_views(scene, device)
    state, _, sh, _ = ckpt.load_checkpoint(path, device)
    bg = torch.zeros(3, device=torch.device(device))
    out = []
    for v in views:
        image = eval_render(state.model, v.camera, bg, sh, "tiled")
        gt = torch.clamp(v.gt_image, 0.0, 1.0)
        out.append((float(psnr(image, gt)), float(l1_loss(image, gt))))
    return out


_VIEWS: dict = {}


def test_views(scene: str, device: str) -> list:
    from sgs_tpu_torch.data.scene import Scene
    from sgs_tpu_torch.utils.config import ModelParams

    key = (scene, device)
    if key not in _VIEWS:
        _VIEWS[key] = Scene(ModelParams(sh_degree=3, source_path=scene, model_path="", resolution=-1,
                                        eval=True), shuffle=False, device=device).getTestCameras()
    return _VIEWS[key]


def first_departure(rows: list) -> dict | None:
    """The first report where a statistic departs from JAX's by more than
    DEPART (relative), with every statistic's departure there, largest first."""
    for row in rows:
        jax = row.get("jax_stats")
        if not jax:
            continue
        rel = {}
        for k, v in row["stats"].items():
            j = jax.get(k)
            if isinstance(j, (int, float)) and isinstance(v, (int, float)) and j != 0:
                rel[k] = abs(v - j) / abs(j)
        over = {k: r for k, r in rel.items() if r > DEPART}
        if over:
            return {"iteration": row["iteration"], "jax_iteration": row["jax_iteration"],
                    "departures": dict(sorted(rel.items(), key=lambda kv: -kv[1]))}
    return None


def jax_stats_at(iteration: int, base: str) -> dict | None:
    """JAX's statistics at `iteration`, its d_<field> from the start `base`."""
    s = JAX_STATS.get(iteration)
    if s is None:
        return None
    out = {k: v for k, v in s.items() if not k.startswith("d_")}
    for f in FIELDS:
        d = s.get(f"d_{f}", {}).get(base)
        if d is not None:
            out[f"d_{f}"] = d
    return out


# ------------------------------------------------------------------- starts

def pack_start(src: str, dst: str) -> None:
    """A start checkpoint's alive rows (and their slots), compressed."""
    z = np.load(src, allow_pickle=False)
    alive = np.asarray(z["alive"], bool)
    slots = np.nonzero(alive)[0].astype(np.int64)
    pool = {k for k in z.files if k.startswith(("param_", "adam_mu_", "adam_nu_"))} | {
        "xyz_gradient_accum", "denom", "max_radii2d"}
    arrays = {k: (z[k][slots] if k in pool else z[k]) for k in z.files if k != "alive"}
    Path(dst).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(dst, slots=slots, capacity=np.asarray(alive.shape[0]), **arrays)


def unpack_start(src: str, dst: str) -> None:
    """The checkpoint `pack_start` packed: dead slots get the pool's dead
    values and zero moments and statistics, as JAX's checkpoints hold."""
    from sgs_tpu_torch.models.gaussians import GaussianModel

    z = np.load(src, allow_pickle=False)
    slots, cap = z["slots"], int(z["capacity"])
    dead = GaussianModel.empty(1, int(z["max_sh_degree"]), "cpu")
    out = {}
    for k in z.files:
        if k in ("slots", "capacity"):
            continue
        v = z[k]
        if v.ndim == 0:
            out[k] = v
            continue
        if k.startswith("param_"):
            full = np.broadcast_to(getattr(dead, k[len("param_"):]).numpy(), (cap,) + v.shape[1:]).copy()
        else:
            full = np.zeros((cap,) + v.shape[1:], v.dtype)
        full[slots] = v
        out[k] = full
    alive = np.zeros(cap, bool)
    alive[slots] = True
    out["alive"] = alive
    np.savez(dst, **out)


def start_file(start: str, workdir: Path) -> str:
    """JAX's start checkpoint: from runs/ or unpacked from checkout/starts/."""
    src = START_FILES[start]
    if src.exists():
        return str(src)
    packed = PACKED_DIR / f"{start}.npz"
    if not packed.exists():
        raise FileNotFoundError(f"neither {src} nor {packed}: run --pack_starts where runs/ is")
    dst = workdir / f"{start}.npz"
    unpack_start(str(packed), str(dst))
    return str(dst)


# --------------------------------------------------------------------- main

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scene", default=str(SCENE))
    p.add_argument("--out", default=None, help="model directory (default: a new temporary one)")
    p.add_argument("--start", choices=STARTS, default="points3d")
    p.add_argument("--reduction", choices=("kernel", "jax_prefix"), default="kernel")
    p.add_argument("--iterations", type=int, default=ITERATIONS)
    p.add_argument("--densify_until_iter", type=int, default=DENSIFY_UNTIL)
    p.add_argument("--test_iterations", type=int, nargs="+", default=None,
                   help="default: the start's JAX report iterations")
    p.add_argument("--resume_iteration", type=int, default=RESUME_ITERATION,
                   help="jax_procedure: where the PLY is taken and the run resumes")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", default=None, help="also write the result here")
    p.add_argument("--report", nargs="+", default=None, metavar="CKPT",
                   help="only report these checkpoints' test views")
    p.add_argument("--pack_starts", action="store_true",
                   help="only write the JAX start states to checkout/starts/")
    return p


def report_checkpoints(paths, scene: str, device: str) -> list:
    """[{checkpoint, iteration, test_l1, test_psnr, gaussians}] of each
    checkpoint's test views through `trainer.training_report`."""
    from sgs_tpu_torch.train import checkpoint as ckpt
    from sgs_tpu_torch.train.trainer import training_report

    class TestViews:  # the report's scene: its test views only
        def __init__(self, views):
            self.views = views

        def getTestCameras(self):
            return self.views

        def getTrainCameras(self):
            return []

    views = test_views(scene, device)
    bg = torch.zeros(3, device=torch.device(device))
    out = []
    for path in paths:
        state, iteration, sh, _ = ckpt.load_checkpoint(path, device)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            training_report(None, iteration, TestViews(views), state.model, sh, bg, mode="tiled")
        r = parse_log(buf.getvalue())["reports"][iteration]
        out.append({"checkpoint": str(path), "iteration": iteration, **r})
    return out


def densify_windows(densify: list, report_iters: list) -> list:
    """The densify counts summed over each window that ends at a report."""
    out, lo = [], 0
    for hi in report_iters:
        rows = [d for d in densify if lo < d[0] <= hi]
        out.append({"from": lo, "to": hi, "steps": len(rows),
                    "cloned": sum(d[1] for d in rows), "split": sum(d[2] for d in rows),
                    "pruned": sum(d[3] for d in rows)})
        lo = hi
    return out


def main(argv=None) -> dict:
    args, extra = build_parser().parse_known_args(argv)
    if args.pack_starts:
        for name, src in START_FILES.items():
            pack_start(str(src), str(PACKED_DIR / f"{name}.npz"))
            print(f"[long run] packed {src} -> {PACKED_DIR / f'{name}.npz'}")
        return {}
    if args.report:
        result = {"reports": report_checkpoints(args.report, args.scene, args.device)}
        print(json.dumps(result))
        return result
    dev = torch.device(args.device)
    out = Path(args.out or tempfile.mkdtemp(prefix="flagship_long_run_"))
    out.mkdir(parents=True, exist_ok=True)
    last = args.iterations
    jax_iters, barred = START_REPORTS[args.start]
    tests = list(args.test_iterations or jax_iters)
    common = ["-s", args.scene, *CFG_ARGS, "--device", args.device, *extra]
    schedule = ["--densify_until_iter", args.densify_until_iter, "--position_lr_max_steps", last,
                "--seed", args.seed]
    smi = device_line(dev)
    print(f"[long run] device: {smi}; start {args.start}; reduction {args.reduction}; "
          f"model directory {out}", flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reduction = contextlib.nullcontext()
    if args.reduction == "jax_prefix":
        from sgs_tpu_torch.tools.jax_reduction import use_jax_reduction
        reduction = use_jax_reduction()

    t0 = time.perf_counter()
    log_parts = []
    start_ckpt, base = None, None
    keep = [last]
    if args.start in ("resume3000", "chkpnt10000"):
        start_ckpt = start_file(args.start, out)
        base = args.start
    with reduction:
        if args.start == "jax_procedure":
            # JAX's rounds 3-4: the schedule stopped after iteration 3000's PLY
            # (written before that iteration's densify and reset)
            from sgs_tpu_torch.tools.resume_from_ply import make_resume_checkpoint

            r = args.resume_iteration
            first = out / "first"
            log_parts.append(run_train([*common, "-m", first, "--iterations", r + 1,
                                        "--test_iterations", -1, "--save_iterations", r,
                                        "--checkpoint_iterations", -1, *schedule]))
            start_ckpt = str(out / f"resume{r}.npz")
            info = make_resume_checkpoint(str(first / "point_cloud" / f"iteration_{r}" / "point_cloud.ply"),
                                          args.scene, r, start_ckpt, device="cpu")
            print(f"[long run] rebuilt {start_ckpt} from the PLY at {r}: {info}", flush=True)
            base = "resume3000"
        elif args.start == "points3d" and args.resume_iteration < min(tests):
            keep.append(args.resume_iteration)
        resume = ["--start_checkpoint", start_ckpt] if start_ckpt else []
        ckpt_iters = sorted(set(tests + keep))
        log_parts.append(run_train([*common, "-m", out, *resume, "--iterations", last,
                                    "--test_iterations", *tests, "--save_iterations", last,
                                    "--checkpoint_iterations", *ckpt_iters, *schedule]))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    log = "\n".join(log_parts)
    parsed = parse_log(log)
    (out / "train.log").write_text(log)
    cmp = compare(parsed["reports"], jax_iters, barred)

    # the state at each report beside JAX's
    if start_ckpt:
        start = np.load(start_ckpt)
    elif (out / f"chkpnt{args.resume_iteration}.npz").exists():
        start = np.load(out / f"chkpnt{args.resume_iteration}.npz")
        base = "resume3000"
    else:
        start = None
    for row in cmp["rows"]:
        path = out / f"chkpnt{row['iteration']}.npz"
        row["stats"] = state_stats(np.load(path), start)
        views = per_view_psnr(str(path), args.scene, args.device)
        row["stats"]["test_psnr_per_view"] = [p for p, _ in views]
        row["jax_stats"] = jax_stats_at(row["jax_iteration"], base)
    for it in sorted(set(ckpt_iters) - {last}):
        (out / f"chkpnt{it}.npz").unlink(missing_ok=True)

    ckpt = out / f"chkpnt{last}.npz"
    bad_layout = layout_mismatches(checkpoint_layout(str(ckpt)))
    reload_dir = out / "reload"
    reloaded = parse_log(run_train([*common, "-m", reload_dir, "--start_checkpoint", ckpt,
                                    "--iterations", last + 1, "--test_iterations", last + 1,
                                    "--checkpoint_iterations", -1, "--seed", args.seed]))
    again = reloaded["reports"].get(last + 1, {})
    final = parsed["reports"][max(parsed["reports"])]
    reload_equal = all(again.get(k) == final.get(k) for k in ("test_l1", "test_psnr", "gaussians"))

    windows = densify_windows(parsed["densify"], sorted(parsed["reports"]))
    for row, win in zip(cmp["rows"], windows):
        j_train = row["jax_train_psnr"]
        print(f"[long run] iteration {row['iteration']} (JAX {row['jax_iteration']}): "
              f"test PSNR {row['test_psnr']:.4f} (JAX {row['jax_test_psnr']:.4f}, "
              f"d {row['d_test_psnr']:+.4f}), test L1 {row['test_l1']:.5f} (JAX {row['jax_test_l1']:.5f}), "
              f"train PSNR {row['train_psnr']:.4f} (JAX "
              + ("-" if j_train is None else f"{j_train:.4f}")
              + f"), Gaussians {row['gaussians']} (JAX {row['jax_gaussians']}, x{row['count_ratio']:.4f})"
              + (f" psnr_ok={row['psnr_ok']} count_ok={row['count_ok']}" if "psnr_ok" in row else "")
              + f"; densify {win['from']}..{win['to']}: {win['steps']} steps, {win['cloned']} cloned, "
              f"{win['split']} split, {win['pruned']} pruned")
        jst = row["jax_stats"] or {}
        print(f"[long run]   state at {row['iteration']} (port | JAX): " + ", ".join(
            f"{k} {v:.6g} | " + (f"{jst[k]:.6g}" if isinstance(jst.get(k), (int, float)) else "-")
            for k, v in row["stats"].items() if k != "test_psnr_per_view"))
        print(f"[long run]   test PSNR per view (port | JAX): "
              + " ".join(f"{a:.3f}" for a in row["stats"]["test_psnr_per_view"]) + " | "
              + " ".join(f"{a:.3f}" for a in jst.get("test_psnr_per_view", [])))
    depart = first_departure(cmp["rows"])
    if depart:
        print(f"[long run] first departure from JAX's state (> {DEPART:.0%}): iteration "
              f"{depart['iteration']} (JAX {depart['jax_iteration']}): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in list(depart["departures"].items())[:8]))
    guard_iters = [it for it, _ in parsed["guard"]]
    print(f"[long run] guard: {len(guard_iters)} firings"
          + (f", iterations {guard_iters[0]}..{guard_iters[-1]}: {guard_iters}" if guard_iters else "")
          + f" (JAX {len(JAX_GUARD_ITERS)}, {JAX_GUARD_ITERS[0]}..{JAX_GUARD_ITERS[-1]})")
    trained = parsed["trained"] or {}
    print(f"[long run] {trained.get('iterations')} iterations at {trained.get('it_per_s')} it/s "
          f"(trainer's line, reports included), wall {wall:.1f} s, peak device memory "
          + (f"{peak / 2**30:.3f} GiB" if peak is not None else "not measured (no card)"))
    print(f"[long run] checkpoint {ckpt.name}: layout equal to JAX's: {not bad_layout} {bad_layout}; "
          f"reloaded and reported at {last + 1}: {again} equal: {reload_equal}")
    result = {
        "device": smi, "start": args.start, "reduction": args.reduction, "seed": args.seed,
        "iterations": last, "wall_s": wall, "peak_device_bytes": peak, "trained": trained,
        "reports": cmp["rows"], "bars_met": cmp["bars_met"], "guard": parsed["guard"],
        "densify_windows": windows, "first_departure": depart,
        "jax_guard_iterations": list(JAX_GUARD_ITERS), "checkpoint_layout_ok": not bad_layout,
        "checkpoint_layout_mismatches": bad_layout, "reload_report": again, "reload_equal": reload_equal,
        "model_dir": str(out),
    }
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    res = main(sys.argv[1:])
    sys.exit(0 if res.get("checkpoint_layout_ok", True) and res.get("reload_equal", True) else 1)
