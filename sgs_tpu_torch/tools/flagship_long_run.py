"""The flagship's full training schedule through the port's train CLI,
beside the JAX package's run of the same schedule.

    python -m sgs_tpu_torch.tools.flagship_long_run [--out DIR] [--seed N] [--json FILE]

Runs `python -m sgs_tpu_torch.train -s data/flagship800 --eval` in this
process with `runs/flagship_r5`'s configuration (cfg_args: SH degree 3, a
black background, `-r -1`; opt_args: `--iterations 15000
--densify_until_iter 7500 --position_lr_max_steps 15000`), test reports at
7000, 10000 and 15000, and a PLY and a checkpoint at 15000 only, written
to `--out` (by default a new directory under the temporary directory).
Then:

- prints each report's test and train L1 and PSNR and Gaussian count
  beside JAX's, the guard's firings (the iterations whose gradient had
  non-finite elements zeroed), it/s by the trainer's `Trained` line, the
  wall time and the peak device memory;
- reloads the last checkpoint through the CLI's `--start_checkpoint` and
  takes one step past it, the last iteration, so with no update: its test
  report must equal the last report of the run;
- holds the checkpoint's keys, shapes past the pool dimension and dtypes
  to JAX's `chkpnt15000.npz`;
- judges the bars: test PSNR at the second and third reports within
  `PSNR_BAR_DB` of JAX's, and the Gaussian count there within
  `COUNT_BAR` of JAX's.

`--report CKPT [CKPT ...]` trains nothing: it prints each checkpoint's
test report through the trainer's own `training_report` (JAX's
`runs/flagship_r5/chkpnt*.npz` load as they are), one JSON line.

The two runs share the initial points and the flags, not the random bits:
the port's densify draws from a `torch.Generator` and `--seed` seeds it
and the camera order. JAX's numbers are constants here because `runs/`
is not copied to the card's machine; `tests/test_torch_flagship_long_run.py`
holds them to `runs/flagship_r5/losses.tsv`, `runs/flagship_r5.log` and
`runs/flagship_r5/chkpnt15000.npz`. Reports are paired with JAX's in
order, so a short run with three `--test_iterations` (arguments the tool
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
JAX_CHECKPOINT = {
    **{f"{kind}_{f}": (shape, "float32") for f, shape in _POOL.items() for kind in ("param", "adam_mu", "adam_nu")},
    **{f"adam_step_{f}": (None, "int32") for f in _POOL},
    "alive": ((), "bool"), "xyz_gradient_accum": ((1,), "float32"), "denom": ((1,), "float32"),
    "max_radii2d": ((), "float32"), "iteration": (None, "int64"), "active_sh_degree": (None, "int64"),
    "max_sh_degree": (None, "int64"), "spatial_lr_scale": (None, "float64"),
}
PSNR_BAR_DB = 0.5
COUNT_BAR = 0.10
BARRED = (1, 2)  # the reports the bars apply to: 10000 and 15000

STAMP = re.compile(r" \[\d\d/\d\d \d\d:\d\d:\d\d\]$")
REPORT = re.compile(r"\[ITER (\d+)\] Evaluating (test|train): L1 (\S+) PSNR (\S+)")
COUNT = re.compile(r"# of Gaussians: (\d+)")
GUARD = re.compile(r"\[ITER (\d+)\] WARNING: (\d+) non-finite gradient elements zeroed")
TRAINED = re.compile(r"Trained (\d+) iterations in (\S+)s \((\S+) it/s\)")


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
    gaussians}}, the guard's [(iteration, elements)] and the `Trained` line."""
    reports: dict = {}
    guard, trained = [], None
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
        m = TRAINED.search(ln)
        if m:
            trained = {"iterations": int(m.group(1)), "seconds": float(m.group(2)),
                       "it_per_s": float(m.group(3))}
    return {"reports": reports, "guard": guard, "trained": trained}


def compare(reports: dict) -> dict:
    """The run's reports against JAX's, paired in order, and the bars."""
    ours, theirs = sorted(reports), sorted(JAX_REPORTS)
    if len(ours) != len(theirs):
        raise ValueError(f"{len(ours)} reports, JAX has {len(theirs)}")
    rows, ok = [], True
    for k, (it, jit) in enumerate(zip(ours, theirs)):
        r = reports[it]
        j_l1, j_psnr, j_tl1, j_tpsnr, j_n = JAX_REPORTS[jit]
        row = {"iteration": it, "jax_iteration": jit, **r,
               "jax_test_l1": j_l1, "jax_test_psnr": j_psnr, "jax_train_l1": j_tl1,
               "jax_train_psnr": j_tpsnr, "jax_gaussians": j_n,
               "d_test_psnr": r["test_psnr"] - j_psnr, "count_ratio": r["gaussians"] / j_n}
        if k in BARRED:
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


def report_checkpoints(paths, scene: str, device: str) -> list:
    """[{checkpoint, iteration, test_l1, test_psnr, gaussians}] of each
    checkpoint's test views through `trainer.training_report`."""
    from sgs_tpu_torch.data.scene import Scene
    from sgs_tpu_torch.train import checkpoint as ckpt
    from sgs_tpu_torch.train.trainer import training_report
    from sgs_tpu_torch.utils.config import ModelParams

    class TestViews:  # the report's scene: its test views only
        def __init__(self, views):
            self.views = views

        def getTestCameras(self):
            return self.views

        def getTrainCameras(self):
            return []

    views = Scene(ModelParams(sh_degree=3, source_path=scene, model_path="", resolution=-1, eval=True),
                  shuffle=False, device=device).getTestCameras()
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scene", default=str(SCENE))
    p.add_argument("--out", default=None, help="model directory (default: a new temporary one)")
    p.add_argument("--iterations", type=int, default=ITERATIONS)
    p.add_argument("--densify_until_iter", type=int, default=DENSIFY_UNTIL)
    p.add_argument("--test_iterations", type=int, nargs="+", default=list(TEST_ITERATIONS))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", default=None, help="also write the result here")
    p.add_argument("--report", nargs="+", default=None, metavar="CKPT",
                   help="only report these checkpoints' test views")
    return p


def main(argv=None) -> dict:
    args, extra = build_parser().parse_known_args(argv)
    if args.report:
        result = {"reports": report_checkpoints(args.report, args.scene, args.device)}
        print(json.dumps(result))
        return result
    dev = torch.device(args.device)
    out = Path(args.out or tempfile.mkdtemp(prefix="flagship_long_run_"))
    last = args.iterations
    common = ["-s", args.scene, *CFG_ARGS, "--device", args.device, *extra]
    argv_run = [*common, "-m", out, "--iterations", last,
                "--densify_until_iter", args.densify_until_iter,
                "--position_lr_max_steps", last,
                "--test_iterations", *args.test_iterations, "--save_iterations", last,
                "--checkpoint_iterations", last, "--seed", args.seed]
    smi = device_line(dev)
    print(f"[long run] device: {smi}; model directory {out}", flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    log = run_train(argv_run)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    parsed = parse_log(log)
    (out / "train.log").write_text(log)
    cmp = compare(parsed["reports"])

    ckpt = out / f"chkpnt{last}.npz"
    bad_layout = layout_mismatches(checkpoint_layout(str(ckpt)))
    reload_dir = out / "reload"
    reloaded = parse_log(run_train([*common, "-m", reload_dir, "--start_checkpoint", ckpt,
                                    "--iterations", last + 1, "--test_iterations", last + 1,
                                    "--checkpoint_iterations", -1, "--seed", args.seed]))
    again = reloaded["reports"].get(last + 1, {})
    final = parsed["reports"][max(parsed["reports"])]
    reload_equal = all(again.get(k) == final.get(k) for k in ("test_l1", "test_psnr", "gaussians"))

    for row in cmp["rows"]:
        print(f"[long run] iteration {row['iteration']} (JAX {row['jax_iteration']}): "
              f"test PSNR {row['test_psnr']:.4f} (JAX {row['jax_test_psnr']:.4f}, "
              f"d {row['d_test_psnr']:+.4f}), test L1 {row['test_l1']:.5f} (JAX {row['jax_test_l1']:.5f}), "
              f"train PSNR {row['train_psnr']:.4f} (JAX {row['jax_train_psnr']:.4f}), "
              f"Gaussians {row['gaussians']} (JAX {row['jax_gaussians']}, x{row['count_ratio']:.4f})"
              + (f" psnr_ok={row['psnr_ok']} count_ok={row['count_ok']}" if "psnr_ok" in row else ""))
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
        "device": smi, "seed": args.seed, "iterations": last, "wall_s": wall,
        "peak_device_bytes": peak, "trained": trained, "reports": cmp["rows"],
        "bars_met": cmp["bars_met"], "guard": parsed["guard"],
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
