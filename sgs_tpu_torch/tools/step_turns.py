"""The flagship training CLI's rate in two checkouts, in turns, and the cost
of the trainers' network-viewer hook, on the card.

    python -m sgs_tpu_torch.tools.step_turns <parent checkout> <checkout>

(1) `chip_smoke.py`'s phase 5 training run (the flagship from a JAX-format
checkpoint at iteration 29,990), lengthened to 100 steps, in each
checkout's own process in turns A B B A A B B A; (2) in the second
checkout, one process, the same run with the trainers'
`viewer.network_gui.serve` as it is (no listener: one `None` check an
iteration) and replaced by a no-op, in turns. Prints each run's
`Trained ...` line (the trainer's rate over its loop) and the call's wall.
It drives each checkout's own `chip_smoke.py`, so an older checkout works
as long as its phase 5 does; (2) needs a checkout that has the viewer.
"""

from __future__ import annotations

import subprocess
import sys

STEPS = 100
TURNS = (0, 1, 1, 0, 0, 1, 1, 0)
SERVE_TURNS = (True, False, False, True, True, False, False, True)

_RUN = r'''
import re, sys, time, torch
import chip_smoke as cs
cs.TRAIN_TO = cs.TRAIN_FROM + {steps}
cs.phase_device()
cs.build.build_all(list(cs.KERNELS))
dev = torch.device("cuda")
out = []
real = cs.run_cli
def spy(fn, argv):
    text = real(fn, argv)
    out.append(text)
    return text
cs.run_cli = spy
def one(label):
    model = cs.flagship_model(dev)
    t0 = time.perf_counter()
    cs.phase_train_flagship(dev, model)
    wall = time.perf_counter() - t0
    rate = [re.sub(r" \[\d\d/\d\d \d\d:\d\d:\d\d\]$", "", ln) for ln in out[-1].splitlines()
            if ln.startswith("Trained ")]
    print("TURN", label, rate, f"call {{wall:.3f}} s", flush=True)
if sys.argv[2] == "cli":
    one(sys.argv[1])
else:
    from sgs_tpu_torch.viewer import network_gui
    serve = network_gui.serve
    for with_serve in {serve_turns}:
        network_gui.serve = serve if with_serve else (lambda *a, **k: None)
        one("serve" if with_serve else "no-op")
'''


def run(tree: str, mode: str) -> None:
    code = _RUN.format(steps=STEPS, serve_turns=SERVE_TURNS)
    res = subprocess.run([sys.executable, "-c", code, tree, mode], cwd=tree, capture_output=True, text=True)
    print("\n".join(ln for ln in res.stdout.splitlines() if ln.startswith(("TURN", "[1 device]"))),
          flush=True)
    if res.returncode:
        raise SystemExit(f"{tree} ({mode}) failed:\n{res.stderr[-3000:]}")


def main(argv=None) -> None:
    trees = list(sys.argv[1:] if argv is None else argv)
    if len(trees) != 2:
        raise SystemExit("usage: python -m sgs_tpu_torch.tools.step_turns <parent checkout> <checkout>")
    for t in TURNS:
        run(trees[t], "cli")
    run(trees[1], "serve")


if __name__ == "__main__":
    main()
