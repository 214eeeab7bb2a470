"""Kernel K: a gather's cost by the layout of its source. Port of
`scripts/exp_gather_layout.py`.

    python -m sgs_tpu_torch.tools.exp_gather_layout [--out-rows R --src S --device cuda]

Makes the script's inputs (`tools/gather_inputs.py::layout_inputs`, seed
0: OUT_ROWS ids, then a (SRC, 16) and a (SRC, 8) f32 table) and, for each
width, holds the table field-major (strides (1, SRC)), the counterpart of
the compact {0,1} layout XLA picks for narrow arrays it owns. It times in
device ms (`tools/ssim_times.py::time_ms`, "not measured" on the CPU), as
the script does: the gather `t[idx]` (`torch.index_select`) from the
field-major table ("xla-native"); Kernel K's row-major copy then the
gather ("pallas+gather"); and Kernel K alone. Then Kernel K's max |err|
against its plain version from both layouts, and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import sys

from sgs_tpu_torch.core.device import resolve_device
from sgs_tpu_torch.ops import build, gather
from sgs_tpu_torch.tools import exp_scene, gather_inputs


def _diff(a, b) -> str:
    return "not measured" if a is None or b is None else f"{a - b:.4f}"


def run(dev, out_rows: int = gather.OUT_ROWS, src: int = gather.SRC) -> dict:
    idx, tables = gather_inputs.layout_inputs(out_rows, src, device=dev)
    res = {"idx": idx, "tables": tables, "widths": {}}
    for rec in gather.WIDTHS:
        t = gather.field_major(tables[rec])
        x_ms = exp_scene.device_ms(lambda: gather_inputs.layout_gather(t, idx), dev)
        p_ms = exp_scene.device_ms(lambda: gather_inputs.layout_gather(gather.layout_identity(t), idx), dev)
        i_ms = exp_scene.device_ms(lambda: gather.layout_identity(t), dev)
        err = max(float((gather.layout_identity(x) - gather.layout_identity_plain(x)).abs().max())
                  for x in (t, tables[rec]))
        print(f"rec={rec:2d}: xla-native {exp_scene.fmt_ms(x_ms)} | pallas+gather {exp_scene.fmt_ms(p_ms)} "
              f"(ident alone {exp_scene.fmt_ms(i_ms)} -> gather ~{_diff(p_ms, i_ms)})", flush=True)
        print(f"    Kernel K against its plain version (field-major and row-major source): "
              f"max |err| {err:.2e}", flush=True)
        res["widths"][rec] = {"field_major": t, "xla_ms": x_ms, "pallas_gather_ms": p_ms,
                              "ident_ms": i_ms, "err": err}
    print(exp_scene.card_line(), flush=True)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Kernel K: gather cost by source layout")
    ap.add_argument("--out-rows", type=int, default=gather.OUT_ROWS)
    ap.add_argument("--src", type=int, default=gather.SRC)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(None if argv is None else [str(a) for a in argv])
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        build.build_all([gather.KERNEL])
    return run(dev, args.out_rows, args.src)


if __name__ == "__main__":
    main(sys.argv[1:])
