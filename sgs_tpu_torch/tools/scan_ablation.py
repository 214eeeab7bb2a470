"""What each design choice of Kernels E and G (the chunk scans) and of
Kernel F's alpha path buys, on the card.

    python -m sgs_tpu_torch.tools.scan_ablation [--parent DIR] [--modes MODE ...]
        [--width W --height H --n N --seed S --device cuda]

Builds the scene of `tools/exp_scene.py` (1920x1080, 100,000 Gaussians)
and times every instantiation, E hs, mxu and nocp, G hs and mxu, F alpha
(8 and 1 state columns), outonly and empty (8), at krows 8 and 32, with
the committed `csrc/exp_forward.cu` and with variants of it, each with
one design choice undone by a text substitution, built into
`build/sgs_tpu_torch/ablation/`; for every instantiation:
- `no_prefetch`: each row fetched when it is walked, its copy's latency
  exposed, in place of the ring running up to krows - 1 rows ahead across
  the block's tiles;
- `no_dead_skip`: hs walks every warp of a walked row in full, in place
  of forming only t_run in a warp with no live pixel;
- `dead_skip_all`: that skip extended to nocp and mxu (left out of the
  committed kernel: it cost mxu about what it saves hs);
- `round_robin`: block b takes the schedule positions b, G + b, 2G + b,
  ... in place of the snake b, 2G - 1 - b, 2G + b, ...;
for F alpha (`ALPHA_VARIANTS`, timed on the F alpha rows only):
- `alpha_one_pixel`: one pixel a thread (256-thread blocks, no launch
  bound) in place of two that share dx, the conic a and b terms and the
  shared loads;
- `alpha_no_prescale`: the -0.5 applied per pair in place of -0.5 conic a
  and c formed once per row in the ring;
- `alpha_no_skip`: an exp for every pair, in place of the warp-uniform
  skip of records far from all of a warp's pixels;
- `alpha_unrolled`: the row's four passes of four groups unrolled as
  well, in place of a loop over the passes (the unrolled row overflows
  the instruction cache);
- `alpha_registers`: ptxas free to take more registers, in place of a
  launch bound of 5 blocks per SM;
- `alpha_pr10`: the alpha path of PR 10 (one pixel a thread, no
  prescale, no skip, no launch bound, and the 64 alphas of a row formed
  one by one and then summed by `tree_sum`);
and, with `--parent DIR`, the `exp_forward.cu` of another checkout (an
earlier design with the same launcher). Committed and variant alternate
(committed, variant, variant, committed), in device ms
(`tools/ssim_times.py::time_ms`). The variants must give the committed
bits; the other checkout's hs and nocp too, and of its mxu the largest
difference from the committed one is printed (both are held to the plain
version elsewhere: `chip_smoke.py` phase 8 and `tests/test_torch_cuda.py`).
Prints one JSON line per instantiation with ptxas's registers, spills and
shared memory of each build, the blocks per SM of the committed one, and
the SASS instruction counts (cuobjdump) of the committed one, of the
other checkout's and, for F alpha, of each alpha variant; then the share
of the walked warps with no live pixel, which the skip spares (from E
hs's per-row state), the share of F alpha's (row, slot, warp) triples
whose exp the warp skips (`exp_forward.far_records`), how evenly the blocks' static tile assignment spreads the walked
rows (`block_balance`), and the card's name and power limit. On the CPU
it builds nothing, prints "not measured" for every time and computes the
share from the plain version. The variants exist only here: the package
builds the committed source alone.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import sys
from pathlib import Path

import torch

from sgs_tpu_torch.core.device import resolve_device
from sgs_tpu_torch.ops import build, exp_forward
from sgs_tpu_torch.tools import exp_scene

SOURCE = build.CSRC_DIR / "exp_forward.cu"
# (kernel, mode, state columns)
INSTANCES = [("E", "hs", 8), ("E", "mxu", 8), ("E", "nocp", 8), ("G", "hs", 8), ("G", "mxu", 8),
             ("F", "alpha", 8), ("F", "alpha", 1), ("F", "outonly", 8), ("F", "empty", 8)]
# The dead-warp skip of hs extended to nocp and mxu: a warp with no live
# pixel forms only t_run, nocp from the last instance's alpha, mxu as
# 2^zc[63] after the contraction.
DEAD_NOCP = """  const float t_row = st[3];
  if constexpr (kMode == kNocp) {
    if (!__any_sync(0xffffffffu, t_row >= kEps)) {
      st[3] = t_row * (1.0f - alpha_of(load_rec<kFieldMajor>(row, kChunk - 1), fx, fy));
      return;
    }
  }
"""
DEAD_MXU = """p & 31);        // zc
    if (!__any_sync(0xffffffffu, t_row >= kEps)) {
      st[3] = t_row * exp2f(cp[kChunk - 1]);
      return;
    }
"""
# name -> (what it changes, [(committed text, variant text)])
VARIANTS = {
    "no_prefetch": ("each row fetched when it is walked, in place of the ring running ahead", [
        ("for (int q = 0; q < kRing - 1; ++q) {", "for (int q = 0; q < 0; ++q) {"),
        ("cp_async_wait<kRing - 2>();",
         "fetch_row<kMode, kFieldMajor>(slot, packed, r, t); cp_async_commit(); cp_async_wait<0>();"),
        ("if (pc.j < rounds) {  // row q + krows - 1", "if (false) {  // row q + krows - 1"),
    ]),
    "no_dead_skip": ("hs walks every warp of a walked row in full",
                     [("if (!__any_sync(0xffffffffu, t_row >= kEps)) {  // no live pixel in the warp",
                       "if (false) {")]),
    "dead_skip_all": ("the dead-warp skip of hs extended to nocp and mxu",
                      [("  const float t_row = st[3];\n", DEAD_NOCP), ("p & 31);        // zc\n", DEAD_MXU)]),
    "round_robin": ("block b takes schedule positions b, G + b, 2G + b, ... in place of the snake",
                    [("((j & 1) ? blocks - 1 - b : b)", "b")]),
}
# PR 10's alpha row: one pixel a thread, the 64 alphas of the row formed
# (6 loads and the -0.5 per pair, an exp each) and then summed by the tree.
PR10_ALPHA = """      float v[kPP], a[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) a[k] = alpha_of(load_rec<true>(rowf, k), fx, fy[0]);
      v[0] = tree_sum(a);
"""
ALPHA_ONE_PIXEL = ("constexpr int kAlphaPix = 2;", "constexpr int kAlphaPix = 1;")
ALPHA_NO_PRESCALE = ("constexpr bool kAlphaPrescale = true;", "constexpr bool kAlphaPrescale = false;")
ALPHA_NO_SKIP = ("constexpr bool kAlphaSkip = true;", "constexpr bool kAlphaSkip = false;")
ALPHA_ONE_BLOCK = ("constexpr int kAlphaMinBlocks = 5;", "constexpr int kAlphaMinBlocks = 1;")
ALPHA_VARIANTS = {
    "alpha_one_pixel": ("one pixel a thread, 256-thread blocks", [ALPHA_ONE_PIXEL, ALPHA_ONE_BLOCK]),
    "alpha_no_prescale": ("the -0.5 per pair, conic a and c as staged", [ALPHA_NO_PRESCALE]),
    "alpha_no_skip": ("an exp for every pair", [ALPHA_NO_SKIP]),
    "alpha_unrolled": ("the row's four passes unrolled too", [("#pragma unroll 1\n  for (int hi = 0;",
                                                               "#pragma unroll\n  for (int hi = 0;")]),
    "alpha_registers": ("ptxas free to use more registers (fewer blocks per SM)", [ALPHA_ONE_BLOCK]),
    "alpha_pr10": ("PR 10's alpha path", [ALPHA_ONE_PIXEL, ALPHA_NO_PRESCALE, ALPHA_NO_SKIP,
                                          ALPHA_ONE_BLOCK, ("""      float v[kPP];
      alpha_row<kPP>(rowf, far_row, fx, fy, v);
""", PR10_ALPHA)]),
}
LAUNCHER = {"exp_forward_launch": exp_forward.KERNEL.functions["exp_forward_launch"]}
PTXAS_ENTRY = re.compile(r"exp_forward_kernelILi(\d+)ELb([01])ELi(\d+)ELi(\d+)E")


def variant_source(name: str, parent=None) -> Path:
    """The source of a variant: the committed one with the variant's
    substitutions ("committed": none), or another checkout's."""
    out = build.BUILD_DIR / "ablation" / f"exp_forward_{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    if parent is not None:
        shutil.copyfile(Path(parent) / "sgs_tpu_torch" / "csrc" / "exp_forward.cu", out)
        return out
    text = SOURCE.read_text()
    for old, new in {**VARIANTS, **ALPHA_VARIANTS}.get(name, ("", []))[1]:
        if old not in text:
            raise RuntimeError(f"variant {name}: committed text not found: {old!r}")
        text = text.replace(old, new)
    out.write_text(text)
    return out


def variant_kernel(name: str, parent=None) -> build.CudaKernel:
    """The build of a variant (`variant_source`), with the committed
    launcher's signature; built by `build.build_all` or at first use."""
    return build.CudaKernel(str(variant_source(name, parent)), LAUNCHER, extra_flags=("--fmad=false",))


def ptxas_table(log: str) -> dict:
    """ptxas -v's report of each exp_forward_kernel instantiation: (mode,
    field_major, krows, out_cols) -> registers, spill stores and loads,
    stack frame and static shared memory in bytes."""
    table, key = {}, None
    for line in log.splitlines():
        m = PTXAS_ENTRY.search(line)
        if m and ("Compiling entry function" in line or "Function properties for" in line):
            key = tuple(int(x) for x in m.groups())
            table.setdefault(key, {})
        elif key is not None and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            table[key].update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif key is not None and "Used" in line and "registers" in line:
            table[key]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            table[key]["static_smem"] = int(smem.group(1)) if smem else 0
            key = None
    return table


def sass_counts(lib) -> dict:
    """The SASS of each exp_forward_kernel instantiation in a built
    library (cuobjdump, beside nvcc): (mode, field_major, krows, out_cols)
    -> its instruction count and the counts of the opcodes it uses most."""
    import collections
    import os
    import subprocess

    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    path = lib.library_path(build.nvcc_path())
    out = subprocess.run([cuobjdump, "-sass", str(path)], check=True, capture_output=True, text=True).stdout
    table, ops = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            m = PTXAS_ENTRY.search(line)
            ops = table.setdefault(tuple(int(x) for x in m.groups()), []) if m else None
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)((?:\.[A-Z0-9_]+)*)", line)
        if m and ops is not None:
            ops.append((m.group(1), m.group(2)))
    out = {}
    for k, v in table.items():
        loads = collections.Counter(op + mods for op, mods in v if op == "LDS")
        out[k] = {"instructions": len(v), "top": dict(collections.Counter(op for op, _ in v).most_common(12)),
                  "shared_loads": dict(loads)}
    return out


def runner(sc: dict, kernel: str, mode: str, krows: int, out_cols: int = exp_forward.SROWS):
    args = (sc["chunk_row_start"], sc["n_chunks"], sc["schedule"], sc["tiles_x"], mode, krows)
    if kernel == "E":
        return lambda: exp_forward.forward_rows(sc["packed_fm"], *args)
    if kernel == "F":
        return lambda: exp_forward.ablation_rows(sc["packed_fm"], *args, out_cols)
    return lambda: exp_forward.transposed_rows(sc["packed"], *args)


def with_kernel(lib, fn):
    """Run `fn` with `exp_forward.KERNEL` swapped for the build `lib`."""
    committed, exp_forward.KERNEL = exp_forward.KERNEL, lib
    try:
        return fn()
    finally:
        exp_forward.KERNEL = committed


def time_with(lib, fn, dev):
    return with_kernel(lib, lambda: exp_scene.device_ms(fn, dev))


def compare(kernel: str, mode: str, got, want) -> dict:
    """A variant's per-row state against the committed one's: the same
    bits (F empty: row 0, the only row it defines), or for mxu the largest
    difference (over every pixel)."""
    if kernel == "G":
        got, want = got.transpose(1, 2), want.transpose(1, 2)
    if mode == "empty":
        got, want = got[:1], want[:1]
    same = bool(torch.equal(got, want))
    out = {"same_bits": same}
    if mode == "mxu" and not same:
        out["max_abs_diff"] = float((got - want).abs()[:, :, :5].max())
        out["last_contrib_diffs"] = int((got[:, :, 5] != want[:, :, 5]).sum())
    return out


def block_balance(sc: dict, walked, blocks: int) -> dict:
    """How the kernels' static snake spreads the walked rows over
    `blocks` persistent blocks (positions b, 2G - 1 - b, 2G + b, ... of
    `schedule`), against a greedy assignment that gives each tile, in
    schedule order, to the block with the fewest walked rows so far (what
    blocks fetching their tiles one at a time would reach): the largest
    block's walked rows over the mean, for each."""
    import heapq

    t = sc["num_tiles"]
    per_tile = torch.zeros(t, dtype=torch.int64)
    per_tile.index_add_(0, sc["row_tile"][walked].long().cpu(), torch.ones(int(walked.sum()), dtype=torch.int64))
    cost = per_tile[sc["schedule"].long().cpu()].tolist()
    snake = [0] * blocks
    for i, c in enumerate(cost):
        j, b = divmod(i, blocks)
        snake[blocks - 1 - b if j & 1 else b] += c
    heap = [(0, b) for b in range(blocks)]
    for c in cost:
        load, b = heapq.heappop(heap)
        heapq.heappush(heap, (load + c, b))
    mean = sum(cost) / blocks
    return {"blocks": blocks, "mean_walked_rows": mean, "snake_max_over_mean": max(snake) / mean,
            "greedy_max_over_mean": max(x for x, _ in heap) / mean}


def run(sc: dict, dev, parent=None, modes=None) -> dict:
    """Time the committed kernels and the variants on the scene `sc` (the
    instantiations of `modes`, or all); returns {"rows": [one dict per
    instantiation], "dead_warps": ..., "far": ..., "balance": ...}."""
    on_card = dev.type == "cuda"
    names = list(VARIANTS) + list(ALPHA_VARIANTS) + (["parent"] if parent is not None else [])
    libs, ptxas, sass = {}, {}, {}
    if on_card:
        libs = {n: variant_kernel(n, parent if n == "parent" else None) for n in names}
        # a copy of the committed source, built here, for ptxas's report
        # (the package's own build may have been cached)
        report = variant_kernel("committed")
        build.build_all([exp_forward.KERNEL, report, *libs.values()])
        ptxas = {"committed": ptxas_table(report.build_log),
                 **{n: ptxas_table(k.build_log) for n, k in libs.items()}}
        sass = {"committed": sass_counts(report), **{n: sass_counts(k) for n, k in libs.items()}}
    rows = []
    for kernel, mode, out_cols in INSTANCES:
        if modes and mode not in modes:
            continue
        mine = [n for n in names if n not in ALPHA_VARIANTS or mode == "alpha"]
        for krows in exp_forward.KROWS:
            fn = runner(sc, kernel, mode, krows, out_cols)
            row = {"kernel": kernel, "mode": mode, "krows": krows, "out_cols": out_cols}
            if not on_card:
                row.update(committed_ms="not measured", **{f"{n}_ms": "not measured" for n in mine})
            else:
                want = fn()
                key = (exp_forward.MODES[mode], int(kernel != "G"), krows, out_cols)
                row["blocks_per_sm"] = exp_forward.blocks_per_sm(mode, kernel != "G", krows, out_cols)
                row["ptxas"] = {n: ptxas[n].get(key) for n in ["committed", *mine]}
                shown = ["committed", *(n for n in mine if n in ALPHA_VARIANTS or n == "parent")]
                row["sass"] = {n: sass[n].get(key) for n in shown}
                row["committed_ms"] = []
                for n in mine:
                    lib, times = libs[n], []
                    row["committed_ms"].append(exp_scene.device_ms(fn, dev))
                    times.append(time_with(lib, fn, dev))
                    times.append(time_with(lib, fn, dev))
                    row["committed_ms"].append(exp_scene.device_ms(fn, dev))
                    row[f"{n}_ms"] = times
                    row[n] = compare(kernel, mode, with_kernel(lib, fn), want)
                    if not row[n]["same_bits"] and not (mode == "mxu" and n == "parent"):
                        raise AssertionError(f"variant {n} changed {kernel} {mode} krows {krows}: {row[n]}")
                row["median_ms"] = {n: statistics.median(row[f"{n}_ms"]) for n in ["committed", *mine]}
            print(json.dumps(row), flush=True)
            rows.append(row)
    hs = runner(sc, "E", "hs", 8)()
    dead = exp_forward.dead_warps(hs, sc["row_first"], sc["row_tile"], sc["num_tiles"])
    dead["share"] = dead["dead_warps"] / max(dead["warps_walked"], 1)
    print(json.dumps({"dead_warps": dead}), flush=True)
    far = exp_forward.far_records(sc["packed_fm"], sc["row_tile"], sc["tiles_x"], sc["num_tiles"])
    print(json.dumps({"alpha_far_slot_warps": far}), flush=True)
    # the blocks of hs at krows 8: one per SM on the card (132 on an H100 SXM)
    blocks = (exp_forward.blocks_per_sm("hs", True, 8) * torch.cuda.get_device_properties(dev).multi_processor_count
              if on_card else 132)
    walked, _ = exp_forward.walked_rows(hs, sc["row_first"], sc["row_tile"], sc["num_tiles"])
    balance = block_balance(sc, walked, min(blocks, sc["num_tiles"]))
    print(json.dumps({"balance": balance}), flush=True)
    print(exp_scene.card_line(), flush=True)
    return {"rows": rows, "dead_warps": dead, "far": far, "balance": balance}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Kernels E, F and G with each design choice undone")
    ap.add_argument("--parent", default=None, help="a checkout whose exp_forward.cu is timed beside")
    ap.add_argument("--modes", nargs="*", default=None, help="time only these modes (all by default)")
    ap.add_argument("--width", type=int, default=exp_scene.WIDTH)
    ap.add_argument("--height", type=int, default=exp_scene.HEIGHT)
    ap.add_argument("--n", type=int, default=exp_scene.N_GAUSSIANS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(None if argv is None else [str(a) for a in argv])
    dev = resolve_device(args.device)
    sc = exp_scene.build_scene(args.width, args.height, args.n, args.seed, dev)
    exp_scene.describe(sc, args.seed)
    return run(sc, dev, args.parent, args.modes)


if __name__ == "__main__":
    main(sys.argv[1:])
