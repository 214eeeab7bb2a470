"""`sgs_tpu_torch.tools.exp_bounds` lists a bound for every `pl.pallas_call`
of the six experiment scripts, at the line where each script makes it,
and counts the forward kernels' slots, pairs and per-row state and the
gather kernels' bytes and operations."""

from pathlib import Path

import pytest
import torch

from sgs_tpu_torch.ops import exp_forward
from sgs_tpu_torch.tools import exp_bounds, exp_scene, gather_inputs

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SMALL = (96, 64, 800)


@pytest.fixture(scope="module")
def bound_rows():
    return exp_bounds.rows(*SMALL)


def test_every_experiment_call_has_a_bound(bound_rows):
    for row in bound_rows:
        path, line = row["script"].split(":")
        text = (ROOT / path).read_text().splitlines()
        assert "pallas_call" in text[int(line) - 1], row["script"]
        assert row["bound_by"] in ("bytes", "operations")
        # `empty` moves nothing; every other kernel has a bound
        assert row["bound_ms"] > 0 or "empty" in row["kernel"], row
    calls = {r["script"] for r in bound_rows}
    for script in ROOT.glob("scripts/exp_*.py"):
        for i, ln in enumerate(script.read_text().splitlines(), 1):
            if "pl.pallas_call(" in ln:
                assert f"scripts/{script.name}:{i}" in calls, (script.name, i)


def test_forward_rows_count_slots_pairs_and_state(bound_rows):
    """Each forward variant reads only its mode's fields of the used rows
    (9 for the scans, 6 for alpha) and the tile tables, and writes the
    per-row state (8 columns, or out_cols); P counts 256 pairs for every
    instance; the triangular contraction counts 65 TF32 flops per pair."""
    sc = exp_scene.build_scene(*SMALL, seed=0, device="cpu")
    slots, p = sc["rows_used"] * 64, 256 * sc["instances"]
    state = sc["max_rows"] * 256 * 4
    tables = 12 * sc["num_tiles"]
    fwd = {r["kernel"]: r for r in bound_rows if "P" in r}
    assert len(fwd) == 9 and all(r["slots_read"] == slots and r["P"] == p for r in fwd.values())
    assert fwd["forward variant (Kernel E), hs, out_cols 8"]["bytes"] == slots * 9 * 4 + tables + 8 * state
    assert fwd["transposed forward (Kernel G), hs, out_cols 8"]["bytes"] == slots * 9 * 4 + tables + 8 * state
    assert fwd["structural ablation (Kernel F), alpha, out_cols 1"]["bytes"] == slots * 6 * 4 + tables + state
    assert fwd["structural ablation (Kernel F), outonly, out_cols 8"]["bytes"] == tables + 8 * state
    assert fwd["structural ablation (Kernel F), empty, out_cols 8"]["bytes"] == 0
    mxu = fwd["transposed forward (Kernel G), mxu, out_cols 8"]
    assert mxu["ops"] == exp_forward.OPS_PER_PAIR["mxu"] * p
    assert mxu["bound_ms"] >= (42 * p / exp_bounds.F32_OPS_PER_S + 65 * p / exp_bounds.TF32_OPS_PER_S) * 1e3 * (1 - 1e-12)


def test_scene_counts_walked_rows():
    """Counting only the rows walked reads fewer rows and pairs."""
    sc = exp_scene.build_scene(*SMALL, seed=0, device="cpu")
    walked = torch.zeros(sc["max_rows"], dtype=torch.bool)
    walked[: sc["rows_used"] // 2] = True
    c_all, c_half = exp_bounds.scene_counts(sc), exp_bounds.scene_counts(sc, walked)
    assert c_half["read"] == sc["rows_used"] // 2 and c_all["read"] == sc["rows_used"]
    assert c_half["P"] == exp_forward.pairs(sc["windows"], sc["n_gaussians"], walked) < c_all["P"]
    assert c_all["rows"] == c_half["rows"] == sc["max_rows"]


def test_gather_rows_count_partials_and_two_ops():
    """H and I write every grid step's (128, 16) partial; H counts one f32
    operation per gathered element, I and J two (rec + rec, then the add);
    H reads the table rows its ids name, J the attribute rows its windows
    cover, each once; rows past the last whole step of 8 count nothing."""
    table, ids = gather_inputs.vmem_inputs(50, 20, seed=0)  # 2 steps, 4 rows past them
    n_ids, partials = 2 * 8 * 128, 2 * 128 * 16 * 4
    used = torch.unique(ids[:n_ids]).numel()
    h = exp_bounds.vmem_gather_row(table, ids)
    assert h["bytes"] == n_ids * 4 + used * 16 * 4 + partials and h["ops"] == n_ids * 16
    i = exp_bounds.packed_sum_row(20 * 128)
    assert i["bytes"] == n_ids * 16 * 4 + partials and i["ops"] == 2 * n_ids * 16
    attr = torch.zeros((1000, 16))
    # 8 rows in the grid (the 9th is past it); start 900 clamps to 872:
    # [0, 192) + [300, 428) + [860, 1000) = 460 rows
    starts = torch.tensor([0, 0, 64, 300, 860, 872, 872, 900, 5], dtype=torch.int32)
    j = exp_bounds.dma_gather_row(attr, starts)
    assert j["attr_rows_read"] == 460
    assert j["bytes"] == 460 * 16 * 4 + 8 * 4 + 128 * 16 * 4 and j["ops"] == 2 * 8 * 128 * 16
    k = exp_bounds.identity_row(100, 8)
    assert k["bytes"] == 2 * 100 * 8 * 4 and k["ops"] == 0 and k["bound_by"] == "bytes"
    for row in (h, i, j):
        assert row["bound_by"] == "bytes" and row["bound_ms"] > 0


@pytest.mark.parametrize("rate", [1e12, exp_bounds.L2_READ_BYTES_PER_S, 1e16])
def test_vmem_gather_bound_has_l2_term(rate):
    """H's bound is the larger of its HBM bytes' time and its gathered
    records' bytes (64 per id of a whole grid step) at the L2 read rate."""
    table, ids = gather_inputs.vmem_inputs(50, 20, seed=0)  # 2 steps, 4 rows past them
    n_ids = 2 * 8 * 128
    h = exp_bounds.vmem_gather_row(table, ids, rate)
    assert h["l2_bytes"] == n_ids * 64 and h["l2_bytes_per_s"] == rate
    assert h["l2_ms"] == pytest.approx(n_ids * 64 / rate * 1e3, rel=1e-12)
    assert h["hbm_bound_ms"] == pytest.approx(h["bytes"] / exp_bounds.HBM_BYTES_PER_S * 1e3, rel=1e-12)
    assert h["bound_ms"] == max(h["hbm_bound_ms"], h["l2_ms"]) and h["bound_by"] == "bytes"
    assert h["bound_term"] == ("l2" if h["l2_ms"] > h["hbm_bound_ms"] else "hbm")
    small_dma = (torch.zeros((1000, 16)), torch.zeros(16, dtype=torch.int32))
    assert exp_bounds.gather_rows((table, ids), small_dma, 100, rate)[0]["bound_ms"] == h["bound_ms"]


@pytest.mark.parametrize("mode", exp_forward.SCANS)
def test_scan_counts_read_the_rows_each_scan_walks(mode):
    """A scan's bound counts the rows its plain version walks: hs and mxu
    the same rows, nocp its own; its bytes are 9 fields of each slot of
    those rows, the tile tables and the per-row state."""
    sc = exp_scene.build_scene(*SMALL, seed=0, device="cpu")
    _, info = exp_forward.scan_plain(sc["packed_fm"], sc["chunk_row_start"], sc["n_chunks"],
                                     sc["tiles_x"], mode)
    c = exp_bounds.scan_counts(sc, mode)
    assert c == exp_bounds.scene_counts(sc, info["walked"])
    assert 0 < c["read"] <= sc["rows_used"]
    if mode == "mxu":
        assert c == exp_bounds.scan_counts(sc, "hs")
    row = exp_bounds.forward("scripts/exp_fwd.py:210", "forward variant (Kernel E)", c, mode)
    assert row["bytes"] == c["read"] * 64 * 9 * 4 + 12 * sc["num_tiles"] + sc["max_rows"] * 256 * 8 * 4
    assert row["ops"] == exp_forward.OPS_PER_PAIR[mode] * c["P"] and row["bound_ms"] > 0
