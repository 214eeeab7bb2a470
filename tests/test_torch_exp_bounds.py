"""`sgs_tpu_torch.tools.exp_bounds` lists a bound for every `pl.pallas_call`
of the six experiment scripts, at the line where each script makes it."""

from pathlib import Path

from sgs_tpu_torch.tools import exp_bounds

ROOT = Path(__file__).resolve().parents[1]


def test_every_experiment_call_has_a_bound():
    rows = exp_bounds.rows()
    for row in rows:
        path, line = row["script"].split(":")
        text = (ROOT / path).read_text().splitlines()
        assert "pallas_call" in text[int(line) - 1], row["script"]
        assert row["bound_ms"]
    calls = {r["script"] for r in rows}
    for script in ROOT.glob("scripts/exp_*.py"):
        for i, ln in enumerate(script.read_text().splitlines(), 1):
            if "pl.pallas_call(" in ln:
                assert f"scripts/{script.name}:{i}" in calls, (script.name, i)
