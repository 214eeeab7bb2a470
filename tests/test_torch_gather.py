"""Port parity of the gather experiments on the CPU: the inputs and XLA-side
gathers (`sgs_tpu_torch/tools/gather_inputs.py`), the plain versions of
Kernels H, I, J and K (`ops/gather.py`) and the three CLIs against the
scripts' own Pallas kernels (`scripts/exp_vmem_gather.py`,
`exp_dma_gather.py`, `exp_gather_layout.py`).

The scripts run as they are, at reduced sizes (N 1000, ROWS 32, M 2000,
OUT_ROWS 1000, SRC 16384), with three test-side patches that edit no
script: `pl.pallas_call` runs in interpret mode (`interpret=True`: the TPU
interpreter refuses H's vector gather), `dtime.device_ms` is replaced by a
recorder that calls the timed function once, and jit is off, so that the
arguments and outputs of every `pallas_call` are recorded as concrete
arrays.

H and I equal the Pallas outputs exactly (the same f32 adds in the same
order). J sums in another order than the TPU grid's serial one: both sums
are within gamma_n * sum|x| of the exact sum (n additions, unit roundoff
2^-24), so the two differ by at most twice that, element by element.
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from sgs_tpu_torch.ops import gather as g
from sgs_tpu_torch.tools import exp_dma_gather, exp_gather_layout, exp_vmem_gather
from sgs_tpu_torch.tools import gather_inputs as gi

torch.set_num_threads(1)
SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
N, ROWS, M, OUT_ROWS, SRC = 1000, 32, 2000, 1000, 16384
SIZES = {"exp_vmem_gather": {"N": N, "ROWS": ROWS},
         "exp_dma_gather": {"ROWS": ROWS, "M": M},
         "exp_gather_layout": {"OUT_ROWS": OUT_ROWS, "SRC": SRC}}
U = 2.0**-24


@pytest.fixture(scope="module")
def recorded():
    """Each script's `main` at the reduced sizes. Returns, per script, the
    `pallas_call`s made ((kernel name, inputs, output)) and the
    `device_ms` calls ((inputs, output of the timed function))."""
    pallas, timed, current = {}, {}, []
    real = pl.pallas_call

    def rec_pallas(kernel, *a, **kw):
        f = real(kernel, *a, interpret=True, **kw)

        def call(*args):
            out = f(*args)
            pallas[current[0]].append((kernel.__name__, [np.array(x) for x in args], np.array(out)))
            return out
        return call

    def rec_timed(fn, args, iters=3, top=0):
        timed[current[0]].append(([np.array(x) for x in args], np.array(fn(*args))))
        return 0.0, {}

    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(SCRIPTS))
        import dtime
        mp.setattr(dtime, "device_ms", rec_timed)
        mp.setattr(pl, "pallas_call", rec_pallas)
        for name, sizes in SIZES.items():
            sys.modules.pop(name, None)
            mod = importlib.import_module(name)
            for k, v in sizes.items():
                mp.setattr(mod, k, v)
            current[:] = [name]
            pallas[name], timed[name] = [], []
            with jax.disable_jit():
                mod.main()
            sys.modules.pop(name, None)
    return pallas, timed


def _calls(recorded, script, kernel):
    return [c for c in recorded[0][script] if c[0] == kernel]


def test_inputs_match_the_scripts(recorded):
    """The port's numpy draws equal the arrays the scripts hand to their
    kernels, in the scripts' draw order."""
    _, (ids, table), _ = _calls(recorded, "exp_vmem_gather", "kern")[0]
    t, i = gi.vmem_inputs(N, ROWS)
    np.testing.assert_array_equal(t.numpy(), table)
    np.testing.assert_array_equal(i.numpy(), ids)
    _, (starts, attr), _ = _calls(recorded, "exp_dma_gather", "kern_b")[0]
    a, s = gi.dma_inputs(M, ROWS)
    np.testing.assert_array_equal(a.numpy(), attr)
    np.testing.assert_array_equal(s.numpy(), starts)
    assert int(s.max()) == M and int((s == M).sum()) >= 1, "some window should start at M"
    idx, tables = gi.layout_inputs(OUT_ROWS, SRC)
    idents = _calls(recorded, "exp_gather_layout", "kern")
    for rec in g.WIDTHS:
        x = next(c[1][0] for c in idents if c[1][0].shape[1] == rec)
        np.testing.assert_array_equal(tables[rec].numpy(), x)
    assert idx.dtype == torch.int32 and idx.shape == (OUT_ROWS,) and int(idx.max()) < SRC


def test_plain_h_equals_the_vmem_gather_kernel(recorded):
    """Plain H's last step is the Pallas output bit for bit; every step's
    sum equals JAX's gather summed in the kernel's order; the script's own
    check (the last step against the sum over all steps) fails by design."""
    _, (ids, table), out = _calls(recorded, "exp_vmem_gather", "kern")[0]
    steps = g.vmem_gather_steps(torch.as_tensor(table), torch.as_tensor(ids))
    assert steps.shape == (ROWS // g.KROWS, g.CHUNK, g.REC)
    np.testing.assert_array_equal(steps[-1].numpy(), out)
    np.testing.assert_array_equal(g.vmem_gather(torch.as_tensor(table), torch.as_tensor(ids)).numpy(), out)
    rec = jnp.asarray(table)[jnp.asarray(ids)].reshape(-1, g.KROWS, g.CHUNK, g.REC)
    acc = jnp.zeros((rec.shape[0], g.CHUNK, g.REC), jnp.float32)
    for j in range(g.KROWS):
        acc = acc + rec[:, j]
    np.testing.assert_array_equal(steps.numpy(), np.asarray(acc))
    assert not np.allclose(out, np.asarray(rec.sum(axis=(0, 1))), rtol=1e-4, atol=1e-3)


def test_pack_gather_and_plain_i_equal_the_script(recorded):
    """The pack gather equals the script's XLA gather (indices clamped to
    M), and plain I's last step equals `kern_a`'s output bit for bit."""
    _, (packed,), out = _calls(recorded, "exp_dma_gather", "kern_a")[0]
    attr, starts = gi.dma_inputs(M, ROWS)
    mine = gi.pack(attr, starts, M)
    np.testing.assert_array_equal(mine.numpy(), packed)
    (timed_args, timed_out) = recorded[1]["exp_dma_gather"][0]  # the timed pack gather
    np.testing.assert_array_equal(mine.numpy(), timed_out)
    np.testing.assert_array_equal(g.packed_sum(mine).numpy(), out)
    steps = g.packed_sum_steps(mine)
    want = torch.zeros_like(steps)
    for j in range(g.KROWS):
        r = mine.view(-1, g.KROWS, g.CHUNK, g.REC)[:, j]
        want = want + (r + r)
    assert torch.equal(steps, want)


def _j_bound(attr, starts):
    """2 gamma_n sum|x| per element for J's sum: n counts the additions of
    the longer order (rows, plus J's block partials)."""
    rows = (starts.numel() // g.KROWS) * g.KROWS
    w = attr[starts[:rows].long()[:, None] + torch.arange(g.CHUNK)].double()
    n = rows + -(-rows // g.J_ROWS_PER_BLOCK)
    gamma = n * U / (1 - n * U)
    return 2 * gamma * (2 * w.abs()).sum(0), (2 * w).sum(0)


def test_plain_j_within_its_tolerance_of_the_dma_kernel(recorded):
    """Plain J against `kern_b` within 2 gamma_n sum|x|; its windows start
    at M without a clamp, so near the end it reads other rows than the
    pack gather, and the script's `A == B` is False."""
    _, (starts, attr), out = _calls(recorded, "exp_dma_gather", "kern_b")[0]
    a, s = torch.as_tensor(attr), torch.as_tensor(starts)
    got = g.dma_gather(a, s)
    bound, exact = _j_bound(a, s)
    assert torch.all((got.double() - torch.as_tensor(out).double()).abs() <= bound)
    assert torch.all((got.double() - exact).abs() <= bound / 2)
    at_m = int(torch.nonzero(s == M)[0, 0])
    window = a[M:M + g.CHUNK]
    packed_window = gi.pack(a, s, M).view(ROWS, g.CHUNK, g.REC)[at_m]
    assert torch.equal(packed_window, a[M].expand(g.CHUNK, g.REC))
    assert not torch.equal(packed_window, window)
    _, (packed,), out_a = _calls(recorded, "exp_dma_gather", "kern_a")[0]
    assert not np.allclose(out_a, out, rtol=1e-5)


def test_plain_k_is_the_identity_kernel(recorded):
    """`ident`'s output is its input; plain K from a row-major and a
    field-major source equals it; the layout gathers equal the script's
    gathers from the XLA array and from the identity's output."""
    idx, tables = gi.layout_inputs(OUT_ROWS, SRC)
    idents = _calls(recorded, "exp_gather_layout", "kern")
    timed = recorded[1]["exp_gather_layout"]
    for rec in g.WIDTHS:
        x, out = next((c[1][0], c[2]) for c in idents if c[1][0].shape[1] == rec)
        np.testing.assert_array_equal(out, x)
        fm = g.field_major(tables[rec])
        assert g.layout(fm) == "field-major" and g.layout(tables[rec]) == "row-major"
        for src in (tables[rec], fm):
            got = g.layout_identity(src)
            assert got.is_contiguous()
            np.testing.assert_array_equal(got.numpy(), out)
        # the script's timed calls per width: t[idx], ident(t)[idx], ident(t)
        gathers = [o for a, o in timed if a[0].shape[1] == rec]
        np.testing.assert_array_equal(gi.layout_gather(fm, idx).numpy(), gathers[0])
        np.testing.assert_array_equal(gi.layout_gather(g.layout_identity(fm), idx).numpy(), gathers[1])
        np.testing.assert_array_equal(gathers[2], out)


def test_rows_past_the_last_step_are_not_read():
    """The grids take ROWS // 8 steps: 37 rows read what 32 rows read."""
    table, ids = gi.vmem_inputs(N, 37, seed=3)
    assert torch.equal(g.vmem_gather_steps(table, ids), g.vmem_gather_steps(table, ids[: 32 * g.CHUNK]))
    attr, starts = gi.dma_inputs(M, 37, seed=3)
    packed = gi.pack(attr, starts, M)
    assert torch.equal(g.packed_sum_steps(packed), g.packed_sum_steps(packed[: 32 * g.CHUNK]))
    assert torch.equal(g.dma_gather(attr, starts), g.dma_gather(attr, starts[:32]))


@pytest.mark.parametrize("rows", [300, 1100])
def test_plain_j_over_several_blocks(rows):
    """More rows than one block of J (ragged last block): within gamma_n
    sum|x| of the exact sum, and the block order spelled out."""
    attr, starts = gi.dma_inputs(80 * rows, rows, seed=rows)
    got = g.dma_gather(attr, starts)
    bound, exact = _j_bound(attr, starts)
    assert torch.all((got.double() - exact).abs() <= bound / 2)
    used = (rows // g.KROWS) * g.KROWS
    w = attr[starts[:used].long()[:, None] + torch.arange(g.CHUNK)]
    want = torch.zeros((g.CHUNK, g.REC))
    for b0 in range(0, used, g.J_ROWS_PER_BLOCK):
        part = torch.zeros((g.CHUNK, g.REC))
        for r in range(b0, min(b0 + g.J_ROWS_PER_BLOCK, used)):
            part = part + (w[r] + w[r])
        want = want + part
    assert torch.equal(got, want)


def test_out_of_range_ids_and_starts_are_clamped():
    table, ids = gi.vmem_inputs(50, 8, seed=1)
    bad = ids.clone()
    bad[:3] = torch.tensor([-5, 50, 10**6], dtype=torch.int32)
    clamped = bad.clamp(0, 49)
    assert torch.equal(g.vmem_gather_steps(table, bad), g.vmem_gather_steps(table, clamped))
    attr, starts = gi.dma_inputs(400, 16, seed=1)
    s = starts.clone()
    s[-1] = 10**6
    fixed = starts.clone()
    fixed[-1] = attr.shape[0] - g.CHUNK
    assert torch.equal(g.dma_gather(attr, s), g.dma_gather(attr, fixed))


def test_wrappers_refuse_bad_inputs():
    table, ids = gi.vmem_inputs(50, 8)
    with pytest.raises(ValueError):
        g.vmem_gather_steps(table.double(), ids)
    with pytest.raises(ValueError):
        g.vmem_gather_steps(table, ids.long())
    with pytest.raises(ValueError):
        g.vmem_gather_steps(table, ids[: 7 * g.CHUNK])  # no whole grid step
    with pytest.raises(ValueError):
        g.packed_sum_steps(torch.zeros((g.CHUNK * 8, 8)))
    attr, starts = gi.dma_inputs(64, 8)
    with pytest.raises(ValueError):
        g.dma_gather(attr[:100], starts)  # no window of 128 rows
    with pytest.raises(ValueError):
        g.layout_identity(torch.zeros((64, 12)))
    with pytest.raises(ValueError):
        g.layout_identity(torch.zeros((64, 32))[:, ::2])


def test_clis_reproduce_the_scripts(recorded):
    """The three CLIs on the CPU at the reduced sizes: the same outputs as
    the scripts' kernels, the scripts' own checks False by design, every
    kernel at 0 from its plain version."""
    vm = exp_vmem_gather.main(["--device", "cpu", "--n", N, "--rows", ROWS])
    np.testing.assert_array_equal(vm["out"].numpy(), _calls(recorded, "exp_vmem_gather", "kern")[0][2])
    assert vm["ok"] is False and vm["err"] == 0.0 and vm["ms"] is None
    dm = exp_dma_gather.main(["--device", "cpu", "--m", M, "--rows", ROWS])
    np.testing.assert_array_equal(dm["a"].numpy(), _calls(recorded, "exp_dma_gather", "kern_a")[0][2])
    bound, _ = _j_bound(dm["attr"], dm["starts"])
    kern_b = torch.as_tensor(_calls(recorded, "exp_dma_gather", "kern_b")[0][2]).double()
    assert torch.all((dm["b"].double() - kern_b).abs() <= bound)
    assert dm["err_i"] == dm["err_j"] == 0.0
    lay = exp_gather_layout.main(["--device", "cpu", "--out-rows", OUT_ROWS, "--src", SRC])
    assert sorted(lay["widths"]) == sorted(g.WIDTHS)
    assert all(w["err"] == 0.0 and w["xla_ms"] is None for w in lay["widths"].values())
