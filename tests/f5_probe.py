"""Hold the port's training to the JAX package's on the flagship's real
training states, on the CPU. Not a test: a command-line probe that
imports both packages and reads JAX's checkpoints in `runs/`.

    PYTHONPATH=. python tests/f5_probe.py time  [--ckpt C] [--view V]
    PYTHONPATH=. python tests/f5_probe.py step  [--ckpts C ...] [--views-per-state 8] [--json F]
    PYTHONPATH=. python tests/f5_probe.py drift --ckpt C --steps K --run jax|jax_ulp|port --out F
    PYTHONPATH=. python tests/f5_probe.py compare-drift A.npz B.npz ...
    PYTHONPATH=. python tests/f5_probe.py densify --state S.npz [--json F]
    PYTHONPATH=. python tests/f5_probe.py reduction [--ckpts C ...] [--json F]

`time` times one full-size (800x800) step of each package. `step` takes
one step from each checkpoint on the train views that JAX's run
(`runs/flagship_r5`, resumed at 3,000 with `random.Random(0)`) popped
right after it, and holds the loss, the per-field gradients, the new
parameters and moments, the tap gradient, `radii`, `visibility_filter`
and `nonfinite_grads` to JAX's at `tests/test_torch_train_step.py`'s
bars. JAX runs `sgs_tpu.train.loop.train_step` in tiled mode on its
non-Pallas route (`backend="xla"`, rect binning, the scan compositor;
the JAX package's tests hold it equal to its Pallas kernels); the port
runs its CPU path (tight binning and Kernels A-D's plain versions).

`drift` runs K steps from one checkpoint on the views JAX's run took
there and saves the per-field state every `--every` steps; `jax_ulp`
is JAX with every `xyz` moved by one ulp, the chaos floor.
`compare-drift` prints each field's mean |difference| between two saved
states, relative to the field's mean |value|. `densify` gives one state (a
drift run's save, with the statistics its steps accumulated, or a
checkpoint) to both `densify_and_prune` functions with the same split
noise (JAX's draws), then to both `reset_opacity` functions and one Adam
step after each, and holds the counts, the alive slots (so the clone,
split and prune masks) and the children.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import time
from functools import partial

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from sgs_tpu.data.scene import Scene as JaxScene  # noqa: E402
from sgs_tpu.models import densify as jdensify  # noqa: E402
from sgs_tpu.models.gaussians import PARAM_FIELDS  # noqa: E402
from sgs_tpu.ops.ssim import l1_loss as jl1, ssim as jssim  # noqa: E402
from sgs_tpu.render.pipeline import render as jrender  # noqa: E402
from sgs_tpu.train import checkpoint as jckpt  # noqa: E402
from sgs_tpu.train import loop as jloop  # noqa: E402
from sgs_tpu.train.optim import adam_update as jadam_update  # noqa: E402
from sgs_tpu.train.optim import make_lr_dict as jlr_dict  # noqa: E402
from sgs_tpu.utils import config as jconfig  # noqa: E402
from sgs_tpu_torch.core.camera import Camera  # noqa: E402
from sgs_tpu_torch.models import densify as pdensify  # noqa: E402
from sgs_tpu_torch.train import checkpoint as pckpt  # noqa: E402
from sgs_tpu_torch.train import loop as ploop  # noqa: E402
from sgs_tpu_torch.train.optim import make_lr_dict  # noqa: E402
from sgs_tpu_torch.utils.config import OptimizationParams  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "data", "flagship800")
RESUME = os.path.join(ROOT, "runs", "resume3000.npz")
R5 = os.path.join(ROOT, "runs", "flagship_r5")
CKPTS = [RESUME] + [os.path.join(R5, f"chkpnt{k}.npz") for k in (7000, 10000, 13000)]
FIRST_ITER, LAST_ITER, DENSIFY_UNTIL, DENSIFY_FROM, INTERVAL = 3000, 15000, 7500, 500, 100
GUARD_ITER = 13083  # JAX's first guard firing (runs/flagship_r5.log)
RTOL, ATOL_SCALE = 1e-4, 2e-4  # tests/test_torch_train_step.py
SEED = 0


def opt_params(cls):
    o = cls()
    o.iterations, o.densify_until_iter, o.position_lr_max_steps = LAST_ITER, DENSIFY_UNTIL, LAST_ITER
    return o


def view_schedule(n_views: int) -> dict:
    """{iteration: train view index} of JAX's resumed run: the trainer's
    `random.Random(0)` pops, with the instance-bucket `sample(cams, 4)` at
    the start and after each densify step (sgs_tpu/train/trainer.py)."""
    py = random.Random(SEED)
    cams = list(range(n_views))
    py.sample(cams, 4)
    stack: list = []
    out = {}
    for it in range(FIRST_ITER + 1, LAST_ITER + 1):
        if not stack:
            stack = list(cams)
        out[it] = stack.pop(py.randint(0, len(stack) - 1))
        if it < DENSIFY_UNTIL and it > DENSIFY_FROM and it % INTERVAL == 0:
            py.sample(cams, 4)
    return out


_SCENE = None


def train_views():
    """JAX's train views in the order its trainer holds them (train.py
    seeds `random` and numpy with 0 before the Scene shuffles)."""
    global _SCENE
    if _SCENE is None:
        random.seed(0)
        np.random.seed(0)
        args = jconfig.ModelParams(source_path=SCENE, model_path="", sh_degree=3, eval=True)
        _SCENE = JaxScene(args)
    return _SCENE.getTrainCameras()


def port_camera(jc) -> Camera:
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    return Camera(world_view_transform=t(jc.world_view_transform),
                  full_proj_transform=t(jc.full_proj_transform), camera_center=t(jc.camera_center),
                  tanfovx=t(jc.tanfovx), tanfovy=t(jc.tanfovy), image_width=int(jc.image_width),
                  image_height=int(jc.image_height))


@partial(jax.jit, static_argnames=("active_sh_degree", "max_instances"))
def jax_grads(state, camera, gt, bg, active_sh_degree, max_instances):
    """train_step's value_and_grad, unchanged (sgs_tpu/train/loop.py)."""
    pool = state.pool
    tap0 = jnp.zeros((pool.capacity, 3), jnp.float32)

    def loss_fn(params, tap):
        p = pool.with_params(params)
        out = jrender(camera, p.render_inputs(active_sh_degree), bg, vspace_tap=tap, mode="tiled",
                      max_instances=max_instances, backend="xla")
        image = out["render"]
        ll1 = jl1(image, gt)
        loss = 0.8 * ll1 + 0.2 * (1.0 - jssim(image, gt))
        return loss, (ll1, out["radii"], out["visibility_filter"], out["overflow"])

    (loss, aux), (pg, tg) = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(pool.params(), tap0)
    return loss, aux, pg, tg


def jax_step(state, cam, gt, iteration, sh, extent):
    """(new state, metrics) of JAX's train_step, the bucket sized as the
    trainer sizes it (rect binning on the xla route)."""
    mi = jloop.instance_bucket(state.pool, cam, tight=False)
    lrs = {k: jnp.float32(v)
           for k, v in jlr_dict(opt_params(jconfig.OptimizationParams), extent, iteration).items()}
    new, m = jloop.train_step(state, cam, jnp.asarray(gt), jnp.zeros(3, jnp.float32), lrs,
                              active_sh_degree=sh, mode="tiled", max_instances=mi, backend="xla")
    return new, m, mi


def ulp_state(state):
    """The state with every xyz moved one ulp toward +inf."""
    xyz = np.asarray(state.pool.xyz)
    return state.replace(pool=state.pool.replace(
        xyz=jnp.asarray(np.nextafter(xyz, np.float32(np.inf)).astype(np.float32))))


def load_jax(path):
    return jckpt.load_checkpoint(path)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close_report(got, want) -> dict:
    """Worst |got - want| against the bars, as a share of the bar."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    tol = RTOL * np.abs(want) + ATOL_SCALE * scale
    err = np.abs(got - want)
    bad = err > tol
    with np.errstate(invalid="ignore", divide="ignore"):
        share = np.where(tol > 0, err / tol, np.where(err > 0, np.inf, 0.0))
    return {"max_abs": float(err.max()) if err.size else 0.0, "scale": scale,
            "worst_share_of_bar": float(share.max()) if share.size else 0.0,
            "n_over_bar": int(bad.sum()), "mean_abs": float(err.mean()) if err.size else 0.0,
            "ok": bool(not bad.any())}


# --------------------------------------------------------------------- time

def cmd_time(args):
    views = train_views()
    lc = views[args.view]
    for rep in range(2):
        state, it, sh, ext = load_jax(args.ckpt)
        t0 = time.perf_counter()
        new, m, mi = jax_step(state, lc.camera, lc.gt_image, it + 1, sh, ext)
        jax.block_until_ready(new)
        print(f"jax train_step (xla, bucket {mi}) run {rep}: {time.perf_counter() - t0:.2f} s "
              f"loss {float(m['loss'])!r}", flush=True)
    pstate, _, _, ext = pckpt.load_checkpoint(args.ckpt, "cpu")
    lrs = make_lr_dict(opt_params(OptimizationParams), ext, it + 1)
    for rep in range(2):
        t0 = time.perf_counter()
        _, pm = ploop.train_step(pstate, port_camera(lc.camera), torch.from_numpy(lc.gt_image),
                                 torch.zeros(3), lrs, active_sh_degree=sh)
        print(f"port train_step run {rep}: {time.perf_counter() - t0:.2f} s "
              f"loss {float(pm['loss'])!r}", flush=True)


# --------------------------------------------------------------------- step

def one_step(path, view_idx, iteration, views) -> dict:
    lc = views[view_idx]
    state, it, sh, ext = load_jax(path)
    mi = jloop.instance_bucket(state.pool, lc.camera, tight=False)
    loss, (ll1, radii, vis, ovf), pg, tg = jax_grads(state, lc.camera, jnp.asarray(lc.gt_image),
                                                      jnp.zeros(3, jnp.float32), sh, mi)
    j_nonfinite = int(sum(int(jnp.sum(~jnp.isfinite(g))) for g in jax.tree.leaves(pg))
                      + int(jnp.sum(~jnp.isfinite(tg))))
    j_nonfinite_fields = {f: int(jnp.sum(~jnp.isfinite(pg[f]))) for f in PARAM_FIELDS}
    j_nonfinite_fields["tap"] = int(jnp.sum(~jnp.isfinite(tg)))
    jnew, jm, _ = jax_step(state, lc.camera, lc.gt_image, iteration, sh, ext)
    # the floor: JAX against itself with every xyz moved by one ulp
    ustate, *_ = load_jax(path)
    ustate = ulp_state(ustate)
    _, (_, uradii, _, _), upg, utg = jax_grads(ustate, lc.camera, jnp.asarray(lc.gt_image),
                                               jnp.zeros(3, jnp.float32), sh, mi)

    pstate, _, _, _ = pckpt.load_checkpoint(path, "cpu")
    cam = port_camera(lc.camera)
    gt = torch.from_numpy(np.array(lc.gt_image))
    lrs = make_lr_dict(opt_params(OptimizationParams), ext, iteration)
    model = pstate.model

    def render_fn(leaves, tap):
        from sgs_tpu_torch.render.pipeline import render
        return render(cam, model.with_params(leaves).render_inputs(sh), torch.zeros(3), vspace_tap=tap)

    p_loss, p_l1, p_pg, p_tg, p_out = ploop.view_grads(model, render_fn, gt)
    p_nonfinite_fields = {f: int((~torch.isfinite(p_pg[f])).sum()) for f in PARAM_FIELDS}
    p_nonfinite_fields["tap"] = int((~torch.isfinite(p_tg)).sum())
    pnew, pm = ploop.train_step(pstate, cam, gt, torch.zeros(3), lrs, active_sh_degree=sh)

    alive = _np(model.alive)
    row = {"state": os.path.basename(path), "iteration": iteration, "view": view_idx,
           "loss": [float(jm["loss"]), float(pm["loss"])], "l1": [float(jm["l1"]), float(pm["l1"])],
           "loss_rel": abs(float(pm["loss"]) - float(jm["loss"])) / abs(float(jm["loss"])),
           "nonfinite": [int(jm["nonfinite_grads"]), int(pm["nonfinite_grads"])],
           "nonfinite_fields": {"jax": j_nonfinite_fields, "port": p_nonfinite_fields},
           "radii_equal": bool(np.array_equal(_np(radii), _np(p_out["radii"]))),
           "radii_n_differ": int((_np(radii) != _np(p_out["radii"])).sum()),
           "visibility_equal": bool(np.array_equal(_np(vis), _np(p_out["visibility_filter"]))),
           "n_visible": int(_np(vis).sum()), "alive": int(alive.sum())}
    fields = {}
    finite = lambda a: np.where(np.isfinite(_np(a)), _np(a), 0.0)  # noqa: E731
    for f in PARAM_FIELDS:
        fields[f] = {
            "grad": close_report(finite(p_pg[f]), finite(pg[f])),
            "param": close_report(getattr(pnew.model, f), getattr(jnew.pool, f)),
            "mu": close_report(pnew.adam.mu[f], jnew.adam.mu[f]),
            "nu": close_report(pnew.adam.nu[f], jnew.adam.nu[f]),
        }
    fields["tap"] = {"grad": close_report(finite(p_tg), finite(tg))}
    row["floor"] = {f: close_report(finite(upg[f]), finite(pg[f])) for f in PARAM_FIELDS}
    row["floor"]["tap"] = close_report(finite(utg), finite(tg))
    row["floor_radii_n_differ"] = int((_np(uradii) != _np(radii)).sum())
    # the port's worst tap elements: which Gaussians they are
    err = np.abs(finite(p_tg) - finite(tg)).max(axis=1)
    worst = np.argsort(err)[::-1][:5]
    op = 1.0 / (1.0 + np.exp(-_np(model.opacity)[:, 0]))
    row["worst_tap"] = [{"slot": int(i), "err": float(err[i]), "radius": int(_np(radii)[i]),
                         "opacity": float(op[i]), "max_scale": float(np.exp(_np(model.scaling)[i]).max()),
                         "jax": finite(tg)[i].tolist(), "port": finite(p_tg)[i].tolist()} for i in worst]
    fields["stats"] = {
        "xyz_gradient_accum": close_report(pnew.stats.xyz_gradient_accum, jnew.stats.xyz_gradient_accum),
        "denom": close_report(pnew.stats.denom, jnew.stats.denom),
        "max_radii2d": close_report(pnew.stats.max_radii2d, jnew.stats.max_radii2d)}
    row["fields"] = fields
    row["all_within_bars"] = bool(
        all(v["ok"] for f in PARAM_FIELDS for v in fields[f].values())
        and fields["tap"]["grad"]["ok"] and all(v["ok"] for v in fields["stats"].values())
        and row["radii_equal"] and row["visibility_equal"] and row["nonfinite"][0] == row["nonfinite"][1])
    return row


def cmd_step(args):
    views = train_views()
    sched = view_schedule(len(views))
    rows = []
    for path in args.ckpts:
        it0 = int(np.load(path)["iteration"])
        its = list(range(it0 + 1, it0 + 1 + args.views_per_state))
        if it0 < GUARD_ITER <= it0 + 3000 and GUARD_ITER not in its:
            its[-1] = GUARD_ITER
        for it in its:
            t0 = time.perf_counter()
            row = one_step(path, sched[it], it, views)
            row["seconds"] = time.perf_counter() - t0
            rows.append(row)
            f = row["fields"]
            print(f"[step] {row['state']} it {it} view {row['view']}: loss {row['loss']} "
                  f"rel {row['loss_rel']:.2e} nonfinite {row['nonfinite']} radii_eq {row['radii_equal']} "
                  f"vis_eq {row['visibility_equal']} within bars {row['all_within_bars']}; worst share of "
                  "bar grad/param/mu/nu: " + ", ".join(
                      f"{k} " + "/".join(f"{v['worst_share_of_bar']:.3g}" for v in f[k].values())
                      for k in PARAM_FIELDS) + f", tap {f['tap']['grad']['worst_share_of_bar']:.3g}; "
                  f"{row['seconds']:.0f} s; floor (JAX, xyz + 1 ulp): " + ", ".join(
                      f"{k} {v['worst_share_of_bar']:.3g}" for k, v in row["floor"].items()), flush=True)
            if args.json:
                with open(args.json, "w") as fh:
                    json.dump(rows, fh, indent=1)


# -------------------------------------------------------------------- drift

def save_fields(path, params: dict, mu: dict, nu: dict, stats: dict, alive, losses):
    arrs = {f"param_{f}": _np(params[f]) for f in PARAM_FIELDS}
    arrs.update({f"mu_{f}": _np(mu[f]) for f in PARAM_FIELDS})
    arrs.update({f"nu_{f}": _np(nu[f]) for f in PARAM_FIELDS})
    arrs.update({k: _np(v) for k, v in stats.items()})
    arrs["alive"] = _np(alive)
    arrs["losses"] = np.asarray(losses, np.float64)
    np.savez(path, **arrs)


def cmd_drift(args):
    views = train_views()
    sched = view_schedule(len(views))
    it0 = int(np.load(args.ckpt)["iteration"])
    os.makedirs(args.out, exist_ok=True)
    losses = []
    if args.run in ("jax", "jax_ulp"):
        state, _, sh, ext = load_jax(args.ckpt)
        if args.run == "jax_ulp":
            state = ulp_state(state)
        for k in range(1, args.steps + 1):
            it = it0 + k
            lc = views[sched[it]]
            state, m, _ = jax_step(state, lc.camera, lc.gt_image, it, sh, ext)
            losses.append([it, float(m["loss"]), int(m["nonfinite_grads"])])
            print(f"[drift {args.run}] it {it} view {sched[it]} loss {losses[-1][1]!r}", flush=True)
            if k % args.every == 0 or k == args.steps:
                st = state.stats
                save_fields(os.path.join(args.out, f"{args.run}_{it}.npz"), state.pool.params(),
                            state.adam.mu, state.adam.nu,
                            {"xyz_gradient_accum": st.xyz_gradient_accum, "denom": st.denom,
                             "max_radii2d": st.max_radii2d}, state.pool.alive, losses)
    else:
        pstate, _, sh, ext = pckpt.load_checkpoint(args.ckpt, "cpu")
        for k in range(1, args.steps + 1):
            it = it0 + k
            lc = views[sched[it]]
            lrs = make_lr_dict(opt_params(OptimizationParams), ext, it)
            pstate, m = ploop.train_step(pstate, port_camera(lc.camera), torch.from_numpy(np.array(lc.gt_image)),
                                         torch.zeros(3), lrs, active_sh_degree=sh)
            losses.append([it, float(m["loss"]), int(m["nonfinite_grads"])])
            print(f"[drift port] it {it} view {sched[it]} loss {losses[-1][1]!r}", flush=True)
            if k % args.every == 0 or k == args.steps:
                st = pstate.stats
                save_fields(os.path.join(args.out, f"port_{it}.npz"), pstate.model.params(),
                            pstate.adam.mu, pstate.adam.nu,
                            {"xyz_gradient_accum": st.xyz_gradient_accum, "denom": st.denom,
                             "max_radii2d": st.max_radii2d}, pstate.model.alive, losses)


def cmd_compare_drift(args):
    """Mean |a - b| over alive slots per field between two saved states,
    relative to the mean |b|; and between each and the start."""
    a, b = np.load(args.a), np.load(args.b)
    alive = b["alive"].astype(bool)
    out = {}
    for key in sorted(a.files):
        if key in ("alive", "losses"):
            continue
        x, y = a[key][alive].astype(np.float64), b[key][alive].astype(np.float64)
        out[key] = {"mean_abs_diff": float(np.abs(x - y).mean()),
                    "rel": float(np.abs(x - y).mean() / max(np.abs(y).mean(), 1e-30))}
    print(json.dumps(out))
    return out


# ------------------------------------------------------------------ densify

def cmd_densify(args):
    """Both densify_and_prune functions on one state, with JAX's split noise."""
    z = dict(np.load(args.state))
    for f in PARAM_FIELDS:  # a checkpoint's keys, or a drift save's
        for kind in ("mu", "nu"):
            if f"adam_{kind}_{f}" in z:
                z[f"{kind}_{f}"] = z[f"adam_{kind}_{f}"]
    if "adam_step_xyz" in z:
        args.adam_step = int(z["adam_step_xyz"])
    base, it0, sh, ext = load_jax(args.base)
    cap = base.pool.capacity
    params = {f: jnp.asarray(z[f"param_{f}"]) for f in PARAM_FIELDS}
    jpool = base.pool.replace(**params, alive=jnp.asarray(z["alive"]))
    jadam = base.adam.replace(mu={f: jnp.asarray(z[f"mu_{f}"]) for f in PARAM_FIELDS},
                              nu={f: jnp.asarray(z[f"nu_{f}"]) for f in PARAM_FIELDS},
                              step={f: jnp.int32(args.adam_step) for f in PARAM_FIELDS})
    from sgs_tpu.models.gaussians import DensifyStats as JStats
    jstats = JStats(xyz_gradient_accum=jnp.asarray(z["xyz_gradient_accum"]),
                    denom=jnp.asarray(z["denom"]), max_radii2d=jnp.asarray(z["max_radii2d"]))
    key = jax.random.PRNGKey(args.key)
    # JAX's draws: densify_and_prune splits its key into n_split keys
    keys = jax.random.split(key, 2)
    noise = [np.asarray(jax.random.normal(k, (cap, 3), jnp.float32)) for k in keys]
    size_threshold = 20.0 if args.iteration > 3000 else 0.0
    kw = dict(max_grad=0.0002, min_opacity=0.005, extent=ext, max_screen_size=size_threshold,
              percent_dense=0.01)
    jp, ja, js, jinfo = jdensify.densify_and_prune(jpool, jadam, jstats, key, **kw)

    from sgs_tpu_torch.models.gaussians import GaussianModel, DensifyStats
    from sgs_tpu_torch.train.optim import AdamState
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    pmodel = GaussianModel(**{f: t(z[f"param_{f}"]) for f in PARAM_FIELDS}, alive=t(z["alive"]).bool(),
                           max_sh_degree=3)
    padam = AdamState(mu={f: t(z[f"mu_{f}"]) for f in PARAM_FIELDS}, nu={f: t(z[f"nu_{f}"]) for f in PARAM_FIELDS},
                      step={f: args.adam_step for f in PARAM_FIELDS})
    pstats = DensifyStats(xyz_gradient_accum=t(z["xyz_gradient_accum"]), denom=t(z["denom"]),
                          max_radii2d=t(z["max_radii2d"]))
    pm, pa, ps, pinfo = pdensify.densify_and_prune(pmodel, padam, pstats, noise=[t(n) for n in noise], **kw)

    res = {"jax_info": {k: int(v) for k, v in jinfo.items()}, "port_info": pinfo,
           "alive_equal": bool(np.array_equal(_np(jp.alive), _np(pm.alive)))}
    res["fields"] = {f: close_report(getattr(pm, f), getattr(jp, f)) for f in PARAM_FIELDS}
    res["moments"] = {f: [close_report(pa.mu[f], ja.mu[f]), close_report(pa.nu[f], ja.nu[f])]
                      for f in PARAM_FIELDS}
    # the reset, then one Adam step with the same gradient in each
    jp2, ja2 = jdensify.reset_opacity(jp, ja)
    pm2, pa2 = pdensify.reset_opacity(pm, pa)
    res["reset_opacity"] = close_report(pm2.opacity, jp2.opacity)
    rng = np.random.default_rng(1)
    grads = {f: rng.normal(0, 1e-4, z[f"param_{f}"].shape).astype(np.float32) for f in PARAM_FIELDS}
    lrs = make_lr_dict(opt_params(OptimizationParams), ext, args.iteration + 1)
    jn, jas = jadam_update(jp2.params(), {f: jnp.asarray(g) for f, g in grads.items()}, ja2,
                           {k: jnp.float32(v) for k, v in lrs.items()}, update_mask=jp2.alive)
    from sgs_tpu_torch.train.optim import adam_update
    pn, pas = adam_update(pm2.params(), {f: t(g) for f, g in grads.items()}, pa2, lrs, update_mask=pm2.alive)
    res["adam_after_reset"] = {f: close_report(pn[f], jn[f]) for f in PARAM_FIELDS}
    print(json.dumps(res, indent=1))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(res, fh, indent=1)


# ---------------------------------------------------------------- reduction

CHANNELS = ("mx", "my", "ca", "cb", "cc", "op", "r", "g", "b")


def capture_instances(path, iteration, views):
    """The port's presort instance gradients of one full-size step (its
    plain backward), with the step's gradients and view."""
    from sgs_tpu_torch.ops import flat_raster as pfr
    from sgs_tpu_torch.render.pipeline import render

    sched = view_schedule(len(views))
    lc = views[sched[iteration]]
    pstate, _, sh, _ = pckpt.load_checkpoint(path, "cpu")
    model = pstate.model
    cam, gt = port_camera(lc.camera), torch.from_numpy(np.array(lc.gt_image))
    cap, plain = {}, pfr.reduce_runs_plain

    def grab(inst, rank_start, order):
        cap.update(inst=inst.clone(), rank_start=rank_start.clone(), order=order.clone())
        return plain(inst, rank_start, order)

    def render_fn(leaves, tap):
        return render(cam, model.with_params(leaves).render_inputs(sh), torch.zeros(3), vspace_tap=tap)

    pfr.reduce_runs_plain = grab
    try:
        _, _, pg, tg, _ = ploop.view_grads(model, render_fn, gt)
    finally:
        pfr.reduce_runs_plain = plain
    return cap, pg, tg, model, render_fn, gt


def jax_reduce(inst, rank_start, order, bucket):
    """JAX's own reduce_grads_presort on the port's instance records, laid
    out as its slots: one level-1 row per depth rank, offs2 = rank_start."""
    from sgs_tpu.ops.pallas import flat_raster as jfr

    m, n = inst.shape[0], order.shape[0]
    g = np.zeros((bucket, 16), np.float32)
    g[:m, :9] = inst.numpy()
    padgrads = (jnp.asarray(g[:, 0:8]), jnp.asarray(g[:, 8:16]))
    rank_rows = (jnp.arange(n, dtype=jnp.int32), jnp.ones((n,), jnp.int32))
    out = jfr.reduce_grads_presort(padgrads, jnp.arange(bucket, dtype=jnp.int32), rank_rows,
                                   jnp.asarray(rank_start.numpy().astype(np.int32)),
                                   jnp.asarray(order.numpy().astype(np.int32)), n)
    return torch.from_numpy(np.array(out))


def cmd_reduction(args):
    """Per channel, how far each reduction lands from the exact (f64) sums:
    Kernel C's order (reduce_runs_plain), JAX's reduce_grads_presort and
    the port's emulation of it (tools/jax_reduction.py); then the step's
    parameter gradients with JAX's sums against the port's."""
    from sgs_tpu_torch.ops import flat_raster as pfr
    from sgs_tpu_torch.tools import jax_reduction

    views = train_views()
    rows = []
    for path in args.ckpts:
        it = int(np.load(path)["iteration"]) + 1
        cap, pg, tg, model, render_fn, gt = capture_instances(path, it, views)
        inst, rs, order = cap["inst"], cap["rank_start"], cap["order"]
        m = inst.shape[0]
        bucket = max(jax_reduction.BUCKET, 1 << int(np.ceil(np.log2(m))))
        c64 = torch.cat([torch.zeros(1, 9, dtype=torch.float64), torch.cumsum(inst.double(), 0)])
        exact = torch.empty((order.shape[0], 9), dtype=torch.float64)
        exact[order] = c64[rs[1:]] - c64[rs[:-1]]
        got = {"port": pfr.reduce_runs_plain(inst, rs, order),
               "jax": jax_reduce(inst, rs, order, bucket),
               "emulated": jax_reduction.jax_prefix_reduce(inst, rs, order, bucket)}
        live = torch.zeros(order.shape[0], dtype=torch.bool)
        live[order[(rs[1:] - rs[:-1]) > 0]] = True
        row = {"state": os.path.basename(path), "iteration": it, "instances": m, "bucket": bucket,
               "gaussians_with_instances": int(live.sum()), "channels": {}}
        for c, name in enumerate(CHANNELS):
            e = exact[live, c]
            entry = {"median_abs": float(e.abs().median())}
            for k, v in got.items():
                err = (v[live, c].double() - e).abs()
                entry[k] = {"max_err": float(err.max()), "mean_err": float(err.mean()),
                            "share_err_over_10pct": float((err > 0.1 * e.abs()).double().mean())}
            row["channels"][name] = entry
        with jax_reduction.use_jax_reduction(bucket):
            _, _, jpg, jtg, _ = ploop.view_grads(model, render_fn, gt)
        alive = model.alive
        row["fields"] = {}
        for f, a, b in [(f, pg[f], jpg[f]) for f in PARAM_FIELDS] + [("tap", tg[:, :2], jtg[:, :2])]:
            a, b = a[alive].double(), b[alive].double()
            nz = a.abs() > 0
            row["fields"][f] = {
                "share_err_over_10pct": float(((b - a).abs() > 0.1 * a.abs())[nz].double().mean()),
                "rel_rms": float(((b - a).pow(2).mean() / a.pow(2).mean()).sqrt())}
        rows.append(row)
        print(f"[reduction] {row['state']} it {it}: {m} instances, bucket {bucket}; share of Gaussians "
              "with error > 10% (port / JAX / emulated): " + ", ".join(
                  f"{n} " + "/".join(f"{row['channels'][n][k]['share_err_over_10pct']:.4f}"
                                     for k in ("port", "jax", "emulated")) for n in CHANNELS)
              + "; step gradients with JAX's sums, share of elements off by > 10%: " + ", ".join(
                  f"{f} {v['share_err_over_10pct']:.4f}" for f, v in row["fields"].items()), flush=True)
        if args.json:
            with open(args.json, "w") as fh:
                json.dump(rows, fh, indent=1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("time")
    t.add_argument("--ckpt", default=os.path.join(R5, "chkpnt10000.npz"))
    t.add_argument("--view", type=int, default=0)
    s = sub.add_parser("step")
    s.add_argument("--ckpts", nargs="+", default=CKPTS)
    s.add_argument("--views-per-state", type=int, default=8)
    s.add_argument("--json", default=None)
    d = sub.add_parser("drift")
    d.add_argument("--ckpt", required=True)
    d.add_argument("--steps", type=int, default=50)
    d.add_argument("--every", type=int, default=10)
    d.add_argument("--run", choices=("jax", "jax_ulp", "port"), required=True)
    d.add_argument("--out", required=True)
    c = sub.add_parser("compare-drift")
    c.add_argument("a")
    c.add_argument("b")
    e = sub.add_parser("densify")
    e.add_argument("--state", required=True)
    e.add_argument("--base", default=RESUME)
    e.add_argument("--iteration", type=int, default=3100)
    e.add_argument("--adam-step", type=int, default=100)
    e.add_argument("--key", type=int, default=0)
    e.add_argument("--json", default=None)
    r = sub.add_parser("reduction")
    r.add_argument("--ckpts", nargs="+", default=CKPTS)
    r.add_argument("--json", default=None)
    args = p.parse_args(argv)
    torch.set_num_threads(int(os.environ.get("PROBE_THREADS", "4")))
    {"time": cmd_time, "step": cmd_step, "drift": cmd_drift, "compare-drift": cmd_compare_drift,
     "densify": cmd_densify, "reduction": cmd_reduction}[args.cmd](args)


if __name__ == "__main__":
    main()
