"""Gradients through the port's reference rasterizer (`render/reference.py`)
against `jax.grad` through the JAX package's, on the CPU.

Mirrors tests/test_reference_render.py's gradient checks: the oracle's
gradient of a loss with respect to the means, conics, colours and
opacities, and the screen-space tap's (with the means' and opacities')
through `render(mode="reference")`, within rtol 1e-4 of JAX's plus an atol
of 1e-6 of each field's largest gradient (the f32 noise of sums over a few
hundred pixels); then one training step through the oracle (autograd
through the checkpointed chunks, as `--rasterizer reference` trains) of
the 3DGS pool and of the latent model against JAX's, jitted (op by op each
takes a minute), to the tolerances of tests/test_torch_train_step.py.
The scenes and helpers are tests/test_torch_reference_render.py's.
"""

import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from sgs_tpu.core.camera import Camera as JaxCamera
from sgs_tpu.models.gaussians import PARAM_FIELDS
from sgs_tpu.ops.ssim import l1_loss as jax_l1
from sgs_tpu.ops.ssim import ssim as jax_ssim
from sgs_tpu.render import render as jax_render
from sgs_tpu.render.reference import rasterize_sorted as jax_rasterize_sorted
from sgs_tpu.train import checkpoint as jckpt
from sgs_tpu.train import loop as jloop
from sgs_tpu_torch.core.camera import Camera
from sgs_tpu_torch.data.readers import read_cameras_from_transforms
from sgs_tpu_torch.models.latent import LatentGaussianModel
from sgs_tpu_torch.render.pipeline import render
from sgs_tpu_torch.render.reference import rasterize_sorted
from sgs_tpu_torch.train import checkpoint, lgm_trainer, loop
from sgs_tpu_torch.train.optim import make_lr_dict
from sgs_tpu_torch.utils.config import OptimizationParams

from test_torch_lgm_step import _checkpoint_arrays as _lgm_arrays
from test_torch_lgm_step import _flat as _lgm_flat
from test_torch_lgm_step import _jax_model as _lgm_jax_model
from test_torch_reference_render import ROOT, cameras, close_grad, random_scene, scene_inputs, terminating_scene
from test_torch_train_step import ITERATION, _close, _jax_state, _view

torch.set_num_threads(1)


def test_gradients_match_jax():
    """d(loss)/d(mean2d, conic, rgb, opacity) of the oracle, autograd
    through the checkpointed chunks against jax.grad through JAX's."""
    _, _, p = terminating_scene(seed=5)
    target = np.random.default_rng(6).uniform(size=(3, 32, 40)).astype(np.float32)
    rest = ("valid", "bg")

    def jloss(m, c, r, o):
        img = jax_rasterize_sorted(m, jnp.asarray(p["depth"]), c, r, o,
                                   *(jnp.asarray(p[k]) for k in rest), 40, 32,
                                   radius=jnp.asarray(p["radius"]), chunk_size=16, pixel_block=256)
        return jnp.sum(jnp.abs(img - target))

    diff = ("mean2d", "conic", "rgb", "opacity")
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(p[k]) for k in diff))
    leaves = [torch.tensor(p[k], requires_grad=True) for k in diff]
    img = rasterize_sorted(leaves[0], torch.as_tensor(p["depth"]), leaves[1], leaves[2], leaves[3],
                           *(torch.as_tensor(p[k]) for k in rest), 40, 32,
                           radius=torch.as_tensor(p["radius"]), chunk_size=16, pixel_block=256)
    torch.sum(torch.abs(img - torch.from_numpy(target))).backward()
    for name, leaf, w in zip(diff, leaves, want):
        assert float(np.abs(np.asarray(w)).max()) > 0, name
        close_grad(leaf.grad, w, name)


def test_train_step_through_the_oracle_matches_jax(tmp_path):
    """One `train_step` with mode="reference" (the backward by autograd
    through the oracle) against JAX's, jitted (op by op it takes a minute),
    on the state and view of tests/test_torch_train_step.py cut to 400
    Gaussians at 48x48, to that file's tolerances."""
    jstate = _jax_state(False)
    keep = np.arange(400)
    pool = jstate.pool.replace(alive=jstate.pool.alive & jnp.isin(jnp.arange(jstate.pool.capacity), keep))
    jstate = jloop.TrainState(pool=pool, adam=jstate.adam, stats=jstate.stats)
    path = str(tmp_path / "state.npz")
    jckpt.save_checkpoint(path, jstate, ITERATION, 3, 4.03)
    state = checkpoint.load_checkpoint(path, device="cpu")[0]
    info, gt96 = _view()
    gt = gt96.reshape(3, 48, 2, 48, 2).mean(axis=(2, 4)).astype(np.float32)
    jcam = JaxCamera.from_Rt(info.R, info.T, info.FovX, info.FovY, 48, 48)
    cam = Camera.from_Rt(info.R, info.T, info.FovX, info.FovY, 48, 48, device="cpu")
    lrs = make_lr_dict(OptimizationParams(), 4.03, ITERATION)
    jnew, jm = jloop.train_step(jstate, jcam, jnp.asarray(gt), jnp.zeros(3),
                                {k: jnp.float32(v) for k, v in lrs.items()},
                                active_sh_degree=3, mode="reference")
    new, m = loop.train_step(state, cam, torch.from_numpy(gt), torch.zeros(3), lrs,
                             active_sh_degree=3, mode="reference")
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert int(m["n_visible"]) == int(jm["n_visible"]) > 20
    for f in PARAM_FIELDS:
        _close(getattr(new.model, f), getattr(jnew.pool, f), f)
        _close(new.adam.mu[f], jnew.adam.mu[f], f"mu {f}")
    _close(new.stats.xyz_gradient_accum, jnew.stats.xyz_gradient_accum, "xyz_gradient_accum")
    moved = new.stats.xyz_gradient_accum - state.stats.xyz_gradient_accum
    assert float(moved.abs().max()) > 0


def test_tap_gradient_matches_jax():
    """The screen-space tap's gradient through render(mode="reference"),
    in NDC units, with the means' and opacities'."""
    jcam, cam = cameras(30, 26)
    scene = random_scene(12, seed=21)
    jin, tin = scene_inputs(scene, "reference", colors=True)
    target = np.random.default_rng(22).uniform(size=(3, 26, 30)).astype(np.float32)

    def jloss(tap, means, opac):
        out = jax_render(jcam, jin.replace(means3d=means, opacities=opac), jnp.zeros(3),
                         vspace_tap=tap, mode="reference")
        return jnp.mean(jnp.abs(out["render"] - target))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.zeros((12, 3)), jin.means3d, jin.opacities)
    tap = torch.zeros((12, 3), requires_grad=True)
    means = tin.means3d.clone().requires_grad_(True)
    opac = tin.opacities.clone().requires_grad_(True)
    tin.means3d, tin.opacities = means, opac
    out = render(cam, tin, torch.zeros(3), vspace_tap=tap, mode="reference")
    torch.mean(torch.abs(out["render"] - torch.from_numpy(target))).backward()
    assert float(tap.grad[:, :2].abs().max()) > 0 and float(tap.grad[:, 2].abs().max()) == 0
    for name, leaf, w in zip(("tap", "means", "opacities"), (tap, means, opac), want):
        close_grad(leaf.grad, w, name)


def test_lgm_step_through_the_oracle_matches_jax():
    """The latent model's step gradients with mode="reference" (what
    `train_lgm --rasterizer reference` runs) against JAX's, jitted as its
    LGM trainer's step is, on tests/test_torch_lgm_step.py's 250 structures
    of the committed checkpoint, at 48x48, to that file's tolerances."""
    keep = np.sort(np.random.default_rng(0).choice(2000, 250, replace=False))
    arrays = {k: (v[keep] if k.startswith("structure_") else v) for k, v in _lgm_arrays().items()}
    info = read_cameras_from_transforms(os.path.join(ROOT, "data", "lgm400"), "transforms_train.json",
                                        False)[3]
    full = np.asarray(info.image, np.float32).transpose(2, 0, 1)[:, :384, :384] / 255.0
    gt = full.reshape(3, 48, 8, 48, 8).mean(axis=(2, 4)).astype(np.float32)
    jcam = JaxCamera.from_Rt(info.R, info.T, info.FovX, info.FovY, 48, 48)
    cam = Camera.from_Rt(info.R, info.T, info.FovX, info.FovY, 48, 48, device="cpu")
    jmodel = _lgm_jax_model(arrays)

    def loss_fn(p):
        image = jax_render(jcam, jmodel.with_params(p).render_inputs(0), jnp.zeros(3),
                           mode="reference")["render"]
        ll1 = jax_l1(image, jnp.asarray(gt))
        return (1 - 0.2) * ll1 + 0.2 * (1 - jax_ssim(image, jnp.asarray(gt)))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jmodel.trainable_params())
    want = _lgm_flat(jax.tree_util.tree_map(np.asarray, jgrads))
    model = LatentGaussianModel.from_jax_arrays(arrays, device="cpu")
    loss, _, grads, out = lgm_trainer.lgm_grads(model, cam, torch.from_numpy(gt), torch.zeros(3), 0.2, 0,
                                                mode="reference")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert out["n_instances"] == 0 and int((out["radii"] > 0).sum()) > 500
    transposed = model.transposed_params()
    assert set(grads) == set(want)
    for k, g in grads.items():
        _close((g.T if k in transposed else g).numpy(), want[k], k)
