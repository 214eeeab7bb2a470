"""Port parity of the latent model's training step on the CPU.

- The Adam (`optim.adam_tree_update`) against `optax.adam(5e-4,
  eps=1e-15)` over 10 steps on a seeded tree shaped like the LGM's, from
  non-zero moments and step count 30: rtol 1e-6 (measured: equal bits).
- One step's gradients from the committed JAX run's checkpoint
  (`runs/lgm_r5/chkpnt3000.npz`): a seeded subset of 250 structures
  (2,000 decoded Gaussians) and the trained decoder, on a `data/lgm400`
  train view mean-pooled to 96x96. JAX renders in tiled mode with the
  Pallas backend and tight culling (the kernels in interpret mode) and
  takes its gradient jitted, as its LGM trainer's step does
  (`make_lgm_train_step` is a `jax.jit`): op by op under
  `jax.disable_jit` the JAX side alone takes about 45 s here, and the
  two differ far inside the bar below (tests/test_torch_train_step.py
  measured jitted against op by op: 6.8e-5 of a field's largest
  gradient). The port runs Kernels A-D's plain versions. The loss and L1
  to rtol 1e-5; every leaf's gradient to rtol 1e-4 plus 2e-4 of the
  leaf's largest magnitude, the f32 noise floor of such gradients that
  tests/test_torch_train_step.py documents; the non-finite count
  exactly; then the port's step. Gradients are compared, not one Adam
  step: Adam restarts on resume, and its first step is sign-like, which
  would hide a gradient error. tests/test_torch_lgm_nonfinite.py runs the
  same check with one structure made degenerate.
"""

import os

import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax

from sgs_tpu.core.camera import Camera as JaxCamera
from sgs_tpu.data import readers
from sgs_tpu.data.scene import pool_from_arrays
from sgs_tpu.models import latent as jlatent
from sgs_tpu.ops.ssim import l1_loss as jax_l1
from sgs_tpu.ops.ssim import ssim as jax_ssim
from sgs_tpu.render.pipeline import render as jax_render
from sgs_tpu.train import lgm_trainer as jtrainer
from sgs_tpu.train import loop as jloop
from sgs_tpu_torch.core.camera import Camera
from sgs_tpu_torch.models.latent import LatentGaussianModel
from sgs_tpu_torch.train import lgm_trainer
from sgs_tpu_torch.train.optim import TreeAdamState, adam_tree_update

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(ROOT, "runs", "lgm_r5", "chkpnt3000.npz")
N_SUBSET, SIZE, VIEW, LAMBDA = 250, 96, 3, 0.2
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 2e-4


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jax_model(arrays):
    decoder = {}
    for k, v in arrays.items():
        if k.startswith("decoder_params/"):
            _, lin, leaf = k.split("/")
            decoder.setdefault(lin, {})[leaf] = jnp.asarray(v)
    fields = {k: jnp.asarray(v) for k, v in arrays.items() if k.startswith("structure_")}
    return jlatent.LatentGaussianModel(decoder_params=decoder, **fields)


def _checkpoint_arrays():
    z = np.load(CHECKPOINT)
    return {k[2:]: z[k] for k in z.files if k.startswith("p:")}


def test_adam_matches_optax():
    rng = np.random.default_rng(0)
    model = LatentGaussianModel(60, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in model.trainable_params().items()}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    mu = {k: rng.normal(0, 1e-3, s).astype(np.float32) for k, s in shapes.items()}
    nu = {k: rng.uniform(1e-8, 1e-6, s).astype(np.float32) for k, s in shapes.items()}
    opt = optax.adam(jtrainer.LGM_LR, eps=jtrainer.LGM_EPS)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    (adam_state, *rest) = opt.init(jp)
    jstate = (adam_state._replace(count=jnp.int32(30), mu={k: jnp.asarray(v) for k, v in mu.items()},
                                  nu={k: jnp.asarray(v) for k, v in nu.items()}), *rest)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = TreeAdamState(mu={k: torch.from_numpy(v.copy()) for k, v in mu.items()},
                           nu={k: torch.from_numpy(v.copy()) for k, v in nu.items()}, count=30)
    assert (lgm_trainer.LGM_LR, lgm_trainer.LGM_EPS) == (jtrainer.LGM_LR, jtrainer.LGM_EPS)
    for _ in range(10):
        g = {k: rng.normal(0, 1e-2, s).astype(np.float32) for k, s in shapes.items()}
        updates, jstate = opt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tp, tstate = adam_tree_update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, tstate,
                                      lgm_trainer.LGM_LR, eps=lgm_trainer.LGM_EPS)
    assert tstate.count == int(jstate[0].count) == 40
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(tstate.mu[k].numpy(), np.asarray(jstate[0].mu[k]), rtol=1e-6)
        np.testing.assert_allclose(tstate.nu[k].numpy(), np.asarray(jstate[0].nu[k]), rtol=1e-6)


def _view():
    info = readers.read_cameras_from_transforms(
        os.path.join(ROOT, "data", "lgm400"), "transforms_train.json", False)[VIEW]
    f = 400 // SIZE
    full = np.asarray(info.image, np.float32).transpose(2, 0, 1)[:, :SIZE * f, :SIZE * f] / 255.0
    gt = full.reshape(3, SIZE, f, SIZE, f).mean(axis=(2, 4)).astype(np.float32)
    return info, gt


def check_step(degenerate: bool) -> None:
    full = _checkpoint_arrays()
    keep = np.sort(np.random.default_rng(0).choice(2000, N_SUBSET, replace=False))
    arrays = {k: (v[keep] if k.startswith("structure_") else v) for k, v in full.items()}
    if degenerate:
        arrays["structure_scales"] = arrays["structure_scales"].copy()
        arrays["structure_scales"][5] = [50.0, 0.0, 0.0]
    info, gt = _view()
    jcam = JaxCamera.from_Rt(info.R, info.T, info.FovX, info.FovY, SIZE, SIZE)
    cam = Camera.from_Rt(info.R, info.T, info.FovX, info.FovY, SIZE, SIZE, device="cpu")
    jmodel = _jax_model(arrays)
    bg = jnp.zeros(3)

    raw = {k: np.asarray(v) for k, v in jmodel.decode().items()}
    mi, mr, mk = jloop.instance_bucket(pool_from_arrays(raw, 0), jcam, tight=True)

    def loss_fn(p):  # make_lgm_train_step's loss
        out = jax_render(jcam, jmodel.with_params(p).render_inputs(0), bg, mode="tiled",
                         max_instances=mi, backend="pallas", max_row_instances=mr,
                         max_kernel_rows=mk)
        image = out["render"]
        ll1 = jax_l1(image, jnp.asarray(gt))
        loss = (1 - LAMBDA) * ll1 + LAMBDA * (1 - jax_ssim(image, jnp.asarray(gt)))
        return loss, (ll1, out["overflow"])

    (jloss, (jl1, ovf)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jmodel.trainable_params())
    assert int(ovf) == 0
    want = _flat(jax.tree_util.tree_map(np.asarray, jgrads))
    want_nonfinite = sum(int((~np.isfinite(g)).sum()) for g in want.values())
    assert (want_nonfinite > 0) == degenerate

    model = LatentGaussianModel.from_jax_arrays(arrays, device="cpu")
    loss, l1, grads, out = lgm_trainer.lgm_grads(model, cam, torch.from_numpy(gt), torch.zeros(3),
                                                 LAMBDA, 0)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(l1), float(jl1), rtol=1e-5)
    assert int((out["radii"] > 0).sum()) > 1000
    transposed = model.transposed_params()
    assert set(grads) == set(want)
    for k, g in grads.items():
        g = (g.T if k in transposed else g).numpy()
        fin = np.isfinite(want[k])
        np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=k)
        scale = float(np.abs(want[k][fin]).max())
        assert scale > 0, k
        np.testing.assert_allclose(g[fin], want[k][fin], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_SCALE * scale, err_msg=k)

    # the step: the same loss, the guard's count, every leaf moved and finite
    before = {k: v.detach().clone() for k, v in model.trainable_params().items()}
    adam, m = lgm_trainer.lgm_train_step(model, TreeAdamState.init(before), cam,
                                         torch.from_numpy(gt), torch.zeros(3), LAMBDA, 0)
    assert float(m["loss"]) == float(loss)
    assert int(m["nonfinite_grads"]) == want_nonfinite
    assert adam.count == 1
    for k, p in model.trainable_params().items():
        assert bool(torch.isfinite(p).all()), k
        assert not torch.equal(p.detach(), before[k]), k


def test_step_gradients_match_jax():
    check_step(degenerate=False)
