"""Port parity of the latent/structured model on the CPU: `quat_multiply`,
the quaternion composition, the positional embedding, the autodecoder,
`create_from_pcd`, `decode`/`render_inputs` and the gradients of a decode
loss, each against the JAX package on the same inputs (numpy, seeded) and
the same weights (carried across; the initialisers cannot share bits).

Tolerances:
- the quaternion product and composition: bit for bit (the same f32
  operations in the same order, eager JAX against eager PyTorch);
- the positional embedding: the x block exactly, sin/cos to 1 ulp-scale
  (atol 1e-6; the two libraries' sin and cos of the same f32 argument);
- the decoder, `decode` and `render_inputs`: rtol 2e-5, atol 1e-6, the
  bar of tests/test_latent_model.py (f32 matrix products summed in
  another order);
- `create_from_pcd`'s deterministic fields (means, opacities, rotations,
  latents 0:14) and the median: exactly, on an even count with the clip
  active, from the same 3-NN distances; the log-scales to one ulp (XLA's
  CPU sqrt and log are not correctly rounded);
- the gradients of a decode loss: rtol 1e-4 plus 2e-4 of each leaf's
  largest magnitude (the bar of tests/test_torch_train_step.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgs_tpu.core import transforms as jtransforms
from sgs_tpu.models import autodecoder as jdec
from sgs_tpu.models import latent as jlatent
from sgs_tpu.ops.knn import mean_sq_dist_3nn as jax_knn
from sgs_tpu_torch.core import transforms
from sgs_tpu_torch.models import autodecoder
from sgs_tpu_torch.models import latent
from sgs_tpu_torch.ops import knn as knn_port

torch.set_num_threads(1)
RTOL, ATOL = 2e-5, 1e-6
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 2e-4


def _flat(tree, prefix=""):
    """A flax parameter tree as {"a/b/c": numpy array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _quats(seed, shape):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    q[0] = 0.0  # a zero quaternion: normalize's 1e-12 floor
    q[1, 0] = -abs(q[1, 0])
    return q


def test_quat_multiply_bit_for_bit():
    a, b = _quats(0, (64,)), _quats(1, (64,))
    want = np.asarray(jtransforms.quat_multiply(jnp.asarray(a), jnp.asarray(b)))
    got = transforms.quat_multiply(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)


def test_quaternion_normalize_then_multiply_bit_for_bit():
    # broadcast as decode() does: one structure quaternion against K offsets
    a, b = _quats(2, (30,))[:, None, :], _quats(3, (30, 8))
    with jax.disable_jit():
        want = np.asarray(jlatent.quaternion_normalize_then_multiply(jnp.asarray(a), jnp.asarray(b)))
    got = latent.quaternion_normalize_then_multiply(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[..., 0] >= 0).all() and (want[..., 0] < 0).sum() == 0


def test_get_embedder():
    x = np.random.default_rng(4).uniform(-3, 3, (50, 3)).astype(np.float32)
    jembed, jdim = jdec.get_embedder(10)
    embed, dim = autodecoder.get_embedder(10)
    assert dim == jdim == 63
    want = np.asarray(jembed(jnp.asarray(x)))
    got = embed(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


DECODERS = {
    "plain": dict(latent_size=32, hidden_sizes=[64, 64], output_dim=112, norm_layers=()),
    "plain_no_residual": dict(latent_size=32, hidden_sizes=[48, 48, 48], output_dim=40,
                              norm_layers=(), residual=False),
    "weight_norm": dict(latent_size=8, hidden_sizes=[16], output_dim=4, norm_layers=(0, 1),
                        residual=False),
    "weight_norm_residual_tanh": dict(latent_size=16, hidden_sizes=[24, 24, 24], output_dim=10,
                                      norm_layers=(0, 2, 3), use_tanh=True),
    "latent_in": dict(latent_size=12, hidden_sizes=[20, 30, 30], output_dim=6, norm_layers=(1,),
                      latent_in=(2,), residual=False),
    "pos_emb": dict(latent_size=32, hidden_sizes=[32, 32], output_dim=112, pos_emb_size=63,
                    norm_layers=()),
}


@pytest.mark.parametrize("name", sorted(DECODERS))
def test_decoder_matches_jax(name):
    cfg = DECODERS[name]
    jdecoder = jdec.Decoder(**cfg)
    in_dim = cfg["latent_size"] + cfg.get("pos_emb_size", 0)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(40, in_dim)).astype(np.float32)
    params = jdecoder.init(jax.random.PRNGKey(6), jnp.asarray(x))["params"]
    arrays = _flat(params)
    if "v" in str(arrays.keys()):
        # g away from ||v|| so the normalisation is exercised
        for k in arrays:
            if k.endswith("/g"):
                arrays[k] = arrays[k] * rng.uniform(0.5, 2.0, arrays[k].shape).astype(np.float32)
        params = jax.tree_util.tree_map(jnp.asarray, _unflat(arrays))
    want = np.asarray(jdecoder.apply({"params": params}, jnp.asarray(x)))

    cfg_t = {k: v for k, v in cfg.items()}
    dec = autodecoder.Decoder(**cfg_t)
    names = {n for n, _, _ in dec.jax_named_parameters()}
    assert names == set(arrays), (names, set(arrays))
    dec.load_jax_arrays(arrays)
    got = dec(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _unflat(arrays):
    tree = {}
    for k, v in arrays.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def test_decoder_init_distribution():
    """JAX's initialiser: weights U(+-1/sqrt(in)), biases U(+-1/sqrt(out)),
    g the norm of v's output rows (so W = v at init)."""
    dec = autodecoder.Decoder(latent_size=400, hidden_sizes=[900], output_dim=4,
                              norm_layers=(1,))
    dec.reset_parameters(torch.Generator().manual_seed(0))
    w0, b0 = dec.layers["lin0"].weight.detach(), dec.layers["lin0"].bias.detach()
    assert w0.shape == (900, 400)
    assert float(w0.abs().max()) <= 1 / 20 and float(w0.abs().max()) > 0.95 / 20
    assert float(b0.abs().max()) <= 1 / 30 and float(b0.abs().max()) > 0.9 / 30
    v, g, b = (p.detach() for p in (dec.layers["lin1"].v, dec.layers["lin1"].g, dec.layers["lin1"].b))
    assert float(v.abs().max()) <= 1 / 30 and 0.4 < float(b.abs().max()) <= 0.5
    torch.testing.assert_close(g, torch.linalg.vector_norm(v, dim=1), rtol=0, atol=0)


def _pcd(m, seed):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(m, 3)) * 0.4).astype(np.float32)
    pts[:3] += 25.0  # three far outliers: their 3-NN scale is clipped
    cols = rng.uniform(size=(m, 3)).astype(np.float32)
    return pts, cols


def _jax_model(m, seed, **config):
    pts, cols = _pcd(m, seed)
    model = jlatent.LatentGaussianModel.create(
        jax.random.PRNGKey(seed), np.zeros((1, 3), np.float32), **config)
    return model.create_from_pcd(jax.random.PRNGKey(seed + 1), pts, cols), pts, cols


def _arrays(jmodel):
    return _flat(jax.tree_util.tree_map(np.asarray, jmodel.trainable_params()))


def test_create_from_pcd_deterministic_fields(monkeypatch):
    m = 40  # even: the median averages the two middle distances
    jmodel, pts, cols = _jax_model(m, 7)
    # the 3-NN distances are the knn port's (matrix products summed in
    # another order); the rest of the init is held to JAX from JAX's
    knn = np.asarray(jax_knn(jnp.asarray(pts)))
    np.testing.assert_allclose(knn_port.mean_sq_dist_3nn(torch.from_numpy(pts)).numpy(), knn, rtol=1e-5)
    monkeypatch.setattr(knn_port, "mean_sq_dist_3nn", lambda p: torch.tensor(knn))
    model = latent.LatentGaussianModel(1, device="cpu")
    model.create_from_pcd(torch.Generator().manual_seed(0), pts, cols)
    dist = np.sqrt(np.maximum(knn, 1e-7))
    med = np.float32((np.sort(dist)[m // 2 - 1] + np.sort(dist)[m // 2]) * np.float32(0.5))
    assert med != np.sort(dist)[m // 2 - 1], "the median must differ from torch.median's"
    assert (dist > 4 * med).sum() == 3, "the clip must be active"
    got_med = latent.median(torch.from_numpy(dist)).numpy()
    assert got_med == np.asarray(jnp.median(jnp.asarray(dist))) == med
    for f in ("structure_means", "structure_opacities", "structure_rotations"):
        np.testing.assert_array_equal(getattr(model, f).detach().numpy(),
                                      np.asarray(getattr(jmodel, f)), err_msg=f)
    # XLA's CPU sqrt and log are not correctly rounded (on 100,000 uniform
    # f32 inputs 703 square roots and 7,962 logarithms differ from
    # PyTorch's by one ulp), so the log-scales are held to one ulp
    np.testing.assert_array_max_ulp(model.structure_scales.detach().numpy(),
                                    np.asarray(jmodel.structure_scales), maxulp=1)
    clipped = model.structure_scales.detach().numpy()[dist > 4 * med]
    np.testing.assert_array_equal(clipped, torch.log(torch.tensor(np.float32(4.0) * med)).numpy())
    np.testing.assert_array_equal(model.structure_latents.detach().numpy()[:, :14],
                                  np.asarray(jmodel.structure_latents)[:, :14])
    assert model.structure_latents.shape == (m, 32)
    assert float(model.structure_latents.detach()[:, 14:].std()) > 0.5


@pytest.mark.parametrize("pos_emb", [False, True])
def test_decode_and_render_inputs_match_jax(pos_emb):
    jmodel, _, _ = _jax_model(24, 8, use_positional_embedding=pos_emb)
    model = latent.LatentGaussianModel.from_jax_arrays(_arrays(jmodel), device="cpu",
                                                       use_positional_embedding=pos_emb)
    noise = np.random.default_rng(9).normal(0, 0.1, (24, 32)).astype(np.float32)
    for jn, n in ((None, None), (jnp.asarray(noise), torch.from_numpy(noise))):
        with jax.disable_jit():
            want = jmodel.decode(jn)
            jin = jmodel.render_inputs(0, jn)
        got = model.decode(n)
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        gin = model.render_inputs(0, n)
        for k in ("means3d", "opacities", "scales", "rotations", "shs"):
            np.testing.assert_allclose(getattr(gin, k).detach().numpy(), np.asarray(getattr(jin, k)),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        assert gin.sh_degree == 0 and bool(gin.alive.all()) and gin.alive.shape == (24 * 8,)


def test_decode_gradients_match_jax():
    jmodel, _, _ = _jax_model(16, 10, use_positional_embedding=True)
    model = latent.LatentGaussianModel.from_jax_arrays(_arrays(jmodel), device="cpu",
                                                       use_positional_embedding=True)
    rng = np.random.default_rng(11)
    with jax.disable_jit():
        raw = jmodel.decode()
    target = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in raw.items()}

    def jloss(p):
        out = jmodel.with_params(p).decode()
        return sum(jnp.sum((out[k] - target[k]) ** 2) for k in out)

    with jax.disable_jit():
        want = _flat(jax.tree_util.tree_map(np.asarray, jax.grad(jloss)(jmodel.trainable_params())))
    params = model.trainable_params()
    out = model.decode()
    loss = sum(torch.sum((out[k] - torch.from_numpy(target[k])) ** 2) for k in out)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    transposed = model.transposed_params()
    assert set(grads) == set(want)
    for k, g in grads.items():
        g = (g.T if k in transposed else g).numpy()
        scale = float(np.abs(want[k]).max())
        assert scale > 0, k
        np.testing.assert_allclose(g, want[k], rtol=GRAD_RTOL, atol=GRAD_ATOL_SCALE * scale,
                                   err_msg=k)
