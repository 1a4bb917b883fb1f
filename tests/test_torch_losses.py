"""The port's stage-1 losses against the JAX package's, on the CPU.

The JAX discriminator and LPIPS are built from a seed; their parameters
are carried into the port with ``compat.from_jax``. Inputs are numpy
arrays from a seed handed to both. The port runs on CPU tensors, so every
op takes its plain PyTorch version; JAX runs its XLA paths (the Pallas
kernels of the discriminator are held against the port in
``tests/test_torch_ops.py``). All in f32; each tolerance is stated at its
assert.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhancing_tpu.losses import LPIPS as JaxLPIPS
from enhancing_tpu.losses import StyleDiscriminator as JaxStyleDiscriminator
from enhancing_tpu.losses import GAN_LOSSES as JAX_GAN_LOSSES
from enhancing_tpu.losses import minibatch_stddev as jax_minibatch_stddev
from enhancing_tpu.losses.vqperceptual import \
    VQLPIPSWithDiscriminator as JaxVQLPIPSWithDiscriminator
from enhancing_tpu_torch.compat import (load_lpips_from_jax,
                                        load_style_discriminator_from_jax)
from enhancing_tpu_torch.losses import (GAN_LOSSES, LPIPS, StyleDiscriminator,
                                        VQLPIPSWithDiscriminator,
                                        minibatch_stddev)
from enhancing_tpu_torch.ops.common import PLAIN_CALLS, reset_launches

SIZE = 32
LOSS_KW = dict(image_size=SIZE, loglaplace_weight=0.5, loggaussian_weight=1.0,
               perceptual_weight=0.1, allow_random_lpips=True,
               adversarial_weight=0.1, disc_loss="hinge")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _images(batch, seed):
    return np.random.default_rng(seed).random((batch, SIZE, SIZE, 3),
                                              dtype=np.float32)


@pytest.fixture(scope="module")
def losses():
    """The composite loss on both sides with the same D and LPIPS weights."""
    jl = JaxVQLPIPSWithDiscriminator(**LOSS_KW)
    tl = VQLPIPSWithDiscriminator(**LOSS_KW)
    load_style_discriminator_from_jax(tl.discriminator,
                                      _np_tree(jl.disc_init_params))
    load_lpips_from_jax(tl.perceptual, _np_tree(jl.lpips_params))
    return jl, tl


@pytest.mark.parametrize("name", ["hinge", "vanilla", "least_square"])
def test_gan_losses_match_jax(name):
    rng = np.random.default_rng(0)
    fake, real = (rng.standard_normal(16).astype(np.float32) for _ in "ab")
    for args in ((fake,), (fake, real)):
        want = JAX_GAN_LOSSES[name](*map(jnp.asarray, args))
        got = GAN_LOSSES[name](*map(_t, args))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("batch", [8, 6, 3])
def test_minibatch_stddev_matches_jax(batch):
    x = np.random.default_rng(1).standard_normal((batch, 4, 4, 16)).astype(
        np.float32)
    want = jax_minibatch_stddev(jnp.asarray(x))
    got = minibatch_stddev(_t(x))
    # f32 variance and mean over a few values
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-5)


def test_style_discriminator_output_and_input_gradient(losses):
    jl, tl = losses
    x = _images(8, 2) * 2 - 1
    params = jl.disc_init_params
    want, vjp = jax.vjp(lambda a: jl.run_discriminator(params, a),
                        jnp.asarray(x))
    g = np.random.default_rng(3).standard_normal(8).astype(np.float32)
    (want_dx,) = vjp(jnp.asarray(g))
    leaf = _t(x).requires_grad_()
    got = tl.discriminator(leaf)
    (got_dx,) = torch.autograd.grad(got, leaf, _t(g))
    assert got.shape == (8,)
    # f32 through 12 convolutions of up to 512 channels, another order
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx),
                               atol=1e-5, rtol=1e-3)


def test_discriminator_loader_rejects_a_wrong_tree(losses):
    jl, _ = losses
    tree = _np_tree(jl.disc_init_params)
    with pytest.raises(KeyError):
        load_style_discriminator_from_jax(
            StyleDiscriminator(size=SIZE), dict(tree, extra={"bias": 0.0}))
    with pytest.raises(KeyError, match="block_6"):
        load_style_discriminator_from_jax(StyleDiscriminator(size=64), tree)
    bad = dict(tree, final_linear2=dict(tree["final_linear2"],
                                        weight=np.zeros((512, 2))))
    with pytest.raises(ValueError, match="final_linear2.weight"):
        load_style_discriminator_from_jax(StyleDiscriminator(size=SIZE), bad)


def test_lpips_matches_jax(losses):
    jl, tl = losses
    x, y = (_images(3, s) * 2 - 1 for s in (4, 5))
    want = jl.perceptual.apply({"params": jl.lpips_params}, jnp.asarray(x),
                               jnp.asarray(y))
    got = tl.perceptual(_t(x), _t(y))
    assert got.shape == (3,)
    # f32 through 13 convolutions and a unit normalisation
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    assert not any(p.requires_grad for p in tl.perceptual.parameters())


def _close_logs(got, want, rtol, atol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


def test_generator_loss_matches_jax(losses):
    jl, tl = losses
    x, xrec = _images(8, 6), _images(8, 7)
    qloss = np.float32(0.37)
    _, want = jl.generator_loss(jnp.asarray(qloss), jnp.asarray(x),
                                jnp.asarray(xrec), jl.disc_init_params, 1.0)
    _, got = tl.generator_loss(torch.tensor(qloss), _t(x), _t(xrec), 1.0)
    # f32 sums over the batch and the pixels
    _close_logs(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("do_r1", [False, True])
def test_discriminator_loss_and_its_gradient_match_jax(losses, do_r1):
    """With R1 the D-parameter gradient differentiates the input gradient
    a second time: the check of force_plain_ops' double backward."""
    jl, tl = losses
    x, xrec = _images(4, 8), _images(4, 9)

    def jax_loss(p):
        return jl.discriminator_loss(p, jnp.asarray(x), jnp.asarray(xrec),
                                     1.0, do_r1=do_r1)

    (_, want), want_grads = jax.value_and_grad(jax_loss, has_aux=True)(
        jl.disc_init_params)
    reset_launches()
    d_loss, got = tl.discriminator_loss(_t(x), _t(xrec), 1.0, do_r1=do_r1)
    params = dict(tl.discriminator.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(d_loss,
                                                 list(params.values()))))
    _close_logs(got, want, rtol=1e-4, atol=1e-6)
    assert sum(PLAIN_CALLS.values()) == 0  # CPU tensors are not routed
    # every gradient tensor, relative to its own largest entry: f32 through
    # a second-order backward of 12 convolutions, where the small entries
    # are sums over 4 x 16 x 16 positions that cancel: 3e-3 of the largest
    # entry plus 1e-3 relative
    for path, leaf in jax.tree_util.tree_flatten_with_path(want_grads)[0]:
        keys = [p.key for p in path]
        name = ".".join(keys[:-1] + ["weight" if keys[-1] in ("kernel",)
                                     else keys[-1]])
        g = grads[name].numpy()
        w = np.asarray(leaf)
        if w.ndim == 4:
            w = w.transpose(3, 2, 0, 1)
        elif w.ndim == 2:
            w = w.T
        np.testing.assert_allclose(g, w, atol=3e-3 * np.abs(w).max(),
                                   rtol=1e-3, err_msg=name)


def test_r1_chunk_equals_the_one_shot_penalty(losses):
    _, tl = losses
    x, xrec = _images(8, 10), _images(8, 11)
    _, whole = tl.discriminator_loss(_t(x), _t(xrec), do_r1=True)
    tl.r1_chunk = 4
    try:
        _, chunked = tl.discriminator_loss(_t(x), _t(xrec), do_r1=True)
        tl.r1_chunk = 3
        with pytest.raises(ValueError, match="r1_chunk"):
            tl.discriminator_loss(_t(x), _t(xrec), do_r1=True)
    finally:
        tl.r1_chunk = None
    # the same per-image norms, summed in another order
    np.testing.assert_allclose(float(chunked["train/r1_reg"]),
                               float(whole["train/r1_reg"]), rtol=1e-5)


def test_random_lpips_is_refused_for_training():
    loss = VQLPIPSWithDiscriminator(**dict(LOSS_KW, allow_random_lpips=False))
    with pytest.raises(ValueError, match="allow_random_lpips"):
        loss.check_trainable()
    VQLPIPSWithDiscriminator(**LOSS_KW).check_trainable()


def test_adaptive_weight_matches_jax(losses):
    jl, tl = losses
    rng = np.random.default_rng(12)
    a, b = (rng.standard_normal((64, 48)).astype(np.float32) for _ in "ab")
    want = jl.adaptive_weight(jnp.asarray(a), jnp.asarray(b))
    got = tl.adaptive_weight(_t(a), _t(b))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
