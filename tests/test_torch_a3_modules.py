"""The rest of the port's training modules against the JAX package's, on
the CPU: ``PatchDiscriminator`` with BatchNorm or ActNorm, the
segmentation losses, the ``VQCond`` / ``VQSegmentation`` condition
models and the LPIPS weight loader.

JAX weights are drawn from a seed and carried across with
``compat.from_jax``; inputs are made with numpy from a seed. All f32; each
tolerance is stated where it is used. Torch runs on one thread here: the
tests share the CPU with other test processes.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhancing_tpu.losses import ActNorm as JaxActNorm
from enhancing_tpu.losses import BCELoss as JaxBCELoss
from enhancing_tpu.losses import BCELossWithQuant as JaxBCELossWithQuant
from enhancing_tpu.losses import PatchDiscriminator as JaxPatchDiscriminator
from enhancing_tpu.losses.lpips import LPIPS as JaxLPIPS
from enhancing_tpu.losses.lpips import \
    load_torch_lpips as jax_load_torch_lpips
from enhancing_tpu.models.cond import VQCond as JaxVQCond
from enhancing_tpu.models.cond import VQSegmentation as JaxVQSegmentation
from enhancing_tpu_torch.compat import (load_patch_discriminator_from_jax,
                                        load_vitvq_from_jax)
from enhancing_tpu_torch.losses import (VQLPIPS, ActNorm, BCELoss,
                                        BCELossWithQuant, PatchDiscriminator,
                                        init_lpips)
from enhancing_tpu_torch.models.cond import VQCond, VQSegmentation
from enhancing_tpu_torch.train import Trainer

# f32 convolutions and normalisations in another summation order
F32_TOL = dict(rtol=1e-5, atol=1e-5)
VIT_CLASS = "enhancing_tpu.models.stage1.vitvqgan.ViTVQ"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=F32_TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **tol, err_msg=msg)


# -- PatchDiscriminator and ActNorm ---------------------------------------------

@pytest.mark.parametrize("use_actnorm", [False, True],
                         ids=["batchnorm", "actnorm"])
def test_patch_discriminator_matches_flax(use_actnorm):
    """ndf 8, 3 layers at 32 px, batch 4. Two training batches: the
    outputs, and after them the running statistics (BatchNorm: flax's
    momentum 0.99 and biased batch variance; ActNorm: the first batch's
    loc and scale, kept on the second); the parameter gradients of the
    second; then the outputs in eval mode on a third batch."""
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
          for _ in range(3)]
    jd = JaxPatchDiscriminator(ndf=8, n_layers=3, use_actnorm=use_actnorm)
    variables = jd.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    td = PatchDiscriminator(ndf=8, n_layers=3, use_actnorm=use_actnorm)
    load_patch_discriminator_from_jax(td, _np_tree(variables))

    def loss(p, stats, x):
        out, new = jd.apply({"params": p, "batch_stats": stats}, x,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out * out), (out, new["batch_stats"])

    train = jax.jit(jax.value_and_grad(loss, has_aux=True))
    params, stats = variables["params"], variables["batch_stats"]
    for i, x in enumerate(xs[:2]):
        (_, (out, stats)), grads = train(params, stats, jnp.asarray(x))
        got = td(_t(x), train=True)
        _close(got, out, msg=f"batch {i}")
        got_grads = torch.autograd.grad(torch.sum(got * got),
                                        list(td.parameters()))
    leaves = jax.tree_util.tree_flatten_with_path(stats)[0]
    bufs = dict(td.named_buffers())
    assert len(leaves) == len(bufs)
    for path, value in leaves:
        name = ".".join(str(k.key) for k in path)
        _close(bufs[name].float(), np.asarray(value, np.float32), msg=name)

    ref = PatchDiscriminator(ndf=8, n_layers=3, use_actnorm=use_actnorm)
    load_patch_discriminator_from_jax(ref, _np_tree(
        {"params": grads, "batch_stats": stats}))
    for (name, want_g), got_g in zip(ref.named_parameters(), got_grads):
        # sums over 4 x 32 x 32 outputs of the squared logits
        _close(got_g, want_g.detach(),
               dict(rtol=1e-4, atol=1e-4 * float(want_g.abs().max())),
               msg=name)

    out = jd.apply({"params": params, "batch_stats": stats},
                   jnp.asarray(xs[2]), train=False)
    _close(td(_t(xs[2]), train=False), out, msg="eval")


@pytest.mark.parametrize("squeeze", [False, True], ids=["nhwc", "2d"])
def test_actnorm_first_batch_init_and_logdet(squeeze):
    """ActNorm(16, logdet=True): the first training batch sets loc = -mean
    and scale = 1 / (std (ddof 1) + 1e-6) and is normalised by them; the
    second training batch keeps them; the logdet H * W * sum(log |scale|)
    per sample; and the input gradient of the first batch, which flows
    through its own statistics."""
    rng = np.random.default_rng(2)
    shape = (6, 16) if squeeze else (3, 5, 7, 16)
    xs = [(rng.standard_normal(shape) * 3 + 1).astype(np.float32)
          for _ in range(2)]
    ja = JaxActNorm(16, logdet=True)
    variables = ja.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    ta = ActNorm(16, logdet=True)
    load_patch_discriminator_from_jax(ta, _np_tree(
        {"params": {}, **variables}))
    def fwd(x, stats):
        (h, logdet), new = ja.apply({"batch_stats": stats}, x, train=True,
                                    mutable=["batch_stats"])
        return jnp.sum(h * h), (h, logdet, new["batch_stats"])

    train = jax.jit(jax.value_and_grad(fwd, has_aux=True))
    stats = variables["batch_stats"]
    for i, x in enumerate(xs):
        (_, (h, logdet, stats)), gx = train(jnp.asarray(x), stats)
        tx = _t(x).requires_grad_()
        th, tlogdet = ta(tx, train=True)
        (tgx,) = torch.autograd.grad(torch.sum(th * th), tx)
        _close(th, h, msg=f"batch {i}")
        _close(tlogdet, logdet, dict(rtol=1e-5, atol=1e-4), msg="logdet")
        _close(tgx, gx, dict(rtol=1e-4, atol=1e-4), msg="dx")
        _close(ta.loc.reshape(-1), stats["loc"].reshape(-1), msg="loc")
        _close(ta.scale.reshape(-1), stats["scale"].reshape(-1), msg="scale")
        assert int(ta.initialized) == int(stats["initialized"]) == 1


# -- the segmentation losses ----------------------------------------------------------

@pytest.mark.parametrize("cls,jcls", [(BCELoss, JaxBCELoss),
                                      (BCELossWithQuant, JaxBCELossWithQuant)])
def test_segmentation_losses_match_jax(cls, jcls):
    """Logits up to |40| (the stable form's both branches) against one-hot
    label maps; every log value, train and val splits."""
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 8, 8, 5)) * 10).astype(np.float32)
    logits[0, 0, 0] = [40, -40, 0, 1e-3, -1e-3]
    targets = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (2, 8, 8))]
    qloss = np.float32(0.37)
    kw = {"codebook_weight": 0.5} if cls is BCELossWithQuant else {}
    for split in ("train", "val"):
        want_loss, want = jcls(**kw)(jnp.asarray(qloss), jnp.asarray(targets),
                                     jnp.asarray(logits), split=split)
        got_loss, got = cls(**kw).generator_loss(
            torch.tensor(qloss), _t(targets), _t(logits), split=split)
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], dict(rtol=1e-6, atol=1e-7), msg=k)
        _close(got_loss, want_loss, dict(rtol=1e-6, atol=1e-7))


# -- VQCond and VQSegmentation ---------------------------------------------------

TOWER = dict(dim=16, depth=1, heads=1, mlp_dim=16)


def test_vqcond_matches_jax():
    """tests/test_cond.py's VQCond case: the JAX class path resolves to the
    port's class; codes of the same weights equal, to_img clips to [0,
    1]."""
    kw = dict(image_size=16, patch_size=8, encoder=TOWER, decoder=TOWER,
              quantizer=dict(embed_dim=8, n_embed=16))
    jm = JaxVQCond(VIT_CLASS, **kw)
    tm = VQCond(VIT_CLASS, device="cpu", **kw)
    assert type(tm).__module__.startswith("enhancing_tpu_torch.")
    load_vitvq_from_jax(tm, _np_tree(jm.params))
    x = np.random.default_rng(4).random((1, 16, 16, 3), dtype=np.float32)
    codes = tm.encode_codes(x)
    assert codes.shape == (1, 4)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(
        jm.encode_codes(x)))
    v = np.asarray([[2.0, -1.0, 0.5]], np.float32)
    _close(tm.to_img(v), jm.to_img(v), dict(rtol=0, atol=0))


def _segmentation_pair(n_labels=8):
    tower = dict(TOWER, channels=n_labels)
    kw = dict(image_size=16, patch_size=8, encoder=tower, decoder=tower,
              quantizer=dict(embed_dim=8, n_embed=16))
    jm = JaxVQSegmentation(VIT_CLASS, n_labels, **kw)
    tm = VQSegmentation(VIT_CLASS, n_labels, device="cpu", **kw)
    load_vitvq_from_jax(tm, _np_tree(jm.params))
    return jm, tm


def test_vqsegmentation_matches_jax():
    """tests/test_cond.py's VQSegmentation case on the same weights: the
    reconstruction's logits and quantizer loss, the colorize projection
    (numpy's default_rng(0)) and log_images (inputs colorized, the
    reconstruction's one-hot argmax colorized)."""
    n_labels = 8
    jm, tm = _segmentation_pair(n_labels)
    rng = np.random.default_rng(5)
    seg = np.eye(n_labels, dtype=np.float32)[rng.integers(0, n_labels,
                                                          (2, 16, 16))]
    rec, qloss = tm(seg)
    rec_j, qloss_j = jm(seg)
    assert rec.shape == (2, 16, 16, n_labels)
    _close(rec, rec_j, dict(rtol=1e-4, atol=1e-5))
    _close(qloss, qloss_j, dict(rtol=1e-5, atol=1e-7))
    _close(tm.colorize, jm.colorize, dict(rtol=0, atol=0))
    logs, logs_j = tm.log_images({"image": seg}), jm.log_images({"image":
                                                                 seg})
    assert set(logs) == set(logs_j) == {"inputs", "reconstructions"}
    for k in logs:
        assert logs[k].shape == (2, 16, 16, 3)
        _close(logs[k], logs_j[k], dict(rtol=1e-6, atol=1e-6), msg=k)


class _Maps:
    """A data module of one-hot label maps, no validation split."""

    datasets: dict = {}

    def __init__(self, maps) -> None:
        self.maps = maps

    def setup(self) -> None:
        pass

    def train_dataloader(self):
        return [{"image": m} for m in self.maps]


def test_vqsegmentation_trains_on_bce_with_quant():
    """A VQSegmentation over 8 labels trains through the Trainer's stage-1
    branch on BCELossWithQuant (no discriminator): two steps, the loss
    logs finite, every autoencoder parameter moved."""
    n_labels = 8
    tower = dict(TOWER, channels=n_labels)
    model = VQSegmentation(
        VIT_CLASS, n_labels, device="cpu", image_size=16, patch_size=8,
        encoder=tower, decoder=tower, quantizer=dict(embed_dim=8, n_embed=16),
        loss={"target": "enhancing_tpu_torch.losses.segmentation."
                        "BCELossWithQuant",
              "params": {"codebook_weight": 1.0}})
    assert isinstance(model.loss, BCELossWithQuant)
    rng = np.random.default_rng(6)
    maps = [np.eye(n_labels, dtype=np.float32)[rng.integers(0, n_labels,
                                                            (2, 16, 16))]
            for _ in range(2)]
    before = [p.detach().clone() for p in model.module.parameters()]
    trainer = Trainer(max_steps=2, base_lr=1e-3, log_every=10)
    trainer.fit(model, _Maps(maps))
    assert trainer.final_state.step == 2
    log = trainer.last_log
    assert set(log) == {"train/total_loss", "train/bce_loss",
                        "train/quant_loss", "train/code_perplexity",
                        "train/codes_used"}
    assert all(bool(torch.isfinite(v)) for v in log.values())
    assert all(not torch.equal(p, q) for p, q in
               zip(model.module.parameters(), before))


# -- the LPIPS weight loader ---------------------------------------------------------

TORCHVISION_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
VGG_WIDTHS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
LIN_WIDTHS = (64, 128, 256, 512, 512)


def _lpips_file(path: Path, lin_key: str, wrapped: bool,
                drop: str = "", extra: str = "", bad: str = "") -> Path:
    """Seeded random VGG16 convs (torchvision's ``features.{i}``, OIHW)
    and non-negative lin heads (the lpips package's keys), ``torch.save``d;
    optionally a key dropped, one added, or one of the wrong shape."""
    rng = np.random.default_rng(7)
    sd = {}
    in_ch = 3
    for idx, width in zip(TORCHVISION_CONVS, VGG_WIDTHS):
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            (rng.standard_normal((width, in_ch, 3, 3))
             / np.sqrt(9 * in_ch)).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            (rng.standard_normal(width) * 0.1).astype(np.float32))
        in_ch = width
    for i, width in enumerate(LIN_WIDTHS):
        sd[lin_key.format(i)] = torch.from_numpy(
            (rng.random((1, width, 1, 1)) * 0.1).astype(np.float32))
    if drop:
        del sd[drop]
    if extra:
        sd[extra] = torch.zeros(3)
    if bad:
        sd[bad] = torch.zeros(1, 7, 1, 1)
    torch.save({"state_dict": sd} if wrapped else sd, path)
    return path


@pytest.fixture(scope="module")
def jax_lpips():
    """JAX's LPIPS module with its init and apply jitted once."""
    jlp = JaxLPIPS()
    return jax.jit(jlp.init), jax.jit(jlp.apply)


@pytest.mark.parametrize("lin_key,wrapped", [
    ("lin{}.model.1.weight", False), ("lins.{}.model.1.weight", True)])
def test_lpips_loader_matches_jax(tmp_path, jax_lpips, lin_key, wrapped):
    """One file in the torchvision + lpips layout through JAX's
    load_torch_lpips and the port's init_lpips: equal LPIPS distances on
    32 px images in [-1, 1]; the loss built on it (VQLPIPS(lpips_weights=
    ...)) trains without allow_random_lpips."""
    path = _lpips_file(tmp_path / "lpips.pt", lin_key, wrapped)
    x = jnp.zeros((1, 32, 32, 3))
    init, apply = jax_lpips
    params = jax_load_torch_lpips(str(path), init(
        jax.random.PRNGKey(0), x, x)["params"])
    rng = np.random.default_rng(8)
    a, b = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
            for _ in "ab")
    want = apply({"params": params}, jnp.asarray(a), jnp.asarray(b))
    got = init_lpips(str(path))(_t(a), _t(b))
    # 13 f32 convolutions in another summation order
    _close(got, want, dict(rtol=1e-4, atol=1e-6))
    loss = VQLPIPS(perceptual_weight=0.1, lpips_weights=str(path))
    loss.check_trainable()
    assert not loss.lpips_is_random


@pytest.mark.parametrize("fault", ["missing", "left-over", "shape"])
def test_lpips_loader_refuses_a_bad_file(tmp_path, fault):
    kw = {"missing": dict(drop="features.12.bias"),
          "left-over": dict(extra="scaling_layer.shift"),
          "shape": dict(bad="lin2.model.1.weight")}[fault]
    path = _lpips_file(tmp_path / "lpips.pt", "lin{}.model.1.weight", False,
                       **kw)
    with pytest.raises((KeyError, ValueError)):
        init_lpips(str(path))
