"""Reference (Lightning) checkpoints into the port: ``ViTVQ(path=...)``,
``CondTransformer(path=...)`` and ``compat.torch_loader``, against the JAX
package's ``path=`` models and loaders and ``tests/test_compat.py``'s torch
clones with the reference's state-dict names, on the CPU.

The loaders are held leaf for leaf to the JAX package's on the same input
tree; the models' codes exactly, their reconstructions within 2e-4 and the
GPT's logits within 2e-4 absolute / 1e-3 relative (fp32 sums in another
order over two blocks).
"""
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_compat import TorchGPT, TorchViTVQ

from enhancing_tpu.compat import torch_loader as jax_loader
from enhancing_tpu.losses import StyleDiscriminator as JaxStyleDiscriminator
from enhancing_tpu.models.stage1.vitvqgan import ViTVQ as JaxViTVQ
from enhancing_tpu.models.stage2 import GPT as JaxGPT
from enhancing_tpu_torch.compat import (load_style_discriminator_from_jax,
                                        to_jax_tree, torch_loader)
from enhancing_tpu_torch.losses.discriminator import StyleDiscriminator
from enhancing_tpu_torch.models.stage1 import ViTVQ
from enhancing_tpu_torch.models.stage2 import CondTransformer

TOWER = dict(dim=64, depth=2, heads=2, mlp_dim=128)
VITVQ = dict(image_size=32, patch_size=8, encoder=TOWER, decoder=TOWER,
             quantizer=dict(embed_dim=16, n_embed=64))
GPT_KW = dict(vocab_cond_size=10, vocab_img_size=32, embed_dim=32,
              cond_num_tokens=1, img_num_tokens=8, n_heads=2, n_layers=2)
REC_TOL = dict(rtol=0, atol=2e-4)
LOGIT_TOL = dict(rtol=1e-3, atol=2e-4)
PORT = "enhancing_tpu_torch.models"
REPO = Path(__file__).resolve().parents[1]


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_equal(got, want):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def vitvq_ckpt(tmp_path_factory):
    torch.manual_seed(0)
    clone = TorchViTVQ().eval()
    path = tmp_path_factory.mktemp("vitvq") / "model.ckpt"
    torch.save({"state_dict": clone.state_dict()}, path)
    return clone, str(path), JaxViTVQ(**VITVQ, path=str(path))


def test_vitvq_path_matches_jax_and_clone(vitvq_ckpt):
    clone, path, jax_model = vitvq_ckpt
    port = ViTVQ(**VITVQ, path=path, device="cpu")
    img = np.random.default_rng(0).random((2, 32, 32, 3), dtype=np.float32)
    with torch.no_grad():
        clone_rec, clone_codes = clone(torch.from_numpy(
            img.transpose(0, 3, 1, 2)))
    codes = port.encode_codes(img).numpy()
    np.testing.assert_array_equal(codes, clone_codes.numpy())
    np.testing.assert_array_equal(codes, np.asarray(
        jax_model.encode_codes(img)))
    rec = port(img)[0].numpy()
    np.testing.assert_allclose(rec, np.asarray(jax_model(img)[0]), **REC_TOL)
    np.testing.assert_allclose(rec, clone_rec.numpy().transpose(0, 2, 3, 1),
                               **REC_TOL)
    dec = port.decode_codes(codes).numpy()
    np.testing.assert_allclose(dec, np.asarray(jax_model.decode_codes(
        jnp.asarray(codes))), **REC_TOL)
    # the port's tree in the JAX names is the JAX model's, leaf for leaf
    _assert_trees_equal(to_jax_tree(port.module), _np(jax_model.params))


def test_vitvq_ignore_keys_keep_the_seed_values(vitvq_ckpt, capsys):
    clone, path, _ = vitvq_ckpt
    fresh = ViTVQ(**VITVQ, seed=3, device="cpu")
    port = ViTVQ(**VITVQ, seed=3, path=path, ignore_keys=["quantizer."],
                 device="cpu")
    out = capsys.readouterr().out
    assert "Deleting key quantizer.embedding.weight from state_dict." in out
    assert f"Restored from {path}" in out
    torch.testing.assert_close(port.module.quantizer.embedding,
                               fresh.module.quantizer.embedding,
                               rtol=0, atol=0)
    torch.testing.assert_close(port.module.pre_quant.weight,
                               clone.pre_quant.weight, rtol=0, atol=0)


@pytest.mark.parametrize("ignore", [(), ("encoder.transformer.layers.1",
                                         "quantizer.")])
def test_vitvq_loader_equals_jax(vitvq_ckpt, ignore):
    """The port's and JAX's ``load_vitvq_params`` on one input tree."""
    _, path, jax_model = vitvq_ckpt
    tree = _np(JaxViTVQ(**VITVQ, seed=5).params)
    _assert_trees_equal(
        torch_loader.load_vitvq_params(path, tree, ignore),
        _np(jax_loader.load_vitvq_params(path, tree, ignore)))


def _gpt_ckpt(tmp_path, prefix=""):
    torch.manual_seed(1)
    clone = TorchGPT().eval()
    sd = {prefix + k: v for k, v in clone.state_dict().items()}
    if prefix:   # a stage-2 Lightning file also holds the tokenizer
        sd["first_stage_model.pre_quant.weight"] = torch.zeros(16, 64)
    path = tmp_path / "gpt.ckpt"
    torch.save({"state_dict": sd}, path)
    return clone, str(path)


def _cond_transformer(target="GPT", **kw):
    return CondTransformer(
        cond_key="class", cond={"target": f"{PORT}.cond.DummyCond"},
        stage1={"target": f"{PORT}.stage1.ViTVQ", "params": VITVQ},
        transformer={"target": f"{PORT}.stage2.layers.{target}",
                     "params": kw.pop("prior", GPT_KW)},
        device="cpu", **kw)


def test_gpt_path_matches_jax_and_clone(tmp_path):
    clone, path = _gpt_ckpt(tmp_path, prefix="transformer.")
    port = _cond_transformer(path=path)
    jax_gpt = JaxGPT(**GPT_KW)
    codes = np.random.default_rng(2).integers(0, 32, (2, 8))
    conds = np.random.default_rng(3).integers(0, 10, (2, 1))
    params = jax_loader.load_gpt_params(path, jax_gpt.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        jnp.zeros((1, 1), jnp.int32))["params"])
    want = np.asarray(jax_gpt.apply({"params": params}, jnp.asarray(codes),
                                    jnp.asarray(conds)))
    with torch.no_grad():
        logits = port(codes, conds)[0].numpy()
        ref = clone(torch.from_numpy(codes), torch.from_numpy(conds))
    np.testing.assert_allclose(logits, want, **LOGIT_TOL)
    np.testing.assert_allclose(logits, ref.numpy(), **LOGIT_TOL)


@pytest.mark.parametrize("ignore", [(), ("head", "layer_norm",
                                         "tok_emb_cond")])
def test_gpt_loader_equals_jax(tmp_path, ignore):
    """Both layouts of the JAX tree: stacked ``blocks`` and ``blocks_{i}``;
    a bare prior's state dict and a Lightning file's ``transformer.``
    keys. (Ignoring one layer of a stacked tree raises in both.)"""
    for scan, prefix in ((True, ""), (False, "transformer.")):
        _, path = _gpt_ckpt(tmp_path, prefix)
        tree = _np(JaxGPT(**GPT_KW, scan_layers=scan).init(
            jax.random.PRNGKey(4), jnp.zeros((1, 8), jnp.int32),
            jnp.zeros((1, 1), jnp.int32))["params"])
        _assert_trees_equal(
            torch_loader.load_gpt_params(path, tree, ignore),
            _np(jax_loader.load_gpt_params(path, tree, ignore)))


def test_gpt_ignore_keys_keep_the_seed_values(tmp_path, capsys):
    clone, path = _gpt_ckpt(tmp_path)
    fresh = _cond_transformer(seed=2).transformer
    port = _cond_transformer(seed=2, path=path, ignore_keys=["head"])
    assert "Deleting key head.weight from state_dict." in \
        capsys.readouterr().out
    torch.testing.assert_close(port.transformer.head.weight,
                               fresh.head.weight, rtol=0, atol=0)
    torch.testing.assert_close(port.transformer.blocks_1.mlp.p0.weight,
                               clone.blocks[1].mlp.p0.weight, rtol=0, atol=0)


RQ_KW = dict(vocab_cond_size=10, vocab_img_size=32, embed_dim=32,
             cond_num_tokens=1, img_num_tokens=4, depth_num_tokens=2,
             spatial_n_heads=2, depth_n_heads=2, spatial_n_layers=2,
             depth_n_layers=1)
# the reference's RQTransformer names for the JAX tree's top-level nodes
RQ_STACKS = {"spatial": "spatial_transformer", "depth": "depth_transformer"}


def _reference_prior_state_dict(tree):
    """The reference state dict of a JAX-named prior tree (``blocks_{i}`` /
    ``spatial_{i}`` / ``depth_{i}`` layout): the inverse of
    ``load_gpt_params``."""
    sd = {}

    def walk(node, names):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, names + [key])
                continue
            *owner, leaf = names + [key]
            stack, _, i = owner[0].rpartition("_") if owner else ("", "", "")
            if stack in RQ_STACKS or stack == "blocks":
                owner = [RQ_STACKS.get(stack, stack), i] + owner[1:]
            if leaf == "kernel":
                sd[".".join(owner + ["weight"])] = value.T
            elif leaf in ("scale", "embedding"):
                sd[".".join(owner + ["weight"])] = value
            else:
                sd[".".join(owner + [leaf])] = value
    walk(tree, [])
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def test_rq_prior_path_round_trip(tmp_path):
    """An RQ prior's reference checkpoint (written from a seeded prior)
    restores every parameter into a prior of another seed."""
    source = _cond_transformer("RQTransformer", prior=RQ_KW, seed=0)
    path = tmp_path / "rq.ckpt"
    torch.save({"state_dict": {
        "transformer." + k: v for k, v in _reference_prior_state_dict(
            to_jax_tree(source.transformer)).items()}}, path)
    port = _cond_transformer("RQTransformer", prior=RQ_KW, seed=1,
                             path=str(path))
    for (name, got), want in zip(port.transformer.named_parameters(),
                                 source.transformer.parameters()):
        torch.testing.assert_close(got, want, rtol=0, atol=0, msg=name)


def _reference_disc_state_dict(params, size, rng):
    """A reference ``loss.discriminator.*`` state dict of random values
    shaped as the JAX StyleDiscriminator's tree (tests/test_compat.py's
    layout)."""
    def conv(p):      # (k, k, in, out) -> (out, in, k, k)
        return rng.standard_normal((p.shape[3], p.shape[2], p.shape[0],
                                    p.shape[1])).astype(np.float32)

    def vec(p):
        return rng.standard_normal(p.shape).astype(np.float32)

    sd = {"blocks.0.0.weight": conv(params["stem"]["conv"]["weight"]),
          "blocks.0.1.bias": vec(params["stem"]["act_bias"])}
    log_size = int(math.log2(size))
    for j in range(1, log_size - 1):
        blk = params[f"block_{log_size - (j - 1)}"]
        sd[f"blocks.{j}.conv1.0.weight"] = conv(blk["conv1"]["conv"]["weight"])
        sd[f"blocks.{j}.conv1.1.bias"] = vec(blk["conv1"]["act_bias"])
        sd[f"blocks.{j}.conv2.1.weight"] = conv(blk["conv2"]["conv"]["weight"])
        sd[f"blocks.{j}.conv2.2.bias"] = vec(blk["conv2"]["act_bias"])
        sd[f"blocks.{j}.skip.1.weight"] = conv(blk["skip"]["conv"]["weight"])
    sd["final_conv.0.weight"] = conv(params["final_conv"]["conv"]["weight"])
    sd["final_conv.1.bias"] = vec(params["final_conv"]["act_bias"])
    for i, name in ((0, "final_linear1"), (1, "final_linear2")):
        w = params[name]["weight"]
        sd[f"final_linear.{i}.weight"] = rng.standard_normal(
            (w.shape[1], w.shape[0])).astype(np.float32)
        sd[f"final_linear.{i}.bias"] = vec(params[name]["bias"])
    return {"loss.discriminator." + k: torch.from_numpy(v)
            for k, v in sd.items()}


def test_discriminator_restored_as_jax_maps_it(vitvq_ckpt, tmp_path):
    """``ViTVQ(path=...)`` with the StyleGAN loss restores
    ``loss.discriminator.*`` as JAX's ``load_style_discriminator_params``
    maps it (carried across); an ignored prefix keeps the seed values."""
    clone, _, _ = vitvq_ckpt
    size = 32
    jax_params = _np(JaxStyleDiscriminator(size=size).init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))["params"])
    sd = dict(clone.state_dict(), **_reference_disc_state_dict(
        jax_params, size, np.random.default_rng(0)))
    path = tmp_path / "gan.ckpt"
    torch.save({"state_dict": sd}, path)

    want = load_style_discriminator_from_jax(
        StyleDiscriminator(size=size),
        _np(jax_loader.load_style_discriminator_params(
            str(path), jax_params, size=size)))
    loss = {"target": "enhancing_tpu_torch.losses.vqperceptual."
                      "VQLPIPSWithDiscriminator",
            "params": {"allow_random_lpips": True, "image_size": size}}
    port = ViTVQ(**VITVQ, loss=loss, path=str(path), device="cpu")
    for (name, got), ref in zip(port.loss.discriminator.named_parameters(),
                                want.parameters()):
        torch.testing.assert_close(got, ref, rtol=0, atol=0, msg=name)
    torch.testing.assert_close(port.module.pre_quant.weight,
                               clone.pre_quant.weight, rtol=0, atol=0)

    # the loss draws its discriminator from seed + 1
    fresh = StyleDiscriminator(size=size,
                               generator=torch.Generator().manual_seed(1))
    kept = ViTVQ(**VITVQ, loss=loss, path=str(path), device="cpu",
                 ignore_keys=["loss.discriminator.final_linear"])
    for name, got in kept.loss.discriminator.named_parameters():
        ref = dict((fresh if name.startswith("final_linear") else
                    port.loss.discriminator).named_parameters())[name]
        torch.testing.assert_close(got, ref, rtol=0, atol=0, msg=name)

    # the two packages' loaders agree on one input tree
    _assert_trees_equal(
        torch_loader.load_style_discriminator_params(str(path), jax_params,
                                                     size=size),
        _np(jax_loader.load_style_discriminator_params(str(path),
                                                       jax_params,
                                                       size=size)))


def test_chip_smoke_writer_round_trips_through_both_loaders(tmp_path):
    """``chip_smoke.py`` phase 18's ``reference_vitvq_state_dict`` of a
    seeded port model with the StyleGAN loss: the port's ``path=``
    restores every parameter, and JAX's ``path=`` reads the tokenizer's
    as the port holds them."""
    loss = {"target": "enhancing_tpu_torch.losses.vqperceptual."
                      "VQLPIPSWithDiscriminator",
            "params": {"allow_random_lpips": True, "image_size": 32}}
    source = ViTVQ(**VITVQ, loss=loss, device="cpu")
    bias = source.module.decoder.to_pixel.bias
    with torch.no_grad():   # the reference keeps one pixel bias a channel
        bias.copy_(torch.randn(3).repeat_interleave(bias.numel() // 3))
    path = tmp_path / "written.ckpt"
    torch.save({"state_dict": chip_smoke().reference_vitvq_state_dict(
        source)}, path)
    restored = ViTVQ(**VITVQ, loss=dict(loss, params=dict(
        loss["params"], seed=4)), seed=1, path=str(path), device="cpu")
    for part in ("module", "loss"):
        for (name, got), want in zip(
                getattr(restored, part).named_parameters(),
                getattr(source, part).parameters()):
            if part == "loss" and not name.startswith("discriminator."):
                continue   # LPIPS is not in the checkpoint
            torch.testing.assert_close(got, want, rtol=0, atol=0, msg=name)
    _assert_trees_equal(_np(JaxViTVQ(**VITVQ, path=str(path)).params),
                        to_jax_tree(source.module))
