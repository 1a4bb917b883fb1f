"""Reconstruction quality of a stage-1 tokenizer.

    python -m enhancing_tpu_torch.scripts.evaluate -c imagenet_vitvq_base \
        [--ckpt weight/imagenet_vitvq_base.ckpt] [--split validation] \
        [--max-batches 50] [--batch-size 16] [--device cuda]

Counterpart of the JAX package's ``scripts/evaluate.py``: PSNR, SSIM,
codebook usage and, where the model's loss holds LPIPS, a VGG-feature
Fréchet distance between the dataset's images and their encode -> decode
reconstructions, printed as JSON (the VGG trunk is the loss's, so its
``lpips_weights`` make it the published trunk).
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional

import numpy as np
import torch


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--split", default="validation")
    p.add_argument("--max-batches", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..eval import FrechetDistance, codebook_usage, psnr, ssim
    from ..eval.metrics import vgg_feature_fn
    from .common import load_model, loader

    cfg, model = load_model(args.config, args.ckpt, args.device)
    data = loader(cfg, args.split, args.batch_size)

    fd = None
    if model.loss is not None and hasattr(model.loss, "perceptual"):
        fd = FrechetDistance(vgg_feature_fn(model.loss.perceptual))

    psnrs, ssims, all_codes = [], [], []
    n_embed = model.module.quantizer.embedding.shape[0]
    for i, batch in enumerate(data):
        if i >= args.max_batches:
            break
        x = model.get_input(batch, model.image_key)
        codes = model.encode_codes(x)
        rec = torch.clamp(model.decode_codes(codes).float(), 0.0, 1.0)
        psnrs.extend(psnr(x, rec).tolist())
        ssims.extend(ssim(x, rec).tolist())
        all_codes.append(codes.cpu().numpy().reshape(-1))
        if fd is not None:
            fd.update_real(x)
            fd.update_fake(rec)

    result = {
        "psnr": float(np.mean(psnrs)),
        "ssim": float(np.mean(ssims)),
        "num_images": len(psnrs),
        **{f"codebook_{k}": v for k, v in
           codebook_usage(np.concatenate(all_codes), n_embed).items()},
    }
    if fd is not None:
        result["vgg_frechet_distance"] = fd.compute()
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
