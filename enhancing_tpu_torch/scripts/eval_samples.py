"""Generation quality: the Fréchet distance between prior samples and
dataset images.

    python -m enhancing_tpu_torch.scripts.eval_samples \
        -c imagenet_gpt_vitvq_base [--ckpt prior.ckpt] [--num_samples 256] \
        [--batch 16] [--top_k 300] [--inception_weights inception.pth] \
        [--device cuda]

Counterpart of the JAX package's ``scripts/eval_samples.py``: samples
random classes with ``CondTransformer.sample`` and compares them with
dataset images through InceptionV3 pool3 features when
``--inception_weights`` gives a torchvision-layout state dict (true FID),
else through a VGG16 trunk of random weights drawn from a seed. Prints
the result as JSON.
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
    p.add_argument("--num_samples", type=int, default=256)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--top_k", type=int, default=300)
    p.add_argument("--top_p", type=float, default=None)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--split", default="validation")
    p.add_argument("--inception_weights", default=None,
                   help="torchvision InceptionV3 state_dict for true FID")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..eval import FrechetDistance
    from .common import load_model, loader

    cfg, model = load_model(args.config, args.ckpt, args.device)
    if args.inception_weights:
        from ..eval.inception import fid_feature_fn, init_inception
        feat_fn = fid_feature_fn(init_inception(
            weights_path=args.inception_weights, device=model.device))
    else:
        from ..eval.metrics import vgg_feature_fn
        from ..losses.lpips import init_lpips
        feat_fn = vgg_feature_fn(init_lpips(
            generator=torch.Generator().manual_seed(0)).to(model.device))

    data = loader(cfg, args.split)
    fd = FrechetDistance(feat_fn)
    n_classes = model.transformer.vocab_cond_size
    rng = np.random.default_rng(args.seed)

    made = 0
    while made < args.num_samples:
        b = min(args.batch, args.num_samples - made)
        conds = rng.integers(0, n_classes, (b, 1)).astype(np.int32)
        pixels = model.sample(conds, top_k=args.top_k, top_p=args.top_p,
                              softmax_temperature=args.temperature,
                              seed=args.seed + made)
        fd.update_fake(pixels.float())
        made += b

    seen = 0
    for batch in data:
        x = model.stage1_model.get_input(batch, model.stage1_model.image_key)
        fd.update_real(x)
        seen += x.shape[0]
        if seen >= args.num_samples:
            break

    result = {
        "frechet_distance": fd.compute(),
        "feature_trunk": ("inception_pool3" if args.inception_weights
                          else "vgg16_random_init"),
        "num_samples": made,
        "num_real": seen,
    }
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
