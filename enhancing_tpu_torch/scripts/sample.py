"""Generate images from a trained stage-2 prior.

    python -m enhancing_tpu_torch.scripts.sample -c imagenet_gpt_vitvq_base \
        --classes 1 7 42 [--top_k 100] [--top_p 0.95] [--temperature 1.0] \
        [-n 4] [-o samples] [--device cuda]

Counterpart of the JAX package's ``scripts/sample.py``:
``CondTransformer.sample`` of ``-n`` images per class, written as one grid
``samples.png`` (a row per class). ``--shard`` (data-parallel decoding
over several cards) is ROADMAP A9 and raises.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--classes", type=int, nargs="+", default=[0])
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--top_p", type=float, default=None)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("-n", "--num_per_class", type=int, default=1)
    p.add_argument("-s", "--seed", type=int, default=0)
    p.add_argument("-o", "--outdir", default="samples")
    p.add_argument("--shard", action="store_true",
                   help="decode over several cards (ROADMAP A9)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.shard:
        raise NotImplementedError(
            "--shard: sampling over several cards is ROADMAP A9")

    from ..utils.logging import save_image_grid
    from .common import load_model

    _, model = load_model(args.config, args.ckpt, args.device)
    conds = np.repeat(np.asarray(args.classes, np.int32),
                      args.num_per_class)[:, None]
    pixels, codes = model.sample(conds, top_k=args.top_k, top_p=args.top_p,
                                 softmax_temperature=args.temperature,
                                 seed=args.seed, return_codes=True)
    pixels = pixels.float().cpu().numpy()
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    save_image_grid(pixels, outdir / "samples.png", nrow=args.num_per_class)
    print(f"wrote {len(conds)} samples to {outdir}/samples.png")
    return {"pixels": pixels, "codes": codes.cpu().numpy()}


if __name__ == "__main__":
    main()
