"""Tokenize and reconstruct images with a trained stage-1 model.

    python -m enhancing_tpu_torch.scripts.reconstruct -c imagenet_vitvq_base \
        [--ckpt weight/imagenet_vitvq_base.ckpt] image1.jpg image2.png \
        [-o out_dir] [--resolution 256] [--device cuda]

Counterpart of the JAX package's ``scripts/reconstruct.py``: builds the
model of the config's ``model:`` block (``--ckpt`` restores a reference
checkpoint through the model's ``path=``), encodes each image to codes,
decodes them, and writes ``codes.npy`` and an original | reconstruction
grid per image.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--config", required=True)
    p.add_argument("images", nargs="+")
    p.add_argument("--ckpt", default=None)
    p.add_argument("-o", "--outdir", default="reconstructions")
    p.add_argument("--resolution", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..data.transforms import EvalTransform, load_image
    from ..utils.logging import save_image_grid
    from .common import load_model

    _, model = load_model(args.config, args.ckpt, args.device)
    res = args.resolution or model.image_size
    tf = EvalTransform(res)
    batch = np.stack([tf(load_image(f)) for f in args.images])

    codes = model.encode_codes(batch)
    recon = torch.clamp(model.decode_codes(codes).float(), 0, 1)
    recon = recon.cpu().numpy()
    codes = codes.cpu().numpy()

    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    np.save(outdir / "codes.npy", codes)
    for i, f in enumerate(args.images):
        save_image_grid(np.stack([batch[i], recon[i]]),
                        outdir / f"{Path(f).stem}_recon.png", nrow=2)
    mse = float(np.mean((recon - batch) ** 2))
    print(f"wrote {len(args.images)} grids to {outdir}  (codes shape "
          f"{tuple(codes.shape)}, MSE {mse:.5f})")
    return {"codes": codes, "reconstructions": recon, "images": batch,
            "mse": mse}


if __name__ == "__main__":
    main()
