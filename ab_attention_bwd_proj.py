#!/usr/bin/env python3
"""Time the attention backward (csrc/attention_bwd.cu, ``attention_bwd_kernel``),
attention -> projection -> residual (csrc/attn_proj.cu, ``attn_proj_kernel``)
and the paths that run them, for one checkout on one NVIDIA card.

    python3 ab_attention_bwd_proj.py ROOT LABEL

ROOT is the root of a checkout (its ``enhancing_tpu_torch`` is imported
and its kernels built there). To compare two versions, unpack the other
one (``git archive <commit> enhancing_tpu_torch``) into a directory that
.gitignore lists and run this script for both in turns within one call on
one card: A, B, B, A. Prints the ms per call (CUDA events, the median of 5
loops of 10) of the backward at ViT-VQGAN-Base's training shape (B = 8,
N = 1024, 12 heads of 64, the lane slices of a qkv buffer) and of B15 at
the serving batch 128 (HO = 768); the ms per step of ``Trainer.fit`` on
``configs/fake_vitvq_base.yaml`` at batch 8 (steps 1-4, after step 0's
R1; host clock between the trainer's synchronised log calls); and the ms
per ``encode_codes`` -> ``decode_codes`` round trip of a ViT-VQGAN-Base
with random bf16 weights and both fused serving options (``ffn_impl:
fused``, ENHANCING_TPU_ATTN_PROJ=1) at batch 128; with a checksum of each
kernel's output.
"""
import os
import statistics
import sys
import time

TOWER = {"dim": 768, "depth": 12, "heads": 12, "mlp_dim": 3072}
FUSED = dict(TOWER, ffn_impl="fused")
BASE = {"image_size": 256, "patch_size": 8, "encoder": FUSED,
        "decoder": FUSED, "quantizer": {"embed_dim": 32, "n_embed": 8192}}
TRAIN_STEPS = 5


def time_ms(fn, iters=10, loops=5, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(loops):
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / iters)
    return statistics.median(out)


def trip_ms(model, x, iters=5):
    import torch
    for _ in range(2):
        model.decode_codes(model.encode_codes(x))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        model.decode_codes(model.encode_codes(x))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


class Clock:
    """The trainer's metrics logger: the host clock at each log call."""

    def __init__(self):
        self.t = []

    def log_metrics(self, metrics, step):
        import torch
        torch.cuda.synchronize()
        self.t.append((step, time.perf_counter()))


def step_ms(config):
    from enhancing_tpu_torch.train import Trainer
    from enhancing_tpu_torch.utils.config import initialize_from_config
    model = initialize_from_config(config["model"], device="cuda")
    data = initialize_from_config(config["dataset"])
    clock = Clock()
    Trainer(max_steps=TRAIN_STEPS, log_every=1,
            metrics_logger=clock).fit(model, data)
    # the first TRAIN_STEPS log calls end the steps (then validation)
    times = [t for _, t in clock.t[:TRAIN_STEPS]]
    return (times[-1] - times[0]) / (TRAIN_STEPS - 1) * 1e3


def main() -> int:
    root, label = sys.argv[1], sys.argv[2]
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from chip_smoke import FAKE_VITVQ_BASE
    from enhancing_tpu_torch.models.stage1.vitvqgan import ViTVQ
    from enhancing_tpu_torch.ops import attention as att
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    out = []
    b, n, h, d = 8, 1024, 12, 64
    q3, k3, v3 = att.split_qkv_scaled(rand(b, n, 3 * h * d), d ** -0.5)
    do = rand(b, n, h * d)
    bwd = lambda: att.attention_bwd_kernel(q3, k3, v3, do, h, d)  # noqa: E731
    out.append(f"B5 {time_ms(bwd):.4f} (checksum "
               f"{sum(float(g.float().sum()) for g in bwd()):.4f})")
    del q3, k3, v3, do

    b = 128
    qkv = rand(b, n, 3 * h * d)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.chunk(3, -1))
    wp = rand(768, h * d, scale=(2.0 / (2 * 768)) ** 0.5)
    bp = 0.02 * rand(768, dtype=torch.float32)
    res = rand(b, n, 768)
    proj = lambda: att.attn_proj_kernel(  # noqa: E731
        q, k, v, wp, bp, res, d ** -0.5)
    out.append(f"B15 {time_ms(proj):.4f} (checksum "
               f"{float(proj().float().sum()):.4f})")
    del qkv, q, k, v, res

    out.append(f"train step {step_ms(FAKE_VITVQ_BASE):.2f}")
    images = torch.from_numpy(np.random.default_rng(0).random(
        (128, 256, 256, 3), dtype=np.float32)).cuda()
    os.environ["ENHANCING_TPU_ATTN_PROJ"] = "1"
    model = ViTVQ(dtype="bfloat16", seed=0, device="cuda", **BASE)
    out.append(f"fused trip {trip_ms(model, images):.2f}")
    del os.environ["ENHANCING_TPU_ATTN_PROJ"]
    print(f"[ab] {label}: " + "; ".join(out) + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
