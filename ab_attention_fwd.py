#!/usr/bin/env python3
"""Time the attention forwards (csrc/attention_bnhd.cu: B2, B8, B17, B18,
B19) and the paths that run them, for one checkout on one NVIDIA card.

    python3 ab_attention_fwd.py ROOT LABEL [--kernels-only]

ROOT is the root of a checkout (its ``enhancing_tpu_torch`` and
``chip_smoke.py`` are imported and its kernels built there). To compare
two versions, unpack the other one (``git archive <commit>
enhancing_tpu_torch chip_smoke.py``) into a directory that .gitignore
lists and run this script for both in turns within one call on one card:
A, B, B, A. Prints the ms per call (CUDA events, the median of 5 loops of
10) of B2 on ViT-VQGAN-Base's qkv buffer at the serving batch 128 (N =
1024, 12 heads of 64), B8 on that buffer's lane slices, B17 on (B, H, N,
D) and B18 on (B, N, H, D) tensors of that shape, B19 at the stage-2
training shape (batch 8, N = 1025, 16 heads of 64, prefix-causal) and B8
at the GPT prior's (batch 8, N = 1025, 16 heads of 384, prefix-causal),
with a checksum of each output; then, unless ``--kernels-only``, the ms
per ``encode_codes`` -> ``decode_codes`` round trip of a ViT-VQGAN-Base
with random bf16 weights at batch 128, by default and with both fused
serving options (``ffn_impl: fused``, ENHANCING_TPU_ATTN_PROJ=1), and the
ms per step of ``Trainer.fit`` on ``configs/fake_vitvq_base.yaml`` at batch
8 (steps 1-4, after step 0's R1; host clock between the trainer's
synchronised log calls).
"""
import os
import statistics
import sys
import time

TOWER = {"dim": 768, "depth": 12, "heads": 12, "mlp_dim": 3072}
FUSED = dict(TOWER, ffn_impl="fused")
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
        self.t.append(time.perf_counter())


def step_ms(config):
    from enhancing_tpu_torch.train import Trainer
    from enhancing_tpu_torch.utils.config import initialize_from_config
    model = initialize_from_config(config["model"], device="cuda")
    data = initialize_from_config(config["dataset"])
    clock = Clock()
    Trainer(max_steps=TRAIN_STEPS, log_every=1,
            metrics_logger=clock).fit(model, data)
    # the first TRAIN_STEPS log calls end the steps (then validation)
    times = clock.t[:TRAIN_STEPS]
    return (times[-1] - times[0]) / (TRAIN_STEPS - 1) * 1e3


def main() -> int:
    root, label = sys.argv[1], sys.argv[2]
    kernels_only = "--kernels-only" in sys.argv[3:]
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

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    out = []

    def row(name, fn):
        out.append(f"{name} {time_ms(fn):.4f} (checksum "
                   f"{float(fn().float().sum()):.4f})")

    b, n, h, d = 128, 1024, 12, 64
    qkv = rand(b, n, 3 * h * d)
    row("B2", lambda: att.attention_packed_qkv_kernel(qkv, h, d, d ** -0.5))
    q, k, v = (t.view(b, n, h, d) for t in qkv.split(h * d, dim=-1))
    row("B8 D=64 (lane slices)",
        lambda: att.attention_bnhd_kernel(q, k, v, d ** -0.5))
    del qkv, q, k, v
    q, k, v = (rand(b, h, n, d) for _ in range(3))
    row("B17", lambda: att.attention_bhnd_kernel(q, k, v, d ** -0.5))
    q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    row("B18", lambda: att.attention_strided_kernel(
        "attention_fused_bnhd", q, k, v, d ** -0.5, score_scale=True))
    del q, k, v
    q3 = rand(8, 1025, 16 * d, scale=0.125)
    k3, v3 = rand(8, 1025, 16 * d), rand(8, 1025, 16 * d)
    row("B19", lambda: att.attention_packed_gridchunk(
        q3, k3, v3, "prefix_causal", 1, d))
    del q3, k3, v3
    q, k, v = (rand(8, 1025, 16, 384) for _ in range(3))
    row("B8 D=384", lambda: att.attention_bnhd_kernel(
        q, k, v, 384 ** -0.5, "prefix_causal", 1))
    del q, k, v

    if not kernels_only:
        images = torch.from_numpy(np.random.default_rng(0).random(
            (128, 256, 256, 3), dtype=np.float32)).cuda()
        base = {"image_size": 256, "patch_size": 8,
                "quantizer": {"embed_dim": 32, "n_embed": 8192}}
        model = ViTVQ(dtype="bfloat16", seed=0, device="cuda",
                      encoder=TOWER, decoder=TOWER, **base)
        out.append(f"trip {trip_ms(model, images):.2f}")
        del model
        os.environ["ENHANCING_TPU_ATTN_PROJ"] = "1"
        model = ViTVQ(dtype="bfloat16", seed=0, device="cuda",
                      encoder=FUSED, decoder=FUSED, **base)
        out.append(f"fused trip {trip_ms(model, images):.2f}")
        del os.environ["ENHANCING_TPU_ATTN_PROJ"], model, images
        torch.cuda.empty_cache()
        out.append(f"train step {step_ms(FAKE_VITVQ_BASE):.2f}")
    print(f"[ab] {label}: " + "; ".join(out) + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
