#!/usr/bin/env python3
"""Time the fp32 attention kernels (csrc/attention_f32.cu: B2, B8, B17,
B18, B19 forward, B5 backward) and the fp32 paths that run them, for one
checkout on one NVIDIA card.

    python3 ab_attention_f32.py ROOT LABEL [--kernels-only]

ROOT is the root of a checkout (its ``enhancing_tpu_torch`` and
``chip_smoke.py`` are imported and its kernels built there). To compare
two versions, unpack the other one (``git archive <commit>
enhancing_tpu_torch chip_smoke.py configs``) into a directory that
.gitignore lists and run this script for both in turns within one call
on one card: A, B, B, A. Prints the card's name and power limit
(``nvidia-smi``), then the ms per call (CUDA events, the median of 5
loops) with a checksum of each output of: fp32 B2 on ViT-VQGAN-Base's qkv
buffer at batch 8 (N = 1024, 12 heads of 64) and at 16 heads of 80; fp32
B8 at the GPT prior's teacher-forced shape (batch 8, N = 1025, 16 heads of
384, prefix-causal); fp32 B17 on (B, H, N, D) and B18 on (B, N, H, D)
tensors of the B2 shape; fp32 B19 at (8, 1025, 16 heads of 64,
prefix-causal); fp32 B5 at the training shape (batch 8, 12 heads of 64)
and at 16 heads of 80; and bf16 B2 and B5 at batch 8, whose checksums
show that the bf16 kernels are untouched. Then, unless
``--kernels-only``: ms per ``encode_codes`` -> ``decode_codes`` round trip
of ``configs/imagenet_vitvq_base.yaml`` and ``imagenet_vitvq_large.yaml``
in their own fp32 at batch 8, of a bf16 ViT-VQGAN-Base at batch 128 by
default and with both fused serving options (``ffn_impl: fused``,
ENHANCING_TPU_ATTN_PROJ=1); ms per step of ``Trainer.fit`` on
``configs/fake_vitvq_base.yaml`` with ``dtype: float32`` at batch 8 (steps
1-4, after step 0's R1); and ms of the fp32 24 x 6144 prior's
teacher-forced forward (batch 8, N = 1025: its 24 B8 launches) and per
step of its prefill + 16 decode steps, random weights drawn on the card.
"""
import gc
import json
import os
import statistics
import subprocess
import sys
import time

TOWER = {"dim": 768, "depth": 12, "heads": 12, "mlp_dim": 3072}
FUSED = dict(TOWER, ffn_impl="fused")
TRAIN_STEPS = 5
PRIOR_STEPS = 16


def time_ms(fn, iters=5, loops=5, warmup=2):
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


def kernels(out, att, torch):
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32 = torch.float32

    def rand(*shape, dtype=f32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    def row(name, fn):
        res = fn()
        res = res if isinstance(res, tuple) else (res,)
        check = sum(float(t.double().sum()) for t in res)
        out.append(f"{name} {time_ms(fn):.4f} (checksum {check:.6f})")

    b, n = 8, 1024
    for dtype in (f32, torch.bfloat16):
        for h, d in ((12, 64), (16, 80)):
            if dtype != f32 and d != 64:
                continue
            tag = f"{'f32' if dtype == f32 else 'bf16'} D={d}"
            qkv = rand(b, n, 3 * h * d, dtype=dtype)
            row(f"B2 {tag}", lambda: att.attention_packed_qkv_kernel(
                qkv, h, d, d ** -0.5))
            q3, k3, v3 = att.split_qkv_scaled(qkv, d ** -0.5)
            do = rand(b, n, h * d, dtype=dtype)
            row(f"B5 {tag}", lambda: att.attention_bwd_kernel(
                q3, k3, v3, do, h, d))
            del qkv, q3, k3, v3, do
    h, d = 12, 64
    q, k, v = (rand(b, h, n, d) for _ in range(3))
    row("B17 f32", lambda: att.attention_bhnd_kernel(q, k, v, d ** -0.5))
    q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    row("B18 f32", lambda: att.attention_strided_kernel(
        "attention_fused_bnhd", q, k, v, d ** -0.5, score_scale=True))
    del q, k, v
    q3 = rand(b, 1025, 16 * d, scale=0.125)
    k3, v3 = rand(b, 1025, 16 * d), rand(b, 1025, 16 * d)
    row("B19 f32", lambda: att.attention_packed_gridchunk(
        q3, k3, v3, "prefix_causal", 1, d))
    del q3, k3, v3
    q, k, v = (rand(b, 1025, 16, 384) for _ in range(3))
    row("B8 f32 D=384", lambda: att.attention_bnhd_kernel(
        q, k, v, 384 ** -0.5, "prefix_causal", 1))
    del q, k, v


def paths(out, root, torch):
    import numpy as np

    from chip_smoke import (FAKE_VITVQ_BASE, GPT_VITVQ_BASE, P_VOCAB,
                            teacher_forced)
    from enhancing_tpu_torch.models.stage1.vitvqgan import ViTVQ
    from enhancing_tpu_torch.utils.config import (initialize_from_config,
                                                  load_config)
    rng = np.random.default_rng(0)
    x8 = torch.from_numpy(rng.random((8, 256, 256, 3),
                                     dtype=np.float32)).cuda()
    for name in ("imagenet_vitvq_base", "imagenet_vitvq_large"):
        cfg = load_config(os.path.join(root, "configs", f"{name}.yaml"))
        model = initialize_from_config(cfg.model, device="cuda")
        out.append(f"{name} f32 trip b8 {trip_ms(model, x8):.2f}")
        del model
        torch.cuda.empty_cache()
    x128 = torch.from_numpy(rng.random((128, 256, 256, 3),
                                       dtype=np.float32)).cuda()
    base = {"image_size": 256, "patch_size": 8,
            "quantizer": {"embed_dim": 32, "n_embed": 8192}}
    model = ViTVQ(dtype="bfloat16", seed=0, device="cuda", encoder=TOWER,
                  decoder=TOWER, **base)
    out.append(f"bf16 trip b128 {trip_ms(model, x128):.2f}")
    del model
    os.environ["ENHANCING_TPU_ATTN_PROJ"] = "1"
    model = ViTVQ(dtype="bfloat16", seed=0, device="cuda", encoder=FUSED,
                  decoder=FUSED, **base)
    out.append(f"bf16 fused trip b128 {trip_ms(model, x128):.2f}")
    del os.environ["ENHANCING_TPU_ATTN_PROJ"], model, x128
    torch.cuda.empty_cache()
    cfg = json.loads(json.dumps(FAKE_VITVQ_BASE))
    cfg["model"]["params"]["dtype"] = "float32"
    out.append(f"f32 train step {step_ms(cfg):.2f}")
    gc.collect()
    torch.cuda.empty_cache()

    model = initialize_from_config(json.loads(json.dumps(GPT_VITVQ_BASE)),
                                   device="cuda")
    gpt = model.transformer
    gen = torch.Generator(device="cuda").manual_seed(4)
    conds = torch.arange(8, device="cuda")[:, None]
    codes = torch.randint(0, P_VOCAB, (8, 1024),
                          generator=gen, device="cuda")

    def forward():
        with torch.inference_mode():
            return gpt(codes, conds)
    forward()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        forward()
    torch.cuda.synchronize()
    out.append(f"f32 prior forward b8 N=1025 "
               f"{(time.perf_counter() - t0) / 2 * 1e3:.2f}")
    teacher_forced(gpt, codes, conds, PRIOR_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    teacher_forced(gpt, codes, conds, PRIOR_STEPS)
    torch.cuda.synchronize()
    out.append(f"f32 prior prefill + {PRIOR_STEPS} steps, per step "
               f"{(time.perf_counter() - t0) / (PRIOR_STEPS + 1) * 1e3:.2f}")


def main() -> int:
    root, label = sys.argv[1], sys.argv[2]
    kernels_only = "--kernels-only" in sys.argv[3:]
    sys.path.insert(0, root)
    import torch

    from enhancing_tpu_torch.ops import attention as att
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    out = []
    kernels(out, att, torch)
    if not kernels_only:
        paths(out, root, torch)
    print(f"[ab] {label} ({card}): " + "; ".join(out) + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
