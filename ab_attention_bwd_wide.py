#!/usr/bin/env python3
"""Time B5 at the GPT prior's head dim 384 (csrc/attention_bwd_wide.cu) and
the prior's training step that runs it, for one checkout on one NVIDIA
card.

    python3 ab_attention_bwd_wide.py ROOT LABEL [--kernels-only]

ROOT is the root of a checkout (its ``enhancing_tpu_torch`` and
``chip_smoke.py`` are imported and its kernels built there). To compare
two versions, unpack the other one (``git archive <commit>
enhancing_tpu_torch chip_smoke.py configs``) into a directory that
.gitignore lists and run this script for both in turns within one call
on one card: A, B, B, A. Prints the card's name and power limit
(``nvidia-smi``), then the ms per call (CUDA events, the median of 5
loops) with a checksum of each output of B5 at D = 384 in bf16 and fp32 at
the prior's training shape (batch 4, N = 1025, 16 heads of 384,
prefix-causal with the one condition token, on the lane slices of a qkv
buffer), and of bf16 B5 at ViT-VQGAN-Base's training shape (batch 8, 12
heads of 64), whose checksum shows that kernel untouched. Then, unless
``--kernels-only``: ms per step of ``Trainer.fit`` on the prior of
``configs/imagenet_gpt_vitvq_base.yaml`` at its published widths, cut to
4 layers in bf16 and 2 in fp32 (``chip_smoke.prior_train_config``:
FakeImages at 256 px, batch 4, fp32 master weights), from the host clock
at the trainer's synchronising log calls, steps after the first.
"""
import gc
import statistics
import subprocess
import sys
import time

STEPS = {"bfloat16": (4, 4), "float32": (2, 3)}  # layers, steps


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


class Clock:
    """The trainer's metrics logger: the host clock at each log call."""

    def __init__(self):
        self.t = []

    def log_metrics(self, metrics, step):
        import torch
        torch.cuda.synchronize()
        self.t.append(time.perf_counter())


def kernels(out, att, torch):
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def row(name, fn):
        res = fn()
        check = sum(float(t.double().sum()) for t in res)
        out.append(f"{name} {time_ms(fn):.4f} (checksum {check:.6f})")

    for b, n, h, d, mode, cl in ((4, 1025, 16, 384, "prefix_causal", 1),
                                 (8, 1024, 12, 64, "none", 0)):
        for dtype in (torch.bfloat16, torch.float32):
            if d != 384 and dtype != torch.bfloat16:
                continue
            qkv = rand(b, n, 3 * h * d, dtype=dtype)
            q3, k3, v3 = att.split_qkv_scaled(qkv, d ** -0.5)
            do = rand(b, n, h * d, dtype=dtype)
            row(f"B5 {str(dtype)[6:]} D={d}", lambda: att.attention_bwd_kernel(
                q3, k3, v3, do, h, d, mode, cl))
            del qkv, q3, k3, v3, do
            gc.collect()
            torch.cuda.empty_cache()


def prior_steps(out, torch):
    from chip_smoke import prior_train_config
    from enhancing_tpu_torch.train import Trainer
    from enhancing_tpu_torch.utils.config import initialize_from_config
    for dtype, (layers, steps) in STEPS.items():
        cfg = prior_train_config(dtype, layers)
        model = initialize_from_config(cfg["model"], device="cuda")
        data = initialize_from_config(cfg["dataset"])
        clock = Clock()
        Trainer(max_steps=steps, log_every=1, metrics_logger=clock).fit(
            model, data)
        # the first `steps` log calls end the steps (then validation)
        t = clock.t[:steps]
        out.append(f"prior step {dtype[:4]} depth {layers} "
                   f"{(t[-1] - t[0]) / (steps - 1) * 1e3:.2f}")
        del model, data
        gc.collect()
        torch.cuda.empty_cache()


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
        prior_steps(out, torch)
    print(f"[ab] {label} ({card}): " + "; ".join(out) + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
