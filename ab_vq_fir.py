#!/usr/bin/env python3
"""Time the VQ search (B4, csrc/vq.cu), the FIR blur (B6, csrc/fir.cu) and
the blur's VJP, and the paths that run them, for one checkout on one
NVIDIA card.

    python3 ab_vq_fir.py ROOT LABEL [--kernels-only]

ROOT is the root of a checkout (its ``enhancing_tpu_torch`` and
``chip_smoke.py`` are imported and its kernels built there). To compare
two versions, unpack the other one (``git archive <commit>
enhancing_tpu_torch chip_smoke.py configs assets``) into a directory that
.gitignore lists and run this script for both in turns within one call on
one card: A, B, B, A. Prints the card's name and power limit
(``nvidia-smi``), then, each time the median of 5 loops of CUDA events
with a checksum:

- B4 (``ops.vq.nearest_codebook_indices``) on ViT-VQGAN-Base's codebook
  (8192 codes of 32, rows and codes unit-norm fp32) at batch 128 (M =
  131 072) and batch 8 (M = 8192);
- the 12 blurs of one 256-px discriminator forward at batch 8, fp32
  (``ops.upfirdn2d.upfirdn2d``), summed, and the same as device ms
  (``torch.profiler``, each blur 20 times);
- their 12 VJPs as a training step's backward runs them
  (``torch.autograd.grad`` through ``upfirdn2d`` on a kept graph:
  whatever that version's backward computes), summed, events and device
  ms.

Then, unless ``--kernels-only``: ms per ``encode_codes`` ->
``decode_codes`` round trip of ViT-VQGAN-Base in bf16 at batch 128 (host
clock around 5 synchronised trips) and one trip's device busy ms; ms per
GAN step of ``configs/fake_vitvq_base.yaml`` at batch 8 (the train step
without R1, host clock around each of 5 synchronised steps after 2 warm
ones, their median) and one step's device busy ms, the device ms under
the blur's backward (``_FIRBackward``) and in the blur's kernel.
"""
import statistics
import subprocess
import sys
import time

TRIP_BATCH, STEPS = 128, 5


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


def device_ms(fn, calls=20):
    """Device ms a call, summed over its kernels (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / calls


def kernels(out, torch, cs):
    import torch.nn.functional as F

    from enhancing_tpu_torch.ops import upfirdn2d as fir
    from enhancing_tpu_torch.ops import vq
    gen = torch.Generator(device="cuda").manual_seed(0)
    cb = F.normalize(torch.randn((cs.CODES, cs.EMBED), generator=gen,
                                 device="cuda"), dim=-1)
    for batch in (TRIP_BATCH, cs.TRAIN_BATCH):
        z = F.normalize(torch.randn((batch * cs.TOKENS, cs.EMBED),
                                    generator=gen, device="cuda"), dim=-1)
        fn = lambda: vq.nearest_codebook_indices(z, cb)  # noqa: E731
        out.append(f"B4 b{batch} {time_ms(fn):.4f} (checksum "
                   f"{int(fn().long().sum())})")
    blur = fir.make_blur_kernel([1, 3, 3, 1])
    fwd = bwd = fwd_dev = bwd_dev = 0.0
    check_f = check_b = 0.0
    for shape, pad in cs.D_BLURS:
        x = torch.randn(shape, generator=gen, device="cuda")
        xg = x.clone().requires_grad_()
        y = fir.upfirdn2d(xg, blur, pad=pad)
        g = torch.randn(y.shape, generator=gen, device="cuda")
        f = lambda: fir.upfirdn2d(x, blur, pad=pad)  # noqa: E731
        b = lambda: torch.autograd.grad(  # noqa: E731
            y, xg, g, retain_graph=True)
        fwd += time_ms(f, iters=20)
        bwd += time_ms(b, iters=20)
        fwd_dev += device_ms(f)
        bwd_dev += device_ms(b)
        check_f += float(f().double().sum())
        check_b += float(b()[0].double().sum())
    out.append(f"B6 12 blurs {fwd:.4f} device {fwd_dev:.4f} (checksum "
               f"{check_f:.6f})")
    out.append(f"B6 12 VJPs {bwd:.4f} device {bwd_dev:.4f} (checksum "
               f"{check_b:.6f})")


def paths(out, torch, cs):
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from enhancing_tpu_torch.models.stage1.vitvqgan import ViTVQ
    from enhancing_tpu_torch.train import Trainer
    from enhancing_tpu_torch.utils.config import initialize_from_config
    model = ViTVQ(dtype="bfloat16", seed=0, device="cuda", **cs.BASE)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (TRIP_BATCH, 256, 256, 3), dtype=np.float32)).cuda()
    trip = lambda: model.decode_codes(model.encode_codes(x))  # noqa: E731
    for _ in range(2):
        trip()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        trip()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    out.append(f"trip b{TRIP_BATCH} {ms:.2f} busy {device_ms(trip, 1):.2f}")
    del model, x
    torch.cuda.empty_cache()

    model = initialize_from_config(cs.FAKE_VITVQ_BASE["model"], device="cuda")
    data = initialize_from_config(cs.FAKE_VITVQ_BASE["dataset"])
    data.setup()
    x = model.get_input(next(iter(data.val_dataloader())), "image")
    state, step, _ = Trainer(max_steps=1)._build_stage1(model)
    model.module.train()
    for _ in range(2):
        step(state, x, do_r1=False)
    steps = []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, x, do_r1=False)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, x, do_r1=False)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == cuda and not e.key.startswith("Optimizer")
               ) / 1e3
    vjp = sum(e.device_time_total for e in prof.events()
              if e.name.startswith("autograd::engine")
              and "_FIRBackward" in e.name) / 1e3
    blur = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == cuda and "fir_kernel" in e.key) / 1e3
    out.append(f"GAN step {statistics.median(steps):.2f} "
               f"({min(steps):.2f}-{max(steps):.2f}) busy {busy:.2f}, blur "
               f"VJP {vjp:.3f}, blur kernel {blur:.3f}")


def main() -> int:
    root, label = sys.argv[1], sys.argv[2]
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    out = []
    kernels(out, torch, cs)
    if "--kernels-only" not in sys.argv[3:]:
        paths(out, torch, cs)
    print(f"[ab] {label} ({card}): " + "; ".join(out) + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
