#!/usr/bin/env python3
"""Time the fp32 LN -> GEMM (B1 in fp32: csrc/ln_gemm_f32.cu, and at a
decode step's few rows csrc/ln_shift_gemm.cu), the LN -> shift -> GEMM B11
and the fp32 paths that run them, for one checkout on one NVIDIA card.

    python3 ab_ln_gemm_f32.py ROOT LABEL [--kernels-only] [--route]

ROOT is the root of a checkout (its ``enhancing_tpu_torch`` and
``chip_smoke.py`` are imported and its kernels built there). To compare
two versions, unpack the other one (``git archive <commit>
enhancing_tpu_torch chip_smoke.py configs``) into a directory that
.gitignore lists and run this script for both in turns within one call
on one card: A, B, B, A. Prints the card's name and power limit
(``nvidia-smi``), then:

- fp32 B1 (``ops.ln_gemm.ln_gemm_kernel``, fp32 x and W, tanh and a bias)
  at batch 8 (M = 8192) on ViT-VQGAN-Base's qkv (768 -> 2304) and fc1
  (768 -> 3072) and on imagenet_vitvq_large.yaml's decoder qkv (1280 ->
  3840) and fc1 (1280 -> 5120): ms per call (CUDA events, the median of 5
  loops) and a checksum;
- the decode step's fp32 calls at the prior's widths, batch 8, as
  ``ops.ln_gemm.fused_ln_gemm`` makes them with the stored bf16 weights
  (the LNFUSE mlp site 6144 -> 24576 with squared ReLU, the head 6144 ->
  8192; whatever casts a version makes are in its time) and B11 at the
  LNFUSE qkv (6144 -> 18432, the shift, bf16 W): device ms per call
  (``torch.profiler``, 20 calls, two weight copies in turn) and a
  checksum.

Then, unless ``--kernels-only``: ms per ``encode_codes`` ->
``decode_codes`` round trip of ``configs/imagenet_vitvq_base.yaml`` and
``imagenet_vitvq_large.yaml`` in their own fp32 at batch 8; ms per step of
``Trainer.fit`` on ``configs/fake_vitvq_base.yaml`` with ``dtype:
float32`` at batch 8 (steps 1-4, after step 0's R1); and the bf16 24 x
6144 prior's decode step under ENHANCING_TPU_DECODE_LNFUSE=all at cur_len
512, batch 8: host ms a step (the median of 5 loops of 20 steps) and one
step's device busy ms and device time by kernel group
(``chip_smoke.profile_device``).

``--route`` (a checkout with ``ops.ln_gemm.ln_gemm_route``) also times
fp32 B1's two kernels against each other at the prior's mlp and head
(6144 -> 24576, 8192) for fp32 x of 8 to 96 rows, bf16 and fp32 W:
B11's kernel without the shift and the fp32 tiles, device ms, whatever
``LN_GEMM_DECODE_ROWS`` says; the crossing sets it.
"""
import gc
import json
import os
import statistics
import subprocess
import sys
import time

TRAIN_STEPS = 5
# (label, d, n): the fp32 towers' LN -> GEMM calls at batch 8
F32_SHAPES = (("Base qkv", 768, 2304), ("Base fc1", 768, 3072),
              ("Large dec qkv", 1280, 3840), ("Large dec fc1", 1280, 5120))


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
    times = clock.t[:TRAIN_STEPS]
    return (times[-1] - times[0]) / (TRAIN_STEPS - 1) * 1e3


def cycling(fn, copies):
    state = {"i": 0}

    def call():
        state["i"] = (state["i"] + 1) % len(copies)
        return fn(copies[state["i"]])
    return call


def kernels(out, lg, torch):
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    def checksum(res):
        res = res if isinstance(res, tuple) else (res,)
        return sum(float(t.double().sum()) for t in res)

    m = 8192
    for label, d, n in F32_SHAPES:
        x = rand(m, d)
        g, bt = 1.0 + 0.1 * rand(d), 0.1 * rand(d)
        w, b = rand(n, d, scale=d ** -0.5), 0.02 * rand(n)
        fn = lambda: lg.ln_gemm_kernel(x, g, bt, w, b, "tanh")  # noqa: E731
        out.append(f"f32 B1 {label} {time_ms(fn):.4f} (checksum "
                   f"{checksum(fn()):.6f})")
        del x, w

    c, rows = 6144, 8
    x = rand(rows, c)
    g, bt = 1.0 + 0.1 * rand(c), 0.1 * rand(c)
    for label, n, act in (("LNFUSE mlp p0", 4 * c, "sqrelu"),
                          ("LNFUSE head", 8192, None)):
        copies = [rand(n, c, dtype=torch.bfloat16, scale=0.02)
                  for _ in range(2)]
        fn = cycling(lambda w: lg.fused_ln_gemm(  # noqa: B023
            x, g, bt, w, activation=act), copies)  # noqa: B023
        out.append(f"{label} f32 x b8 device {device_ms(fn):.4f} (checksum "
                   f"{checksum(fn()):.6f})")
        del copies
    tm = torch.linspace(0, 1, c, device="cuda")
    prev = rand(rows, c, dtype=torch.bfloat16)
    bq = 0.02 * rand(3 * c)
    copies = [rand(3 * c, c, dtype=torch.bfloat16, scale=0.02)
              for _ in range(2)]
    fn = cycling(lambda w: lg.fused_ln_shift_gemm(x, g, bt, tm, prev, w, bq),
                 copies)
    out.append(f"B11 LNFUSE qkv f32 x b8 device {device_ms(fn):.4f} "
               f"(checksum {checksum(fn()):.6f})")


def route(out, lg, torch):
    gen = torch.Generator(device="cuda").manual_seed(1)
    c = 6144
    g = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    bt = 0.1 * torch.randn(c, generator=gen, device="cuda")
    rows = lg.LN_GEMM_DECODE_ROWS
    for w_dtype in (torch.bfloat16, torch.float32):
        for label, n in (("mlp p0", 4 * c), ("head", 8192)):
            w = (torch.randn((n, c), generator=gen, device="cuda")
                 * 0.02).to(w_dtype)
            for m in (8, 16, 32, 48, 64, 96):
                x = torch.randn((m, c), generator=gen, device="cuda")
                decode = device_ms(lambda: lg._ln_shift_gemm_launch(
                    x, g, bt, None, None, w, None, "sqrelu",  # noqa: B023
                    1e-5, want_xn=False))
                lg.LN_GEMM_DECODE_ROWS = 0
                try:
                    tiles = device_ms(lambda: lg.ln_gemm_kernel(
                        x, g, bt, w, None, "sqrelu"))  # noqa: B023
                finally:
                    lg.LN_GEMM_DECODE_ROWS = rows
                out.append(f"route {label} {str(w_dtype)[6:]} W m={m}: "
                           f"decode {decode:.4f} tiles {tiles:.4f}")
            del w


def paths(out, root, torch):
    import numpy as np

    from chip_smoke import (CLASSES, FAKE_VITVQ_BASE, profile_device,
                            sampling_model)
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
    cfg = json.loads(json.dumps(FAKE_VITVQ_BASE))
    cfg["model"]["params"]["dtype"] = "float32"
    out.append(f"f32 train step {step_ms(cfg):.2f}")
    gc.collect()
    torch.cuda.empty_cache()

    model = sampling_model()
    gpt = model.transformer
    conds = torch.tensor(CLASSES, device="cuda")[:, None]
    os.environ["ENHANCING_TPU_DECODE_LNFUSE"] = "all"
    try:
        with torch.inference_mode():
            cache = gpt.init_cache(len(CLASSES))
            _, cache = gpt.prefill(conds, cache)
            tok = torch.zeros(len(CLASSES), dtype=torch.int32, device="cuda")
            for _ in range(2):
                gpt.decode_step(tok, 512, cache)
            loops = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(20):
                    gpt.decode_step(tok, 512, cache)
                torch.cuda.synchronize()
                loops.append((time.perf_counter() - t0) / 20 * 1e3)
            busy = profile_device("LNFUSE decode step at cur_len 512",
                                  lambda: gpt.decode_step(tok, 512, cache))
    finally:
        del os.environ["ENHANCING_TPU_DECODE_LNFUSE"]
    out.append(f"LNFUSE step host {statistics.median(loops):.3f} "
               f"({min(loops):.3f}-{max(loops):.3f}), device busy "
               f"{busy:.3f}")


def main() -> int:
    root, label = sys.argv[1], sys.argv[2]
    kernels_only = "--kernels-only" in sys.argv[3:]
    with_route = "--route" in sys.argv[3:]
    sys.path.insert(0, root)
    import torch

    from enhancing_tpu_torch.ops import ln_gemm as lg
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    out = []
    kernels(out, lg, torch)
    if with_route:
        route(out, lg, torch)
    if not kernels_only:
        paths(out, root, torch)
    print(f"[ab] {label} ({card}): " + "; ".join(out) + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
