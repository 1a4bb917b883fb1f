#!/usr/bin/env python3
"""Time the final LayerNorm, the int8 decode MLP and the paths that run
them, for one checkout on one NVIDIA card.

    python3 ab_layernorm_int8_mlp.py ROOT LABEL [--kernels-only]

ROOT is the root of a checkout (its ``enhancing_tpu_torch`` and
``chip_smoke.py`` are imported and its kernels built there). To compare
two versions, unpack the other one (``git archive <commit>
enhancing_tpu_torch chip_smoke.py``) into a directory that .gitignore
lists and run this script for both in turns within one call on one card:
A, B, B, A. It prints, as CUDA-event ms per call (the median of 5 loops of
back-to-back calls) and as device ms per call (``torch.profiler``, 20
calls):

- B3 (``csrc/layernorm.cu``) at the tokenizer's final LayerNorm at batch
  128 (131072 x 768 bf16), beside ``F.layer_norm`` on the same inputs and
  a device-to-device copy of the same bytes;
- B14 (``csrc/int8_mlp.cu``) at the int8 decode step's MLP of the
  published prior (x fp32 (8, 6144), hidden 24576, squared ReLU), and with
  bf16 x;

then, unless ``--kernels-only``: the fused serving round trip at batch 128
(``ffn_impl: fused``, ``ENHANCING_TPU_ATTN_PROJ=1``: 26 B3 launches a
trip; ms a trip on the host clock, the median of 5) and the int8 sampler
of the 24 x 6144 prior (random bf16 weights from a seed,
``quantize_decode_params``, ``drop_quantized_kernels``, ``kv_int8``;
``sample_gpt`` of 8 images, top-k 100: ms a step on the host clock, and one
decode step at cur_len 512: its host ms, device busy ms and idle share).
"""
import os
import statistics
import sys
import time


def time_ms(fn, iters, loops=5, warmup=3):
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
    """Device time per call of ``fn`` summed over its kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               ) / 1e3 / calls


def fused_trip_ms(base):
    """Host ms of one fused serving round trip at batch 128, the median of
    5 after 2 warm-up trips."""
    import numpy as np
    import torch

    from enhancing_tpu_torch.models.stage1.vitvqgan import ViTVQ
    cfg = dict(base, encoder=dict(base["encoder"], ffn_impl="fused"),
               decoder=dict(base["decoder"], ffn_impl="fused"))
    model = ViTVQ(dtype="bfloat16", seed=0, device="cuda", **cfg)
    x = torch.from_numpy(np.random.default_rng(3).random(
        (128, 256, 256, 3), dtype=np.float32)).cuda()
    os.environ["ENHANCING_TPU_ATTN_PROJ"] = "1"
    try:
        out = []
        for i in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.decode_codes(model.encode_codes(x))
            torch.cuda.synchronize()
            if i >= 2:
                out.append((time.perf_counter() - t0) * 1e3)
    finally:
        os.environ.pop("ENHANCING_TPU_ATTN_PROJ")
    del model
    torch.cuda.empty_cache()
    return statistics.median(out)


def int8_step(prior, classes):
    """Host ms a sampler step (prefill counted as a step) of the int8
    prior, and one decode step at cur_len 512: host ms, device busy ms."""
    import torch

    from chip_smoke import profile_device
    from enhancing_tpu_torch.models.stage2 import (GPT, drop_quantized_kernels,
                                                   quantize_decode_params)
    from enhancing_tpu_torch.models.stage2.sampling import sample_gpt
    gpt = GPT(**prior, dtype="bfloat16", device="cuda")
    quantize_decode_params(gpt)
    drop_quantized_kernels(gpt)
    gpt.kv_int8 = True
    torch.cuda.empty_cache()
    conds = torch.tensor(classes, device="cuda")[:, None]
    gen = torch.Generator("cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample_gpt(gpt, conds, gen, top_k=100, with_logits=False)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / gpt.img_num_tokens * 1e3
    with torch.inference_mode():
        cache = gpt.init_cache(conds.shape[0])
        tok = conds[:, 0] % gpt.vocab_img_size
        for _ in range(2):
            gpt.decode_step(tok, 512, cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            gpt.decode_step(tok, 512, cache)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / 20 * 1e3
        busy = profile_device("int8 decode step at cur_len 512",
                              lambda: gpt.decode_step(tok, 512, cache))
    del cache, gpt
    torch.cuda.empty_cache()
    return per_step, host, busy


def main() -> int:
    root, label = sys.argv[1], sys.argv[2]
    kernels_only = "--kernels-only" in sys.argv[3:]
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from chip_smoke import BASE, CLASSES, PRIOR, rand
    from enhancing_tpu_torch.ops import int8
    from enhancing_tpu_torch.ops import ln_gemm as lg
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []

    def row(name, fn, iters):
        out.append(f"{name} {time_ms(fn, iters):.4f} (device "
                   f"{device_ms(fn):.4f})")

    m, d = 128 * 1024, 768
    x = rand((m, d), gen)
    g = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    b = 0.1 * torch.randn(d, generator=gen, device="cuda")
    row("B3 131072x768 bf16", lambda: lg.layernorm_kernel(x, g, b), 50)
    g16, b16 = g.to(x.dtype), b.to(x.dtype)
    row("F.layer_norm", lambda: F.layer_norm(x, (d,), g16, b16, 1e-5), 50)
    y = torch.empty_like(x)
    row("copy", lambda: y.copy_(x), 50)  # the same bytes, no arithmetic
    del x, y

    c, hdim = 6144, 4 * 6144
    w0_q, s0 = int8.quantize_channelwise(rand((hdim, c), gen, scale=0.02))
    w1_q, s1 = int8.quantize_channelwise(rand((c, hdim), gen, scale=0.02))
    b0, b1 = rand((hdim,), gen, scale=0.02), rand((c,), gen, scale=0.02)
    x32 = torch.randn((8, c), generator=gen, device="cuda")
    for name, xm in (("B14 f32 x", x32), ("B14 bf16 x", x32.bfloat16())):
        args = (xm, g.new_ones(c), g.new_zeros(c), w0_q, s0, b0, w1_q, s1,
                b1, x32)
        row(name, lambda: int8.int8_mlp_kernel(*args), 20)  # noqa: B023
    del w0_q, w1_q
    torch.cuda.empty_cache()

    if not kernels_only:
        out.append(f"fused trip B=128 {fused_trip_ms(BASE):.2f} ms")
        step, host, busy = int8_step(PRIOR, CLASSES)
        busy_s = "not measured" if busy is None else f"{busy:.3f}"
        idle = "" if busy is None else f", idle {1 - busy / host:.1%}"
        out.append(f"int8 sample {step:.3f} ms a step (cur_len 512 step: "
                   f"host {host:.3f}, device busy {busy_s}{idle})")
    print(f"[ab] {label}: " + "; ".join(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
