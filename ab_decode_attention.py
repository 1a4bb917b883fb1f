#!/usr/bin/env python3
"""Time the GPT prior's attention kernels and its sampling step, for one
checkout on one NVIDIA card.

    python3 ab_decode_attention.py ROOT LABEL [--kernels-only]

ROOT is the root of a checkout (its ``enhancing_tpu_torch`` and
``chip_smoke.py`` are imported and its kernels built there). To compare
two versions, unpack the other one (``git archive <commit>
enhancing_tpu_torch chip_smoke.py``) into a directory that .gitignore
lists and run this script for both in turns within one call on one card:
A, B, B, A. At the published prior's shapes (``configs/
imagenet_gpt_vitvq_base.yaml``: 16 heads of 384, batch 8) it prints the
ms per call (CUDA events over back-to-back calls, the median of 5 loops)
and the device ms per call (``torch.profiler``, 20 calls) of B8
(``csrc/attention_bnhd.cu``, prefix-causal) at the teacher-forced
forward's N = 1025 and the prefill's N = 1, and of B9
(``csrc/decode_attention.cu``) with a bf16 cache under bf16 q and an
int8 cache under fp32 q at cur_len 1, 256, 512 and 1024 (three layers of
the (24, 8, 1032, 6144) stack in turn, so that L2 holds none of a call's
K and V); then, unless ``--kernels-only``, the ms per step of the
sampler (``sample_gpt``: prefill + 1023 decode steps of the 24 x 6144
prior with random bf16 weights, top-k 100; host clock) in bf16 and, after
``quantize_decode_params``, ``drop_quantized_kernels`` and ``kv_int8``,
in int8, each with one decode step's device busy time at cur_len 512 and
the device's idle share of that step.
"""
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


def step_ms(gpt, conds, seed):
    """Host ms per sampler step (prefill counted as a step), and the device
    busy ms and idle share of one decode step at cur_len 512."""
    import torch
    from chip_smoke import profile_device
    from enhancing_tpu_torch.models.stage2.sampling import sample_gpt
    gen = torch.Generator("cuda").manual_seed(seed)
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
        busy = profile_device("decode step at cur_len 512",
                              lambda: gpt.decode_step(tok, 512, cache))
    del cache
    return per_step, busy, 1 - busy / host


def main() -> int:
    root, label = sys.argv[1], sys.argv[2]
    kernels_only = "--kernels-only" in sys.argv[3:]
    sys.path.insert(0, root)
    import torch

    from chip_smoke import (CLASSES, P_HEAD_DIM, P_HEADS, PRIOR,
                            SAMPLE_BATCH, cycling, prior_stack, rand)
    from enhancing_tpu_torch.ops import attention as att
    from enhancing_tpu_torch.ops import int8
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, d = SAMPLE_BATCH, P_HEADS, P_HEAD_DIM
    out = []

    def row(name, fn, iters):
        out.append(f"{name} {time_ms(fn, iters):.4f} (device "
                   f"{device_ms(fn):.4f})")

    for n in (1025, 1):
        q, k, v = (rand((b, n, h, d), gen) for _ in range(3))
        row(f"B8 D=384 N={n}", lambda: att.attention_bnhd_kernel(
            q, k, v, d ** -0.5, "prefix_causal", 1), 10 if n > 1 else 50)
        del q, k, v
    layers = [11, 18, 1]
    kc, vc = prior_stack(gen, 1024)
    q3 = rand((b, h * d), gen, scale=d ** -0.5)
    kn, vn = rand((b, h * d), gen), rand((b, h * d), gen)
    for cur in (1, 256, 512, 1024):
        row(f"B9 bf16 cur_len {cur}", cycling(
            lambda li: att.decode_attention_kernel(  # noqa: B023
                q3, kc, vc, kn, vn, cur, li, d), layers), 50)
    k8, ks = int8.quantize_channelwise(kc)
    v8, vs = int8.quantize_channelwise(vc)
    del kc, vc
    q3, kn, vn = q3.float(), kn.float(), vn.float()
    for cur in (1, 256, 512, 1024):
        row(f"B9 int8 cur_len {cur}", cycling(
            lambda li: att.decode_attention_kernel(  # noqa: B023
                q3, k8, v8, kn, vn, cur, li, d, ks, vs), layers), 50)
    del k8, v8, ks, vs
    torch.cuda.empty_cache()

    if not kernels_only:
        from enhancing_tpu_torch.models.stage2 import (
            GPT, drop_quantized_kernels, quantize_decode_params)
        gpt = GPT(**PRIOR, dtype="bfloat16", device="cuda")
        conds = torch.tensor(CLASSES, device="cuda")[:, None]
        ms, busy, idle = step_ms(gpt, conds, 0)
        out.append(f"bf16 sample {ms:.3f} ms a step (cur_len 512 step: "
                   f"device busy {busy:.3f}, idle {idle:.1%})")
        quantize_decode_params(gpt)
        drop_quantized_kernels(gpt)
        gpt.kv_int8 = True
        torch.cuda.empty_cache()
        ms, busy, idle = step_ms(gpt, conds, 0)
        out.append(f"int8 sample {ms:.3f} ms a step (cur_len 512 step: "
                   f"device busy {busy:.3f}, idle {idle:.1%})")
    print(f"[ab] {label}: " + "; ".join(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
