#!/usr/bin/env python3
"""Time the int8 decode GEMMs and the int8 sampler that runs them, for one
checkout on one NVIDIA card.

    python3 ab_int8_gemm.py ROOT LABEL [--kernels-only | --host-only]

ROOT is the root of a checkout (its ``enhancing_tpu_torch``,
``chip_smoke.py`` and ``ab_layernorm_int8_mlp.py`` are imported and its
kernels built there). To compare two versions, unpack the other one
(``git archive <commit> enhancing_tpu_torch chip_smoke.py configs
ab_layernorm_int8_mlp.py``) into a directory that .gitignore lists and run
this script for both in turns within one call on one card: A, B, B, A.
At the int8 decode step's shapes of the published 24 x 6144 prior (batch
8; weights from a seed) it prints, as CUDA-event ms per call (the median
of 5 loops of back-to-back calls) and as device ms per call
(``torch.profiler``, 20 calls), and a checksum of one output:

- B12 (``csrc/int8_gemm.cu``): the decode projection, fp32 x (8, 6144) ->
  6144, three weight copies in turn (37.7 MB, more than L2 keeps between
  layers); the prefill's fused qkv, bf16 x -> 18432;
- B13 (``csrc/int8_ln_gemm.cu``): the decode qkv with the token shift,
  fp32 x -> 18432; the vocab head, fp32 x -> 8192, three copies in turn;

and the host's cost of each such call: us to enqueue one call of the
wrapper and of its C entry alone (the arguments of the wrapper's last
launch, passed again through ctypes), the median of 5 loops of 50 calls
timed before the loop's sync (50 launches wait in no queue). Then, unless
``--kernels-only``, the int8 sampler of the 24 x 6144 prior:
``sample_gpt`` of 8 images, top-k 100 (host ms a step), and the decode
step at cur_len 512: host ms a step over 20 steps in each of 5 loops
(min, median), the ms to enqueue them and the thread's CPU ms for them (a
coarse clock on some hosts), its device busy ms and device time by kernel
group (``chip_smoke.profile_device``). ``--host-only`` skips the device
times of the single calls.
"""
import statistics
import sys
import time


def host_us(fn, calls=50, loops=5):
    """Median us a call to enqueue ``calls`` back-to-back calls of fn."""
    import torch
    fn()
    out = []
    for _ in range(loops):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(out)


def c_entry(fn):
    """A call of the C entry that fn's last kernel launch went through,
    with the same arguments."""
    from enhancing_tpu_torch.ops import cuda_lib
    seen, real = [], cuda_lib.call

    def record(name, *args):
        seen.append((name, args))
        real(name, *args)
    cuda_lib.call = record
    try:
        fn()
    finally:
        cuda_lib.call = real
    name, args = seen[-1]
    entry = getattr(cuda_lib.lib(), name)
    return lambda: entry(*args)


def int8_step_host(prior, classes):
    """(host ms a sample step, host ms a decode step at cur_len 512 in each
    of 5 loops of 20 steps, the median ms to enqueue a step and its CPU
    ms, device busy ms)."""
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
    host, enqueue, cpu = [], [], []
    with torch.inference_mode():
        cache = gpt.init_cache(conds.shape[0])
        tok = conds[:, 0] % gpt.vocab_img_size
        for _ in range(2):
            gpt.decode_step(tok, 512, cache)
        for _ in range(5):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), time.thread_time()
            for _ in range(20):
                gpt.decode_step(tok, 512, cache)
            t1, c1 = time.perf_counter(), time.thread_time()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) / 20 * 1e3)
            enqueue.append((t1 - t0) / 20 * 1e3)
            cpu.append((c1 - c0) / 20 * 1e3)
        busy = profile_device("int8 decode step at cur_len 512",
                              lambda: gpt.decode_step(tok, 512, cache))
    del cache, gpt
    torch.cuda.empty_cache()
    return (per_step, host, statistics.median(enqueue),
            statistics.median(cpu), busy)


def main() -> int:
    root, label = sys.argv[1], sys.argv[2]
    kernels_only = "--kernels-only" in sys.argv[3:]
    host_only = "--host-only" in sys.argv[3:]
    sys.path.insert(0, root)
    import torch

    from ab_layernorm_int8_mlp import device_ms, time_ms
    from chip_smoke import CLASSES, PRIOR, cycling
    from enhancing_tpu_torch.ops import int8
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    c, b = PRIOR["embed_dim"], 8

    def quantized(n):
        w = torch.randn((n, c), generator=gen, device="cuda") * 0.02
        return int8.quantize_channelwise(w)

    x = torch.randn((b, c), generator=gen, device="cuda")
    x16 = x.bfloat16()
    g = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    bt = 0.1 * torch.randn(c, generator=gen, device="cuda")
    tm = torch.rand(c, generator=gen, device="cuda")
    prev = torch.randn((b, c), generator=gen, device="cuda")
    proj = [quantized(c) for _ in range(3)]
    head = [quantized(PRIOR["vocab_img_size"]) for _ in range(3)]
    qkv_q, qkv_s = quantized(3 * c)
    pb = 0.02 * torch.randn(c, generator=gen, device="cuda")
    qb = 0.02 * torch.randn(3 * c, generator=gen, device="cuda")
    rows = (
        ("B12 proj f32", cycling(
            lambda w: int8.int8_gemm_kernel(x, w[0], w[1], pb), proj), 50),
        ("B12 prefill qkv bf16", lambda: int8.int8_gemm_kernel(
            x16, qkv_q, qkv_s, qb.bfloat16()), 30),
        ("B13 qkv shift f32", lambda: int8.int8_ln_gemm_kernel(
            x, g, bt, tm, prev, qkv_q, qkv_s, qb)[0], 30),
        ("B13 head f32", cycling(lambda w: int8.int8_ln_gemm_kernel(
            x, g, bt, None, None, w[0], w[1])[0], head), 50))
    out = []
    for name, fn, iters in rows:
        check = float(fn().double().sum())
        host = (f"host us a call {host_us(fn):.1f}, C entry alone "
                f"{host_us(c_entry(fn)):.1f}")
        if host_only:
            out.append(f"{name} {host}")
            continue
        out.append(f"{name} {time_ms(fn, iters):.4f} (device "
                   f"{device_ms(fn):.4f}; {host}; checksum {check:.6e})")
    del proj, head, qkv_q
    torch.cuda.empty_cache()
    if not kernels_only:
        step, host, enqueue, cpu, busy = int8_step_host(PRIOR, CLASSES)
        busy_s = "not measured" if busy is None else f"{busy:.3f}"
        med = statistics.median(host)
        out.append(f"int8 sample {step:.3f} ms a step (cur_len 512 step: "
                   f"host min {min(host):.3f}, median {med:.3f} of "
                   f"{', '.join(f'{h:.3f}' for h in host)}; enqueue "
                   f"{enqueue:.3f}, CPU {cpu:.3f}; device busy {busy_s})")
    print(f"[ab] {label}: " + "; ".join(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
