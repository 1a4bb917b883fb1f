#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

The main path is the ViT-VQGAN-Base tokenizer round trip
(``encode_codes`` -> ``decode_codes``) at full widths and depth (256 px,
8x8 patches, width 768, 12 heads of 64, MLP 3072, 12 + 12 layers, 8192
codes of 32), in bf16 with random weights from seed 0. Phases, each of
which raises on failure:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every kernel of ``enhancing_tpu_torch/csrc`` by ``nvcc`` for
   sm_90a, with the ptxas register and shared-memory report;
3. each kernel against its plain PyTorch version on the card at the main
   path's shapes (batch 8), with the tolerance stated on its line;
4. each kernel's time at batch 128 (CUDA events), beside its plain
   version, one PyTorch library call computing the same function (timed
   only; the port never calls it) and its bound on an H100 SXM;
5. the main path through the public entry points: requests of batch 1, 8
   and 128 with launch counters reset just before and read just after,
   outputs checked, the kernels compared with the plain path on one small
   batch, images/s and peak memory at batch 128, and the device time of
   one round trip by kernel group (``torch.profiler``).

The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``. With no card, or run
from a directory that does not hold the package, it fails before printing
any result.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

BASE = dict(image_size=256, patch_size=8,
            encoder=dict(dim=768, depth=12, heads=12, mlp_dim=3072),
            decoder=dict(dim=768, depth=12, heads=12, mlp_dim=3072),
            quantizer=dict(embed_dim=32, n_embed=8192))
TOKENS, WIDTH, HEADS, HEAD_DIM, MLP, CODES, EMBED = 1024, 768, 12, 64, 3072, 8192, 32
CHECK_BATCH, TIME_BATCH = 8, 128
ROUND_TRIP = {"ln_gemm": 48, "attention": 24, "layernorm": 2, "vq": 1}
REPLACES = {
    "ln_gemm": "enhancing_tpu/ops/ln_gemm.py:65",
    "attention": "enhancing_tpu/ops/attention.py:334",
    "layernorm": "enhancing_tpu/ops/ln_gemm.py:385",
    "vq": "enhancing_tpu/ops/vq.py:48",
}
SOURCES = {name: f"enhancing_tpu_torch/csrc/{name}.cu" for name in REPLACES}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call over ``iters`` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


@contextlib.contextmanager
def plain_versions():
    """Run the plain PyTorch versions on CUDA tensors: the reference path
    of this script only. The package itself sends CUDA tensors to the
    kernels and has no such switch."""
    from enhancing_tpu_torch.ops import attention, ln_gemm, vq
    mods = (attention, ln_gemm, vq)
    saved = [m.use_kernel for m in mods]
    for m in mods:
        m.use_kernel = lambda *tensors: False
    try:
        yield
    finally:
        for m, fn in zip(mods, saved):
            m.use_kernel = fn


def phase_device() -> str:
    check(torch.cuda.is_available(), "no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(f"[device] {name}; torch {torch.__version__} cuda {torch.version.cuda}"
        f"; count {torch.cuda.device_count()}")
    log(smi.stdout.strip().splitlines()[0])
    return name


def phase_build() -> None:
    from enhancing_tpu_torch.ops import cuda_lib
    cuda_lib.lib()
    info = cuda_lib.build_info
    log(f"[build] {info['path']} in {info['seconds']:.1f} s "
        f"(cached: {info['cached']})")
    for line in info["log"].splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line \
                or line.startswith("=="):
            log("  " + line.strip())


def rand(shape, gen, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def kernel_inputs(batch: int, gen: torch.Generator) -> dict:
    """Main-path shapes at ``batch`` images, from seeded random numbers."""
    m = batch * TOKENS
    d = WIDTH
    w_scale = (2.0 / (d + 3 * d)) ** 0.5
    return {
        "x": rand((m, d), gen),
        "gamma": 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda"),
        "beta": 0.1 * torch.randn(d, generator=gen, device="cuda"),
        "w_qkv": rand((3 * d, d), gen, scale=w_scale),
        "w_fc1": rand((MLP, d), gen, scale=w_scale),
        "b_fc1": 0.02 * torch.randn(MLP, generator=gen, device="cuda"),
        "qkv": rand((batch, TOKENS, 3 * HEADS * HEAD_DIM), gen),
        "z": F.normalize(torch.randn((m, EMBED), generator=gen,
                                     device="cuda"), dim=-1),
        "codebook": F.normalize(torch.randn((CODES, EMBED), generator=gen,
                                            device="cuda"), dim=-1),
    }


def vq_scores(z, codebook):
    return -2.0 * (z @ codebook.t()) + (codebook * codebook).sum(-1)[None]


def near_tie_rows(scores, rel=1e-5):
    """Rows whose two best plain scores lie within ``rel`` of each other."""
    top2 = torch.topk(scores, 2, dim=-1, largest=False).values
    gap = top2[:, 1] - top2[:, 0]
    return gap <= rel * top2[:, 0].abs().clamp(min=1e-6)


def phase_compare() -> dict:
    """Kernel vs plain on the card; returns max_abs_err per kernel."""
    from enhancing_tpu_torch.ops import attention as att
    from enhancing_tpu_torch.ops import ln_gemm as lg
    from enhancing_tpu_torch.ops import vq
    gen = torch.Generator(device="cuda").manual_seed(0)
    t = kernel_inputs(CHECK_BATCH, gen)
    errs = {}

    def close(name, label, got, want, atol, rtol):
        err = (got.float() - want.float()).abs()
        worst = float((err - rtol * want.float().abs()).max())
        ok = worst <= atol and bool(torch.isfinite(got).all())
        mae = float(err.max())
        errs[name] = max(errs.get(name, 0.0), mae)
        log(f"[compare] {label}: max_abs_err {mae:.3e} tol atol {atol:g} + "
            f"rtol {rtol:g}*|plain| -> {'pass' if ok else 'FAIL'}")
        check(ok, f"{label} disagrees with its plain version")

    # bf16 outputs: one bf16 rounding (2^-8 relative) on each side, plus
    # the normalised row rounding to bf16 at a different place in a few
    # elements, so two bf16 steps
    tol = dict(atol=2.0 ** -7, rtol=2.0 ** -7)
    for label, w, b, act in (("ln_gemm qkv n=2304", t["w_qkv"], None, None),
                             ("ln_gemm fc1 n=3072 tanh", t["w_fc1"],
                              t["b_fc1"], "tanh")):
        got = lg.ln_gemm_kernel(t["x"], t["gamma"], t["beta"], w, b, act)
        want = lg.ln_gemm_plain(t["x"], t["gamma"], t["beta"], w, b, act)
        close("ln_gemm", label + " bf16 M=8192", got, want, **tol)
    # fp32 SIMT path: same products, another summation order
    x32, w32 = t["x"][:2048].float(), t["w_qkv"].float()
    close("ln_gemm", "ln_gemm f32 M=2048 n=2304",
          lg.ln_gemm_kernel(x32, t["gamma"], t["beta"], w32, None, "gelu"),
          lg.ln_gemm_plain(x32, t["gamma"], t["beta"], w32, None, "gelu"),
          atol=1e-4, rtol=1e-5)

    got = lg.layernorm_kernel(t["x"], t["gamma"], t["beta"])
    want = lg.layernorm(t["x"], t["gamma"], t["beta"])
    close("layernorm", "layernorm bf16 M=8192 d=768", got, want, **tol)

    # attention: P is rounded to bf16 against the running row max in the
    # kernel and the final row max in the plain version
    atol_att = dict(atol=1e-2, rtol=2.0 ** -7)
    got = att.attention_packed_qkv_kernel(t["qkv"], HEADS, HEAD_DIM,
                                          HEAD_DIM ** -0.5)
    want = att.attention_packed_qkv_plain(t["qkv"], HEADS, HEAD_DIM,
                                          HEAD_DIM ** -0.5)
    close("attention", "attention none B=8 N=1024 H=12 D=64", got, want,
          **atol_att)
    for (b, n, h, d, mode, cl) in ((2, 1025, 4, 64, "prefix_causal", 5),
                                   (2, 1025, 12, 64, "none", 0),
                                   (1, 200, 4, 32, "prefix_causal", 17),
                                   (1, 300, 2, 128, "none", 0)):
        qkv = rand((b, n, 3 * h * d), gen)
        got = att.attention_packed_qkv_kernel(qkv, h, d, d ** -0.5, mode, cl)
        want = att.attention_packed_qkv_plain(qkv, h, d, d ** -0.5, mode, cl)
        close("attention", f"attention {mode} B={b} N={n} H={h} D={d}",
              got, want, **atol_att)

    got = vq.nearest_kernel(t["z"], t["codebook"])
    want = vq.nearest_plain(t["z"], t["codebook"])
    scores = vq_scores(t["z"], t["codebook"])
    ties = near_tie_rows(scores)
    diff = got != want
    bad = int((diff & ~ties).sum())
    # the error of a code is the gap between the plain scores it and the
    # plain version's code get: 0 where they agree
    rows = torch.arange(len(got), device=got.device)
    errs["vq"] = float((scores[rows, got.long()]
                        - scores[rows, want.long()]).abs().max())
    log(f"[compare] vq M=8192 n=8192 D=32: {int(diff.sum())} mismatches, "
        f"{int(ties.sum())} near-tie rows (best two plain scores within "
        f"1e-5 relative), {bad} mismatches outside near-ties (tol 0) -> "
        f"{'pass' if bad == 0 else 'FAIL'}")
    check(bad == 0, "vq kernel disagrees outside near-ties")
    dup = torch.cat([t["codebook"][:64], t["codebook"][:64]])
    check(bool((vq.nearest_kernel(t["z"][:4096], dup) < 64).all()),
          "vq kernel: duplicated codes must resolve to the lowest index")
    torch.cuda.synchronize()
    return errs


def phase_times() -> dict:
    """ms of kernel, plain version and library call at batch 128."""
    from enhancing_tpu_torch.ops import attention as att
    from enhancing_tpu_torch.ops import ln_gemm as lg
    from enhancing_tpu_torch.ops import vq
    gen = torch.Generator(device="cuda").manual_seed(1)
    t = kernel_inputs(TIME_BATCH, gen)
    m, d = TIME_BATCH * TOKENS, WIDTH
    rows = {}

    def row(name, kernel, plain, library, flops, nbytes, peak, iters):
        b_ms, b_by = bound(flops, nbytes, peak)
        rows[name] = dict(ms=time_ms(kernel, iters),
                          plain_ms=time_ms(plain, 3, warmup=1),
                          library_ms=time_ms(library, iters),
                          bound_ms=b_ms, bound_by=b_by)
        r = rows[name]
        log(f"[time] {name} B={TIME_BATCH}: kernel_ms {r['ms']:.4f} "
            f"plain_ms {r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
            f"bound_ms {b_ms:.4f} ({b_by}); {flops / r['ms'] / 1e9:.1f} "
            f"TFLOP/s, {nbytes / r['ms'] / 1e6:.1f} GB/s")
        return r

    x, g, b = t["x"], t["gamma"], t["beta"]
    for label, w, bias, act in (("ln_gemm qkv", t["w_qkv"], None, None),
                                ("ln_gemm fc1", t["w_fc1"], t["b_fc1"],
                                 "tanh")):
        n = w.shape[0]
        lib_bias = None if bias is None else bias.to(torch.bfloat16)
        row(label,
            lambda: lg.ln_gemm_kernel(x, g, b, w, bias, act),
            lambda: lg.ln_gemm_plain(x, g, b, w, bias, act),
            lambda: lg._act(F.linear(F.layer_norm(x, (d,), g.to(x.dtype),
                                                  b.to(x.dtype), 1e-5),
                                     w, lib_bias), act),
            2.0 * m * d * n, (m * d + n * d + m * n) * 2 + (2 * d + n) * 4,
            PEAK_BF16, 20)

    qkv = t["qkv"]
    q, k, v = qkv.view(TIME_BATCH, TOKENS, 3, HEADS, HEAD_DIM).permute(
        2, 0, 3, 1, 4)
    hd = HEADS * HEAD_DIM
    row("attention",
        lambda: att.attention_packed_qkv_kernel(qkv, HEADS, HEAD_DIM,
                                                HEAD_DIM ** -0.5),
        lambda: att.attention_packed_qkv_plain(qkv, HEADS, HEAD_DIM,
                                               HEAD_DIM ** -0.5),
        lambda: F.scaled_dot_product_attention(q, k, v),
        4.0 * TIME_BATCH * HEADS * TOKENS * TOKENS * HEAD_DIM,
        (TIME_BATCH * TOKENS * 4 * hd) * 2, PEAK_BF16, 10)

    row("layernorm",
        lambda: lg.layernorm_kernel(x, g, b),
        lambda: lg.layernorm(x, g, b),
        lambda: F.layer_norm(x, (d,), g.to(x.dtype), b.to(x.dtype), 1e-5),
        8.0 * m * d, 2 * m * d * 2 + 2 * d * 4, PEAK_BF16, 50)

    z, cb = t["z"], t["codebook"]
    row("vq",
        lambda: vq.nearest_kernel(z, cb),
        lambda: vq.nearest_plain(z, cb),
        lambda: torch.cdist(z, cb).argmin(-1),
        2.0 * m * CODES * EMBED + 2.0 * CODES * EMBED,
        (m * EMBED + CODES * EMBED) * 4 + m * 4, PEAK_F32, 10)
    return rows


def phase_main_path() -> dict:
    """The tokenizer round trip through the public entry points."""
    from enhancing_tpu_torch.models.stage1.vitvqgan import ViTVQ
    from enhancing_tpu_torch.ops import LAUNCHES, reset_launches
    log(f"[main] allow_tf32 matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    model = ViTVQ(dtype="bfloat16", seed=0, device="cuda", **BASE)
    log(f"[main] ViT-VQGAN-Base bf16 built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    images = {b: rng.random((b, 256, 256, 3), dtype=np.float32)
              for b in (1, CHECK_BATCH, TIME_BATCH)}
    inputs = {b: torch.from_numpy(x).cuda() for b, x in images.items()}
    torch.cuda.synchronize()

    reset_launches()
    outs = {}
    for b in (1, CHECK_BATCH, TIME_BATCH):
        codes = model.encode_codes(inputs[b])
        outs[b] = (codes, model.decode_codes(codes))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    trips = len(outs)
    log(f"[main] launches over {trips} round trips: {launches}; per round "
        f"trip {({k: v / trips for k, v in launches.items()})}")
    for name, per_trip in ROUND_TRIP.items():
        check(launches[name] == trips * per_trip,
              f"{name}: {launches[name]} launches, expected "
              f"{trips * per_trip}")

    for b, (codes, rec) in outs.items():
        check(codes.shape == (b, TOKENS) and codes.dtype == torch.int32,
              f"codes of batch {b}: {codes.shape} {codes.dtype}")
        check(bool(((codes >= 0) & (codes < CODES)).all()),
              f"codes of batch {b} out of range")
        check(rec.shape == (b, 256, 256, 3) and rec.dtype == torch.bfloat16,
              f"reconstruction of batch {b}: {rec.shape} {rec.dtype}")
        check(bool(torch.isfinite(rec).all()), f"batch {b}: non-finite")
    log("[main] requests of batch 1, 8, 128: codes int32 in [0, 8192), "
        "reconstructions finite (B, 256, 256, 3) bf16")

    # the plain path on the card, same weights, one small batch
    codes_k, rec_k = outs[CHECK_BATCH]
    before = dict(LAUNCHES)
    with plain_versions():
        codes_p = model.encode_codes(inputs[CHECK_BATCH])
        rec_p = model.decode_codes(codes_k)
    check(LAUNCHES == before, "the plain path launched a kernel")
    match = float((codes_k == codes_p).float().mean()) * 100
    rec_err = float((rec_k.float() - rec_p.float()).abs().max())
    rec_scale = float(rec_p.float().abs().max())
    log(f"[main] bf16 kernels vs bf16 plain, batch {CHECK_BATCH}: code match "
        f"{match:.3f}% (threshold 95%), reconstruction from the same codes "
        f"max_abs_err {rec_err:.4e} (|plain| max {rec_scale:.3f}, "
        f"threshold 0.1)")
    check(match >= 95.0, "bf16 kernel codes disagree with the plain path")
    check(rec_err <= 0.1, "reconstructions disagree with the plain path")

    model32 = ViTVQ(dtype="float32", seed=0, device="cuda", **BASE)
    with plain_versions():
        codes_32 = model32.encode_codes(inputs[CHECK_BATCH])
    match32 = float((codes_k == codes_32).float().mean()) * 100
    log(f"[main] bf16 kernels vs f32 plain, batch {CHECK_BATCH}: code match "
        f"{match32:.3f}%")
    del model32

    torch.cuda.reset_peak_memory_stats()
    x = inputs[TIME_BATCH]
    for _ in range(2):
        model.decode_codes(model.encode_codes(x))
    torch.cuda.synchronize()
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        model.decode_codes(model.encode_codes(x))
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    peak = torch.cuda.max_memory_allocated()
    log(f"[main] round trip batch {TIME_BATCH}: {dt * 1e3:.2f} ms, "
        f"{TIME_BATCH / dt:.1f} images/s, peak memory {peak / 2**30:.2f} GiB")
    profile_round_trip(model, x)
    return launches


# kernel-name fragments -> the share of the round trip they belong to
KERNEL_GROUPS = (("ln_gemm", "ln_gemm"), ("attn_qkv", "attention"),
                 ("layernorm_kernel", "layernorm"), ("vq_nearest", "vq"),
                 ("gemm", "cuBLAS"), ("xmma", "cuBLAS"), ("cutlass", "cuBLAS"),
                 ("nvjet", "cuBLAS"))


def profile_round_trip(model, x) -> None:
    """Device time by kernel group over one round trip, torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.decode_codes(model.encode_codes(x))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict[str, float] = {}
    others = []
    for event in prof.key_averages():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = event.self_device_time_total / 1e3
        group = next((g for frag, g in KERNEL_GROUPS if frag in event.key),
                     "other")
        groups[group] = groups.get(group, 0.0) + ms
        if group == "other":
            others.append((ms, event.key[:60]))
    busy = sum(groups.values())
    if busy == 0:
        log("[profile] no device time in the trace: not measured")
        return
    shares = ", ".join(f"{g} {ms:.2f} ms ({ms / busy:.1%})" for g, ms in
                       sorted(groups.items(), key=lambda kv: -kv[1]))
    log(f"[profile] one round trip batch {TIME_BATCH}: device busy "
        f"{busy:.2f} ms of {wall_ms:.2f} ms wall under the profiler "
        f"(idle {1 - busy / wall_ms:.1%}); {shares}")
    log("[profile] largest 'other' kernels: " + "; ".join(
        f"{name} {ms:.2f} ms" for ms, name in sorted(others)[::-1][:4]))


def main() -> int:
    import enhancing_tpu_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = phase_device()
    phase_build()
    errs = phase_compare()
    times = phase_times()
    launches = phase_main_path()
    kernels = []
    for kname in REPLACES:
        rows = [r for label, r in times.items() if label.startswith(kname)]
        # ln_gemm has two main-path shapes; its row sums them (one qkv and
        # one fc1 launch per block), as do its bound and library times
        agg = {key: sum(r[key] for r in rows)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        kernels.append(dict(name=kname, route="cuda", source=SOURCES[kname],
                            replaces=REPLACES[kname],
                            launches=launches[kname],
                            max_abs_err=errs[kname], bound_by=rows[0]["bound_by"],
                            **agg))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
