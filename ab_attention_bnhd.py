#!/usr/bin/env python3
"""Time the strided attention forward (csrc/attention_bnhd.cu, through
``attention_bnhd_kernel``) of one checkout on one NVIDIA card.

    python3 ab_attention_bnhd.py ROOT LABEL

ROOT is the root of a checkout (its ``enhancing_tpu_torch`` is imported
and its kernels built there). To compare two versions, unpack the other
one (``git archive <commit> enhancing_tpu_torch``) into a directory that
.gitignore lists and run this script for both in turns within one call on
one card: A, B, B, A. Prints the ms per call at the GPT prior's shapes
(batch 8, 16 heads of 384, N = 1025 prefix-causal and N = 1) and on the
lane slices of ViT-Base's qkv buffer at batch 128 (CUDA events), and a
checksum of the last output.
"""
import sys


def time_ms(fn, iters, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main() -> int:
    root, label = sys.argv[1], sys.argv[2]
    sys.path.insert(0, root)
    import torch

    from enhancing_tpu_torch.ops import attention as att
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen,
                           device="cuda").to(torch.bfloat16)

    out = []
    for n in (1025, 1):
        q, k, v = (rand(8, n, 16, 384) for _ in range(3))
        ms = time_ms(lambda: att.attention_bnhd_kernel(
            q, k, v, 384 ** -0.5, "prefix_causal", 1), 20 if n > 1 else 200)
        out.append(f"N={n} D=384 {ms:.4f}")
    qkv = rand(128, 1024, 3 * 768)
    qs, ks, vs = (t.view(128, 1024, 12, 64) for t in qkv.split(768, dim=-1))
    ms = time_ms(lambda: att.attention_bnhd_kernel(qs, ks, vs, 0.125), 10)
    out.append(f"ViT lane slices B=128 {ms:.4f}")
    ref = att.attention_bnhd_kernel(qs, ks, vs, 0.125)
    print(f"[b8] {label}: " + "; ".join(out)
          + f"; checksum {float(ref.float().sum()):.6f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
