#!/usr/bin/env python3
"""Time LN -> GEMM (csrc/ln_gemm.cu, ``ln_gemm_kernel``), the fused FFN
(csrc/ffn.cu, ``ffn_kernel``) and the tokenizer round trips that run them,
for one checkout on one NVIDIA card.

    python3 ab_ln_gemm_ffn.py ROOT LABEL

ROOT is the root of a checkout (its ``enhancing_tpu_torch`` is imported
and its kernels built there). To compare two versions, unpack the other
one (``git archive <commit> enhancing_tpu_torch``) into a directory that
.gitignore lists and run this script for both in turns within one call on
one card: A, B, B, A. Prints, at ViT-VQGAN-Base's widths and batch 128
(M = 131072 tokens, d = 768), the ms per call of LN -> qkv (n = 2304, no
bias), LN -> fc1 + tanh (n = 3072) and the FFN (h = 3072, tanh) (CUDA
events), and the ms per ``encode_codes`` -> ``decode_codes`` round trip of
a ViT-VQGAN-Base with random bf16 weights, by default and with both fused
serving options (``ffn_impl: fused``, ENHANCING_TPU_ATTN_PROJ=1; host
clock around a synchronised loop); with a checksum of each kernel's
output.
"""
import os
import sys
import time

TOWER = {"dim": 768, "depth": 12, "heads": 12, "mlp_dim": 3072}
BASE = {"image_size": 256, "patch_size": 8, "encoder": TOWER,
        "decoder": TOWER, "quantizer": {"embed_dim": 32, "n_embed": 8192}}


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


def main() -> int:
    root, label = sys.argv[1], sys.argv[2]
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from enhancing_tpu_torch.models.stage1.vitvqgan import ViTVQ
    from enhancing_tpu_torch.ops import ffn
    from enhancing_tpu_torch.ops import ln_gemm as lg
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    m, d, h = 128 * 1024, 768, 3072
    x = rand(m, d)
    gamma, beta = 1.0 + 0.1 * rand(d, dtype=torch.float32), \
        0.1 * rand(d, dtype=torch.float32)
    w_qkv, w_fc1 = rand(3 * d, d, scale=0.03), rand(h, d, scale=0.03)
    b_fc1 = 0.02 * rand(h, dtype=torch.float32)
    w2, b2 = rand(d, h, scale=0.03), 0.02 * rand(d, dtype=torch.float32)
    out = []
    for name, fn in (
            ("qkv", lambda: lg.ln_gemm_kernel(x, gamma, beta, w_qkv)),
            ("fc1", lambda: lg.ln_gemm_kernel(x, gamma, beta, w_fc1, b_fc1,
                                              "tanh")),
            ("ffn", lambda: ffn.ffn_kernel(x, w_fc1, b_fc1, w2, b2,
                                           "tanh"))):
        ms = time_ms(fn, 10)
        out.append(f"{name} {ms:.4f} (checksum "
                   f"{float(fn().float().sum()):.4f})")
    del x, w_qkv, w_fc1, w2

    images = torch.from_numpy(np.random.default_rng(0).random(
        (128, 256, 256, 3), dtype=np.float32)).cuda()
    model = ViTVQ(dtype="bfloat16", seed=0, device="cuda", **BASE)
    out.append(f"trip {trip_ms(model, images):.2f}")
    del model
    fused = dict(BASE, encoder=dict(TOWER, ffn_impl="fused"),
                 decoder=dict(TOWER, ffn_impl="fused"))
    os.environ["ENHANCING_TPU_ATTN_PROJ"] = "1"
    model = ViTVQ(dtype="bfloat16", seed=0, device="cuda", **fused)
    out.append(f"fused trip {trip_ms(model, images):.2f}")
    del os.environ["ENHANCING_TPU_ATTN_PROJ"]
    print(f"[ab] {label}: " + "; ".join(out) + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
