#!/usr/bin/env python3
"""Time the KV-cache row write (B10, ``csrc/cache_row_update.cu``) of one
checkout on one NVIDIA card.

    python3 ab_cache_row_update.py ROOT LABEL [--sass] [--bulk]

ROOT is the root of a checkout (its ``enhancing_tpu_torch`` is imported
and its kernels built there). To compare two versions, unpack the other
one (``git archive <commit> enhancing_tpu_torch``) into a directory that
.gitignore lists and run this script for both in turns within one call on
one card: A, B, B, A.

On the stacks the samplers write, (L, B, ctx, C) = (24, 8, 1032, C) at
batch 8: the GPT prior's bf16 C = 6144 (``configs/
imagenet_gpt_vitvq_base.yaml``), the RQ prior's bf16 C = 1536
(``configs/imagenet_rqtransformer_base.yaml``) and the int8 cache of the
GPT prior's ``kv_int8`` (6144 one-byte lanes), each with a scalar cur
(512) and a ragged (B,) int32 cur, it prints per call:

- ``graph``: device ms, a CUDA graph of 100 calls replayed 20 times
  between CUDA events, divided by the calls (launch gaps inside a graph
  included, no host work; ``chip_smoke.graph_ms`` of the checkout this
  script sits in);
- ``events``: ms of back-to-back eager calls between CUDA events (the
  host's enqueue time where that is longer than the device's);
- ``bound``: each row read once and written once over 3.35 TB/s;
- a check that the kernel, on a copy of the stack as it was before any
  write, writes exactly what ``cache_row_update_plain`` writes;

then the host's microseconds per call of the entry point
``ops.cache.cache_row_update``, of ``cache_row_update_kernel``, of
``check_kernel_args`` alone, of ``cuda_lib.stream()`` and of the C entry
called through ctypes with its arguments ready (each the median of 5
loops of 500 calls, the host clock up to the last enqueue).

``--bulk`` (a checkout that has ``csrc/cache_row_update_bulk.cu``) also
times the 1-D bulk-copy design there, ``etk_cache_row_update_bulk``, at
each (chunk bytes, ring stages, blocks an SM) of ``BULK_VARIANTS`` on the
same inputs, in turns with the shipped kernel, each checked the same way.
``--sass`` prints the instructions of the kernels' SASS (``cuobjdump``)
and, with ``--bulk``, fails unless the bulk kernel holds bulk copies
(``UBLKCP``) in both directions.
"""
import re
import statistics
import subprocess
import sys
import time

PEAK_BYTES = 3.35e12
STACKS = (("GPT bf16", 6144, "bfloat16"), ("RQ bf16", 1536, "bfloat16"),
          ("GPT int8", 6144, "int8"))
LAYERS, BATCH, CTX_PAD = 24, 8, 1032
CUR = 512
RAGGED = (1, 100, 255, 256, 511, 513, 900, 1024)
# (chunk bytes, ring stages, blocks an SM; 0: a block a piece): the
# design's first setting first (8 KB pieces, 4 stages, one block an SM)
BULK_VARIANTS = ((8192, 4, 1), (8192, 4, 2), (8192, 4, 0), (4096, 4, 1),
                 (2048, 8, 1), (2048, 4, 0))


def load_chip_smoke():
    """The ``chip_smoke`` module beside this script (one timing method for
    this script and the smoke test's phase 4)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def events_ms(fn, iters=200, loops=5):
    import torch
    for _ in range(3):
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


def host_us(fn, calls=500, loops=5):
    import torch
    for _ in range(10):
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


def sass_ops(lib_path, kernel):
    """The opcodes of the SASS of the kernel whose name holds ``kernel``,
    with their counts."""
    from pathlib import Path

    from torch.utils.cpp_extension import CUDA_HOME
    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    ops = {}
    for block in sass.split("Function : ")[1:]:
        if kernel not in block.split("\n", 1)[0]:
            continue
        for line in block.splitlines():
            # an instruction: /*<hex address>*/ <opcode> ...
            if not re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
                continue
            text = line.split("*/", 1)[1].strip()
            if not text or text.startswith("/*"):
                continue
            op = text.split()[0]
            if op.startswith("@"):
                op = text.split()[1]
            ops[op] = ops.get(op, 0) + 1
    return ops


def main() -> int:
    root, label = sys.argv[1], sys.argv[2]
    sys.path.insert(0, root)
    import torch

    from enhancing_tpu_torch.ops import cache, cuda_lib
    from enhancing_tpu_torch.ops.common import check_kernel_args
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    graph_ms = load_chip_smoke().graph_ms
    bulk = "--bulk" in sys.argv[3:]

    def bulk_write(t, news, cur, variant):
        l, b, ctx, c = t.shape
        scalar = isinstance(cur, int)
        cuda_lib.call("etk_cache_row_update_bulk", t.data_ptr(),
                      news.data_ptr(), None if scalar else cur.data_ptr(),
                      cur if scalar else 0, l, b, ctx, c * t.element_size(),
                      *variant, cuda_lib.stream())
        return t

    gen = torch.Generator(device="cuda").manual_seed(0)
    out, differs = [], []
    ragged = torch.tensor(RAGGED, dtype=torch.int32, device="cuda")
    for name, c, dtype in STACKS:
        shape = (LAYERS, BATCH, CTX_PAD, c)
        if dtype == "int8":
            stack = torch.randint(-127, 128, shape, generator=gen,
                                  device="cuda", dtype=torch.int8)
            news = torch.randint(-127, 128, (LAYERS, BATCH, 1, c),
                                 generator=gen, device="cuda",
                                 dtype=torch.int8)
        else:
            stack = torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16)
            news = torch.randn((LAYERS, BATCH, 1, c), generator=gen,
                               device="cuda").to(torch.bfloat16)
        nbytes = 2 * news.numel() * news.element_size()
        bound = nbytes / PEAK_BYTES * 1e3
        base, stack = stack, stack.clone()  # base: as before any write
        for cur, cur_name in ((CUR, "scalar"), (ragged, "ragged")):
            want = cache.cache_row_update_plain(base.clone(), news, cur)
            arms = [("kernel", lambda t, cur=cur:
                     cache.cache_row_update_kernel(t, news, cur))]
            if bulk:
                arms += [(f"bulk {v[0]} B x {v[1]} stages, "
                          f"{v[2] or 'a piece a'} block(s) an SM",
                          lambda t, cur=cur, v=v: bulk_write(t, news, cur, v))
                         for v in BULK_VARIANTS]
                arms.append(arms[0])  # the shipped kernel again, last
            for arm, write in arms:
                got = write(base.clone())
                torch.cuda.synchronize()
                exact = torch.equal(got, want)
                differs.extend([] if exact else [f"{name} {cur_name} {arm}"])
                del got
                fn = lambda write=write: write(stack)  # noqa: E731
                g, e = graph_ms(fn), events_ms(fn)
                out.append(f"{name} {tuple(shape)} cur {cur_name}, {arm}: "
                           f"graph {g:.5f} ms, events {e:.5f} ms, bound "
                           f"{bound:.5f} ms ({g / bound:.1f}x), "
                           f"{'exact' if exact else 'DIFFERS'}")
            del want
        if name == "GPT bf16":
            handle = cuda_lib.lib().etk_cache_row_update
            s = cuda_lib.stream()
            args = (stack.data_ptr(), news.data_ptr(), None, CUR, LAYERS,
                    BATCH, CTX_PAD, c * 2, s)
            host = {
                "cache_row_update": lambda: cache.cache_row_update(
                    stack, news, CUR),
                "cache_row_update_kernel": lambda: (
                    cache.cache_row_update_kernel(stack, news, CUR)),
                "check_kernel_args": lambda: check_kernel_args(
                    "cache_row_update", stack, news, None),
                "cuda_lib.stream": cuda_lib.stream,
                "C entry": lambda: handle(*args),
            }
            out.append("host us a call: " + ", ".join(
                f"{k} {host_us(fn):.2f}" for k, fn in host.items()))
        del base, stack, news
        torch.cuda.empty_cache()
    # the floor of a launch in a graph: one 16-byte fill a call
    tiny = torch.zeros(4, device="cuda")
    out.append(f"a one-kernel call (a 16-byte fill) in the same graph: "
               f"{graph_ms(lambda: tiny.fill_(1.0)):.5f} ms")
    dev = torch.cuda.current_device()
    raw = torch._C._cuda_getCurrentRawStream
    out.append("host us a call: " + ", ".join(
        f"{k} {host_us(fn):.2f}" for k, fn in (
            ("torch.cuda.current_device", torch.cuda.current_device),
            ("torch._C._cuda_getCurrentRawStream", lambda: raw(dev)),
            ("tensor.device.index", lambda: tiny.device.index))))
    for line in out:
        print(f"[ab] {label}: {line}", flush=True)
    if "--sass" in sys.argv[3:]:
        for kernel in ("row_write_kernel",) + (
                ("row_write_bulk_kernel",) if bulk else ()):
            ops = sass_ops(cuda_lib.build_info["path"], kernel)
            print(f"[ab] {label}: SASS of {kernel}: {ops}", flush=True)
        if bulk and len([op for op in ops if op.startswith("UBLKCP")]) < 2:
            raise SystemExit("the bulk kernel's SASS lacks a bulk copy "
                             "in one direction")
    if differs:
        raise SystemExit(f"not what the plain version writes: {differs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
