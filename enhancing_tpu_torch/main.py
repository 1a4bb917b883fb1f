"""The port's command-line trainer.

    python -m enhancing_tpu_torch.main -c <config> [-s seed] [-u accum]
        [-e epochs] [-lr lr] [-a] [-b freq] [-m max_images]
        [--max_steps N] [--log_every N] [--split_gan_step] [--reuse_xrec]
        [--resume] [--run_dir DIR] [--device cuda|cpu]

Counterpart of the JAX package's ``main.py``, with its flags and defaults:
it reads ``configs/<config>.yaml`` (relative to the working directory,
through the port's own YAML reader), builds the model on ``--device``
(default ``cuda``; without a card it raises unless given ``--device
cpu``), and trains it with ``train.Trainer`` into a run directory:
``experiments/<config>/<timestamp>`` by default, ``--run_dir``, or with
``--resume`` and no ``--run_dir`` the newest run of the config by mtime.
The run directory gets ``config.yaml``, ``metrics.jsonl`` (always), image
grids under ``log/results/`` and a checkpoint an epoch under ``ckpt/``;
``--resume`` goes on from the newest checkpoint. ``-a`` sets bf16 on the
model and on its StyleGAN discriminator, as the JAX CLI does.

Flags for several cards or hosts (``-mp``, ``-pp``, ``--microbatches``,
``--zero1``, ``--sp``, ``-nn`` / ``-ng`` above 1, ``--coordinator``,
``--process_id``) are ROADMAP A9 and raise. ``--compile_cache`` names
XLA's persistent cache, which the port has nothing to point at: its
kernels build once into ``build/kernels-<digest>`` (``ops/cuda_lib.py``),
so it raises too.

:func:`main` takes the argument list and returns the ``Trainer``, so tests
and scripts call it in-process.
"""
from __future__ import annotations

import argparse
from datetime import datetime
from pathlib import Path
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m enhancing_tpu_torch.main")
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("-s", "--seed", type=int, default=0)
    parser.add_argument("-nn", "--num_nodes", type=int, default=1)
    parser.add_argument("-ng", "--num_chips", "--num_gpus", type=int,
                        default=0, help="0 = the one visible card")
    parser.add_argument("-u", "--update_every", type=int, default=1)
    parser.add_argument("-e", "--epochs", type=int, default=100)
    parser.add_argument("-lr", "--base_lr", type=float, default=4.5e-6)
    parser.add_argument("-a", "--use_amp", default=False, action="store_true",
                        help="bf16 model and discriminator")
    parser.add_argument("-b", "--batch_frequency", type=int, default=750)
    parser.add_argument("-m", "--max_images", type=int, default=4)
    parser.add_argument("-mp", "--model_parallel", type=int, default=1)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--log_every", type=int, default=50,
                        help="scalar-metric cadence (console + "
                             "metrics.jsonl + wandb), in steps")
    parser.add_argument("--split_gan_step", action="store_true",
                        help="refuse the adaptive adversarial weight, as "
                             "the JAX split step does")
    parser.add_argument("--reuse_xrec", action="store_true",
                        help="D trains on the AE phase's reconstruction "
                             "instead of re-running the generator forward "
                             "(D's fake is one SGD step stale; implies "
                             "--split_gan_step)")
    parser.add_argument("--zero1", action="store_true")
    parser.add_argument("-pp", "--pipeline_parallel", type=int, default=1)
    parser.add_argument("--microbatches", type=int, default=8)
    parser.add_argument("--resume", action="store_true",
                        help="go on from the newest checkpoint in the run "
                             "directory; without --run_dir, the newest "
                             "existing run of this config")
    parser.add_argument("--run_dir", type=str, default=None,
                        help="explicit experiment directory (default: a new "
                             "timestamped one under experiments/<config>)")
    parser.add_argument("--sp", action="store_true")
    parser.add_argument("--compile_cache", type=str, default=None)
    parser.add_argument("--coordinator", type=str, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu (the plain versions)")
    return parser


def refuse_unported(args: argparse.Namespace) -> None:
    """Raise on the flags the port cannot honour."""
    if args.compile_cache is not None:
        raise NotImplementedError(
            "--compile_cache names XLA's persistent compilation cache; the "
            "port compiles no XLA programs: its CUDA kernels build once per "
            "source digest into build/kernels-<digest> "
            "(enhancing_tpu_torch/ops/cuda_lib.py), which later runs reuse")
    asked = [flag for flag, on in (
        ("-mp", args.model_parallel != 1),
        ("-pp", args.pipeline_parallel != 1),
        ("--zero1", args.zero1), ("--sp", args.sp),
        ("-nn", args.num_nodes > 1), ("-ng", args.num_chips > 1),
        ("--coordinator", args.coordinator is not None),
        ("--process_id", args.process_id is not None)) if on]
    if asked:
        raise NotImplementedError(
            f"{asked}: training on several cards or hosts is ROADMAP A9; "
            f"the port trains on one card")


def run_dir(args: argparse.Namespace, now: str) -> Path:
    if args.run_dir is not None:
        return Path(args.run_dir)
    if args.resume:
        # newest by mtime: the day-first %d%m%Y_%H%M%S names do not sort
        # chronologically across months
        runs = sorted((Path("experiments") / args.config).glob("*"),
                      key=lambda p: p.stat().st_mtime)
        if runs:
            return runs[-1]
    return Path("experiments") / args.config / now


def main(argv: Optional[List[str]] = None):
    args = build_parser().parse_args(argv)
    refuse_unported(args)

    from .ops.common import resolve_device
    from .train import Trainer
    from .utils.callback import ImageLogger, SetupCallback
    from .utils.config import get_config_from_file, initialize_from_config
    from .utils.general import set_seed
    from .utils.logging import JsonlLogger, MultiLogger, WandbLogger

    device = resolve_device(args.device)
    set_seed(args.seed)
    config = get_config_from_file(Path("configs") / f"{args.config}.yaml")
    exp_config = {"name": args.config, "epochs": args.epochs,
                  "update_every": args.update_every, "base_lr": args.base_lr,
                  "use_amp": args.use_amp,
                  "batch_frequency": args.batch_frequency,
                  "max_images": args.max_images}

    # -a: bf16 compute in the model and, as the reference's AMP does, in
    # the StyleGAN discriminator
    if args.use_amp and "params" in config.model:
        config.model["params"]["dtype"] = "bfloat16"
        loss_cfg = config.model["params"].get("loss")
        if loss_cfg and "Discriminator" in str(loss_cfg.get("target", "")):
            dp = loss_cfg.setdefault("params", {}).setdefault(
                "disc_params", {})
            dp.setdefault("dtype", "bfloat16")

    model = initialize_from_config(config.model, device=device)

    now = datetime.now().strftime("%d%m%Y_%H%M%S")
    basedir = run_dir(args, now)
    setup_cb = SetupCallback(config.to_dict(), exp_config, basedir)
    wandb_logger = WandbLogger(str(basedir), f"{args.config}_{now}",
                               enabled=True)
    metrics_logger = MultiLogger(JsonlLogger(str(basedir)), wandb_logger)
    image_cb = ImageLogger(args.batch_frequency, args.max_images,
                           logdir=basedir / "log", wandb_logger=wandb_logger)

    data = initialize_from_config(config.dataset)
    data.prepare_data()

    trainer = Trainer(max_epochs=args.epochs, base_lr=args.base_lr,
                      use_amp=args.use_amp,
                      accumulate_grad_batches=args.update_every,
                      basedir=str(basedir), seed=args.seed,
                      callbacks=[setup_cb, image_cb],
                      max_steps=args.max_steps, log_every=args.log_every,
                      split_gan_step=args.split_gan_step,
                      reuse_xrec=args.reuse_xrec,
                      metrics_logger=metrics_logger, resume=args.resume)
    trainer.fit(model, data)
    return trainer


if __name__ == "__main__":
    main()
