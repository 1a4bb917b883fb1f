"""Per-epoch training checkpoints: one directory an epoch, written by
rename, read with ``torch.load(weights_only=True)``.

The JAX Trainer keeps its checkpoints through orbax: ``basedir/ckpt/<step>``
for every saved step (here, every saved epoch), all kept, and a step
directory appears under its final name only once its files are written.
:class:`CheckpointDir` does the same with ``torch.save``: the payload is
written into ``<epoch>.tmp`` and the directory is renamed to ``<epoch>``,
so a save cut off by preemption leaves a ``.tmp`` directory that
:meth:`CheckpointDir.latest_step` never reads.

A payload holds only tensors and plain containers (no pickled port
objects), so ``weights_only=True`` reads it.
:func:`multisteps_state` / :func:`load_multisteps` carry an
``optim.MultiSteps``: its AdamW state, its LR schedule (a ``LambdaLR``
whose multiplier function the Trainer rebuilds from the config), and the
accumulation's ``mini_step`` and running mean ``acc``, since a save may
fall between two updates.
"""
from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from .optim import MultiSteps

STATE_FILE = "state.pt"


def multisteps_state(ms: MultiSteps) -> Dict[str, Any]:
    sched = {k: v for k, v in ms.sched.state_dict().items()
             if k != "lr_lambdas"}
    return {"opt": ms.opt.state_dict(), "sched": sched,
            "mini_step": ms.mini_step,
            "acc": None if ms.acc is None else list(ms.acc)}


def load_multisteps(ms: MultiSteps, state: Dict[str, Any]) -> None:
    ms.opt.load_state_dict(state["opt"])
    sched = dict(state["sched"], lr_lambdas=[None] * len(ms.sched.lr_lambdas))
    ms.sched.load_state_dict(sched)
    ms.mini_step = state["mini_step"]
    params = [p for g in ms.opt.param_groups for p in g["params"]]
    ms.acc = (None if state["acc"] is None else
              [a.to(p.device) for a, p in zip(state["acc"], params)])


class CheckpointDir:
    """``root/<epoch>/state.pt``, every epoch kept."""

    def __init__(self, root: str | Path) -> None:
        self.root = Path(root)

    def path(self, step: int) -> Path:
        return self.root / str(step) / STATE_FILE

    def all_steps(self) -> List[int]:
        if not self.root.is_dir():
            return []
        return sorted(int(p.name) for p in self.root.iterdir()
                      if p.name.isdigit() and (p / STATE_FILE).is_file())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, payload: Dict[str, Any]) -> Path:
        """Write ``payload`` as step ``step``; an earlier save of that step
        is replaced."""
        self.root.mkdir(parents=True, exist_ok=True)
        tmp = self.root / f"{step}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(payload, tmp / STATE_FILE)
        final = self.root / str(step)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        return final / STATE_FILE

    def load(self, step: Optional[int] = None,
             map_location: str | torch.device = "cpu") -> Dict[str, Any]:
        """The payload of ``step`` (default: the newest)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        return torch.load(self.path(step), map_location=map_location,
                          weights_only=True)
