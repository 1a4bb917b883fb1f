"""LSUN dataset (LMDB-backed), classes suffixed _train/_val.

The port's copy of ``enhancing_tpu/data/lsun.py``. It needs the ``lmdb``
package, imported when a dataset is built (neither the test machine nor
the card's has it); layout: root/<class>_<split>_lmdb databases with
webp-encoded values, decoded by Pillow.
"""
from __future__ import annotations

import io
from pathlib import Path
from typing import List, Optional, Union

import numpy as np

from .base import Dataset
from .transforms import EvalTransform, TrainTransform


class LSUNBase(Dataset):
    split = "train"
    train = True

    def __init__(self, root: str, classes: Union[str, List[str]] = "bedroom",
                 resolution: int = 256) -> None:
        try:
            import lmdb  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "LSUN requires the 'lmdb' package, which is not installed. "
                "Install lmdb or use another dataset.") from e
        import lmdb

        self.root = Path(root)
        if isinstance(classes, str):
            classes = [classes]
        self.classes = [f"{c}_{self.split}" for c in classes]

        self.dbs = []
        self.counts = []
        self.keys = []
        for c in self.classes:
            env = lmdb.open(str(self.root / f"{c}_lmdb"), max_readers=1,
                            readonly=True, lock=False, readahead=False,
                            meminit=False)
            with env.begin(write=False) as txn:
                count = txn.stat()["entries"]
                keys = [key for key in txn.cursor().iternext(values=False)]
            self.dbs.append(env)
            self.counts.append(count)
            self.keys.append(keys)
        self.transform = (TrainTransform(resolution) if self.train
                          else EvalTransform(resolution))

    def __len__(self) -> int:
        return sum(self.counts)

    def __getitem__(self, idx: int):
        from PIL import Image
        target = 0
        for count in self.counts:
            if idx < count:
                break
            idx -= count
            target += 1
        env = self.dbs[target]
        with env.begin(write=False) as txn:
            buf = txn.get(self.keys[target][idx])
        img = np.asarray(Image.open(io.BytesIO(buf)).convert("RGB"))
        return {"image": self.transform(img), "class": np.int32(target)}


class LSUNTrain(LSUNBase):
    split, train = "train", True


class LSUNValidation(LSUNBase):
    split, train = "val", False
