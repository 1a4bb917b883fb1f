"""iNaturalist dataset (2017-2021 layouts) with download/verify/extract.

The port's copy of ``enhancing_tpu/data/inatural.py``: the URL and MD5
tables, and :func:`download_and_extract` (fetch, MD5 check, tar.gz
extraction), which also takes a local archive through ``source=`` (a
path or a URL overriding the table).

On-disk category layouts supported:
- 2017/2018: root/<super>/<subdir per class>/**.jpg (category = class dir)
- 2019:     root/<categ_id>/*.jpg
- 2021:     root/<"id super name">/...
"""
from __future__ import annotations

import hashlib
import tarfile
import urllib.request
from pathlib import Path

import numpy as np

from .base import Dataset
from .transforms import (IMG_EXTENSIONS, EvalTransform, TrainTransform,
                         load_image)

DATASET_URLS = {
    "2017": "https://ml-inat-competition-datasets.s3.amazonaws.com/2017/train_val_images.tar.gz",
    "2018": "https://ml-inat-competition-datasets.s3.amazonaws.com/2018/train_val2018.tar.gz",
    "2019": "https://ml-inat-competition-datasets.s3.amazonaws.com/2019/train_val2019.tar.gz",
    "2021_train": "https://ml-inat-competition-datasets.s3.amazonaws.com/2021/train.tar.gz",
    "2021_train_mini": "https://ml-inat-competition-datasets.s3.amazonaws.com/2021/train_mini.tar.gz",
    "2021_valid": "https://ml-inat-competition-datasets.s3.amazonaws.com/2021/val.tar.gz",
}
DATASET_MD5 = {
    "2017": "7c784ea5e424efaec655bd392f87301f",
    "2018": "b1c6952ce38f31868cc50ea72d066cc3",
    "2019": "c60a6e2962c9b8ccbd458d12c8582644",
    "2021_train": "e0526d53c7f7b2e3167b2b43bb2690ed",
    "2021_train_mini": "db6ed8330e634445efc8fec83ae81442",
    "2021_valid": "f6f6e0e242e3d4c9569ba56400938afc",
}

# kept as the old name too — scripts/configs may reference it
DOWNLOAD_URLS = DATASET_URLS


def _md5(path: Path, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def download_and_extract(root: str | Path, version: str,
                         source: str | Path | None = None,
                         md5: str | None = "table") -> Path:
    """Fetch (or copy) the versioned archive, verify MD5, extract into root.

    Args:
      root: destination directory (created if missing).
      version: key into DATASET_URLS/DATASET_MD5.
      source: override the URL table with a local path or any URL — this is
        how the pipeline is exercised without network egress.
      md5: expected digest; the default "table" looks up DATASET_MD5 (only
        meaningful when downloading the real archive), None skips the check.

    Returns root. Raises RuntimeError on digest mismatch.
    """
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    if source is None:
        if version not in DATASET_URLS:
            raise KeyError(f"unknown iNaturalist version {version!r}; "
                           f"known: {sorted(DATASET_URLS)}")
        source = DATASET_URLS[version]
    source = str(source)

    if md5 == "table":
        md5 = DATASET_MD5.get(version) if source == DATASET_URLS.get(version) \
            else None

    if "://" in source:
        archive = root / Path(source).name
        if not archive.exists():
            urllib.request.urlretrieve(source, archive)  # noqa: S310
    else:
        archive = Path(source)
        if not archive.exists():
            raise FileNotFoundError(archive)

    if md5 is not None:
        got = _md5(archive)
        if got != md5:
            raise RuntimeError(
                f"MD5 mismatch for {archive}: got {got}, expected {md5}")

    with tarfile.open(archive) as tf:
        tf.extractall(root, filter="data")
    return root


class INaturalistBase(Dataset):
    split = "train"
    train = True

    def __init__(self, root: str, version: str = "2021", resolution: int = 256,
                 download: bool = False,
                 source: str | None = None) -> None:
        self.root = Path(root)
        if download and not any(self.root.glob("*/")):
            download_and_extract(self.root, version, source=source)
        base = self.root / self.split if (self.root / self.split).is_dir() \
            else self.root
        cat_dirs = sorted(d for d in base.iterdir() if d.is_dir())
        self.categories = [d.name for d in cat_dirs]
        self.samples = []
        for ci, d in enumerate(cat_dirs):
            for p in sorted(d.glob("**/*")):
                if p.suffix.lower() in IMG_EXTENSIONS:
                    self.samples.append((str(p), ci))
        self.transform = (TrainTransform(resolution) if self.train
                          else EvalTransform(resolution))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int):
        path, cls = self.samples[idx]
        return {"image": self.transform(load_image(path)),
                "class": np.int32(cls)}


class INaturalistTrain(INaturalistBase):
    split, train = "train", True


class INaturalistValidation(INaturalistBase):
    split, train = "val", False
