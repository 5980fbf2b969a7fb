"""Datasets used in the Flooder paper, for the PyTorch port.

The counterpart of ``flooder_tpu.datasets`` with the same lifecycle and
surface:

- ``BaseDataset``: ``root/raw`` + ``root/processed`` layout, constructor-
  driven ``_download → _process → _load``, integer + advanced indexing
  (slices incl. float fractions, int/bool arrays and tensors, sequences)
  returning shallow-copy subset views, ``shuffle(return_perm)``, per-item
  ``transform`` and load-time ``fixed_transform``.
- ``FlooderDataset``: Google-Drive archive download (gdown, optional
  dependency), SHA256 validation (warning on mismatch), ``.tar.zst``
  extraction, ``meta.yaml``/``splits.yaml`` processing, per-sample
  serialized files, ``_done`` sentinel.
- The six concrete datasets with the same pinned file ids, checksums and
  per-sample processing math.

An item's cloud ``x`` is a float32 CPU tensor: a dataset on disk is host
data, and a caller moves it to the card (``flood_complex`` does so). The
samples are stored as pickled dataclasses. This module is the port's only
user of ``yaml``; neither the package nor the CLI imports it.
"""

from __future__ import annotations

import copy
import hashlib
import os
import os.path as osp
import pickle
import tarfile
import warnings
from collections.abc import Sequence
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterator, List, Tuple, Union

import numpy as np
import torch
import yaml

try:
    from tqdm import tqdm
except Exception:  # pragma: no cover
    def tqdm(x, **kwargs):
        return x

from ..synthetic_data_generators import generate_swiss_cheese_points

IndexType = Union[slice, np.ndarray, torch.Tensor, Sequence]


@dataclass
class FlooderData:
    x: torch.Tensor
    y: Union[int, np.ndarray]
    name: str


@dataclass
class FlooderRocksData(FlooderData):
    surface: float
    volume: float


@dataclass
class LargePointCloudData:
    x: torch.Tensor
    name: str
    description: str

    def __str__(self) -> str:
        return self.name + "\n" + self.description


def _is_scalar_index(idx) -> bool:
    if isinstance(idx, (int, np.integer)):
        return True
    if isinstance(idx, np.ndarray) and idx.ndim == 0:
        return True
    return isinstance(idx, torch.Tensor) and idx.dim() == 0


class BaseDataset:
    """Base class with the download/process/load lifecycle and subset
    views."""

    @property
    def raw_file_names(self) -> List[str]:
        raise NotImplementedError

    @property
    def processed_file_names(self) -> List[str]:
        raise NotImplementedError

    def download(self) -> None:
        raise NotImplementedError

    def process(self) -> None:
        raise NotImplementedError

    def len(self) -> int:
        raise NotImplementedError

    def get(self, idx: int) -> FlooderData:
        raise NotImplementedError

    def _load(self) -> None:
        raise NotImplementedError

    def __init__(
        self,
        root: str,
        fixed_transform: Callable | None = None,
        transform: Callable | None = None,
    ) -> None:
        self.root = root
        self.fixed_transform = fixed_transform
        self.transform = transform
        self._indices = None

        self._download()
        self._process()
        self._load()

    def indices(self) -> Sequence:
        return range(self.len()) if self._indices is None else self._indices

    @property
    def raw_dir(self) -> str:
        return osp.join(self.root, "raw")

    @property
    def processed_dir(self) -> str:
        return osp.join(self.root, "processed")

    @property
    def raw_paths(self) -> List[str]:
        files = self.raw_file_names
        if callable(files):
            files = files()
        return [osp.join(self.raw_dir, f) for f in files]

    @property
    def processed_paths(self) -> List[str]:
        files = self.processed_file_names
        if callable(files):
            files = files()
        return [osp.join(self.processed_dir, f) for f in files]

    def _download(self):
        if all(osp.exists(f) for f in self.raw_paths):
            return
        os.makedirs(self.raw_dir, exist_ok=True)
        self.download()

    def _process(self):
        if all(osp.exists(f) for f in self.processed_paths):
            return
        os.makedirs(self.processed_dir, exist_ok=True)
        self.process()

    def __len__(self) -> int:
        return len(self.indices())

    def __getitem__(self, idx):
        if _is_scalar_index(idx):
            data = self.get(self.indices()[int(idx)])
            return data if self.transform is None else self.transform(data)
        return self.index_select(idx)

    def __iter__(self) -> Iterator:
        for i in range(len(self)):
            yield self[i]

    def index_select(self, idx: IndexType) -> "BaseDataset":
        """Subset view (shallow copy with ``_indices``); supports slices with
        float fractions, int/bool numpy arrays, torch tensors, sequences."""
        indices = self.indices()

        if isinstance(idx, slice):
            start, stop, step = idx.start, idx.stop, idx.step
            if isinstance(start, float):
                start = round(start * len(self))
            if isinstance(stop, float):
                stop = round(stop * len(self))
            indices = indices[slice(start, stop, step)]
        elif isinstance(idx, torch.Tensor):
            if idx.dtype == torch.long:
                return self.index_select(idx.flatten().tolist())
            if idx.dtype == torch.bool:
                return self.index_select(
                    idx.flatten().nonzero(as_tuple=False).flatten().tolist()
                )
            raise IndexError(
                f"Unsupported tensor index dtype '{idx.dtype}'"
            )
        elif isinstance(idx, np.ndarray) and idx.dtype == np.int64:
            return self.index_select(idx.flatten().tolist())
        elif isinstance(idx, np.ndarray) and idx.dtype == bool:
            return self.index_select(idx.flatten().nonzero()[0].tolist())
        elif isinstance(idx, Sequence) and not isinstance(idx, str):
            indices = [indices[i] for i in idx]
        else:
            raise IndexError(
                f"Only slices (':'), list, tuples, torch.tensor and "
                f"np.ndarray of dtype long or bool are valid indices (got "
                f"'{type(idx).__name__}')"
            )

        dataset = copy.copy(self)
        dataset._indices = indices
        return dataset

    def shuffle(
        self, return_perm: bool = False
    ) -> "BaseDataset | Tuple[BaseDataset, np.ndarray]":
        perm = np.random.permutation(len(self))
        dataset = self.index_select(perm.astype(np.int64))
        return (dataset, perm) if return_perm is True else dataset


class FlooderDataset(BaseDataset):
    """Archive-based datasets: gdown download + sha256 + .tar.zst extract +
    per-sample processing."""

    @property
    def file_id(self) -> str:
        raise NotImplementedError

    @property
    def checksum(self) -> str:
        raise NotImplementedError

    @property
    def folder_name(self) -> str:
        raise NotImplementedError

    @property
    def processed_file_names(self) -> List[str]:
        return ["_done", "splits.yaml"]

    def get(self, idx: int) -> FlooderData:
        return self.data[idx]

    def len(self) -> int:
        return len(self.data)

    def unzip_file(self) -> None:
        import zstandard as zstd

        with open(self.raw_paths[0], "rb") as f:
            dctx = zstd.ZstdDecompressor()
            with dctx.stream_reader(f) as reader:
                with tarfile.open(fileobj=reader, mode="r|") as tar:
                    # the "data" extraction filter only exists on
                    # Python >= 3.12 (backported to 3.11.4/3.10.12)
                    if hasattr(tarfile, "data_filter"):
                        tar.extractall(path=self.raw_dir, filter="data")
                    else:
                        tar.extractall(path=self.raw_dir)  # noqa: S202

    def process_file(self, file: Path, ydata: dict):
        raise NotImplementedError

    def get_split_indices(self, splits_data) -> dict:
        return splits_data["splits"]

    @staticmethod
    def _save_sample(obj, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)

    @staticmethod
    def _load_sample(path: str):
        with open(path, "rb") as f:
            return pickle.load(f)

    def process(self) -> None:
        extract_path = osp.join(self.raw_dir, self.folder_name)
        if not osp.isdir(extract_path):
            self.unzip_file()

        with open(osp.join(extract_path, "meta.yaml"), "r") as f:
            ydata = yaml.safe_load(f)
        with open(osp.join(extract_path, "splits.yaml"), "r") as f:
            splits_data = yaml.safe_load(f)

        split_indices = self.get_split_indices(splits_data)
        with open(osp.join(self.processed_dir, "splits.yaml"), "w") as f:
            yaml.safe_dump(split_indices, f)

        in_path = Path(extract_path)
        for file in tqdm(
            sorted(in_path.glob("*.npy")), desc=f"Processing {self.folder_name}"
        ):
            data = self.process_file(file, ydata)
            self._save_sample(
                data, osp.join(self.processed_dir, f"{file.stem}.sample.pkl")
            )
        Path(self.processed_dir, "_done").touch()

    def _load(self) -> None:
        self.data = []
        in_path = Path(self.processed_dir)
        for file in tqdm(
            sorted(in_path.glob("*.sample.pkl")),
            desc=f"Loading {self.folder_name}",
        ):
            data_i = self._load_sample(str(file))
            if self.fixed_transform is not None:
                data_i = self.fixed_transform(data_i)
            self.data.append(data_i)

        with open(osp.join(self.processed_dir, "splits.yaml"), "r") as f:
            self.splits = yaml.safe_load(f)
        self.classes = sorted({int(data.y) for data in self})
        self.num_classes = len(self.classes)

    def download(self) -> None:
        try:
            import gdown
        except ImportError as e:
            raise ImportError(
                f"Downloading {self.__class__.__name__} requires the optional "
                f"'gdown' dependency (pip install gdown), or place the archive "
                f"manually at {self.raw_paths[0]}"
            ) from e
        url = f"https://drive.google.com/uc?id={self.file_id}"
        output = os.path.join(self.raw_dir, self.raw_file_names[0])
        gdown.download(url, output, quiet=False)
        self.validate(output)

    def validate(self, file_path) -> None:
        h = hashlib.new("sha256")
        with open(file_path, "rb") as f:
            for chunk in iter(lambda: f.read(8192), b""):
                h.update(chunk)
        if h.hexdigest() != self.checksum:
            warnings.warn(
                f"Warning: the downloaded file {file_path} did not match the "
                f"expected checksum.\nExpected SHA256: {self.checksum}\n"
                f"Actual SHA256:   {h.hexdigest()}\n"
                f"Please try re-downloading the dataset.",
                UserWarning,
            )

    def __repr__(self) -> str:
        cls = self.__class__.__name__
        n_view = len(self.indices())
        is_subset = self._indices is not None
        size = f"n={n_view}"
        if is_subset and hasattr(self, "data"):
            size += f"/{len(self.data)}"
        parts = [size, f"root='{self.root}'"]
        if is_subset:
            parts.append("subset=yes")
        if hasattr(self, "num_classes"):
            parts.append(f"num_classes={self.num_classes}")
        if hasattr(self, "splits") and isinstance(self.splits, dict):
            parts.append(f"splits={list(self.splits.keys())}")
        if self.transform is not None:
            parts.append(f"transform={self.transform.__class__.__name__}")
        return f"{cls}({', '.join(parts)})"


class SwisscheeseDataset(FlooderDataset):
    """Procedurally generated swiss-cheese clouds; label = index of the void
    count k in ``ks``. The clouds are drawn unseeded (they differ from run
    to run); the splits come from ``RandomState(42)``."""

    def __init__(
        self,
        root: str,
        ks: List[int] = [10, 20],
        num_per_class: int = 500,
        num_points: int = 1_000_000,
        fixed_transform: Callable | None = None,
        transform: Callable | None = None,
    ):
        self.rng = np.random.RandomState(42)
        self.k, self.num_per_class, self.num_points = ks, num_per_class, num_points
        super().__init__(root, fixed_transform=fixed_transform, transform=transform)

    @property
    def folder_name(self) -> str:
        return "swisscheese"

    @property
    def raw_file_names(self) -> List[str]:
        return []

    def process(self) -> None:
        split_indices = {}
        n = len(self.k) * self.num_per_class
        for i in range(10):
            split = {}
            indices = self.rng.permutation(np.arange(n))
            split["trn"] = indices[: int(n * 0.72)].tolist()
            split["val"] = indices[int(n * 0.72) : int(n * 0.80)].tolist()
            split["tst"] = indices[int(n * 0.80) :].tolist()
            split_indices[i] = split
        with open(osp.join(self.processed_dir, "splits.yaml"), "w") as f:
            yaml.safe_dump(split_indices, f)

        rect_min = [0.0, 0.0, 0.0]
        rect_max = [5.0, 5.0, 5.0]
        for ki, k in enumerate(self.k):
            for r in tqdm(range(self.num_per_class)):
                pts, _, _ = generate_swiss_cheese_points(
                    self.num_points, rect_min, rect_max, k, (0.1, 0.5),
                    device="cpu",
                )
                data = FlooderData(x=pts, y=ki, name=f"{k}voids_{r}")
                file_id = hashlib.sha256(pts.numpy().tobytes()).hexdigest()[:10]
                self._save_sample(
                    data, osp.join(self.processed_dir, f"{file_id}.sample.pkl")
                )
        Path(self.processed_dir, "_done").touch()

    def download(self):
        pass


class ModelNet10Dataset(FlooderDataset):
    """4899 clouds × 250k pts from ModelNet10 meshes."""

    @property
    def file_id(self) -> str:
        return "180Gk0I_JYWkGNnLj5McI2P3zwhgGeVtM"

    @property
    def checksum(self) -> str:
        return "6f9504d5574224fdf5b9255d2b9d5f041540298c0241fc6abbbfedaf9e1f4280"

    @property
    def folder_name(self) -> str:
        return "modelnet10_250k"

    @property
    def raw_file_names(self) -> List[str]:
        return ["modelnet10_250k.tar.zst"]

    def process_file(self, file: Path, ydata: dict) -> FlooderData:
        x = torch.from_numpy((np.load(file) / 32767).astype(np.float32))
        y = ydata["data"][file.name]["label"]
        return FlooderData(x=x, y=y, name=file.stem)


class CoralDataset(FlooderDataset):
    """81 clouds × 1M pts, Smithsonian corals, 2 classes."""

    @property
    def file_id(self) -> str:
        return "1g-n8ExkU6eOJLelIMeNaFRdqoEM8ZDry"

    @property
    def checksum(self) -> str:
        return "e8b5ae6b22d03e0bcf118bb28b4d465f8ec5b308e038385879b98df3fed0150f"

    @property
    def folder_name(self) -> str:
        return "corals"

    @property
    def raw_file_names(self) -> List[str]:
        return ["corals.tar.zst"]

    def process_file(self, file: Path, ydata: dict) -> FlooderData:
        x = torch.from_numpy((np.load(file) / 32767).astype(np.float32))
        y = ydata["data"][file.name]["label"]
        return FlooderData(x=x, y=y, name=file.stem)


class MCBDataset(FlooderDataset):
    """1745 clouds × 1M pts, MCB mechanical components."""

    @property
    def file_id(self) -> str:
        return "19EP9DEOMoSj0YVa_pXnui3OR2JZHOgSY"

    @property
    def checksum(self) -> str:
        return "dc36e1c5886e2d21a9f1dbaec084852dda2aab06fb7cd1c36e4403ac3e486a10"

    @property
    def folder_name(self) -> str:
        return "mcb"

    @property
    def raw_file_names(self) -> List[str]:
        return ["mcb.tar.zst"]

    def process_file(self, file: Path, ydata: dict) -> FlooderData:
        x = torch.from_numpy((np.load(file) / 32767).astype(np.float32))
        y = ydata["data"][file.name]["label"]
        return FlooderData(x=x, y=y, name=file.stem)


class RocksDataset(FlooderDataset):
    """1000 PoreSpy voxel rocks → jittered occupied-voxel clouds with
    surface/volume regression targets."""

    @property
    def file_id(self) -> str:
        return "1htI0eeON3RG3V_fShd8U8tZmJ1g6akEx"

    @property
    def checksum(self) -> str:
        return "d635e6ae2e949075ae69b4397217bb2949c737126bbc23108fc48ec1a7aa5b00"

    def __init__(
        self,
        root: str,
        fixed_transform: Callable | None = None,
        transform: Callable | None = None,
    ):
        self.rng = np.random.RandomState(42)
        super().__init__(root, fixed_transform, transform)

    @property
    def folder_name(self) -> str:
        return "rocks"

    @property
    def raw_file_names(self) -> List[str]:
        return ["rocks.tar.zst"]

    def process_file(self, file: Path, ydata: dict) -> FlooderRocksData:
        loaded = np.load(file)
        bool_data = np.unpackbits(loaded).reshape((256, 256, 256)).astype(bool)
        pts = np.stack(np.where(bool_data), axis=1).astype(np.float32)
        pts += 0.1 * self.rng.rand(*pts.shape).astype(np.float32)
        return FlooderRocksData(
            x=torch.from_numpy(pts),
            y=ydata["data"][file.name]["label"],
            surface=ydata["data"][file.name]["target"],
            volume=ydata["data"][file.name]["volume"],
            name=file.stem,
        )


class LargePointCloudDataset(FlooderDataset):
    """Two >10M-point clouds (virus EMD-50844, coral USNM 53156), loaded
    lazily on ``get`` from the archive's torch ``.pt`` payloads."""

    def _load(self):
        pass

    def process(self) -> None:
        extract_path = os.path.join(self.raw_dir, self.folder_name)
        if not os.path.isdir(extract_path):
            self.unzip_file()

    # NOTE: deliberately NOT overridden to [] — ``all([])`` is True, so an
    # empty list would make ``_process`` skip unconditionally and the
    # archive would never be extracted (``get`` would then fail on
    # meta.yaml). Inheriting the sentinel names means ``_process`` always
    # runs and ``process``'s isdir guard makes it a no-op once extracted.

    @property
    def file_id(self) -> str:
        return "1WmX_JN1c-l1U27k1kOWf3z5cUPF8GR6x"

    @property
    def checksum(self) -> str:
        return "6de156a23ba837f034f29af1614c9f7d3aa0ea9026dab94b363f4d4942eb5cab"

    @property
    def folder_name(self) -> str:
        return "large"

    @property
    def raw_file_names(self) -> List[str]:
        return ["large.tar.zst"]

    @property
    def uncompressed_file_names(self) -> List[str]:
        return ["virus.pt", "coral.pt"]

    def len(self) -> int:
        return 2

    def get(self, idx: int) -> LargePointCloudData:
        with open(
            os.path.join(self.raw_dir, self.folder_name, "meta.yaml"), "r"
        ) as f:
            meta = yaml.safe_load(f)["data"][idx]
        x = torch.load(
            os.path.join(
                self.raw_dir, self.folder_name, self.uncompressed_file_names[idx]
            ),
            map_location="cpu",
            weights_only=False,
        )
        return LargePointCloudData(
            x=torch.as_tensor(x, dtype=torch.float32),
            name=meta["name"],
            description=meta["description"],
        )
