"""``flooder_tpu_torch.datasets`` on the CPU.

The cases of tests/test_datasets.py for the port (lifecycle, indexing
semantics, subset views, the offline archive paths), and parity with
``flooder_tpu.datasets``: the same offline ``.tar.zst`` archives processed
by both packages give equal clouds (tensor against array), labels, names
and splits; ``SwisscheeseDataset`` gives equal splits, shapes, labels and
names (its clouds are drawn unseeded in both packages). Nothing is
downloaded.
"""

import io
import shutil
import tarfile

import numpy as np
import pytest
import torch
import yaml

import flooder_tpu.datasets as jax_ds
from flooder_tpu_torch.datasets import (
    CoralDataset,
    FlooderData,
    LargePointCloudDataset,
    MCBDataset,
    ModelNet10Dataset,
    RocksDataset,
    SwisscheeseDataset,
)

CHEESE = dict(ks=[2, 4], num_per_class=4, num_points=500)


def _write_zst_archive(path, folder, entries):
    """entries: {name: payload bytes} written under folder/ in a .tar.zst."""
    zstd = pytest.importorskip("zstandard")
    tar_buf = io.BytesIO()
    with tarfile.open(fileobj=tar_buf, mode="w") as tar:
        for name, payload in entries.items():
            info = tarfile.TarInfo(f"{folder}/{name}")
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(zstd.ZstdCompressor().compress(tar_buf.getvalue()))


def _npy_bytes(arr):
    b = io.BytesIO()
    np.save(b, arr)
    return b.getvalue()


def modelnet_archive(root):
    """ModelNet10's archive with two int16-range clouds; returns
    (files, splits)."""
    rng = np.random.default_rng(0)
    files = {
        "chair_0001.npy": rng.integers(-32767, 32767, size=(50, 3),
                                       dtype=np.int64),
        "desk_0002.npy": rng.integers(-32767, 32767, size=(40, 3),
                                      dtype=np.int64),
    }
    meta = {"data": {"chair_0001.npy": {"label": 0},
                     "desk_0002.npy": {"label": 1}}}
    splits = {"splits": {"0": {"trn": [0], "tst": [1]}}}
    entries = {"meta.yaml": yaml.safe_dump(meta).encode(),
               "splits.yaml": yaml.safe_dump(splits).encode()}
    entries.update({k: _npy_bytes(v) for k, v in files.items()})
    _write_zst_archive(root / "raw" / "modelnet10_250k.tar.zst",
                       "modelnet10_250k", entries)
    return files, splits


OCCUPIED = [(0, 0, 0), (10, 20, 30), (255, 255, 255), (100, 3, 7)]


def rocks_archive(root):
    vol = np.zeros((256, 256, 256), dtype=bool)
    for v in OCCUPIED:
        vol[v] = True
    meta = {"data": {"rock_000.npy": {"label": 1, "target": 2.5,
                                      "volume": 0.125}}}
    splits = {"splits": {"0": {"trn": [0]}}}
    _write_zst_archive(root / "raw" / "rocks.tar.zst", "rocks", {
        "meta.yaml": yaml.safe_dump(meta).encode(),
        "splits.yaml": yaml.safe_dump(splits).encode(),
        "rock_000.npy": _npy_bytes(np.packbits(vol)),
    })


def large_archive(root):
    """LargePointCloudDataset's archive of two torch payloads; returns the
    clouds."""
    rng = np.random.default_rng(0)
    clouds = [rng.random((30, 3)).astype(np.float32),
              rng.random((20, 3)).astype(np.float32)]
    meta = {"data": [{"name": "virus", "description": "EMD-50844"},
                     {"name": "coral", "description": "USNM 53156"}]}
    payloads = {}
    for fname, arr in zip(["virus.pt", "coral.pt"], clouds):
        b = io.BytesIO()
        torch.save(torch.from_numpy(arr), b)
        payloads[fname] = b.getvalue()
    payloads["meta.yaml"] = yaml.safe_dump(meta).encode()
    _write_zst_archive(root / "raw" / "large.tar.zst", "large", payloads)
    return clouds


@pytest.fixture(scope="module")
def cheese_ds(tmp_path_factory):
    root = tmp_path_factory.mktemp("swisscheese")
    return SwisscheeseDataset(str(root), **CHEESE)


def test_lifecycle_and_load(cheese_ds):
    ds = cheese_ds
    assert len(ds) == 8
    assert ds.num_classes == 2
    assert ds.classes == [0, 1]
    assert set(ds.splits.keys()) == set(range(10))
    item = ds[0]
    assert isinstance(item, FlooderData)
    assert isinstance(item.x, torch.Tensor)
    assert item.x.shape == (500, 3)
    assert item.x.dtype == torch.float32 and item.x.device.type == "cpu"
    # splits partition the dataset 72/8/20
    s = ds.splits[0]
    all_idx = sorted(s["trn"] + s["val"] + s["tst"])
    assert all_idx == list(range(8))


def test_reload_from_processed(cheese_ds):
    # second construction must reuse processed artifacts (sentinel logic)
    ds2 = SwisscheeseDataset(cheese_ds.root, **CHEESE)
    assert len(ds2) == 8
    assert [d.name for d in ds2] == [d.name for d in cheese_ds]
    assert torch.equal(ds2[3].x, cheese_ds[3].x)


def test_indexing_views(cheese_ds):
    ds = cheese_ds
    sub = ds[2:6]
    assert len(sub) == 4
    assert sub[0].name == ds[2].name
    # float-fraction slicing
    frac = ds[:0.5]
    assert len(frac) == 4
    # integer-array and bool-array indexing
    ia = ds[np.asarray([0, 3, 5], dtype=np.int64)]
    assert len(ia) == 3 and ia[1].name == ds[3].name
    mask = np.zeros(8, dtype=bool)
    mask[[1, 7]] = True
    bm = ds[mask]
    assert len(bm) == 2 and bm[1].name == ds[7].name
    # nested views compose
    nested = ds[2:8][::2]
    assert len(nested) == 3 and nested[1].name == ds[4].name
    # sequences
    seq = ds[[7, 0]]
    assert seq[0].name == ds[7].name
    # scalar indices of other types
    assert ds[np.int64(3)].name == ds[torch.tensor(3)].name == ds[3].name
    with pytest.raises(IndexError):
        ds["bad"]
    with pytest.raises(IndexError):
        ds[torch.tensor([0.5, 1.5])]


def test_torch_tensor_indexing(cheese_ds):
    ds = cheese_ds
    sub = ds[torch.tensor([1, 2], dtype=torch.long)]
    assert len(sub) == 2
    mask = torch.zeros(8, dtype=torch.bool)
    mask[5] = True
    assert len(ds[mask]) == 1


def test_shuffle(cheese_ds):
    np.random.seed(0)
    shuffled, perm = cheese_ds.shuffle(return_perm=True)
    assert sorted(perm.tolist()) == list(range(8))
    assert shuffled[0].name == cheese_ds[int(perm[0])].name


def test_transforms(cheese_ds):
    def double(d):
        return FlooderData(x=d.x * 2, y=d.y, name=d.name)

    ds = SwisscheeseDataset(cheese_ds.root, **CHEESE, transform=double)
    assert torch.allclose(ds[0].x, cheese_ds[0].x * 2)


def test_repr(cheese_ds):
    r = repr(cheese_ds)
    assert "SwisscheeseDataset" in r and "n=8" in r
    assert "subset=yes" in repr(cheese_ds[:4])


def test_download_requires_gdown_or_manual(tmp_path):
    # no network: a missing archive must fail with a clear message
    try:
        import gdown  # noqa: F401

        pytest.skip("gdown installed; download path untestable offline")
    except ImportError:
        pass
    for cls in (CoralDataset, MCBDataset, ModelNet10Dataset):
        with pytest.raises(ImportError, match="gdown"):
            cls(str(tmp_path / cls.__name__))


@pytest.mark.parametrize("name", ["CoralDataset", "MCBDataset",
                                  "ModelNet10Dataset", "RocksDataset",
                                  "LargePointCloudDataset"])
def test_pinned_ids_and_checksums_match_reference(name):
    from flooder_tpu_torch import datasets as port

    ours, ref = getattr(port, name), getattr(jax_ds, name)
    for prop in ("file_id", "checksum", "folder_name", "raw_file_names"):
        assert getattr(ours, prop).fget(None) == getattr(ref, prop).fget(None)
    assert CoralDataset.checksum.fget(None).startswith("e8b5ae6b")


def test_archive_pipeline_offline(tmp_path):
    """End-to-end archive path without network: a pre-placed .tar.zst,
    extraction, per-.npy processing, the _done sentinel, split
    persistence, loading, and artifact-resume on reinstantiation."""
    root = tmp_path / "mn10"
    files, splits = modelnet_archive(root)

    ds = ModelNet10Dataset(str(root))
    assert len(ds) == 2
    assert ds.num_classes == 2 and ds.classes == [0, 1]
    # /32767 processing semantics, sorted file order
    np.testing.assert_allclose(
        ds[0].x.numpy(), (files["chair_0001.npy"] / 32767).astype(np.float32)
    )
    assert ds[0].x.dtype == torch.float32
    assert ds[0].name == "chair_0001" and int(ds[1].y) == 1
    assert (root / "processed" / "_done").exists()
    assert ds.splits == splits["splits"]

    # artifact resume: with raw + _done present, reinstantiation skips
    # download AND process; the archive is corrupted and the extracted tree
    # deleted to prove neither is touched
    (root / "raw" / "modelnet10_250k.tar.zst").write_bytes(b"garbage")
    shutil.rmtree(root / "raw" / "modelnet10_250k")
    ds2 = ModelNet10Dataset(str(root))
    assert len(ds2) == 2 and int(ds2[1].y) == 1


def test_checksum_mismatch_warns_not_raises(tmp_path):
    f = tmp_path / "payload.bin"
    f.write_bytes(b"not the real archive")
    with pytest.warns(UserWarning, match="checksum"):
        ModelNet10Dataset.validate(
            ModelNet10Dataset.__new__(ModelNet10Dataset), str(f)
        )


def test_rocks_pipeline_offline(tmp_path):
    """unpackbits → jittered voxel coordinates and regression targets."""
    root = tmp_path / "rocks"
    rocks_archive(root)
    ds = RocksDataset(str(root))
    assert len(ds) == 1
    item = ds[0]
    assert item.x.shape == (len(OCCUPIED), 3)
    assert item.x.dtype == torch.float32
    x = item.x.numpy()
    # voxel coordinate + jitter in [0, 0.1): floor recovers the voxel
    np.testing.assert_array_equal(np.floor(x).astype(int), sorted(OCCUPIED))
    assert ((x - np.floor(x)) < 0.1).all()
    assert int(item.y) == 1
    assert item.surface == pytest.approx(2.5)
    assert item.volume == pytest.approx(0.125)


def test_large_point_cloud_lazy_get_offline(tmp_path):
    """_process extracts (nothing creates the _done sentinel, the isdir
    guard makes it a no-op once extracted); get loads lazily."""
    root = tmp_path / "large"
    clouds = large_archive(root)
    ds = LargePointCloudDataset(str(root))
    assert len(ds) == 2
    item = ds[0]
    assert item.x.dtype == torch.float32 and item.x.device.type == "cpu"
    np.testing.assert_array_equal(item.x.numpy(), clouds[0])
    assert item.name == "virus" and "50844" in item.description
    assert ds[1].name == "coral"
    ds2 = LargePointCloudDataset(str(root))
    np.testing.assert_array_equal(ds2[1].x.numpy(), clouds[1])


@pytest.mark.parametrize("kind", ["modelnet10", "rocks", "large"])
def test_archives_match_reference(tmp_path, kind):
    """The same archive processed by both packages: equal clouds (tensor
    against array), labels, targets, names and splits."""
    build, port_cls, ref_cls = {
        "modelnet10": (modelnet_archive, ModelNet10Dataset,
                       jax_ds.ModelNet10Dataset),
        "rocks": (rocks_archive, RocksDataset, jax_ds.RocksDataset),
        "large": (large_archive, LargePointCloudDataset,
                  jax_ds.LargePointCloudDataset),
    }[kind]
    build(tmp_path / "port")
    shutil.copytree(tmp_path / "port", tmp_path / "ref")
    ours, ref = port_cls(str(tmp_path / "port")), ref_cls(
        str(tmp_path / "ref"))
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert isinstance(a.x, torch.Tensor) and a.x.dtype == torch.float32
        np.testing.assert_array_equal(a.x.numpy(), b.x)
        assert a.name == b.name
        for field in ("y", "surface", "volume", "description"):
            assert getattr(a, field, None) == getattr(b, field, None)
    assert getattr(ours, "splits", None) == getattr(ref, "splits", None)


def test_swisscheese_matches_reference(cheese_ds, tmp_path):
    """Equal splits (RandomState(42) in both), and the same shapes, labels
    and names; the clouds are unseeded in both packages."""
    ref = jax_ds.SwisscheeseDataset(str(tmp_path / "ref"), **CHEESE)
    assert cheese_ds.splits == ref.splits
    assert cheese_ds.classes == ref.classes
    ours = {d.name: d for d in cheese_ds}
    theirs = {d.name: d for d in ref}
    assert ours.keys() == theirs.keys()
    assert sorted(ours) == sorted(f"{k}voids_{r}" for k in (2, 4)
                                  for r in range(4))
    for name, d in ours.items():
        assert d.y == theirs[name].y
        assert tuple(d.x.shape) == theirs[name].x.shape
