"""Package rules of flooder_tpu_torch: it stands alone beside flooder_tpu.

- importing it loads neither JAX nor flooder_tpu;
- no module of it imports either, nor the reference's ``tools/`` (an AST
  scan, so lazy imports count);
- no source of it points at a file inside flooder_tpu, and its native
  build compiles only its own sources;
- entry points default to CUDA and raise without it.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "flooder_tpu_torch"
# "tools" is the reference's own tool directory at the repo root
FORBIDDEN = ("jax", "jaxlib", "flooder_tpu", "tools")


def _py_files():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 14
    return files


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_import_loads_no_jax():
    code = (
        "import sys, flooder_tpu_torch as ft\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flooder_tpu')]\n"
        "assert not bad, bad\n"
        "assert len(ft.__all__) == 7 and ft.__version__\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", _py_files(), ids=lambda p: p.name)
def test_no_module_imports_jax_or_flooder_tpu(path):
    tree = ast.parse(path.read_text())
    roots = set(_imported_roots(tree))
    assert not roots & set(FORBIDDEN), (path, roots & set(FORBIDDEN))


def _code_strings(tree):
    """String constants that are not docstrings."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                body[0].value, ast.Constant
            ):
                docs.add(id(body[0].value))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            yield node.value


def test_no_source_points_into_flooder_tpu():
    for path in _py_files():
        tree = ast.parse(path.read_text())
        for s in _code_strings(tree):
            norm = s.replace("\\", "/")
            assert "flooder_tpu/" not in norm, (path, s)
            assert norm != "flooder_tpu", (path, s)
    for path in sorted(PKG.rglob("*.cu")) + sorted(PKG.rglob("*.cuh")):
        for line in path.read_text().splitlines():
            if line.lstrip().startswith("#include"):
                assert "flooder_tpu" not in line, (path, line)


def test_native_build_uses_only_own_sources():
    from flooder_tpu_torch.native import build

    srcs = [build.PERSISTENCE_SRC, build.FLOOD_CPU_SRC] + [
        build.cuda_source(n) for n in ("flood", "fps", "flood_stats")
    ]
    for src in srcs:
        assert src.exists(), src
        assert PKG in src.resolve().parents, src
    assert REPO / "flooder_tpu" not in build.BUILD_DIR.parents
    # the native sources are own, byte-for-byte copies
    ref = REPO / "flooder_tpu" / "native" / "src"
    assert build.PERSISTENCE_SRC.read_bytes() == (
        ref / "persistence.cpp").read_bytes()
    assert build.FLOOD_CPU_SRC.read_bytes() == (
        ref / "flood_cpu.cpp").read_bytes()


def test_default_device_raises_without_cuda(monkeypatch):
    import flooder_tpu_torch as ft
    from flooder_tpu_torch.utils.device import as_tensor, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.random.default_rng(0).random((200, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        ft.flood_complex(X, 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        ft.generate_landmarks(X, 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        ft.generate_noisy_torus_points_3d(100, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        as_tensor(X)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_as_tensor_keeps_identity_and_converts():
    from flooder_tpu_torch.utils.device import as_tensor

    t = torch.zeros(4, 3)
    assert as_tensor(t, device="cpu") is t
    assert as_tensor(t, dtype=torch.float64, device="cpu").dtype == (
        torch.float64
    )
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    a.setflags(write=False)
    got = as_tensor(a, device="cpu")
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), a)


def test_unported_paths_raise():
    """float64 and the dense engine (use_pallas=False / use_triton=False)
    are ported and return complexes; a mesh that is not the port's Mesh
    and integer clouds raise."""
    import flooder_tpu_torch as ft

    X = np.random.default_rng(0).random((300, 3))
    with pytest.warns(RuntimeWarning, match="float64"):
        f64 = ft.flood_complex(X, 10, points_per_edge=5, device="cpu")
    X32 = X.astype(np.float32)
    dense = ft.flood_complex(X32, 10, points_per_edge=5, use_pallas=False,
                             device="cpu")
    alias = ft.flood_complex(X32, 10, points_per_edge=5, use_triton=False,
                             device="cpu")
    kernel = ft.flood_complex(X32, 10, points_per_edge=5, device="cpu")
    assert set(f64) == set(dense) == set(alias) == set(kernel)
    for s, v in kernel.items():
        assert abs(dense[s] - v) < 1e-5 and alias[s] == dense[s]
        assert abs(f64[s] - v) < 3e-6
    with pytest.raises(TypeError, match="Mesh"):
        ft.flood_complex(X32, 10, mesh=object(), device="cpu")
    with pytest.raises(TypeError):
        ft.flood_complex(X.astype(np.int32), 10, device="cpu")


def test_save_to_disk(tmp_path):
    import flooder_tpu_torch as ft

    path = tmp_path / "out.pt"
    ft.save_to_disk({"x": torch.arange(3)}, path)
    loaded = torch.load(path)
    assert torch.equal(loaded["x"], torch.arange(3))
    assert loaded["_meta"]["keys"] == ["x"]
    with pytest.raises(FileExistsError):
        ft.save_to_disk({"x": 1}, path)
    ft.save_to_disk([1, 2], path, overwrite=True)
    assert torch.load(path) == [1, 2]
