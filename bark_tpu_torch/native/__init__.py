"""The native (C++) gradient-boosted-tree booster, loaded with ctypes.

Counterpart of ``bark_tpu/native/__init__.py``. ``gbdt.cpp`` is a copy of
the reference's source (a test holds the two equal): an exact greedy
least-squares GBDT with LightGBM-style arbitrary-subset categorical splits,
emitting trees directly in the flat forest encoding. It runs on the host;
the booster is not a device kernel in either package.

At first use the source is compiled with ``g++ -O3 -std=c++17 -shared
-fPIC`` into ``bark_tpu_torch/_build/`` (listed in ``.gitignore``) under a
name derived from the source's content and the flags, so an edited source
rebuilds and an unchanged one reuses the library. The library is written
to a temporary name and renamed, so processes that build at the same time
never load a half-written file. A failed build raises with the compiler's
output; nothing falls back (``fitting.booster`` has no silent sklearn path).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().parent / "gbdt.cpp"
BUILD_DIR = _PKG / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def gbdt_available() -> bool:
    """Whether a C++ compiler is on the PATH (the booster builds at first
    use; a build that fails then raises)."""
    return shutil.which(CXX) is not None


def library_path() -> Path:
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libbarkgbdt_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``gbdt.cpp`` into the library unless it exists; its path."""
    out = library_path()
    if out.exists():
        return out
    compiler = shutil.which(CXX)
    if compiler is None:
        raise RuntimeError(f"{CXX} not found on the PATH: the native booster cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [compiler, *CXX_FLAGS, str(SOURCE), "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{CXX} failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.bark_gbdt_fit.restype = ctypes.c_int
            lib.bark_gbdt_fit.argtypes = [
                f32p, f32p, ctypes.c_int, ctypes.c_int, i32p, i32p,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.c_int,
                u8p, i32p, f32p, i32p, i32p, i32p, i32p, u8p, f32p,
            ]
            lib.bark_gbdt_predict.restype = None
            lib.bark_gbdt_predict.argtypes = [
                f32p, ctypes.c_int, ctypes.c_int, i32p, ctypes.c_int,
                ctypes.c_int, u8p, i32p, f32p, i32p, i32p, f32p, i32p, f32p,
            ]
            _lib = lib
        return _lib


def fit_gbdt(
    X: np.ndarray,
    y: np.ndarray,
    feat_types: np.ndarray,
    cat_sizes: np.ndarray,
    num_rounds: int = 50,
    max_depth: int = 3,
    learning_rate: float = 0.1,
    node_limit: int = 64,
    min_samples_leaf: int = 1,
) -> dict:
    """Fit the booster; returns the flat forest arrays plus ``leaf_value``.

    Arrays have shape ``(num_rounds, node_limit)`` in the encoding of
    :class:`bark_tpu_torch.forest.Forest`. Raises OverflowError if a tree
    exceeds ``node_limit``.
    """
    lib = _load()
    X = np.ascontiguousarray(X, np.float32)
    y = np.ascontiguousarray(y, np.float32).reshape(-1)
    n, d = X.shape
    if y.shape[0] != n:
        raise ValueError(f"fit_gbdt: {n} rows of X but {y.shape[0]} targets")
    feat_types = np.ascontiguousarray(feat_types, np.int32)
    cat_sizes = np.ascontiguousarray(cat_sizes, np.int32)
    if feat_types.shape != (d,) or cat_sizes.shape != (d,):
        raise ValueError(f"fit_gbdt: feat_types and cat_sizes must be ({d},)")
    shape = (num_rounds, node_limit)
    out = {
        "is_leaf": np.zeros(shape, np.uint8),
        "feature": np.zeros(shape, np.int32),
        "threshold": np.zeros(shape, np.float32),
        "left": np.zeros(shape, np.int32),
        "right": np.zeros(shape, np.int32),
        "parent": np.zeros(shape, np.int32),
        "depth": np.zeros(shape, np.int32),
        "active": np.zeros(shape, np.uint8),
        "leaf_value": np.zeros(shape, np.float32),
    }
    rc = lib.bark_gbdt_fit(
        X, y, n, d, feat_types, cat_sizes,
        num_rounds, max_depth, learning_rate, node_limit, min_samples_leaf,
        out["is_leaf"], out["feature"], out["threshold"], out["left"],
        out["right"], out["parent"], out["depth"], out["active"],
        out["leaf_value"],
    )
    if rc != 0:
        raise OverflowError(f"native GBDT tree exceeded node_limit={node_limit}")
    out["is_leaf"] = out["is_leaf"].astype(bool)
    out["active"] = out["active"].astype(bool)
    return out


def predict_gbdt(
    X: np.ndarray, arrays: dict, feat_types: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Route rows through a fitted native forest: ``(leaves (n, m) int32,
    pred (n,) float32)``, pred the sum of leaf values."""
    lib = _load()
    X = np.ascontiguousarray(X, np.float32)
    n, d = X.shape
    m, node_limit = arrays["is_leaf"].shape
    feat_types = np.ascontiguousarray(feat_types, np.int32)
    if feat_types.shape != (d,):
        raise ValueError(f"predict_gbdt: feat_types must be ({d},)")
    leaves = np.zeros((n, m), np.int32)
    pred = np.zeros((n,), np.float32)
    lib.bark_gbdt_predict(
        X, n, d, feat_types, m, node_limit,
        np.ascontiguousarray(arrays["is_leaf"], np.uint8),
        np.ascontiguousarray(arrays["feature"], np.int32),
        np.ascontiguousarray(arrays["threshold"], np.float32),
        np.ascontiguousarray(arrays["left"], np.int32),
        np.ascontiguousarray(arrays["right"], np.int32),
        np.ascontiguousarray(arrays["leaf_value"], np.float32),
        leaves, pred,
    )
    return leaves, pred
