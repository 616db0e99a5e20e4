"""Build and load the port's CUDA kernels (``csrc/*.cu``).

At first use the sources are compiled by ``nvcc`` for Hopper
(``sm_90a``), one compiler process per source, all started together, and
linked into one shared library with a plain C interface, which is loaded
with ``ctypes`` -- no PyTorch headers, so the build takes seconds.
The library lands in ``bark_tpu_torch/_build/`` (listed in ``.gitignore``)
under a name derived from the sources' content and the flags, so an edit to
a source rebuilds and an unchanged tree reuses the library. A failed build
raises with the compiler's output; nothing falls back.

``nvcc`` is taken from ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or the
``PATH``, in that order.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "bark_gram": (
        [_vp, _ll, _i, _vp, _ll, _i, _vp, _vp, _vp, _vp, _ll, _vp, _ll, _vp,
         _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _vp],
        _i,
    ),
    "bark_chol_inv": ([_vp, _vp, _vp, _i, _i, _i, _vp], _i),
    "bark_error_string": ([_i], ctypes.c_char_p),
}


class KernelLibrary:
    """The loaded shared library and what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, seconds: float, log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = seconds  # 0.0 when an existing build was reused
        self.build_log = log  # nvcc / ptxas output of this build

    def check(self, code: int, what: str) -> None:
        """Raise if a C entry point returned a CUDA error code."""
        if code != 0:
            msg = self.lib.bark_error_string(code).decode()
            raise RuntimeError(f"{what} kernel launch failed: {msg} ({code})")


_library: KernelLibrary | None = None


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float, str]:
    """Compile ``csrc/*.cu`` into the library; returns (path, seconds, log)."""
    srcs = sources()
    out = BUILD_DIR / f"libbark_kernels_{_digest(srcs)}.so"
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name and rename, so a concurrent loader never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    log = []
    try:
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
            objs = [str(Path(objdir) / f"{s.stem}.o") for s in srcs]
            cmds = [
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for src, obj in zip(srcs, objs)
            ]
            procs = [
                subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for c in cmds
            ]
            outputs = [p.communicate() for p in procs]  # waits for every one
            for cmd, p, (stdout, stderr) in zip(cmds, procs, outputs):
                log.append(stdout + stderr)
                if p.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{stdout}\n{stderr}"
                    )
            link = [nvcc, *LINK_FLAGS, "-o", tmp, *objs]
            proc = subprocess.run(link, capture_output=True, text=True)
            log.append(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(link)}\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, time.perf_counter() - t0, "".join(log)


def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernels; cached for the process."""
    global _library
    if _library is None:
        path, seconds, log = build()
        lib = ctypes.CDLL(str(path))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _library = KernelLibrary(lib, path, seconds, log)
    return _library


def stream_and_device(t: torch.Tensor) -> tuple[int, int]:
    """(current CUDA stream handle, device index) for tensor ``t``."""
    return torch.cuda.current_stream(t.device).cuda_stream, t.device.index
