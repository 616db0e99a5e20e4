"""The PyTorch port stands without JAX, and its chip check needs a card.

The machine with the GPU has no JAX, so every module of ``bark_tpu_torch``
and ``chip_smoke.py`` must import with ``jax`` unavailable. These run in
subprocesses so the suite's own JAX import cannot mask a stray one.
"""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "bark_tpu_torch"


def _run(code: str, cwd=REPO, timeout=120):
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=cwd, timeout=timeout,
    )


def test_port_imports_without_jax():
    proc = _run(
        "import sys; sys.modules['jax'] = None\n"
        "import bark_tpu_torch.fitting.sampler, bark_tpu_torch.benchmarks.tree_function\n"
        "import bark_tpu_torch.convert, bark_tpu_torch.domain, bark_tpu_torch.ops.linalg\n"
        "import bark_tpu_torch.ops._build\n"
        "assert not any(m == 'bark_tpu' or m.startswith('bark_tpu.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]


def test_no_port_source_imports_jax():
    offenders = []
    for path in [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            words = line.strip().split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1 and (
                words[1].split(".")[0] in ("jax", "jaxlib", "bark_tpu")
            ):
                offenders.append(f"{path.relative_to(REPO)}:{i}: {line.strip()}")
    assert not offenders, offenders


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "script-alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No CUDA here: the chip check must exit non-zero and print no result,
    in the checkout and in a directory holding only the script."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        cwd = tmp_path
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        cwd=cwd, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_kernel_build_failure_raises(tmp_path, monkeypatch):
    """A compiler error surfaces as an exception carrying its output; no
    library is left behind and nothing falls back."""
    from bark_tpu_torch.ops import _build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: fake compiler refused' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "_library", None)
    with pytest.raises(RuntimeError, match="fake compiler refused"):
        _build.load_library()
    assert list((tmp_path / "build").iterdir()) == []
    assert _build._library is None


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel entry points take CUDA tensors only; the CPU path is the
    dispatch to the plain versions, never a fallback inside a wrapper."""
    import torch

    from bark_tpu_torch.ops.chol import chol_inv_cuda
    from bark_tpu_torch.ops.gram import gram_cuda

    leaves = torch.zeros((1, 4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        gram_cuda(leaves, leaves)
    with pytest.raises(ValueError, match="CUDA"):
        chol_inv_cuda(torch.eye(4)[None])
    assert gram_cuda.launches == 0 and chol_inv_cuda.launches == 0
