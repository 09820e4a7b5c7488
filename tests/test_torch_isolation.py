"""The port stands alone: no jax, no repro; CUDA by default, never a silent CPU.

``repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor anything of
``repro`` (only the parity tests import both), importing the package builds
no kernel, and the entry points refuse to run without a card unless the
caller asks for the CPU.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _foreign(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_no_module_of_the_port_names_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 25
    bad = {str(f.relative_to(ROOT)): n for f in files for n in _imported_names(f) if _foreign(n)}
    assert not bad


def test_importing_every_module_loads_neither_jax_nor_repro_and_builds_nothing():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import _build\n"
        "assert _build.library.cache_info().currsize == 0 and not _build.last_build\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 25


def test_view_manager_defaults_to_cuda_and_never_falls_back():
    from repro_torch.views import ViewManager

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    for kwargs in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            ViewManager(**kwargs)
    assert ViewManager(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_a_card_or_outside_a_checkout(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
