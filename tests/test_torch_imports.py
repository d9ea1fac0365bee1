"""The port stands alone: no JAX and nothing of the reference package.

A fresh interpreter imports every ``repro_torch`` module and must find
neither ``jax`` nor ``repro`` in ``sys.modules``; an AST scan of the
package and of the port's two scripts at the root (``chip_smoke.py``,
``torch_pipecg_breakdown.py``) finds no import of either.
"""
import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                       ROOT / "torch_pipecg_breakdown.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _module_names():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_module_imports_without_jax_or_reference():
    names = _module_names()
    assert "repro_torch.core.krylov.cg" in names
    assert "repro_torch.kernels.pipecg_spmv_fused" in names
    code = ("import importlib, json, sys\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "print(json.dumps(sorted(m for m in sys.modules\n"
            "      if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_source_imports_jax_or_reference():
    assert (ROOT / "chip_smoke.py").exists()
    bad = []
    for path in SOURCES:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path.name, a.name) for a in node.names
                        if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0 and _forbidden(node.module):
                bad.append((path.name, node.module))
    assert bad == []


def test_kernel_sources_are_in_the_package():
    csrc = PKG / "kernels" / "csrc"
    assert {p.name for p in csrc.iterdir()} >= {
        "common.cuh", "spmv_dia.cu", "pipecg_spmv_fused.cu",
        "pipecg_fused.cu"}
