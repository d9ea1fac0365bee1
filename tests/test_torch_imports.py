"""The port stands alone: no JAX and nothing of the reference package.

A fresh interpreter imports every ``repro_torch`` module and must find
neither ``jax`` nor ``repro`` in ``sys.modules``; an AST scan of the
package, of the port's scripts at the root (``chip_smoke.py``,
``torch_pipecg_breakdown.py``, ``torch_sweep_time.py``,
``torch_serve_breakdown.py``, ``torch_allreduce_latency.py``,
``torch_train_breakdown.py``) and of its
examples (``examples/*_torch.py``) finds no import of either.
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
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
SOURCES = sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "torch_pipecg_breakdown.py",
    ROOT / "torch_sweep_time.py", ROOT / "torch_serve_breakdown.py",
    ROOT / "torch_allreduce_latency.py", ROOT / "torch_train_breakdown.py",
    ROOT / "examples" / "quickstart_torch.py",
    ROOT / "examples" / "stochastic_analysis_torch.py",
    ROOT / "examples" / "train_lm_torch.py",
    ROOT / "examples" / "serve_lm_torch.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _module_names():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_module_imports_without_jax_or_reference():
    names = _module_names()
    assert {"repro_torch.core.krylov.cg",
            "repro_torch.core.krylov.distributed",
            "repro_torch.core.noise.injection",
            "repro_torch.core.noise.sampling",
            "repro_torch.core.noise.traces",
            "repro_torch.distributed.comm",
            "repro_torch.distributed.overlap",
            "repro_torch.distributed.ranks",
            "repro_torch.distributed.shm",
            "repro_torch.kernels.fused_dots",
            "repro_torch.kernels.pipecg_spmv_fused",
            "repro_torch.core.krylov.bicgstab",
            "repro_torch.core.perfmodel.sync",
            "repro_torch.kernels.pipebicgstab_fused",
            "repro_torch.core.krylov.pipeline",
            "repro_torch.core.perfmodel.depth",
            "repro_torch.core.krylov.hostops",
            "repro_torch.kernels.spmv_bsr",
            "repro_torch.configs.base",
            "repro_torch.configs.registry",
            "repro_torch.configs.qwen3_1p7b",
            "repro_torch.models.layers",
            "repro_torch.models.attention",
            "repro_torch.models.transformer",
            "repro_torch.launch.steps",
            "repro_torch.launch.serve",
            "repro_torch.serve.metrics",
            "repro_torch.kernels.flash_attn",
            "repro_torch.kernels.wkv",
            "repro_torch.core.krylov.gmres",
            "repro_torch.core.krylov.pgmres",
            "repro_torch.core.perfmodel.folk_theorem",
            "repro_torch.core.perfmodel.queueing",
            "repro_torch.core.perfmodel.comm",
            "repro_torch.core.noise.simulator",
            "repro_torch.core.stats",
            "repro_torch.core.stats.ecdf",
            "repro_torch.core.stats.mle",
            "repro_torch.core.stats.cramer_von_mises",
            "repro_torch.core.stats.lilliefors",
            "repro_torch.core.stats.report",
            "repro_torch.convert",
            "repro_torch.distributed.compression",
            "repro_torch.distributed.fault",
            "repro_torch.core.noise.faults",
            "repro_torch.core.perfmodel.resync",
            "repro_torch.checkpoint",
            "repro_torch.checkpoint.checkpoint",
            "repro_torch.serve.request",
            "repro_torch.serve.queue",
            "repro_torch.serve.batcher",
            "repro_torch.serve.server",
            "repro_torch.serve.chaos",
            "repro_torch.serve.load",
            "repro_torch.experiments",
            "repro_torch.experiments.spec",
            "repro_torch.experiments.noise_sources",
            "repro_torch.experiments.serve_exec",
            "repro_torch.experiments.runner",
            "repro_torch.experiments.fitting",
            "repro_torch.experiments.validation",
            "repro_torch.experiments.report",
            "repro_torch.experiments.campaign",
            "repro_torch.experiments.abft_exec",
            "repro_torch.experiments.fault_exec",
            "repro_torch.experiments.geometry_exec",
            "repro_torch.experiments.precision_exec",
            "repro_torch.kernels.autotune",
            "repro_torch.optim",
            "repro_torch.optim.adamw",
            "repro_torch.optim.clipping",
            "repro_torch.optim.schedules",
            "repro_torch.optim.krylov_newton",
            "repro_torch.data",
            "repro_torch.data.synthetic",
            "repro_torch.launch.train",
            "repro_torch.launch.mesh",
            "repro_torch.distributed.sharding",
            "repro_torch.distributed.card_wire",
            "repro_torch.models.moe_ep"} <= set(names)
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
    assert all(path.exists() for path in SOURCES)
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
        "pipecg_fused.cu", "fused_dots.cu", "pipebicgstab_fused.cu",
        "ghost_chain.cu", "spmv_bsr.cu", "flash_attn.cu", "wkv.cu"}


def test_every_port_test_caps_torch_threads_first():
    """H23: under pytest-xdist each worker's torch must not open a thread
    per core.  Every tests/test_torch_*.py imports tests/torch_cores.py
    before anything else, and this process runs at its share."""
    import torch
    import torch_cores
    tests = sorted((ROOT / "tests").glob("test_torch_*.py"))
    assert len(tests) >= 30
    for path in tests:
        imports = [n for n in ast.parse(path.read_text()).body
                   if isinstance(n, (ast.Import, ast.ImportFrom))
                   and getattr(n, "module", None) != "__future__"]
        first = imports[0]
        assert isinstance(first, ast.Import) and \
            first.names[0].name == "torch_cores", path.name
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    assert torch_cores.THREADS == max(1, (os.cpu_count() or 1) // workers)
    assert torch.get_num_threads() <= torch_cores.THREADS
