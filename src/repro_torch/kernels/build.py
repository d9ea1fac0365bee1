"""Build and load the port's CUDA kernels (kernels/csrc/*.cu).

Every ``.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``, all of
them at once, and the objects are linked into one shared library with a
plain C interface that ``ctypes`` loads.  The library is built at first
use into ``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the sources and flags so an edited
source never reuses a stale build.  Nothing is compiled on import.

The build turns FMA contraction off (``--fmad=false``): the kernels are
bound by memory traffic, and without contraction each kernel rounds
exactly as its plain PyTorch version does.  ``-Xptxas -v`` puts each
kernel's registers, shared memory and spills into the build log
(:func:`ptxas_usage` reads them).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ("-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v")

#: dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
if hasattr(torch, "float8_e4m3fn"):
    DTYPE_CODES[torch.float8_e4m3fn] = 3
#: accumulator dtypes the kernels are instantiated for
ACCUM_DTYPES = (torch.float32, torch.float64)
#: rows per CTA (kBlock in csrc/common.cuh); sizes the partials scratch
BLOCK = 256
#: the most bands an operator may carry (kMaxBands in csrc/common.cuh)
MAX_BANDS = 32
#: dynamic shared memory a CTA may opt into on sm_90 (227 KB), less 4 KB
#: for the kernels' static block-reduction buffers
SMEM_DYNAMIC = 232_448 - 4096

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "rt_spmv_dia": [_I, _I, _P, _I, _L, _I, _P, _P, _P, _P],
    "rt_spmv_dia_ext": [_I, _I, _P, _I, _L, _I, _I, _P, _P, _P, _P],
    "rt_pipecg_spmv_fused": [_I, _I, _P, _I, _L, _I,
                             _P, _P, _I, _P,
                             _P, _P, _P, _P,
                             _P, _P, _P, _P, _I, _L,
                             _P, _P,
                             _P, _P, _P, _P, _P, _I, _I, _I,
                             _P, _I, _P, _P, _P],
    "rt_pipecg_fused": [_I, _L, _I, _P, _P, _P, _P, _P, _I, _P, _P],
    "rt_fused_dots": [_I, _P, _P, _L, _I, _I, _I, _I, _P, _I, _P, _P, _P],
    "rt_pipebicgstab_fused": [_I, _I, _P, _I, _L,
                              _P, _I, _P,
                              _P, _P, _P, _P, _P, _P, _P, _P,
                              _P, _P, _P, _P, _P, _P, _I, _L,
                              _P, _P, _P,
                              _P, _P, _P, _P, _P, _P, _P,
                              _P, _I, _I, _I, _P, _I, _P, _P, _P],
    "rt_spmv_bsr": [_I, _L, _I, _I, _I, _P, _P, _P, _P, _P],
    "rt_pipecg_bsr_fused": [_I, _L, _I, _I, _I, _P,
                            _P, _P, _P, _P,
                            _P, _P, _P, _P,
                            _P, _P, _P, _P, _P, _P, _I, _P, _P],
    "rt_ghost_chain": [_I, _I, _P, _I, _L, _I,
                       _P, _I, _P, _P,
                       _P, _P, _P, _P, _I, _L,
                       _P, ctypes.c_double,
                       _P, _I, _P, _L, _P, _I, _P, _P, _P],
    "rt_flash_attention": [_I, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float,
                           _I, _P],
    "rt_wkv_recurrent": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit (set CUDA_HOME)")
    return found


def _sources() -> Tuple[Sequence[Path], Sequence[Path]]:
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    srcs, hdrs = _sources()
    h = hashlib.sha1(" ".join(ARCH + FLAGS).encode())
    for f in list(srcs) + list(hdrs):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:12]}.so"


def build() -> Tuple[Path, str]:
    """Compile csrc/ into the shared library unless it is already built.

    One ``nvcc`` process per source, all started together, then one link.
    Returns the library path and the compilers' output.
    """
    so = library_path()
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs, _ = _sources()
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    procs = []
    log = []
    try:
        for src in srcs:
            cmd = [nvcc, *ARCH, *FLAGS, "-c", str(src),
                   "-o", str(tmp / (src.stem + ".o"))]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_so = tmp / so.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp_so),
             *(str(tmp / (s.stem + ".o")) for s in srcs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link\n{link.stdout}")
        if link.returncode:
            raise RuntimeError("linking the kernels failed:\n" + "\n".join(log))
        os.replace(tmp_so, so)  # atomic: a concurrent build sees all or nothing
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return so, "\n".join(log)


def ptxas_usage(log: str, keys: Sequence[str]) -> dict:
    """{mangled kernel name: {"registers", "smem", "stack", "spill_stores",
    "spill_loads"}} from a build log, for the kernels whose name holds one
    of ``keys``."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            name = name if any(k in name for k in keys) else None
            if name:
                out[name] = {}
        elif name and "bytes stack frame" in line:
            words = line.replace(",", "").split()
            out[name].update(stack=int(words[0]), spill_stores=int(words[4]),
                             spill_loads=int(words[8]))
        elif name and "Used" in line and "registers" in line:
            words = line.replace(",", "").split()
            out[name]["registers"] = int(words[words.index("registers") - 1])
            if "smem" in words:
                out[name]["smem"] = int(words[words.index("smem") - 2])
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        so, _ = build()
        cdll = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = cdll
    return _lib


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """Device pointer of ``t`` for ctypes (None for a missing operand)."""
    return None if t is None else t.data_ptr()


def stream_of(device: torch.device) -> int:
    """Handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def no_graph(name: str, **tensors) -> None:
    """Raise when autograd would record a kernel's inputs.

    The kernels write their outputs through raw pointers, outside
    autograd: under a graph their outputs would carry no gradient back to
    the inputs, silently.  None has a backward, and neither has its Pallas
    counterpart in the JAX package.  CPU tensors take the plain versions,
    which are differentiable; ``torch.no_grad`` / ``torch.inference_mode``
    lift the check.
    """
    if not torch.is_grad_enabled():
        return
    needs = [key for key, t in tensors.items()
             if isinstance(t, torch.Tensor) and t.requires_grad]
    if needs:
        raise RuntimeError(
            f"{name}: {needs} require grad, but the CUDA kernel has no "
            "backward (nor has the JAX package's Pallas kernel): call it "
            "under torch.no_grad() or torch.inference_mode(), or keep the "
            "kernel off a path that trains")


def check_cuda(name: str, device: torch.device, **tensors) -> None:
    """Raise unless every given tensor is contiguous on ``device`` and
    none is recorded by autograd (:func:`no_graph`).  Every kernel wrapper
    calls it with all of its tensor inputs before it launches."""
    no_graph(name, **tensors)
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def dtype_code(name: str, t: torch.Tensor) -> int:
    """csrc dtype code of ``t`` (raises for a dtype with no kernel)."""
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise ValueError(f"{name}: no kernel for dtype {t.dtype}") from None


def raise_on_error(name: str, rc: int) -> None:
    """Turn a nonzero ``cudaError_t`` from a C entry point into an error."""
    if rc:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError_t {rc}")
