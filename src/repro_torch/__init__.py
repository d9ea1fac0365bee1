"""PyTorch/CUDA port of the pipelined-Krylov package for one NVIDIA H100.

Mirrors the layout of the JAX reference package (``core/krylov``,
``core/perfmodel``, ``kernels``).  Entry points run on the card unless the
caller asks for the CPU: operator factories default to ``device="cuda"``
and solvers follow the device of ``A`` and ``b``.  On a CUDA tensor every
kernel wrapper launches its hand-written CUDA kernel (kernels/csrc/) or
raises; a CPU tensor takes the kernel's plain PyTorch version.
"""
