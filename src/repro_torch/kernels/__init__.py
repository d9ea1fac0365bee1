"""Hand-written CUDA kernels (csrc/) with their wrappers and plain versions.

Nothing is compiled on import: ``build.lib()`` builds the shared library
at the first launch on a CUDA tensor.
"""
