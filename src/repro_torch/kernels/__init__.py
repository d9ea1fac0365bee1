"""Hand-written CUDA kernels (csrc/) with their wrappers and plain versions.

spmv_dia, pipecg_spmv_fused / pipecg_spmv_halo (one sweep kernel),
pipecg_fused and fused_dots; ``ops`` dispatches and counts launches.

Nothing is compiled on import: ``build.lib()`` builds the shared library
at the first launch on a CUDA tensor.
"""
