"""Hand-written CUDA kernels (csrc/) with their wrappers and plain versions.

spmv_dia / spmv_dia_ext (one kernel), pipecg_spmv_fused /
pipecg_spmv_halo (one sweep kernel), pipecg_fused, fused_dots,
pipebicgstab_fused / _halo, ghost_chain_fused / _halo, spmv_bsr,
pipecg_bsr_fused, flash_attention and wkv_recurrent;
``ops`` dispatches and counts launches.

Nothing is compiled on import: ``build.lib()`` builds the shared library
at the first launch on a CUDA tensor.
"""
