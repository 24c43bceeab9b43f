"""PyTorch/CUDA port of the memory-system simulation reproduction.

`repro_torch.core` is the Mess platform (run_point -> sweep) with a
leading batch axis in place of ``vmap``; `repro_torch.kernels` holds the
hand-written Hopper kernels of its hot path, each beside its plain
PyTorch version.  This package imports torch and numpy only.
"""
