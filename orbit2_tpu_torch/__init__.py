"""orbit2_tpu_torch: the PyTorch/CUDA port of orbit2_tpu for NVIDIA Hopper.

Module paths and class names mirror the JAX package (``orbit2_tpu``), which
stays the reference each ported piece is tested against. This package imports
``torch`` and never ``jax``. Importing it loads nothing heavy: the CUDA
kernels under ``csrc/`` are compiled with nvcc at their first launch.
"""
