"""PyTorch + CUDA port of ``nerf_replication_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference; this package imports ``torch``
and numpy, never JAX or anything under ``nerf_replication_tpu``. Its layout
follows the JAX package module for module. The TPU kernels on the serving
path are hand-written CUDA C++ under ``csrc/`` (see ``ops/fused_march.py``).
"""
