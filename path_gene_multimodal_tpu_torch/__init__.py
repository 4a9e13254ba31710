"""PyTorch/CUDA port of ``path_gene_multimodal_tpu`` for one NVIDIA H100.

The JAX package beside it stays the reference; this package imports
nothing of it (and never ``jax``) and keeps its own copies of what it
needs. Module names follow the JAX package so each counterpart is easy to
find. The kernels that the JAX package wrote in Pallas for the TPU are
hand-written CUDA C++ for Hopper under ``csrc/``, built with ``nvcc`` at
first use (``ops/cuda.py``).

Ported so far: the HoverNeXt nuclei stage (``pipeline/nuclei.py``).
"""
