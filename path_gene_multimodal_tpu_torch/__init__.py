"""PyTorch/CUDA port of ``path_gene_multimodal_tpu`` for one NVIDIA H100.

The JAX package beside it stays the reference; this package imports
nothing of it (and never ``jax``) and keeps its own copies of what it
needs. Module names follow the JAX package so each counterpart is easy to
find. The kernels that the JAX package wrote in Pallas for the TPU are
hand-written CUDA C++ for Hopper under ``csrc/``, built with ``nvcc`` at
first use (``ops/cuda.py``).

Ported so far: the HoverNeXt nuclei stage (``pipeline/nuclei.py``), the
islands path (``pipeline/morphology.py``), the CLIP tile embedding
(``models/clip.py``, ``pipeline/embed.py``) and the cell graph with its
statistics (``ops/neighbors.py``, ``pipeline/graph.py``,
``pipeline/graph_stats.py``).
"""
