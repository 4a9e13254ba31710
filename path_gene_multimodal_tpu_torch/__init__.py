"""PyTorch/CUDA port of ``path_gene_multimodal_tpu`` for one NVIDIA H100.

The JAX package beside it stays the reference; this package imports
nothing of it (and never ``jax``) and keeps its own copies of what it
needs. Module names follow the JAX package so each counterpart is easy to
find. The kernels that the JAX package wrote in Pallas for the TPU are
hand-written CUDA C++ for Hopper under ``csrc/``, built with ``nvcc`` at
first use (``ops/cuda.py``).

Ported so far: the HoverNeXt nuclei stage, per tile
(``pipeline/nuclei.py``) and over the whole slide in sliding windows
(``pipeline/nuclei_wsi.py``), with its CLI (``python -m
path_gene_multimodal_tpu_torch.cli.hovernext_infer``); the islands path
(``pipeline/morphology.py``), the CLIP tile embedding (``models/clip.py``,
``pipeline/embed.py``), the cell graph with its statistics
(``ops/neighbors.py``, ``pipeline/graph.py``, ``pipeline/graph_stats.py``)
and the slide feed (``io/tiff.py``, ``io/native.py``).
"""
