"""Configuration read by the ported stages.

A copy of the fields of ``path_gene_multimodal_tpu/config.py`` that this
package reads (the port imports nothing of the JAX package): the nuclei,
embedding and graph sections and the root fields they use, plus the model
configuration that lives in the JAX package's ``models/convnext.py`` and
``models/hovernext.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

# HoverNeXt nucleus type ids → names (reference aggregated_hovernet_run.py:76-82).
TYPE_NAMES: dict[int, str] = {
    1: "neoplastic",
    2: "inflammatory",
    3: "connective",
    4: "dead",
    5: "epithelial",
}


@dataclass(frozen=True)
class NucleiConfig:
    """The ``hovernext`` section of the pipeline config (fields read here).
    ``tile_size`` is the model input/window size (the CLI and the model
    builders read it); ``max_instances_per_tile`` caps the per-window
    instance ids."""

    tile_size: int = 256
    overlap: float = 0.96875
    batch_size: int = 128
    tta: int = 4
    max_instances_per_tile: int = 512
    # ship JPEG tiles as raw 4:2:0 planes; ycbcr420_to_rgb and the reflect
    # pad finish them on the model's device (pipeline/nuclei.py)
    planar_feed: bool = True


@dataclass(frozen=True)
class EmbeddingConfig:
    """Tile feature extraction (reference extract_embedding_from_tiles.py:48-57).
    The model choice is the root ``PipelineConfig.model_type``; the input
    size comes from the vision config."""

    # the reference uses BATCH_SIZE=128; 512 is the JAX package's default
    # (its throughput knee on a TPU, not a measurement of this port)
    batch_size: int = 512
    # the ViT-H Virchow2 tower's batch, clamped in pipeline/embed.py when
    # model_type starts with "virchow" (the JAX package's default)
    virchow2_batch_size: int = 64
    dtype: str = "bfloat16"
    # ship JPEG tiles as raw 4:2:0 planes (half the bytes) and finish their
    # decode on the encoder's device (pipeline/embed.py)
    planar_feed: bool = True


@dataclass(frozen=True)
class GraphConfig:
    """Spatial cell graph (reference hovernet_tile_inference.ipynb cells 11, 23-27)."""

    knn_k: int = 5
    radius_um: float = 40.0
    mpp: float = 0.25


@dataclass(frozen=True)
class PipelineConfig:
    """Root pipeline config (fields read by the ported stages)."""

    patch_size: int = 224
    model_type: str = "CLIP"
    embedding: EmbeddingConfig = field(default_factory=EmbeddingConfig)
    hovernext: NucleiConfig = field(default_factory=NucleiConfig)
    graph: GraphConfig = field(default_factory=GraphConfig)


def default_config(**overrides: Any) -> PipelineConfig:
    return PipelineConfig(**overrides)


@dataclass(frozen=True)
class ConvNeXtConfig:
    depths: tuple[int, ...] = (3, 3, 9, 3)
    dims: tuple[int, ...] = (96, 192, 384, 768)
    # GELU flavor for the whole network: False = tanh approximation (the
    # JAX package's default), True = exact erf (torch ``nn.GELU()``).
    exact_gelu: bool = False

    @property
    def num_stages(self) -> int:
        return len(self.depths)


CONVNEXTV2_TINY = ConvNeXtConfig()


@dataclass(frozen=True)
class HoverNeXtConfig:
    encoder: ConvNeXtConfig = field(default_factory=lambda: CONVNEXTV2_TINY)
    decoder_dims: tuple[int, ...] = (384, 192, 96, 64)
    num_types: int = 5  # PanNuke nucleus types (ids 1..5)
    input_size: int = 256

    @property
    def tp_channels(self) -> int:
        return self.num_types + 1

    @property
    def exact_gelu(self) -> bool:
        return self.encoder.exact_gelu


HOVERNEXT_TINY = HoverNeXtConfig()
