"""Configuration read by the ported stages.

A copy of what this package reads of ``path_gene_multimodal_tpu/config.py``
(the port imports nothing of the JAX package): the class lists, the
tessellation, embedding, TME, polygon, nuclei, molecular, graph, mesh and
compat sections, the root fields of the 8-step runner and the molecular loop with
``replace`` and ``content_hash``,
``resolve_tile_png_name``, ``WSI_EXTS`` and ``slide_paths``; plus the
model configuration that lives in the JAX package's ``models/convnext.py``
and ``models/hovernext.py``. The nuclei section keeps the port's own name
and fields (``NucleiConfig``), so a config hash is the port's own.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

# The five TNBC tissue classes (reference tnbc_config.py:8-14).
DEFAULT_CLASSES: tuple[str, ...] = (
    "Invasive tumor epithelium (TNBC) or In situ carcinoma (DCIS / LCIS)",
    "Tumor-associated stroma",
    "Lymphocyte-rich stroma / TILs",
    "Lymphoid aggregate / TLS",
    "Necrosis / other non-viable tissue",
)

# Classes whose tiles seed the TME region of interest (tnbc_config.py:16-19).
DEFAULT_TME_CLASSES: tuple[str, ...] = DEFAULT_CLASSES[:2]

# Recognised pyramidal-slide extensions (tnbc_config.py:28).
WSI_EXTS: frozenset[str] = frozenset({".svs", ".tif", ".tiff", ".ndpi", ".mrxs"})

# HoverNeXt nucleus type ids → names (reference aggregated_hovernet_run.py:76-82).
TYPE_NAMES: dict[int, str] = {
    1: "neoplastic",
    2: "inflammatory",
    3: "connective",
    4: "dead",
    5: "epithelial",
}

# IDaRS molecular endpoints → pretrained-model tags
# (reference molecular_feature_extraction.py:21-28).
DEFAULT_MOLECULAR_TASKS: dict[str, str] = {
    "msi": "resnet34-idars-msi",
    "hm": "resnet34-idars-hm",
    "cin": "resnet34-idars-cin",
    "cimp": "resnet34-idars-cimp",
    "braf": "resnet34-idars-braf",
    "tp53": "resnet34-idars-tp53",
}


@dataclass(frozen=True)
class PolygonConfig:
    """Polygonization parameters (tnbc_config.py:47-51)."""

    smooth_radius_tiles: float = 1.0
    blur_sigma: float | None = None
    area_min_tiles: int = 3
    simplify_frac: float = 0.2
    min_polygon_area_px: float = 3 * 224 * 224
    # Overlap resolution mode: "prob" (argmax of per-class scores) or
    # "priority" (config class order wins) — reference
    # create_and_overlay_polygon_from_prediction.py:186-218.
    overlap_mode: str = "prob"


@dataclass(frozen=True)
class TessellationConfig:
    """Tissue segmentation + tiling (reference tiling.py:28-42). The tile
    size itself is the root ``PipelineConfig.patch_size``."""

    use_otsu: bool = True
    segment_threshold: int = 20
    thumbnail_size: int = 1024
    min_foreground_frac: float = 0.5
    write_patch_pngs: bool = False  # reference writes per-tile PNGs; optional here
    num_workers: int = 4


@dataclass(frozen=True)
class TMEConfig:
    """TME region-of-interest geometry (load_annotation_with_coordinates.py:188-222)."""

    # Reference quirk: ROI boxes use the *default* 508 px patch size, not the
    # actual 224 px tile size, because main.py:215-220 doesn't pass patch_size.
    roi_patch_size: int = 508
    buffer_factor: float = 2.0  # buffer = buffer_factor * roi_patch_size


@dataclass(frozen=True)
class CompatConfig:
    """Behavioral-compatibility switches for reference quirks."""

    # png naming {x}_{y}.png (current) vs legacy {tile_index}.png
    # (postprocessing.py:107 vs load_annotation_with_coordinates.py:177-180).
    legacy_png_names: bool = False
    # tme_classes default = ALL classes (load_annotation_with_coordinates.py:195).
    tme_classes_default_all: bool = True
    # tiles_to_grid maps tiles by RANK of unique x/y (gaps collapse) —
    # create_and_overlay_polygon_from_prediction.py:111-124; False = dense
    # (x - x0) // tile mapping (geometrically correct for gappy grids).
    rank_compressed_grid: bool = True
    # TME margin corner metric: True = shapely's quad_segs=8 inscribed
    # polygon buffer (load_annotation_with_coordinates.py:216-222, the
    # reference's ≤0.48% corner inset); False = true Euclidean disc.
    polygonal_buffer_corners: bool = True


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
    # model_type starts with "virchow" or the tower is the timm ViT (the JAX
    # package's default)
    virchow2_batch_size: int = 64
    dtype: str = "bfloat16"
    # ship JPEG tiles as raw 4:2:0 planes (half the bytes) and finish their
    # decode on the encoder's device (pipeline/embed.py)
    planar_feed: bool = True


@dataclass(frozen=True)
class MolecularConfig:
    """IDaRS molecular predictors (reference molecular_feature_extraction.py:31-51)."""

    tasks: tuple[str, ...] = tuple(DEFAULT_MOLECULAR_TASKS)
    # the reference uses 64; 256 is the JAX package's default
    batch_size: int = 256
    thumb_power: float = 4.0
    save_prob_maps: bool = False


@dataclass(frozen=True)
class GraphConfig:
    """Spatial cell graph (reference hovernet_tile_inference.ipynb cells 11, 23-27)."""

    knn_k: int = 5
    radius_um: float = 40.0
    mpp: float = 0.25


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh of the data-parallel paths (``parallel/mesh.py``)."""

    data_axis: str = "tiles"
    num_devices: int | None = None  # None → all local devices


@dataclass(frozen=True)
class PipelineConfig:
    """Root pipeline config (field names follow tnbc_config.py)."""

    classes: tuple[str, ...] = DEFAULT_CLASSES
    tme_classes: tuple[str, ...] = DEFAULT_TME_CLASSES
    data_path: str = ""
    outroot: str = ""
    patch_size: int = 224
    model_type: str = "CLIP"
    thumb_size: tuple[int, int] = (2000, 2000)
    done_flag_name: str = "_DONE.json"
    done_flag_molecular: str = "_DONE_MOLECULAR.json"
    stale_lock_hours: float = 48.0

    tessellation: TessellationConfig = field(default_factory=TessellationConfig)
    embedding: EmbeddingConfig = field(default_factory=EmbeddingConfig)
    tme: TMEConfig = field(default_factory=TMEConfig)
    polygon: PolygonConfig = field(default_factory=PolygonConfig)
    hovernext: NucleiConfig = field(default_factory=NucleiConfig)
    molecular: MolecularConfig = field(default_factory=MolecularConfig)
    graph: GraphConfig = field(default_factory=GraphConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    compat: CompatConfig = field(default_factory=CompatConfig)

    def replace(self, **kw: Any) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def content_hash(self) -> str:
        """Stable hash for step-granular resume manifests."""
        blob = json.dumps(self.to_dict(), sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]


def default_config(**overrides: Any) -> PipelineConfig:
    return PipelineConfig(**overrides)


def resolve_tile_png_name(x: int, y: int, tile_index: int, compat: CompatConfig) -> str:
    """Tile PNG naming contract: ``{x}_{y}.png`` (current) or
    ``{tile_index}.png`` (legacy) — load_annotation_with_coordinates.py:177-180."""
    if compat.legacy_png_names:
        return f"{tile_index}.png"
    return f"{x}_{y}.png"


def slide_paths(data_path: str | Path) -> list[Path]:
    """Recursive WSI scan (tnbc_config.py:31-34), as a function instead of an
    import side effect."""
    root = Path(data_path)
    if not root.exists():
        return []
    return sorted(
        p for p in root.rglob("*") if p.is_file() and p.suffix.lower() in WSI_EXTS
    )


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


@dataclass(frozen=True)
class RealHoverNeXtConfig:
    """The published ``hover_next`` layout (smp multi-head U-Net on a timm
    ConvNeXtV2; the JAX package's ``models/hovernext_real.py``), as
    ``models.weights_hovernext_real.infer_real_config`` reads it from a
    checkpoint's shapes. ``branches`` holds one (decoder name, head name,
    output channels) per branch, the names being the checkpoint's module
    prefixes with dots made underscores; branches may share a decoder."""

    encoder: ConvNeXtConfig = field(default_factory=lambda: CONVNEXTV2_TINY)
    decoder_channels: tuple[int, ...] = (256, 128, 64, 32)
    branches: tuple[tuple[str, str, int], ...] = (
        ("decoder_inst", "head_inst", 5),
        ("decoder_ct", "head_ct", 6),
    )
    head_upsampling: int = 2
    input_size: int = 256

    @property
    def exact_gelu(self) -> bool:
        return self.encoder.exact_gelu


# pannuke_convnextv2_tiny_3, the checkpoint the reference's nuclei stage loads
REAL_HOVERNEXT_PANNUKE = RealHoverNeXtConfig()
