"""Step 2 of 8 — tile embeddings.

Counterpart of ``run_extract_features`` of the JAX package's
``pipeline/embed.py`` (ref ``extract_embedding_from_tiles.py:9-70``):
read tiles on the host in a thread pool ahead of the device, run the
image tower batched (bf16 by default) on the card, keep every batch's
features on the device until one copy at the end, and write
``<slide>_features.h5`` + the reference's torch ``.pt`` sidecar + an
``.npy`` sidecar. With the planar feed (``EmbeddingConfig.planar_feed``,
a reader with ``supports_planar``), JPEG tiles cross to the card as raw
4:2:0 planes, half the bytes of RGB, and ``ops.jpegcolor.ycbcr420_to_rgb``
finishes their decode there.

Not ported yet: the class text embeddings (``run_create_class_embeddings``)
and the zero-shot annotation (``run_annotation``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from path_gene_multimodal_tpu_torch.config import PipelineConfig
from path_gene_multimodal_tpu_torch.core.artifacts import write_features_h5
from path_gene_multimodal_tpu_torch.io.slide import SlideReader
from path_gene_multimodal_tpu_torch.models.clip import ImageEncoder
from path_gene_multimodal_tpu_torch.ops.jpegcolor import ycbcr420_to_rgb
from path_gene_multimodal_tpu_torch.pipeline.tessellate import iter_tile_batches


def _is_virchow_tower(cfg: PipelineConfig, encoder) -> bool:
    """True when the image tower is the ViT-H Virchow2, which gets its own
    batch clamp and artifact metadata. The JAX package also recognises its
    timm tower by the encoder's config; that tower is not ported yet, so
    here ``cfg.model_type`` decides."""
    return cfg.model_type.lower().startswith("virchow")


def _recorded_model_type(cfg: PipelineConfig, encoder) -> str:
    """model_type written into the features artifact — the actual tower.
    The JAX package writes "Virchow2" for its timm tower run under another
    model_type; without that tower, the configured model_type is the
    tower's."""
    return cfg.model_type


def _planes_to_device(planes, device: torch.device) -> list[torch.Tensor]:
    """Host planes to ``device``: pinned and non-blocking when it is a card,
    so that the copies do not wait for it."""
    out = [torch.from_numpy(p) for p in planes]
    if device.type == "cuda":
        out = [t.pin_memory() for t in out]
    return [t.to(device, non_blocking=True) for t in out]


def run_extract_features(
    slide: SlideReader,
    coords: np.ndarray,
    encoder: ImageEncoder,
    out_dir: str | Path,
    stem: str,
    cfg: PipelineConfig,
    write_artifacts: bool = True,
) -> np.ndarray:
    """Embed every tile; returns (N, D) float32. Host reads overlap device
    compute: each batch is enqueued without waiting for the card, so the
    thread pool reads batch k+1 while the card runs batch k."""
    batch = cfg.embedding.batch_size
    if _is_virchow_tower(cfg, encoder):
        # the ViT-H Virchow2 tower has its own batch (see
        # EmbeddingConfig.virchow2_batch_size) — clamp to it
        batch = min(batch, cfg.embedding.virchow2_batch_size)
    tile = cfg.patch_size
    planar = (
        cfg.embedding.planar_feed
        and tile % 2 == 0
        and getattr(slide, "supports_planar", lambda level=0: False)()
    )
    outs: list[torch.Tensor] = []
    valids: list[np.ndarray] = []
    for tiles_u8, valid in iter_tile_batches(slide, coords, tile, batch, planar=planar):
        if isinstance(tiles_u8, tuple):  # planes; a chunk may fall back to RGB
            tiles_u8 = ycbcr420_to_rgb(*_planes_to_device(tiles_u8, encoder.device))
        outs.append(encoder(tiles_u8))  # enqueued on the device
        valids.append(valid)
    if not outs:
        # width must match what the encoder would have emitted (2560 for
        # Virchow2, 768 for ViT-L/14 …) so empty-slide artifacts keep the
        # same schema as populated ones
        feats = np.zeros((0, getattr(encoder, "out_dim", 512)), np.float32)
    else:
        feats = torch.cat(outs).cpu().numpy()[np.concatenate(valids)].astype(np.float32)
    if write_artifacts:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        h5_path = out_dir / f"{stem}_features.h5"
        write_features_h5(h5_path, feats, model_type=_recorded_model_type(cfg, encoder))
        np.save(out_dir / f"{stem}_features.npy", feats)
        # reference writes the features h5 AND a torch .pt sidecar
        # (extract_embedding_from_tiles.py:70)
        torch.save(torch.from_numpy(feats), out_dir / f"{stem}_features.pt")
        if not h5_path.exists():  # output oracle (extract_embedding_from_tiles.py:61-62)
            raise RuntimeError(f"feature extraction failed to produce {h5_path}")
    return feats
