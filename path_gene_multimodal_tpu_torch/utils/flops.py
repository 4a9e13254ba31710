"""Analytic FLOP accounting for the port's model families, and the H100's
peaks to read a rate against.

The counts are the JAX package's (``utils/flops.py``), derived from the
model configs (the same dataclasses the port's modules take), for one
forward of one input. 1 MAC = 2 FLOPs.

Tensor cores vs CUDA cores: depthwise convolutions perform C independent
2-D convolutions with no shared contraction, so they do not map onto the
tensor cores' matrix products; they run as multiply-adds on the CUDA
cores. Their MACs are tallied apart (``cuda_core_macs``): folding them
into a tensor-core utilization would overstate what the card can reach,
while ignoring them would hide the encoder's floor (ConvNeXt's dw 7x7).

Reference workloads these models rebuild: CLIP/Virchow2 tile embedding
(``extract_embedding_from_tiles.py:9-70``), HoverNeXt nuclei segmentation
(``hovernet_inference.py:82-170``), IDaRS ResNet34 molecular ensemble
(``molecular_feature_extraction.py:110-139``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

# NVIDIA H100 SXM5 (80 GB HBM3) data-sheet peaks at its 700 W limit: dense
# bf16 tensor-core products, f32 on the CUDA cores (no tensor cores), and
# the HBM3 bandwidth. A card set below 700 W runs slower under load.
PEAK_BF16_FLOPS_H100 = 989e12
PEAK_F32_FLOPS_H100 = 67e12
PEAK_HBM_BYTES_H100 = 3.35e12


@dataclass
class FlopCount:
    """MAC tallies for one forward pass of one input.

    ``tensor_macs``: contractions that map onto the tensor cores (dense
    convs, matmuls, attention products). ``cuda_core_macs``: depthwise-conv
    MACs (see the module docstring)."""

    tensor_macs: int = 0
    cuda_core_macs: int = 0
    by_part: dict[str, int] = field(default_factory=dict)

    def add(self, part: str, macs: int, cuda_core: bool = False) -> None:
        if cuda_core:
            self.cuda_core_macs += macs
        else:
            self.tensor_macs += macs
        self.by_part[part] = self.by_part.get(part, 0) + macs

    @property
    def tensor_flops(self) -> int:
        return 2 * self.tensor_macs

    @property
    def cuda_core_flops(self) -> int:
        return 2 * self.cuda_core_macs

    @property
    def total_flops(self) -> int:
        return 2 * (self.tensor_macs + self.cuda_core_macs)

    def scaled(self, factor: int) -> "FlopCount":
        return FlopCount(
            self.tensor_macs * factor,
            self.cuda_core_macs * factor,
            {k: v * factor for k, v in self.by_part.items()},
        )


def _conv_macs(out_px: int, k: int, cin: int, cout: int) -> int:
    return out_px * k * k * cin * cout


def hovernext_flops(cfg, input_size: int | None = None, tta: int = 1) -> FlopCount:
    """HoverNeXt forward (``models/hovernext.py``): ConvNeXtV2 encoder +
    U-Net decoder + bilinear-upsample final conv + three 1x1 heads.

    The low-res composite final stage (``fused_final="lowres"``) is
    FLOP-neutral against the plain one (its 2x parity fold redistributes,
    never duplicates, the taps), so one count covers both. ``tta``
    multiplies everything (the TTA forward runs the whole network per
    rotation)."""
    s = input_size or cfg.input_size
    enc = cfg.encoder
    fc = FlopCount()
    r = s // 4
    # stem is a stride-4 4x4 conv: out_px=(s/4)², k²·cin taps each
    fc.add("stem", _conv_macs(r * r, 4, 3, enc.dims[0]))
    for st in range(enc.num_stages):
        c = enc.dims[st]
        if st > 0:
            r //= 2
            fc.add(f"down{st}", _conv_macs(r * r, 2, enc.dims[st - 1], c))
        px = r * r
        for _ in range(enc.depths[st]):
            fc.add(f"enc_stage{st}_dw", px * c * 49, cuda_core=True)
            fc.add(f"enc_stage{st}_pw", px * c * 4 * c + px * 4 * c * c)
    # decoder: x starts at s/32; level i convs run at s/32·2^(i+1)
    skips = [enc.dims[2], enc.dims[1], enc.dims[0], 0]
    prev_c = enc.dims[-1]
    r = s // 32
    for i, dim in enumerate(cfg.decoder_dims):
        r *= 2
        px = r * r
        fc.add(f"dec{i}", _conv_macs(px, 3, prev_c + skips[i], dim))
        fc.add(f"dec{i}", _conv_macs(px, 3, dim, dim))
        prev_c = dim
    # final: 2x bilinear upsample then 3x3 conv at full res
    fc.add("final_conv", _conv_macs(s * s, 3, prev_c, cfg.decoder_dims[-1]))
    fc.add("heads", s * s * cfg.decoder_dims[-1] * (4 + cfg.tp_channels))
    return fc.scaled(tta) if tta > 1 else fc


def vit_flops(cfg, input_size: int | None = None) -> FlopCount:
    """ViT image-tower forward — the CLIP ``VisionConfig``
    (``models/clip.py``) and the timm ``TimmViTConfig``
    (``models/vit_timm.py``, Virchow2: packed SwiGLU, register tokens).
    Attention products count L²·D each for scores and mixing (summed over
    heads)."""
    s = input_size or cfg.image_size
    grid = s // cfg.patch_size
    n_patch = grid * grid
    d = cfg.width
    seq = 1 + getattr(cfg, "num_registers", 0) + n_patch
    fc = FlopCount()
    fc.add("patch_embed", n_patch * cfg.patch_size**2 * 3 * d)
    if getattr(cfg, "mlp_type", None) == "swiglu":
        hid = cfg.mlp_hidden
        mlp = seq * d * hid + seq * (hid // 2) * d
    else:
        hid = int(d * getattr(cfg, "mlp_ratio", 4.0))
        mlp = 2 * seq * d * hid
    per_layer = (
        seq * d * 3 * d  # qkv
        + seq * seq * d  # q·kᵀ over all heads
        + seq * seq * d  # scores·v
        + seq * d * d  # out proj
        + mlp
    )
    fc.add("transformer", per_layer * cfg.layers)
    out_dim = getattr(cfg, "out_dim", None)
    if out_dim:
        fc.add("proj", d * out_dim)
    return fc


def resnet_flops(cfg, input_size: int = 224, num_models: int = 1) -> FlopCount:
    """ResNet forward (``models/resnet.py``, BasicBlock layout);
    ``num_models`` scales for the IDaRS ensemble (6 task heads = 6 whole
    backbones, molecular_feature_extraction.py:21-28)."""
    fc = FlopCount()
    r = input_size // 2
    fc.add("stem", _conv_macs(r * r, 7, 3, cfg.width))
    r //= 2  # maxpool
    cin = cfg.width
    for s, blocks in enumerate(cfg.stage_sizes):
        cout = cfg.width * (2**s)
        for b in range(blocks):
            stride = 2 if (s > 0 and b == 0) else 1
            if stride == 2:
                r //= 2
            px = r * r
            fc.add(f"stage{s}", _conv_macs(px, 3, cin, cout))
            fc.add(f"stage{s}", _conv_macs(px, 3, cout, cout))
            if cin != cout or stride != 1:
                fc.add(f"stage{s}_down", _conv_macs(px, 1, cin, cout))
            cin = cout
    fc.add("fc", cin * cfg.num_classes)
    return fc.scaled(num_models) if num_models > 1 else fc


def mfu(
    items_per_sec: float,
    flops_per_item: float,
    peak_flops: float = PEAK_BF16_FLOPS_H100,
) -> float:
    """Model FLOP utilization: the share of the card's peak that a measured
    rate implies."""
    return items_per_sec * flops_per_item / peak_flops
