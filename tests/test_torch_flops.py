"""The port's FLOP accounting (``utils/flops.py``) against the JAX
package's on the same configurations (every field equal), exactly:
``hovernext_flops`` (HoverNeXt-tiny, with TTA and at another input size),
``vit_flops`` (CLIP ViT-B/16 and L/14, the timm Virchow2 tower with SwiGLU
and registers, a GELU timm tower), ``resnet_flops`` (ResNet34, the
six-model IDaRS ensemble), their split into tensor-core and CUDA-core
(depthwise) work (the JAX package's MXU / VPU split) and by part. ``mfu``
reads against the H100's dense bf16 peak, and ``chip_smoke.py``'s FLOP
counts of the same work call these functions."""

import dataclasses

import pytest

import chip_smoke
from path_gene_multimodal_tpu.models import clip as jclip
from path_gene_multimodal_tpu.models import hovernext as jhov
from path_gene_multimodal_tpu.models import resnet as jres
from path_gene_multimodal_tpu.models import vit_timm as jvit
from path_gene_multimodal_tpu.models.convnext import ConvNeXtConfig as JConvNeXtConfig
from path_gene_multimodal_tpu.utils import flops as jflops
from path_gene_multimodal_tpu_torch.config import HOVERNEXT_TINY, ConvNeXtConfig, HoverNeXtConfig
from path_gene_multimodal_tpu_torch.models.clip import CLIP_VIT_B16, CLIP_VIT_L14
from path_gene_multimodal_tpu_torch.models.resnet import RESNET34_IDARS, ResNetConfig
from path_gene_multimodal_tpu_torch.models.vit_timm import VIRCHOW2_TIMM, TimmViTConfig
from path_gene_multimodal_tpu_torch.utils import flops

SMALL_HOVER = HoverNeXtConfig(encoder=ConvNeXtConfig(depths=(1, 1, 2, 1), dims=(24, 48, 96, 192)),
                              decoder_dims=(96, 48, 24, 16))
GELU_TIMM = TimmViTConfig(image_size=56, width=64, layers=3, heads=2, mlp_hidden=256,
                          mlp_type="gelu", use_layerscale=False, pos_embed_mode="prefix")


def _jax_cfg(cfg):
    """The JAX package's config class with the same fields."""
    d = dataclasses.asdict(cfg)
    if isinstance(cfg, HoverNeXtConfig):
        return jhov.HoverNeXtConfig(**dict(d, encoder=JConvNeXtConfig(**d["encoder"])))
    klass = {"VisionConfig": jclip.VisionConfig, "TimmViTConfig": jvit.TimmViTConfig,
             "ResNetConfig": jres.ResNetConfig}[type(cfg).__name__]
    return klass(**d)


def _same(got, want):
    assert got.tensor_macs == want.mxu_macs
    assert got.cuda_core_macs == want.vpu_macs
    assert got.by_part == want.by_part
    assert (got.tensor_flops, got.cuda_core_flops, got.total_flops) == (
        want.mxu_flops, want.vpu_flops, want.total_flops)


@pytest.mark.parametrize("cfg,kw", [(HOVERNEXT_TINY, {}), (HOVERNEXT_TINY, {"tta": 4}),
                                    (HOVERNEXT_TINY, {"input_size": 512}), (SMALL_HOVER, {})])
def test_hovernext_flops_equal_jax(cfg, kw):
    _same(flops.hovernext_flops(cfg, **kw), jflops.hovernext_flops(_jax_cfg(cfg), **kw))
    assert flops.hovernext_flops(cfg).cuda_core_macs > 0  # the depthwise convs


@pytest.mark.parametrize("cfg", [CLIP_VIT_B16, CLIP_VIT_L14, VIRCHOW2_TIMM, GELU_TIMM],
                         ids=["b16", "l14", "virchow2", "gelu_timm"])
def test_vit_flops_equal_jax(cfg):
    _same(flops.vit_flops(cfg), jflops.vit_flops(_jax_cfg(cfg)))
    _same(flops.vit_flops(cfg, input_size=2 * cfg.image_size),
          jflops.vit_flops(_jax_cfg(cfg), input_size=2 * cfg.image_size))
    assert chip_smoke._vit_flops(cfg, 7) == 7 * flops.vit_flops(cfg).total_flops


@pytest.mark.parametrize("cfg,kw", [(RESNET34_IDARS, {}), (RESNET34_IDARS, {"num_models": 6}),
                                    (ResNetConfig((1, 1, 1, 1), 2, 16), {"input_size": 256})])
def test_resnet_flops_equal_jax(cfg, kw):
    _same(flops.resnet_flops(cfg, **kw), jflops.resnet_flops(_jax_cfg(cfg), **kw))
    size = kw.get("input_size", 224)
    assert chip_smoke._resnet_macs(cfg, size) == flops.resnet_flops(cfg, size).tensor_macs


def test_peaks_are_the_h100s():
    assert flops.PEAK_BF16_FLOPS_H100 == 989e12
    assert flops.PEAK_HBM_BYTES_H100 == 3.35e12
    assert (chip_smoke.PEAK_BF16, chip_smoke.PEAK_F32, chip_smoke.PEAK_BYTES) == (
        flops.PEAK_BF16_FLOPS_H100, flops.PEAK_F32_FLOPS_H100, flops.PEAK_HBM_BYTES_H100)
    per_tile = flops.vit_flops(CLIP_VIT_B16).total_flops
    assert flops.mfu(1000.0, per_tile) == 1000.0 * per_tile / 989e12
    assert flops.mfu(1000.0, per_tile, peak_flops=1e15) == 1000.0 * per_tile / 1e15
