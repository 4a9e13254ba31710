"""K1's launch geometry and channel rule, on the CPU.

``ConvNeXtTiling`` is the geometry of the three launches of
``csrc/convnext_block.cu`` (the launchers refuse any other): its 128-pixel
GEMM tiles cover each image's pixels exactly once and never hold two
images, its dw tiles cover every output pixel once, and each launch's
shared memory stays within what a block can take on the H100. The kernel
takes C a multiple of 32 up to 384; the wrapper's kernel path and
``ConvNeXtV2.fuse()`` (for weights on the card) refuse any other C, while
the plain version, like the Pallas kernel, takes any C.
"""

import pytest
import torch

from path_gene_multimodal_tpu_torch.config import ConvNeXtConfig
from path_gene_multimodal_tpu_torch.models import convnext
from path_gene_multimodal_tpu_torch.models.convnext import Block, ConvNeXtV2
from path_gene_multimodal_tpu_torch.ops import convnext_block as k1
from path_gene_multimodal_tpu_torch.ops.decoder import SMEM_PER_BLOCK

# the encoder stage shapes at a 256-px input (batch cut to 3), and ragged ones
SHAPES = [(3, 64, 64, 96), (3, 32, 32, 192), (3, 16, 16, 384), (3, 13, 11, 96),
          (2, 5, 7, 384), (1, 70, 130, 32), (2, 9, 200, 224)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gemm_tiles_cover_each_image_once(shape):
    b, h, w, c = shape
    geo = k1.ConvNeXtTiling(b, h, w, c)
    tiles = geo.m_tiles()
    assert len(tiles) * (4 * c // geo.n1_tile) == geo.pw1_grid
    assert len(tiles) * (c // geo.pw2_n_tile) == geo.pw2_grid
    seen = torch.zeros(b, h * w, dtype=torch.int32)
    for img, p0, p1 in tiles:
        assert 0 < p1 - p0 <= geo.m_tile and p1 <= h * w  # inside one image
        seen[img, p0:p1] += 1
    assert bool((seen == 1).all())
    assert (4 * c) % geo.n1_tile == 0 and c % geo.pw2_n_tile == 0


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_dw_tiles_cover_each_pixel_once(shape):
    b, h, w, c = shape
    geo = k1.ConvNeXtTiling(b, h, w, c)
    strips, ctiles = -(-h // geo.dw_strip), -(-w // geo.dw_tile_w)
    assert geo.dw_grid == b * strips * ctiles
    assert geo.dw_threads == geo.dw_tile_w * c // 4 <= 768 and (c // 4) % 8 == 0
    seen = torch.zeros(h, w, dtype=torch.int32)
    for st in range(strips):
        for ct in range(ctiles):
            y0, x0 = st * geo.dw_strip, ct * geo.dw_tile_w
            seen[y0 : y0 + geo.dw_strip, x0 : x0 + geo.dw_tile_w] += 1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("c", [32, 96, 192, 224, 384])
def test_shared_memory_fits_a_block(c):
    geo = k1.ConvNeXtTiling(512, 64, 64, c)
    for smem in (geo.dw_smem, geo.pw1_smem, geo.pw2_smem):
        assert smem <= SMEM_PER_BLOCK, smem
    # the rings hold their chunks (pw2's the f32 y2 chunk beside its bf16
    # A tile), and each output staging lies over its ring
    ring1 = geo.pw1_stages * (geo.m_tile + geo.n1_tile) * geo.k_chunk * 2
    ring2 = geo.pw2_stages * (geo.m_tile * (4 + 2) + geo.pw2_n_tile * 2) * geo.k_chunk
    assert geo.pw1_ring >= ring1 and geo.pw2_ring == ring2
    assert geo.pw1_staging <= geo.pw1_ring and geo.pw2_staging <= geo.pw2_ring
    assert len(geo.launch_args()) == 9


@pytest.mark.parametrize("c", [0, 8, 16, 48, 100, 416, 768])
def test_unsupported_channels_are_refused(c):
    with pytest.raises(ValueError, match="multiple of 32 up to 384"):
        k1.check_channels(c)
    with pytest.raises(ValueError, match="multiple of 32 up to 384"):
        k1.ConvNeXtTiling(1, 8, 8, c)


def test_wrapper_kernel_path_refuses_unsupported_channels():
    """The kernel path (``launch_parts``, which the card's wrapper shares
    its checks with) refuses C = 48 before touching the card; at C = 32 it
    gets as far as asking for a CUDA tensor. The plain path takes C = 48."""
    x = torch.zeros(1, 8, 8, 48, dtype=torch.bfloat16)
    wts = Block(48).to(torch.bfloat16).kernel_weights()
    with pytest.raises(ValueError, match="multiple of 32 up to 384"):
        k1.launch_parts(x, wts)
    assert k1.convnext_block(x, *wts).shape == x.shape
    x32 = torch.zeros(1, 8, 8, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k1.launch_parts(x32, Block(32).to(torch.bfloat16).kernel_weights())


def test_kernel_weights_hold_the_linear_layout():
    """w1 and w2 are the plain version's (C, 4C) and (4C, C), as transposes
    of contiguous tensors: the K-major B operands of the kernel's products."""
    blk = Block(32)
    wts = blk.kernel_weights()
    assert wts[4].shape == (32, 128) and wts[8].shape == (128, 32)
    assert wts[4].t().is_contiguous() and wts[8].t().is_contiguous()
    assert torch.equal(wts[4].t(), blk.pwconv1.weight.to(torch.bfloat16))
    assert all(t.is_contiguous() for i, t in enumerate(wts) if i not in (4, 8))


def test_fuse_refuses_unsupported_channels_on_the_card(monkeypatch):
    """With the weights on the card, ``fuse()`` refuses a stage width K1's
    kernel cannot take and names it; on the CPU it fuses any width."""
    cfg = ConvNeXtConfig(depths=(1, 1, 1, 1), dims=(48, 64, 96, 128))
    enc = ConvNeXtV2(cfg)
    enc.fuse()  # CPU: the plain version takes C = 48
    assert enc.stages[0][0].k1_weights is not None
    monkeypatch.setattr(convnext, "on_card", lambda m: True)
    with pytest.raises(ValueError, match="encoder stage 0.*C = 48"):
        ConvNeXtV2(cfg).fuse()
    ConvNeXtV2(ConvNeXtConfig(depths=(1, 1, 1, 1), dims=(32, 64, 384, 768))).fuse()
