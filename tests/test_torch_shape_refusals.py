"""Where the port's kernels and the Pallas kernels take different shapes,
and the f32 path's cuDNN precision, on the CPU.

- Wider on the card: ``final_heads`` (K10) and ``final_conv_gelu`` (K8)
  refuse the H that ``fused_final_heads`` / ``fused_final_conv_gelu``
  refuse, on both devices.
- Narrower on the card: ``HoverNeXt(..., run_on="cuda")`` refuses a decoder
  configuration whose kernels cannot take ``cfg.decoder_dims``, and names
  the width and the kernel; on the CPU every width runs (plain versions).
- TF32: an f32 ``HoverNeXt`` forward runs its convs with
  ``torch.backends.cudnn.allow_tf32`` off, and restores it after.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from path_gene_multimodal_tpu.ops.pallas import decoder as jdec
from path_gene_multimodal_tpu_torch.config import HOVERNEXT_TINY
from path_gene_multimodal_tpu_torch.models import hovernext as thn
from path_gene_multimodal_tpu_torch.models.hovernext import HoverNeXt, kernel_width_errors
from path_gene_multimodal_tpu_torch.ops import decoder as tdec
from test_torch_hovernext import _configs

CONFIGS = {"k9": {"fused_final": True}, "heads": {"fused_final": "heads"},
           "pallas": {"fused_final": "pallas"}, "fused_decoder": {"fused_decoder": True}}


@pytest.mark.parametrize("h", [3, 5, 4, 6])
def test_final_heads_refuses_what_the_pallas_kernel_refuses(h):
    rng = np.random.default_rng(h)
    x = rng.standard_normal((1, h, 4, 8)).astype(np.float32)
    w = (0.2 * rng.standard_normal((3, 3, 8, 8))).astype(np.float32)
    b, wh, bh = np.zeros(8, np.float32), np.zeros((8, 10), np.float32), np.zeros(10, np.float32)
    args = [torch.from_numpy(a) for a in (x, w, b, wh, bh)]
    if (2 * h) % 4:
        with pytest.raises(ValueError, match="multiple of 4"):
            tdec.final_heads(*args)
        with pytest.raises(ValueError, match="divisible by 4"):
            jdec.fused_final_heads(*map(jnp.asarray, (x, w, b, wh, bh)), interpret=True)
    else:
        assert tdec.final_heads(*args).shape == (1, 2 * h, 8, 10)


@pytest.mark.parametrize("h", [16, 40, 32])
def test_final_conv_gelu_refuses_what_the_pallas_kernel_refuses(h):
    rng = np.random.default_rng(h)
    x = rng.standard_normal((1, h, 8, 8)).astype(np.float32)
    w = (0.2 * rng.standard_normal((3, 3, 8, 8))).astype(np.float32)
    b = np.zeros(8, np.float32)
    if h % 32:
        with pytest.raises(ValueError, match="multiple of rows=32"):
            tdec.final_conv_gelu(*map(torch.from_numpy, (x, w, b)))
        with pytest.raises(ValueError, match="multiple of rows=32"):
            jdec.fused_final_conv_gelu(*map(jnp.asarray, (x, w, b)), interpret=True)
    else:
        assert tdec.final_conv_gelu(*map(torch.from_numpy, (x, w, b))).shape == (1, h, 8, 8)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_hovernext_refuses_widths_its_kernels_cannot_take_on_the_card(name):
    """The small test configuration (decoder widths 32, 16, 8, 8) runs every
    configuration on the CPU, and none of the kernel ones on the card."""
    _, tcfg = _configs(False)
    HoverNeXt(tcfg, **CONFIGS[name])
    HoverNeXt(tcfg, **CONFIGS[name], run_on="cpu")
    kernel = {"k9": "K9", "heads": "K10", "pallas": "K11", "fused_decoder": "K7/K8"}[name]
    with pytest.raises(ValueError, match=kernel) as err:
        HoverNeXt(tcfg, **CONFIGS[name], run_on="cuda")
    assert "got 8" in str(err.value) or "= 32" in str(err.value)


@pytest.mark.parametrize("name", list(CONFIGS) + ["lowres", "plain"])
def test_hovernext_tiny_widths_pass_on_the_card(name):
    """HoverNeXt-tiny's published widths pass every configuration's check,
    and the plain configurations have nothing to check."""
    opt = CONFIGS.get(name, {"fused_final": "lowres"} if name == "lowres" else {})
    assert kernel_width_errors(HOVERNEXT_TINY, opt.get("fused_decoder", False),
                               opt.get("fused_final", False)) == []
    _, tcfg = _configs(False)
    if name in ("lowres", "plain"):
        HoverNeXt(tcfg, **opt, run_on="cuda")


def test_hovernext_fuse_refuses_widths_on_the_card(monkeypatch):
    """A model built without ``run_on`` and moved to the card is refused
    at ``fuse()``, before its first forward."""
    _, tcfg = _configs(False)
    model = HoverNeXt(tcfg, fused_final="heads")
    monkeypatch.setattr(thn, "on_card", lambda m: True)
    with pytest.raises(ValueError, match="K10"):
        model.fuse()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_f32_forward_runs_its_convs_without_tf32(dtype):
    _, tcfg = _configs(False)
    model = HoverNeXt(tcfg).to(dtype).eval()
    seen = []
    for mod in (model.encoder.downsample_layers[0][0], model.final_conv, model.head_np):
        mod.register_forward_hook(lambda *_: seen.append(torch.backends.cudnn.allow_tf32))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            model(torch.zeros(1, 64, 64, 3))
        assert len(seen) == 3
        assert seen == [dtype != torch.float32] * 3
        assert torch.backends.cudnn.allow_tf32 is True  # restored
        assert torch.backends.cuda.matmul.allow_tf32 is False  # torch's default, left alone
    finally:
        torch.backends.cudnn.allow_tf32 = prev
