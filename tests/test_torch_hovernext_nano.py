"""A canonical HoverNeXt at ConvNeXtV2-nano's widths (80/160/320/640,
decoder 384/192/96/64; depths cut to 1 a stage, input 64) against the JAX
package's, on the CPU: the f32 port model against the flax forward within
atol 5e-4 / rtol 1e-3, and the bf16 port model (K1 on stages 0-2 at C = 80,
160, 320: its plain version here, as on any CPU tensor) against
``hovernext_forward(dtype=bf16, fused_blocks=True, interpret=True)`` within
the bf16 bar of ``tests/test_torch_hovernext.py``, and each decoder
configuration (``fused_decoder``; ``fused_final`` True, "heads", "pallas")
against ``hovernext_forward`` with the same option in interpret mode at the
bar of ``tests/test_torch_decoder.py``. The weights are drawn
from a seed in the JAX layout and carried across by ``params_from_jax``;
the card runs the same model from a converted checkpoint in chip_smoke.py's
``shapes`` phase."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from path_gene_multimodal_tpu.models import hovernext_fn as jfn
from path_gene_multimodal_tpu.models.convnext import ConvNeXtConfig as JConvNeXtConfig
from path_gene_multimodal_tpu.models.hovernext import HoverNeXt as JHoverNeXt
from path_gene_multimodal_tpu.models.hovernext import HoverNeXtConfig as JHoverNeXtConfig
from path_gene_multimodal_tpu_torch.config import ConvNeXtConfig, HoverNeXtConfig
from path_gene_multimodal_tpu_torch.models.hovernext import HoverNeXt
from path_gene_multimodal_tpu_torch.models.weights_hovernext import params_from_jax
from path_gene_multimodal_tpu_torch.pipeline.nuclei import NucleiModel

NANO_DIMS, DEPTHS, DEC = (80, 160, 320, 640), (1, 1, 1, 1), (384, 192, 96, 64)


@pytest.fixture(autouse=True)
def _cpu_f32():
    prev = (torch.get_num_threads(), torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.set_num_threads(2)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.set_num_threads(prev[0])
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev[1:]


@pytest.fixture(scope="module")
def nano():
    """(JAX config, port config, JAX params): the flax module's parameter
    tree (its shapes by ``jax.eval_shape``, nothing compiled) drawn from a
    seed: kernels at std fan_in^-0.5, LayerNorm scales around 1, biases and
    the GRN vectors around 0."""
    jcfg = JHoverNeXtConfig(encoder=JConvNeXtConfig(depths=DEPTHS, dims=NANO_DIMS),
                            decoder_dims=DEC, input_size=64)
    tcfg = HoverNeXtConfig(encoder=ConvNeXtConfig(depths=DEPTHS, dims=NANO_DIMS),
                           decoder_dims=DEC, input_size=64)
    shapes = jax.eval_shape(lambda: JHoverNeXt(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    rng = np.random.default_rng(21)

    def draw(path, leaf):
        name, shape = str(path[-1].key), leaf.shape
        if name == "kernel":
            std = float(np.prod(shape[:-1])) ** -0.5
        elif name in ("gamma", "beta"):
            std = 0.3
        else:
            std = 0.1
        v = rng.normal(scale=std, size=shape) + (1.0 if name == "scale" else 0.0)
        return v.astype(np.float32)

    return jcfg, tcfg, jax.tree_util.tree_map_with_path(draw, shapes)


def _pixels(seed):
    return np.random.default_rng(seed).uniform(0, 1, size=(2, 64, 64, 3)).astype(np.float32)


def test_nano_f32_forward_matches_jax(nano):
    jcfg, tcfg, params = nano
    model = NucleiModel.build(tcfg, state_dict=params_from_jax(params, tcfg),
                              dtype=torch.float32, device="cpu").model
    x = _pixels(22)
    ref = jax.jit(JHoverNeXt(jcfg, dtype=jnp.float32).apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for k in ("np", "hv", "tp"):
        assert got[k].shape == ref[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=5e-4, rtol=1e-3,
                                   err_msg=k)


def test_nano_bf16_forward_tracks_hovernext_forward_fused_blocks(nano):
    """The bf16 port model (K1 at C = 80, 160, 320) against JAX's fused
    forward: max |port - jax| / span of jax < 0.05 per head."""
    jcfg, tcfg, params = nano
    model = NucleiModel.build(tcfg, state_dict=params_from_jax(params, tcfg),
                              dtype=torch.bfloat16, device="cpu").model
    assert [blk.k1_weights is not None for s in model.encoder.stages for blk in s] == [
        True, True, True, False]
    x = _pixels(23)
    ref = jax.jit(lambda p, px: jfn.hovernext_forward(
        p, px, jcfg, dtype=jnp.bfloat16, fused_blocks=True, interpret=True))(params, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for k in ("np", "hv", "tp"):
        r = np.asarray(ref[k], np.float32)
        g = got[k].float().numpy()
        assert g.shape == r.shape, k
        span = float(r.max() - r.min()) or 1.0
        assert float(np.abs(g - r).max()) / span < 0.05, k


@pytest.mark.parametrize("option", [{"fused_decoder": True}, {"fused_final": True},
                                    {"fused_final": "heads"}, {"fused_final": "pallas"}],
                         ids=["fused_decoder", "k9", "heads", "pallas"])
def test_nano_decoder_configurations_match_hovernext_forward(nano, option):
    """Each decoder configuration at nano's widths (K7 at the skip of 80,
    the final stage at 64) against ``hovernext_forward`` with the same
    option, its Pallas kernels in interpret mode, f32 on both sides: max
    |port - jax| / span < 2e-2 per head, ``test_torch_decoder.py``'s bar
    for the kernel configurations."""
    jcfg, tcfg, params = nano
    model = HoverNeXt(tcfg, **option).eval()
    model.load_state_dict(params_from_jax(params, tcfg))
    model.fuse()
    x = _pixels(24)
    ref = jax.jit(lambda p, px: jfn.hovernext_forward(
        p, px, jcfg, dtype=jnp.float32, interpret=True, **option))(params, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for k in ("np", "hv", "tp"):
        r = np.asarray(ref[k], np.float32)
        g = got[k].float().numpy()
        assert g.shape == r.shape, k
        span = float(r.max() - r.min()) or 1.0
        assert float(np.abs(g - r).max()) / span < 2e-2, k
