"""The port's HoverNeXt against the JAX package's: weight layout round trip,
and f32 forward parity (plain blocks, TF32 off) in both GELU modes, with
and without folded TTA."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from path_gene_multimodal_tpu.models.convnext import ConvNeXtConfig as JConvNeXtConfig
from path_gene_multimodal_tpu.models.hovernext import HoverNeXt as JHoverNeXt
from path_gene_multimodal_tpu.models.hovernext import HoverNeXtConfig as JHoverNeXtConfig
from path_gene_multimodal_tpu.models.hovernext import tta_forward as j_tta_forward
from path_gene_multimodal_tpu.models.weights_hovernext import convert_hovernext
from path_gene_multimodal_tpu_torch.config import ConvNeXtConfig, HoverNeXtConfig
from path_gene_multimodal_tpu_torch.models.hovernext import HoverNeXt, tta_forward
from path_gene_multimodal_tpu_torch.models.weights_hovernext import params_from_jax

DEPTHS, DIMS, DEC = (1, 1, 2, 1), (8, 16, 32, 64), (32, 16, 8, 8)


def _configs(exact_gelu: bool):
    jcfg = JHoverNeXtConfig(
        encoder=JConvNeXtConfig(depths=DEPTHS, dims=DIMS, exact_gelu=exact_gelu),
        decoder_dims=DEC, input_size=64,
    )
    tcfg = HoverNeXtConfig(
        encoder=ConvNeXtConfig(depths=DEPTHS, dims=DIMS, exact_gelu=exact_gelu),
        decoder_dims=DEC, input_size=64,
    )
    return jcfg, tcfg


def _jax_params(jcfg, seed=0):
    params = JHoverNeXt(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3))
    )
    # GRN starts at zero in the JAX init: give it values so the parity
    # exercises the GRN arithmetic
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, params)
    for k, blk in params["params"]["encoder"].items():
        if k.startswith("stage"):
            for n in ("gamma", "beta"):
                blk["grn"][n] = rng.normal(scale=0.3, size=blk["grn"][n].shape).astype(np.float32)
    return params


def _port_model(tcfg, sd):
    model = HoverNeXt(tcfg).eval()
    model.load_state_dict(sd, strict=True)
    return model


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def test_params_from_jax_round_trip():
    jcfg, tcfg = _configs(False)
    params = _jax_params(jcfg)
    sd = params_from_jax(params, tcfg)
    assert set(sd) == set(HoverNeXt(tcfg).state_dict())
    _, back, leftover = convert_hovernext({k: v.numpy() for k, v in sd.items()}, jcfg)
    assert leftover == {}
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf, err_msg=str(path))


@pytest.mark.parametrize("exact_gelu", [False, True])
def test_forward_matches_jax(exact_gelu):
    jcfg, tcfg = _configs(exact_gelu)
    params = _jax_params(jcfg, seed=1)
    model = _port_model(tcfg, params_from_jax(params, tcfg))
    x = np.random.default_rng(2).uniform(0, 1, size=(2, 64, 64, 3)).astype(np.float32)
    ref = JHoverNeXt(jcfg, dtype=jnp.float32).apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for k in ("np", "hv", "tp"):
        assert got[k].shape == ref[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=5e-4,
                                   rtol=1e-3, err_msg=k)


@pytest.mark.parametrize("exact_gelu", [False, True])
def test_tta_forward_matches_jax(exact_gelu):
    jcfg, tcfg = _configs(exact_gelu)
    params = _jax_params(jcfg, seed=3)
    model = _port_model(tcfg, params_from_jax(params, tcfg))
    x = np.random.default_rng(4).uniform(0, 1, size=(2, 64, 64, 3)).astype(np.float32)
    jmodel = JHoverNeXt(jcfg, dtype=jnp.float32)
    ref = j_tta_forward(jmodel.apply, params, jnp.asarray(x), tta=4, fold_batch=True)
    with torch.no_grad():
        got = tta_forward(model, torch.from_numpy(x), tta=4)
    for k in ("np", "hv", "tp"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=5e-4,
                                   rtol=1e-3, err_msg=k)


def test_fused_blocks_track_plain_blocks():
    """Stages 0-2 through K1 (its plain version here, bf16 inside) stay
    within bf16 rounding of the all-plain f32 forward."""
    jcfg, tcfg = _configs(False)
    sd = params_from_jax(_jax_params(jcfg, seed=5), tcfg)
    plain = _port_model(tcfg, sd)
    fused = HoverNeXt(tcfg).eval()
    fused.load_state_dict(sd)
    fused.encoder.fuse()
    x = torch.from_numpy(np.random.default_rng(6).uniform(0, 1, size=(1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        a, b = plain(x), fused(x)
    for k in a:
        span = float(a[k].max() - a[k].min()) or 1.0
        assert float((a[k] - b[k]).abs().max()) / span < 0.05, k
