"""The final stage the port's nuclei stage builds, against the JAX package's.

On an accelerator the JAX nuclei stage runs a bf16 model through
``hovernext_forward(..., fused_blocks=True)``, whose default final stage is
the composite-weight low-res one (``fused_final="lowres"``); an f32 model
runs the flax module (``model.apply``), the plain resize path. The port's
``NucleiModel.build`` follows both, and its bf16 forward stays within bf16
rounding of ``hovernext_forward`` with the Pallas blocks in interpret mode,
at the small configuration of ``tests/test_torch_hovernext.py``. Inputs come
from numpy with a seed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from path_gene_multimodal_tpu.models import hovernext_fn as jfn
from path_gene_multimodal_tpu_torch.models.weights_hovernext import params_from_jax
from path_gene_multimodal_tpu_torch.pipeline.nuclei import NucleiModel
from test_torch_hovernext import _configs, _jax_params


@pytest.fixture(scope="module")
def params():
    """JAX parameters of the small configuration, GRN randomised."""
    return _jax_params(_configs(False)[0], seed=9)


def _build(tcfg, params, dtype):
    return NucleiModel.build(tcfg, state_dict=params_from_jax(params, tcfg), dtype=dtype,
                             device="cpu")


@pytest.mark.parametrize("dtype, final", [(torch.bfloat16, "lowres"), (torch.float32, False)],
                         ids=["bf16", "f32"])
def test_build_takes_the_jax_final_stage_for_its_dtype(params, dtype, final):
    """bf16: K1 blocks and ``"lowres"`` (JAX's ``hovernext_forward``); f32:
    plain blocks and the plain resize path (JAX's ``model.apply``)."""
    _, tcfg = _configs(False)
    model = _build(tcfg, params, dtype).model
    assert model.fused_final == final
    assert model.fused_decoder is False and model.lowres_decoder is False
    assert (model.fused_weights is not None) == (dtype == torch.bfloat16)
    assert next(model.parameters()).dtype == dtype


def test_bf16_forward_tracks_hovernext_forward_fused_blocks(params):
    """The bf16 port model (K1's plain version, ``"lowres"``) against JAX
    ``hovernext_forward(dtype=bf16, fused_blocks=True, interpret=True)``:
    max |port - jax| / span of jax < 0.05 per head, the bar of
    ``test_torch_hovernext.py::test_fused_blocks_track_plain_blocks`` (both
    sides round to bf16 at their own points, the Pallas block in its own
    order)."""
    jcfg, tcfg = _configs(False)
    model = _build(tcfg, params, torch.bfloat16).model
    x = np.random.default_rng(10).uniform(0, 1, size=(2, 64, 64, 3)).astype(np.float32)
    ref = jfn.hovernext_forward(params, jnp.asarray(x), jcfg, dtype=jnp.bfloat16,
                                fused_blocks=True, interpret=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for k in ("np", "hv", "tp"):
        r = np.asarray(ref[k], np.float32)
        g = got[k].float().numpy()
        assert g.shape == r.shape, k
        span = float(r.max() - r.min()) or 1.0
        assert float(np.abs(g - r).max()) / span < 0.05, k
