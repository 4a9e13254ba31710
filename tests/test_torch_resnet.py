"""The port's ResNet34 and IDaRS ensemble against the JAX package's on the
CPU: the same flax variables (the JAX model's tree, drawn from a seed)
carried across by ``resnet_state_dict_from_jax``,
at ``ResNetConfig((1, 1, 1, 1), 2, 8)`` and at the ResNet34 depths
(3, 4, 6, 3) with width 8. f32 logits within atol 5e-4 / rtol 1e-3; bf16
P(class=1) against the jitted JAX bf16 forward within BF16_PROB_ATOL (XLA
keeps some fused intermediates in f32, so the two bf16 forwards round in
other places). The ensemble equals its models run one by one (atol
1e-5, as the JAX package's ``test_ensemble_matches_individual``); the
torchvision names convert back to the JAX variables exactly through
JAX's ``convert_resnet34``; the
checkpoint loaders load strict and name a key they do not consume."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_gene_multimodal_tpu.core.checkpoints import save_converted
from path_gene_multimodal_tpu.models.resnet import ResNet as JResNet
from path_gene_multimodal_tpu.models.resnet import ResNetConfig as JResNetConfig
from path_gene_multimodal_tpu.models.weights_resnet import convert_resnet34 as j_convert
from path_gene_multimodal_tpu_torch.core.checkpoints import load_converted, load_resnet_from_torch
from path_gene_multimodal_tpu_torch.models.resnet import (
    IDaRSEnsemble,
    ResNet,
    ResNetConfig,
    seeded_resnet,
)
from path_gene_multimodal_tpu_torch.models.weights_resnet import (
    infer_resnet_config,
    resnet_state_dict_from_jax,
)

ATOL, RTOL = 5e-4, 1e-3
# bf16 port against bf16 JAX under jit, on P(class=1): ~1.1e-3 seen at the
# ResNet34 depths with p near 0.56, where dp/dlogit is largest
BF16_PROB_ATOL = 5e-3
SHAPES = {"small": ((1, 1, 1, 1), 8), "resnet34_w8": ((3, 4, 6, 3), 8)}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_variables(stages, width, seed=0):
    """Variables of the JAX ``ResNet``'s own tree (its shapes from
    ``jax.eval_shape`` of flax's init), drawn with numpy from ``seed``:
    kernels N(0, 1 / fan_in), BatchNorm vectors and statistics off flax's
    1 / 0 so that the check sees them."""
    shapes = jax.eval_shape(JResNet(JResNetConfig(stages, 2, width)).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.float32))
    rng = np.random.default_rng(seed)

    def draw(kp, leaf):
        name, shape = str(kp[-1]), leaf.shape
        if "kernel" in name:
            a = rng.normal(0, 1, shape) / np.sqrt(np.prod(shape[:-1]))
        elif "var" in name:
            a = rng.uniform(0.5, 1.5, shape)
        elif "scale" in name:
            a = rng.normal(1, 0.1, shape)
        else:  # biases and means
            a = rng.normal(0, 0.1, shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def pixels():
    return np.random.default_rng(5).normal(size=(2, 224, 224, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(SHAPES))
def pair(request):
    stages, width = SHAPES[request.param]
    v = _jax_variables(stages, width)
    cfg = ResNetConfig(stages, 2, width)
    return v, cfg, JResNetConfig(stages, 2, width)


def _port(sd, cfg, dtype):
    net = ResNet(cfg, dtype)
    net.load_state_dict(sd, strict=True)
    return net.eval()


def test_resnet_f32_matches_jax(pair, pixels):
    v, cfg, jcfg = pair
    ref = np.asarray(jax.jit(JResNet(jcfg, dtype=jnp.float32).apply)(v, jnp.asarray(pixels)))
    with torch.no_grad():
        got = _port(resnet_state_dict_from_jax(v, cfg), cfg, torch.float32)(
            torch.from_numpy(pixels)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_resnet_bf16_probabilities_match_jax(pair, pixels):
    v, cfg, jcfg = pair
    logits = jax.jit(JResNet(jcfg, dtype=jnp.bfloat16).apply)(v, jnp.asarray(pixels))
    ref = np.asarray(jax.nn.softmax(logits.astype(jnp.float32), axis=-1)[:, 1])
    with torch.no_grad():
        out = _port(resnet_state_dict_from_jax(v, cfg), cfg, torch.bfloat16)(
            torch.from_numpy(pixels))
    assert out.dtype == torch.bfloat16
    got = torch.softmax(out.float(), dim=-1)[:, 1].numpy()
    assert np.abs(got - ref).max() <= BF16_PROB_ATOL


def test_torchvision_names_convert_back_exactly(pair):
    v, cfg, _ = pair
    sd = resnet_state_dict_from_jax(v, cfg)
    assert set(sd) == set(ResNet(cfg).state_dict())
    assert infer_resnet_config(v) == cfg
    back = j_convert({f"module.{k}": t.numpy() for k, t in sd.items()}, JResNetConfig(
        cfg.stage_sizes, cfg.num_classes, cfg.width))
    jax.tree.map(np.testing.assert_array_equal, back, v)


def test_ensemble_matches_individual():
    cfg = ResNetConfig((1, 1, 1, 1), 2, 8)
    ens = IDaRSEnsemble(["a", "b"], cfg=cfg, dtype=torch.float32, seed=3, device="cpu")
    tiles = np.random.default_rng(1).integers(0, 256, (2, 224, 224, 3), dtype=np.uint8)
    out = ens(tiles)
    assert out.shape == (2, 2) and out.dtype == torch.float32
    assert ((out >= 0) & (out <= 1)).all()
    for ti in range(2):
        one = IDaRSEnsemble(["x"], [ens.models[ti].state_dict()], cfg=cfg,
                            dtype=torch.float32, device="cpu")
        np.testing.assert_allclose(one(tiles)[0].numpy(), out[ti].numpy(), atol=1e-5)
    # other seeds, other models
    assert not torch.equal(ens.models[0].conv1.weight, ens.models[1].conv1.weight)


def test_ensemble_matches_jax_ensemble():
    from path_gene_multimodal_tpu.models.resnet import IDaRSEnsemble as JEnsemble

    stages, width = SHAPES["small"]
    vs = [_jax_variables(stages, width, seed=s) for s in (1, 2)]
    cfg = ResNetConfig(stages, 2, width)
    tiles = np.random.default_rng(2).integers(0, 256, (3, 224, 224, 3), dtype=np.uint8)
    ref = np.asarray(JEnsemble(["msi", "hm"], vs, cfg=JResNetConfig(stages, 2, width),
                               dtype=jnp.float32)(jnp.asarray(tiles)))
    got = IDaRSEnsemble(["msi", "hm"], [resnet_state_dict_from_jax(v, cfg) for v in vs],
                        cfg=cfg, dtype=torch.float32, device="cpu")(tiles).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_torchvision_checkpoint_loads_strict(tmp_path):
    cfg = ResNetConfig((1, 1, 1, 1), 2, 8)
    sd = seeded_resnet(cfg, 4, device="cpu").state_dict()
    ckpt = {f"module.{k}": t for k, t in sd.items() if not k.endswith("num_batches_tracked")}
    torch.save(ckpt, tmp_path / "idars.pth")
    got_cfg, got = load_resnet_from_torch(tmp_path / "idars.pth")
    assert got_cfg == cfg
    assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    ckpt["module.head.weight"] = torch.zeros(3)
    torch.save(ckpt, tmp_path / "extra.pth")
    with pytest.raises(ValueError, match="head.weight"):
        load_resnet_from_torch(tmp_path / "extra.pth")


def test_load_converted_reads_jax_artifact(tmp_path):
    stages, width = SHAPES["small"]
    v = _jax_variables(stages, width, seed=7)
    path = save_converted("resnet34", None, v, tmp_path / "msi")
    kind, cfg, variables = load_converted(path)
    assert kind == "resnet34" and cfg is None
    jax.tree.map(np.testing.assert_array_equal, variables, v)
    sd = resnet_state_dict_from_jax(variables, infer_resnet_config(variables))
    ResNet(ResNetConfig(stages, 2, width)).load_state_dict(sd, strict=True)
