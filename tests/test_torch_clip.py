"""The port's CLIP vision tower against the JAX package's: the state-dict
round trip through ``convert_clip_vision``, f32 parity (atol 5e-4, rtol
1e-3), bf16 cosine >= 0.999 per tile, the bf16 rounding points (the
tower's bf16 forward equal to flax's bit for bit on the same normalized
pixels; mutants of the attention's rounding are not), and the non-224
resize in both directions. Small towers (width 64, 2 layers, 32-px
images; registers with ``cls+mean`` pooling) and one at ViT-B/16's widths
with 2 layers and 2 tiles."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from path_gene_multimodal_tpu.models import clip as jclip
from path_gene_multimodal_tpu.models.weights import convert_clip_vision
from path_gene_multimodal_tpu_torch.models import clip as tclip
from path_gene_multimodal_tpu_torch.models import layers
from path_gene_multimodal_tpu_torch.models.weights_clip import vision_state_dict_from_jax

CONFIGS = {
    "small": dict(image_size=32, patch_size=16, width=64, layers=2, heads=2, out_dim=24),
    "registers": dict(image_size=28, patch_size=14, width=64, layers=2, heads=2, out_dim=None,
                      num_registers=4, use_quick_gelu=False, pool="cls+mean"),
    "b16": dict(layers=2),
}
N_TILES = {"small": 3, "registers": 3, "b16": 2}


def _cosine_min(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))).min())


def _jax_params(jcfg, seed=0):
    """Seeded values in the JAX tower's parameter tree (its shapes from
    ``eval_shape``): kernels N(0, 1/fan_in), LayerNorm scales around 1 and
    every other vector around 0, so that the parity sees each of them."""
    s = jcfg.image_size
    shapes = jax.eval_shape(jclip.VisionTower(jcfg, dtype=jnp.float32).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if leaf.ndim == 1 or name.endswith("['cls_token']"):
            base = 1.0 if name.endswith("['scale']") else 0.0
            return (base + rng.normal(0, 0.05, leaf.shape)).astype(np.float32)
        if name.endswith(("['pos_embed']", "['register_tokens']")):
            return rng.normal(0, 0.02, leaf.shape).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return rng.normal(0, fan_in ** -0.5, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


_CACHE: dict = {}


def _setup(name):
    if name not in _CACHE:
        jcfg, tcfg = jclip.VisionConfig(**CONFIGS[name]), tclip.VisionConfig(**CONFIGS[name])
        params = _jax_params(jcfg)
        _CACHE[name] = jcfg, tcfg, params, vision_state_dict_from_jax(params, tcfg)
    return _CACHE[name]


def _tiles(cfg, n, seed=1, size=None):
    s = size or cfg.image_size
    return np.random.default_rng(seed).integers(0, 256, (n, s, s, 3), dtype=np.uint8)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_state_dict_round_trip(name):
    """The port's state dict has exactly the tower's keys, and the JAX
    converter reads it back to the JAX tree: equal leaves, no missing or
    extra keys (register tokens, which the OpenAI layout has not, travel
    as ``visual.register_tokens``)."""
    jcfg, tcfg, params, sd = _setup(name)
    assert set(sd) == set(tclip.VisionTower(tcfg).state_dict())
    back = convert_clip_vision({k: v.numpy() for k, v in sd.items()}, jcfg)["params"]
    want = dict(params["params"])
    if tcfg.num_registers:
        np.testing.assert_array_equal(sd["visual.register_tokens"].numpy(),
                                      want.pop("register_tokens"))
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_back] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_back, flat_want):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encoder_f32_parity(name):
    jcfg, tcfg, params, sd = _setup(name)
    tiles = _tiles(jcfg, N_TILES[name])
    ref = np.asarray(jclip.ImageEncoder(jcfg, params=params, dtype=jnp.float32)(tiles))
    got = tclip.ImageEncoder(tcfg, state_dict=sd, dtype=torch.float32, device="cpu")(tiles)
    assert got.dtype == torch.float32 and got.shape == (len(tiles), ref.shape[1])
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encoder_bf16_cosine(name):
    """bf16 encoders, uint8 tiles in. The JAX encoder's jit computes
    x / 255 and / std as products by reciprocals (XLA on the CPU), so a
    few pixels differ in their last f32 bit and some bf16 roundings of the
    input flip: the bar is cosine >= 0.999 per tile."""
    jcfg, tcfg, params, sd = _setup(name)
    tiles = _tiles(jcfg, N_TILES[name], seed=2)
    ref = np.asarray(jclip.ImageEncoder(jcfg, params=params, dtype=jnp.bfloat16)(tiles))
    got = tclip.ImageEncoder(tcfg, state_dict=sd, device="cpu")(tiles)
    assert got.dtype == torch.float32
    assert _cosine_min(got.numpy(), ref) >= 0.999


class _ScaledLogits(layers.MultiHeadAttention):
    """Mutant: scales the f32 logits instead of q."""

    def forward(self, x, mask=None):
        b, n, d = x.shape
        h, hd, dt = self.num_heads, x.shape[-1] // self.num_heads, self.dtype
        q, k, v = layers.dense(x, self.in_proj_weight, self.in_proj_bias, dt).view(
            b, n, 3, h, hd).permute(2, 0, 3, 1, 4)
        probs = torch.softmax(layers._logits(q, k) * hd ** -0.5, dim=-1).to(dt)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, n, d)
        return layers.dense(out, self.out_proj.weight, self.out_proj.bias, dt)


class _F32Probs(layers.MultiHeadAttention):
    """Mutant: keeps the probabilities in f32 for PV."""

    def forward(self, x, mask=None):
        b, n, d = x.shape
        h, hd, dt = self.num_heads, x.shape[-1] // self.num_heads, self.dtype
        q, k, v = layers.dense(x, self.in_proj_weight, self.in_proj_bias, dt).view(
            b, n, 3, h, hd).permute(2, 0, 3, 1, 4)
        probs = torch.softmax(layers._logits(q * layers._rounded(hd ** -0.5, dt), k), dim=-1)
        out = torch.matmul(probs, v.float()).to(dt).transpose(1, 2).reshape(b, n, d)
        return layers.dense(out, self.out_proj.weight, self.out_proj.bias, dt)


@pytest.mark.parametrize("name", ["small", "registers"])
def test_bf16_rounding_points(name):
    """On the same normalized pixels the bf16 tower equals flax's bf16
    tower run op by op in (nearly) every output: the patch embed and dense
    products (bf16 operands, f32 accumulation, bias added in bf16), the
    LayerNorms (f32 statistics, one rounding), ``x + pos`` in bf16, q
    scaled in bf16 before QK^T, f32 logits, bf16 probabilities, the
    activations step by step in bf16. Attention mutants that round
    elsewhere fall far below. (Under jit, XLA on the CPU may keep a
    fusion's intermediates in f32 and skip their bf16 roundings, so the
    jitted encoder is held by the cosine bar instead.)"""
    jcfg, tcfg, params, sd = _setup(name)
    s = jcfg.image_size
    pixels = np.random.default_rng(3).normal(size=(2, s, s, 3)).astype(np.float32)
    ref = np.asarray(jclip.VisionTower(jcfg, dtype=jnp.bfloat16).apply(
        params, jnp.asarray(pixels)).astype(jnp.float32))

    def agree(attn_cls=None):
        tower = tclip.VisionTower(tcfg, dtype=torch.bfloat16)
        tower.load_state_dict(sd)
        if attn_cls is not None:
            for blk in tower.visual.transformer.resblocks:
                mut = attn_cls(tcfg.width, tcfg.heads, torch.bfloat16)
                mut.load_state_dict(blk.attn.state_dict())
                blk.attn = mut
        with torch.no_grad():
            out = tower(torch.from_numpy(pixels)).float().numpy()
        return float((out == ref).mean())

    assert agree() >= 0.99
    assert agree(_ScaledLogits) < 0.9
    assert agree(_F32Probs) < 0.9


@pytest.mark.parametrize("size", [24, 45], ids=["upsample", "downsample"])
def test_resize_matches_jax(size):
    """Tiles that are not the model's input size: the triangle filter of
    ``jax.image.resize(..., "bilinear")`` (antialiased when shrinking)
    within f32 rounding, and the f32 encoders within the f32 bars."""
    jcfg, tcfg, params, sd = _setup("small")
    x = np.random.default_rng(4).normal(size=(2, size, size, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 32, 32, 3), "bilinear"))
    got = tclip.resize_bilinear(torch.from_numpy(x), 32).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    tiles = _tiles(jcfg, 2, seed=5, size=size)
    ref = np.asarray(jclip.ImageEncoder(jcfg, params=params, dtype=jnp.float32)(tiles))
    got = tclip.ImageEncoder(tcfg, state_dict=sd, dtype=torch.float32, device="cpu")(tiles)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-4, rtol=1e-3)


def test_out_dim_and_presets():
    assert tclip.CLIP_VIT_B16 == tclip.VisionConfig()
    for name in ("CLIP_VIT_B16", "CLIP_VIT_B32", "CLIP_VIT_L14", "VIRCHOW2"):
        j, t = getattr(jclip, name), getattr(tclip, name)
        assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
            {f: getattr(j, f) for f in j.__dataclass_fields__}, name
    small = tclip.ImageEncoder(tclip.VisionConfig(**CONFIGS["registers"]), device="cpu")
    assert small.out_dim == 128
    np.testing.assert_array_equal(tclip.CLIP_MEAN, jclip.CLIP_MEAN)
    np.testing.assert_array_equal(tclip.CLIP_STD, jclip.CLIP_STD)
