"""The port's torch → artifact converters and ``cli/convert_weights``
against the JAX package's, on the CPU at narrow widths.

Every checkpoint is a torch file of seeded numpy draws under the keys and
shapes of a small model: a transformers ``CLIPModel`` (vision + text) and
the OpenAI naming (the port's towers' own ``state_dict()``), a timm ViT
with registers, SwiGLU and LayerScale, the canonical and the published
HoverNeXt layouts, FCMAE- and timm-named ConvNeXtV2 encoders, and an IDaRS
ResNet34 at width 8. Bars, all exact:

- each converter's tree equals the JAX converter's on the same state dict:
  the same paths, every leaf bit for bit (dtype and bytes), the same
  consumed / leftover key sets and the same config;
- the port's ``convert_weights`` writes, for every kind, an ``.npz`` with
  the JAX CLI's keys, meta record and arrays; each package's
  ``load_converted`` reads the other's artifact to equal kind, config and
  arrays;
- strict mode refuses an extra key with the JAX package's message, and
  ``--lenient`` warns and writes;
- the artifact the port writes drives the port's models (through the
  ``*_from_jax`` maps) to the same outputs as the JAX artifact of the same
  checkpoint.
"""

import dataclasses
import logging
import os

import jax
import numpy as np
import pytest
import torch

from path_gene_multimodal_tpu.cli import convert_weights as jcw
from path_gene_multimodal_tpu.core import checkpoints as jck
from path_gene_multimodal_tpu.models import weights as jw
from path_gene_multimodal_tpu.models import weights_convnext as jwc
from path_gene_multimodal_tpu.models import weights_hovernext as jwh
from path_gene_multimodal_tpu.models import weights_hovernext_real as jwr
from path_gene_multimodal_tpu.models import weights_resnet as jwres
from path_gene_multimodal_tpu_torch.cli import convert_weights as tcw
from path_gene_multimodal_tpu_torch.config import ConvNeXtConfig, HoverNeXtConfig
from path_gene_multimodal_tpu_torch.core import checkpoints as tck
from path_gene_multimodal_tpu_torch.models import weights as tw
from path_gene_multimodal_tpu_torch.models import weights_convnext as twc
from path_gene_multimodal_tpu_torch.models import weights_hovernext as twh
from path_gene_multimodal_tpu_torch.models import weights_hovernext_real as twr
from path_gene_multimodal_tpu_torch.models import weights_resnet as twres
from path_gene_multimodal_tpu_torch.models import weights_vit_timm as twt
from path_gene_multimodal_tpu_torch.models.clip import TextConfig, TextTower, VisionConfig, VisionTower
from path_gene_multimodal_tpu_torch.models.convnext import ConvNeXtV2, TimmConvNeXtV2
from path_gene_multimodal_tpu_torch.models.hovernext import HoverNeXt
from path_gene_multimodal_tpu_torch.models.resnet import ResNet, ResNetConfig
from path_gene_multimodal_tpu_torch.models.vit_timm import TimmViT, TimmViTConfig
from path_gene_multimodal_tpu_torch.models.weights_clip import (
    text_state_dict_from_jax,
    vision_state_dict_from_jax,
)
from path_gene_multimodal_tpu_torch.utils.log import get_logger

ENC = ConvNeXtConfig(depths=(1, 1, 2, 1), dims=(8, 16, 24, 32))
HOVER = HoverNeXtConfig(encoder=ENC, decoder_dims=(24, 16, 8, 8), input_size=64)
VISION = VisionConfig(image_size=32, patch_size=16, width=64, layers=2, heads=1, out_dim=24)
TEXT = TextConfig(vocab_size=100, context_length=16, width=64, layers=2, heads=1, out_dim=24)
TIMM = TimmViTConfig(image_size=28, patch_size=14, width=64, layers=2, heads=1,
                     num_registers=4, mlp_hidden=256)
RESNET = ResNetConfig((3, 4, 6, 3), 2, 8)  # the JAX loader converts at ResNet34 depths


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _draw(keys_shapes: dict, seed: int) -> dict[str, torch.Tensor]:
    """Seeded N(0, 0.1) draws under the given keys and shapes (int64
    counters stay 0), as torch tensors."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in keys_shapes.items():
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.int64)
        elif k.endswith("running_var"):
            out[k] = torch.from_numpy(np.asarray(rng.random(shape) + 0.5, np.float32))
        else:
            out[k] = torch.from_numpy(np.asarray(rng.standard_normal(shape) * 0.1, np.float32))
    return out


def _shapes(module: torch.nn.Module, prefix: str = "") -> dict:
    return {prefix + k: tuple(v.shape) for k, v in module.state_dict().items()}


def _hf_clip_shapes() -> dict:
    os.environ.setdefault("USE_TF", "0")  # the torch model only: halves the import
    transformers = pytest.importorskip("transformers")
    cfg = transformers.CLIPConfig(
        text_config=dict(vocab_size=100, hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=1,
                         max_position_embeddings=16, projection_dim=24),
        vision_config=dict(hidden_size=64, intermediate_size=256, num_hidden_layers=2,
                           num_attention_heads=1, image_size=32, patch_size=16,
                           projection_dim=24),
        projection_dim=24,
    )
    return _shapes(transformers.CLIPModel(cfg))


# kind, state-dict shapes and the JAX / port converters of each checkpoint
CHECKPOINTS = {
    "clip_hf": ("clip", _hf_clip_shapes),
    "clip_openai": ("clip", lambda: {**_shapes(VisionTower(VISION)), **_shapes(TextTower(TEXT))}),
    "virchow2": ("virchow2", lambda: _shapes(TimmViT(TIMM))),
    "hovernext": ("hovernext", lambda: _shapes(HoverNeXt(HOVER))),
    "hovernext_real": ("hovernext", None),  # synthesize_real_state_dict
    "convnext_fcmae": ("convnext", lambda: _shapes(ConvNeXtV2(ENC))),
    "convnext_timm": ("convnext", lambda: _shapes(TimmConvNeXtV2(ENC))),
    "resnet34": ("resnet34", lambda: _shapes(ResNet(RESNET))),
}


def _state_dict(name: str) -> dict[str, torch.Tensor]:
    if name == "hovernext_real":
        return {k: torch.from_numpy(np.asarray(v))
                for k, v in twr.synthesize_real_state_dict(seed=3).items()}
    return _draw(CHECKPOINTS[name][1](), seed=sorted(CHECKPOINTS).index(name))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpts")
    out = {}
    for name in CHECKPOINTS:
        sd = _state_dict(name)
        torch.save(sd, d / f"{name}.pt")
        out[name] = (d / f"{name}.pt", sd)
    return out


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _assert_trees_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert g[k].tobytes() == w[k].tobytes(), k


def _cfg(cfg):
    """A config as (class name, fields): the two packages' classes differ."""
    return None if cfg is None else (type(cfg).__name__, dataclasses.asdict(cfg))


def test_clip_converters_equal_jax(ckpts):
    for name in ("clip_hf", "clip_openai"):
        sd = _numpy(ckpts[name][1])
        for infer, conv, jinfer, jconv in (
                (tw.infer_vision_config, tw.convert_clip_vision,
                 jw.infer_vision_config, jw.convert_clip_vision),
                (tw.infer_text_config, tw.convert_clip_text,
                 jw.infer_text_config, jw.convert_clip_text)):
            cfg, jcfg = infer(sd), jinfer(sd)
            assert _cfg(cfg) == _cfg(jcfg), name
            _assert_trees_equal(conv(sd, cfg), jconv(sd, jcfg))
        assert tw.infer_vision_config(sd).out_dim == 24


def test_timm_vit_converter_equals_jax(ckpts):
    sd = _numpy(ckpts["virchow2"][1])
    assert twt.is_timm_vit_layout(sd) and jw.is_timm_vit_layout(sd)
    cfg, p, left = twt.convert_timm_vit({f"module.{k}": v for k, v in sd.items()})
    jcfg, jp, jleft = jw.convert_timm_vit({f"module.{k}": v for k, v in sd.items()})
    assert _cfg(cfg) == _cfg(jcfg) and cfg.num_registers == 4
    assert cfg.mlp_type == "swiglu" and cfg.use_layerscale
    _assert_trees_equal(p, jp)
    assert left == {} and jleft == {}
    extra = dict(sd, **{"head.weight": np.zeros((3, 64), np.float32)})
    assert set(twt.convert_timm_vit(extra)[2]) == set(jw.convert_timm_vit(extra)[2]) == {
        "head.weight"}


def test_hovernext_converters_equal_jax(ckpts):
    sd = _numpy(ckpts["hovernext"][1])
    sd["aux.weight"] = np.ones(3, np.float32)
    cfg, p, left = twh.convert_hovernext(sd)
    jcfg, jp, jleft = jwh.convert_hovernext(sd)
    assert _cfg(cfg) == _cfg(jcfg)
    _assert_trees_equal(p, jp)
    assert set(left) == set(jleft) == {"aux.weight"}

    real = _numpy(ckpts["hovernext_real"][1])
    real["extra.bias"] = np.ones(2, np.float32)
    cfg, p, left = twr.convert_real_hovernext(real)
    jcfg, jp, jleft = jwr.convert_real_hovernext(real)
    assert _cfg(cfg) == _cfg(jcfg)
    _assert_trees_equal(p, jp)
    assert set(left) == set(jleft) == {"extra.bias"}


def test_convnext_and_resnet_converters_equal_jax(ckpts):
    fcmae = _numpy(ckpts["convnext_fcmae"][1])
    p, left = twc.convert_convnextv2({f"backbone.{k}": v for k, v in fcmae.items()})
    jp, jleft = jwc.convert_convnextv2({f"backbone.{k}": v for k, v in fcmae.items()})
    _assert_trees_equal(p, jp)
    assert left == jleft == {}
    timm = _numpy(ckpts["convnext_timm"][1])
    p, consumed = twr.convert_convnextv2_timm(timm)
    jp, jconsumed = jwr.convert_convnextv2_timm(timm)
    _assert_trees_equal(p, jp)
    assert consumed == jconsumed == set(timm)
    rn = _numpy(ckpts["resnet34"][1])
    _assert_trees_equal(twres.convert_resnet34({f"model.{k}": v for k, v in rn.items()}),
                        jwres.convert_resnet34({f"model.{k}": v for k, v in rn.items()}))


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", sorted(CHECKPOINTS))
def test_cli_artifacts_equal_jax_and_cross_read(ckpts, tmp_path, name):
    kind = CHECKPOINTS[name][0]
    src = ckpts[name][0]
    got = tcw.main([kind, str(src), str(tmp_path / "port" / "out.npz")])
    assert got == 0
    jax_written = jcw.convert(kind, src, tmp_path / "jax" / "out.npz")
    port_written = sorted((tmp_path / "port").iterdir())
    assert [p.name for p in port_written] == sorted(p.name for p in jax_written)
    for pp in port_written:
        jp = tmp_path / "jax" / pp.name
        a, b = _npz(pp), _npz(jp)
        assert list(a) == list(b)  # keys in the JAX flattening order
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
        # each package reads the other's artifact
        for load in (jck.load_converted, tck.load_converted):
            (ka, ca, va), (kb, cb, vb) = load(pp), load(jp)
            assert ka == kb and _cfg(ca) == _cfg(cb)
            _assert_trees_equal(va, vb)
        kt, ct, vt = tck.load_converted(jp)
        kj, cj, vj = jck.load_converted(jp)
        assert kt == kj and _cfg(ct) == _cfg(cj)
        jax.tree.map(np.testing.assert_array_equal, vt, vj)
    if kind == "clip":
        assert [p.name for p in port_written] == ["out.npz", "out_text.npz"]


def test_strict_refuses_extra_key_and_lenient_warns(ckpts, tmp_path):
    for name, extra in (("virchow2", "head.weight"), ("hovernext", "aux_head.weight"),
                        ("hovernext_real", "aux_head.weight"), ("convnext_fcmae", "head.weight")):
        kind = CHECKPOINTS[name][0]
        sd = dict(ckpts[name][1], **{extra: torch.ones(3, 3, 3, 3)})
        src = tmp_path / f"{name}_extra.pt"
        torch.save(sd, src)
        with pytest.raises(ValueError) as want:
            jcw.convert(kind, src, tmp_path / "j.npz")
        with pytest.raises(ValueError) as got:
            tcw.convert(kind, src, tmp_path / "t.npz")
        assert str(got.value) == str(want.value)
        assert (extra in str(got.value)) == (kind != "convnext")  # convnext counts them

        seen: list[str] = []
        handler = logging.Handler()
        handler.emit = lambda rec: seen.append(rec.getMessage())
        get_logger().addHandler(handler)
        try:
            assert tcw.main([kind, str(src), str(tmp_path / f"{name}_lenient.npz"),
                             "--lenient"]) == 0
        finally:
            get_logger().removeHandler(handler)
        assert any("(lenient)" in m for m in seen), seen
        jcw.convert(kind, src, tmp_path / f"{name}_jlenient.npz", lenient=True)
        a, b = _npz(tmp_path / f"{name}_lenient.npz"), _npz(tmp_path / f"{name}_jlenient.npz")
        assert list(a) == list(b) and all(a[k].tobytes() == b[k].tobytes() for k in b)


def test_port_artifact_drives_port_models_as_jax_artifact(ckpts, tmp_path):
    """The artifact the port writes and the JAX artifact of the same
    checkpoint give the port's models the same state dicts, equal to the
    checkpoint's, and the same outputs."""
    outs = {}
    for who, convert in (("port", tcw.convert), ("jax", jcw.convert)):
        convert("clip", ckpts["clip_openai"][0], tmp_path / who / "clip.npz")
        convert("hovernext", ckpts["hovernext"][0], tmp_path / who / "hov.npz")
        convert("convnext", ckpts["convnext_fcmae"][0], tmp_path / who / "enc.npz")
        _, vcfg, vp = tck.load_converted(tmp_path / who / "clip.npz")
        _, tcfg, tp = tck.load_converted(tmp_path / who / "clip_text.npz")
        _, hcfg, hp = tck.load_converted(tmp_path / who / "hov.npz")
        _, ecfg, ep = tck.load_converted(tmp_path / who / "enc.npz")
        outs[who] = {"vision": vision_state_dict_from_jax(vp, vcfg),
                     "text": text_state_dict_from_jax(tp, tcfg),
                     "hover": twh.params_from_jax(hp, hcfg),
                     "enc": twh.convnext_state_dict_from_jax(ep, ecfg)}
    ck = ckpts["clip_openai"][1]
    for part, names in (("vision", lambda k: k.startswith("visual.")),
                        ("text", lambda k: not k.startswith("visual."))):
        want = {k: v for k, v in ck.items() if names(k)}
        for who in ("port", "jax"):
            got = outs[who][part]
            assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    for part, want in (("hover", ckpts["hovernext"][1]), ("enc", ckpts["convnext_fcmae"][1])):
        for who in ("port", "jax"):
            got = outs[who][part]
            assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)

    x = torch.from_numpy(np.random.default_rng(5).random((2, 64, 64, 3), np.float32))
    res = {}
    for who in ("port", "jax"):
        net = HoverNeXt(HOVER)
        net.load_state_dict(outs[who]["hover"])
        vis = VisionTower(VISION)
        vis.load_state_dict(outs[who]["vision"])
        with torch.no_grad():
            res[who] = (net.eval()(x)["np"], vis.eval()(x[:, :32, :32]))
    for a, b in zip(res["port"], res["jax"]):
        assert torch.equal(a, b)
