"""The published hover_next checkpoint layout → ``RealHoverNeXtConfig`` and
the port's ``RealHoverNeXt`` state dict.

Copies of the JAX package's ``models/weights_hovernext_real.py``
(``infer_real_config``, ``_discover_decoders``, ``_discover_heads``,
``_pair_branches``, ``synthesize_real_state_dict``, and the converters to
its flax layout, ``convert_convnextv2_timm`` and ``convert_real_hovernext``,
whose trees ``cli/convert_weights`` writes), plus what the port needs
beside them:

- ``normalize_real_state_dict``: a checkpoint's keys → the port's names.
  It strips a ``module.`` or ``model.`` wrapper, maps the bare ``encoder.``
  timm naming and the official FCMAE ``encoder.downsample_layers.*``
  naming onto ``encoder.model.*``, and renames each decoder and head
  prefix to its sanitised branch name (dots made underscores). A key it
  does not recognise keeps its name, so a strict load names it;
- ``real_state_dict_from_jax``: the JAX ``RealHoverNeXt`` parameters (numpy)
  → the port's state dict, the inverse of ``convert_real_hovernext``.

The expected naming (smp/timm): ``encoder.model.stem.{0,1}``,
``encoder.model.stages.S.downsample.{0,1}`` (S >= 1),
``encoder.model.stages.S.blocks.B.{conv_dw,norm,mlp.fc1,mlp.grn,mlp.fc2}``
(GRN vectors (4C,)), ``<decoder>.blocks.N.conv{1,2}.{0,1}.*`` (Conv3x3
without bias + BatchNorm2d with ``running_mean``, ``running_var`` and
``num_batches_tracked``), ``<head>.0.{weight,bias}``. Branches pair
decoders with heads by name suffix, by position otherwise; one decoder
feeds every head.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from path_gene_multimodal_tpu_torch.config import ConvNeXtConfig, RealHoverNeXtConfig
from path_gene_multimodal_tpu_torch.models.weights import _np
from path_gene_multimodal_tpu_torch.models.weights_convnext import (
    _take_conv,
    _take_dense,
    _take_ln,
    convert_convnextv2,
    infer_convnext_config,
    infer_convnext_config_timm,
)
from path_gene_multimodal_tpu_torch.models.weights_hovernext import _conv, _dense, _ln, _t

ENC = "encoder.model."


def _sanitize(prefix: str) -> str:
    return prefix.replace(".", "_")


def _discover_decoders(sd: Mapping[str, np.ndarray]) -> list[str]:
    pat = re.compile(r"^(.+?)\.blocks\.\d+\.conv1\.0\.weight$")
    return sorted({m.group(1) for k in sd if (m := pat.match(k))})


def _discover_heads(sd: Mapping[str, np.ndarray], decoder_prefixes: list[str]) -> list[str]:
    pat = re.compile(r"^(.+?)\.0\.weight$")
    heads = []
    for k, v in sd.items():
        m = pat.match(k)
        if not m:
            continue
        p = m.group(1)
        if p.startswith("encoder") or any(
            p == d or p.startswith(d + ".") for d in decoder_prefixes
        ):
            continue
        if np.ndim(v) == 4:
            heads.append(p)
    return sorted(set(heads))


def _pair_branches(decoders: list[str], heads: list[str]) -> list[tuple[str, str]]:
    """(decoder, head) per branch — suffix-matched when possible."""
    if not decoders or not heads:
        raise ValueError(f"decoders={decoders}, heads={heads}: need ≥1 of each")
    if len(decoders) == 1:
        return [(decoders[0], h) for h in heads]

    def suffix(name: str) -> str:
        return re.split(r"[._]", name)[-1]

    pairs = []
    used = set()
    for h in heads:
        match = [d for d in decoders if suffix(d) == suffix(h)]
        if len(match) == 1:
            pairs.append((match[0], h))
            used.add(match[0])
        else:
            pairs.append((None, h))
    leftovers = [d for d in decoders if d not in used]
    fixed = []
    for d, h in pairs:
        if d is None:
            if not leftovers:
                raise ValueError(
                    f"cannot pair head '{h}' with a decoder (decoders={decoders}, heads={heads})"
                )
            d = leftovers.pop(0)
        fixed.append((d, h))
    return fixed


def _strip_wrapper(sd: Mapping) -> dict:
    sd = dict(sd)
    for prefix in ("module.", "model."):
        if any(k.startswith(prefix + "encoder.") for k in sd):
            sd = {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}
    return sd


def _encoder_cfg(sd: Mapping[str, np.ndarray]) -> ConvNeXtConfig:
    for prefix in ("encoder.model.", "encoder."):
        sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        if "stem.0.weight" in sub:  # timm naming
            return infer_convnext_config_timm(sub)
        if "downsample_layers.0.0.weight" in sub:  # official FCMAE naming
            return infer_convnext_config(sub)
    raise ValueError(
        "no encoder found: expected 'encoder.model.stem.0.weight' (timm), "
        "'encoder.stem.0.weight', or 'encoder.downsample_layers.0.0.weight' (FCMAE) keys"
    )


def infer_real_config(sd: Mapping[str, np.ndarray], input_size: int = 256) -> RealHoverNeXtConfig:
    """The architecture from a (wrapper-stripped) checkpoint's shapes."""
    enc_cfg = _encoder_cfg(sd)
    decoders = _discover_decoders(sd)
    heads = _discover_heads(sd, decoders)
    pairs = _pair_branches(decoders, heads)
    d0 = decoders[0]
    channels = []
    i = 0
    while f"{d0}.blocks.{i}.conv2.0.weight" in sd:
        channels.append(int(np.shape(sd[f"{d0}.blocks.{i}.conv2.0.weight"])[0]))
        i += 1
    branches = tuple(
        (_sanitize(d), _sanitize(h), int(np.shape(sd[f"{h}.0.weight"])[0])) for d, h in pairs
    )
    return RealHoverNeXtConfig(
        encoder=enc_cfg, decoder_channels=tuple(channels), branches=branches,
        input_size=input_size,
    )


# FCMAE block names → timm's
_FCMAE_BLOCK = {"dwconv": "conv_dw", "norm": "norm", "pwconv1": "mlp.fc1",
                "pwconv2": "mlp.fc2", "grn.gamma": "mlp.grn.weight", "grn.beta": "mlp.grn.bias"}


def _fcmae_to_timm(key: str, v):
    """One FCMAE encoder key (without ``encoder.``) → (timm key, value), or
    None for a key outside the layout."""
    m = re.fullmatch(r"downsample_layers\.(\d+)\.([01])\.(weight|bias)", key)
    if m:
        s, i, leaf = m.groups()
        if s == "0":
            return f"stem.{i}.{leaf}", v
        return f"stages.{s}.downsample.{i}.{leaf}", v
    m = re.fullmatch(r"stages\.(\d+)\.(\d+)\.(dwconv|norm|pwconv1|pwconv2|grn)\.(\w+)", key)
    if m:
        s, b, mod, leaf = m.groups()
        if mod == "grn" and leaf in ("gamma", "beta"):
            return f"stages.{s}.blocks.{b}.{_FCMAE_BLOCK['grn.' + leaf]}", np.reshape(v, -1)
        if mod != "grn" and leaf in ("weight", "bias"):
            return f"stages.{s}.blocks.{b}.{_FCMAE_BLOCK[mod]}.{leaf}", v
    return None


def normalize_real_state_dict(
    sd: Mapping[str, np.ndarray], input_size: int = 256
) -> tuple[RealHoverNeXtConfig, dict[str, np.ndarray]]:
    """A published-layout checkpoint (numpy values) → (config, the same
    arrays under ``RealHoverNeXt``'s state-dict names). A missing
    ``num_batches_tracked`` is filled with 0 (the JAX converter consumes
    it only when present); a key outside the layout keeps its name."""
    sd = _strip_wrapper(sd)
    cfg = infer_real_config(sd, input_size=input_size)
    decoders = _discover_decoders(sd)
    heads = _discover_heads(sd, decoders)
    renames = sorted(((p + ".", _sanitize(p) + ".") for p in decoders + heads),
                     key=lambda r: -len(r[0]))
    fcmae = any(k.startswith("encoder.downsample_layers.") for k in sd)
    out: dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if k.startswith(ENC):
            out[k] = v
        elif k.startswith("encoder."):
            sub = k[len("encoder."):]
            hit = _fcmae_to_timm(sub, v) if fcmae else (sub, v)
            if hit is None:
                out[k] = v
            else:
                out[ENC + hit[0]] = hit[1]
        else:
            new = next((n + k[len(o):] for o, n in renames if k.startswith(o)), k)
            out[new] = v
    for dec in {_sanitize(d) for d in decoders}:
        for i in range(len(cfg.decoder_channels)):
            for j in (1, 2):
                key = f"{dec}.blocks.{i}.conv{j}.1.num_batches_tracked"
                if f"{dec}.blocks.{i}.conv{j}.1.running_mean" in out and key not in out:
                    out[key] = np.asarray(0, np.int64)
    return cfg, out


def synthesize_real_state_dict(
    depths: tuple[int, ...] = (1, 1, 1, 1),
    dims: tuple[int, ...] = (8, 16, 32, 64),
    decoder_channels: tuple[int, ...] = (16, 8, 8, 8),
    branch_channels: Mapping[str, int] | None = None,
    seed: int = 0,
    scale: float = 0.1,
) -> dict[str, np.ndarray]:
    """A random state dict in the published smp/timm naming, numpy only:
    the same draws from ``default_rng(seed)`` in the same order as the JAX
    package's, so the arrays are equal byte for byte."""
    if branch_channels is None:
        branch_channels = {"inst": 5, "ct": 6}
    rng = np.random.default_rng(seed)
    sd: dict[str, np.ndarray] = {}

    def w(key: str, *shape: int) -> None:
        sd[key] = (rng.standard_normal(shape) * scale).astype(np.float32)

    e = ENC
    w(e + "stem.0.weight", dims[0], 3, 4, 4)
    w(e + "stem.0.bias", dims[0])
    w(e + "stem.1.weight", dims[0])
    w(e + "stem.1.bias", dims[0])
    for s, (depth, dim) in enumerate(zip(depths, dims)):
        if s > 0:
            w(e + f"stages.{s}.downsample.0.weight", dims[s - 1])
            w(e + f"stages.{s}.downsample.0.bias", dims[s - 1])
            w(e + f"stages.{s}.downsample.1.weight", dim, dims[s - 1], 2, 2)
            w(e + f"stages.{s}.downsample.1.bias", dim)
        for b in range(depth):
            t = e + f"stages.{s}.blocks.{b}."
            w(t + "conv_dw.weight", dim, 1, 7, 7)
            w(t + "conv_dw.bias", dim)
            w(t + "norm.weight", dim)
            w(t + "norm.bias", dim)
            w(t + "mlp.fc1.weight", 4 * dim, dim)
            w(t + "mlp.fc1.bias", 4 * dim)
            w(t + "mlp.grn.weight", 4 * dim)
            w(t + "mlp.grn.bias", 4 * dim)
            w(t + "mlp.fc2.weight", dim, 4 * dim)
            w(t + "mlp.fc2.bias", dim)

    in_chs = [dims[-1]] + list(decoder_channels[:-1])
    skip_chs = [dims[2], dims[1], dims[0]] + [0] * (len(decoder_channels) - 3)
    for name, out_ch in branch_channels.items():
        d = f"decoder_{name}.blocks."
        for i, (ic, sc, oc) in enumerate(zip(in_chs, skip_chs, decoder_channels)):
            for j, cin in ((1, ic + sc), (2, oc)):
                c = f"{d}{i}.conv{j}."
                w(c + "0.weight", oc, cin, 3, 3)
                w(c + "1.weight", oc)
                w(c + "1.bias", oc)
                sd[c + "1.running_mean"] = (rng.standard_normal(oc) * 0.3).astype(np.float32)
                sd[c + "1.running_var"] = (rng.random(oc) * 2 + 0.2).astype(np.float32)
                sd[c + "1.num_batches_tracked"] = np.asarray(0, np.int64)
        w(f"head_{name}.0.weight", out_ch, decoder_channels[-1], 3, 3)
        w(f"head_{name}.0.bias", out_ch)
    return sd


def _bn(p: Mapping, key: str, out: dict) -> None:
    out[f"{key}.weight"] = _t(p["scale"])
    out[f"{key}.bias"] = _t(p["bias"])
    out[f"{key}.running_mean"] = _t(p["mean"])
    out[f"{key}.running_var"] = _t(p["var"])
    out[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def real_state_dict_from_jax(flax_params: Mapping,
                             cfg: RealHoverNeXtConfig) -> dict[str, torch.Tensor]:
    """JAX ``RealHoverNeXt`` params (numpy leaves; ``{"params": ...}`` or
    the inner dict) → the port's ``RealHoverNeXt`` state dict."""
    p = flax_params["params"] if "params" in flax_params else flax_params
    enc = p["encoder"]
    sd: dict[str, torch.Tensor] = {}
    _conv(enc["stem_conv"], ENC + "stem.0", sd)
    _ln(enc["stem_norm"], ENC + "stem.1", sd)
    for s in range(1, cfg.encoder.num_stages):
        _ln(enc[f"down{s}_norm"], ENC + f"stages.{s}.downsample.0", sd)
        _conv(enc[f"down{s}_conv"], ENC + f"stages.{s}.downsample.1", sd)
    for s in range(cfg.encoder.num_stages):
        for b in range(cfg.encoder.depths[s]):
            blk, t = enc[f"stage{s}_block{b}"], ENC + f"stages.{s}.blocks.{b}"
            _conv(blk["dwconv"], f"{t}.conv_dw", sd)
            _ln(blk["norm"], f"{t}.norm", sd)
            _dense(blk["pwconv1"], f"{t}.mlp.fc1", sd)
            sd[f"{t}.mlp.grn.weight"] = _t(blk["grn"]["gamma"]).reshape(-1)
            sd[f"{t}.mlp.grn.bias"] = _t(blk["grn"]["beta"]).reshape(-1)
            _dense(blk["pwconv2"], f"{t}.mlp.fc2", sd)
    for dec, head, _ in cfg.branches:
        if f"{dec}.blocks.0.conv1.0.weight" not in sd:
            for i in range(len(cfg.decoder_channels)):
                blk = p[dec][f"block{i}"]
                for j in (1, 2):
                    _conv(blk[f"conv{j}"]["conv"], f"{dec}.blocks.{i}.conv{j}.0", sd)
                    _bn(blk[f"conv{j}"]["bn"], f"{dec}.blocks.{i}.conv{j}.1", sd)
        _conv(p[head]["conv"], f"{head}.0", sd)
    return sd


# ------------------------------------------- torch names → the flax layout


def _take_bn(sd: Mapping, key: str, consumed: set[str]) -> dict:
    consumed.update({f"{key}.weight", f"{key}.bias", f"{key}.running_mean",
                     f"{key}.running_var"})
    if f"{key}.num_batches_tracked" in sd:
        consumed.add(f"{key}.num_batches_tracked")
    return {
        "scale": _np(sd[f"{key}.weight"]),
        "bias": _np(sd[f"{key}.bias"]),
        "mean": _np(sd[f"{key}.running_mean"]),
        "var": _np(sd[f"{key}.running_var"]),
    }


def convert_convnextv2_timm(
    sd: Mapping[str, np.ndarray], cfg: ConvNeXtConfig | None = None
) -> tuple[dict, set[str]]:
    """timm-named ConvNeXtV2 → the JAX package's ``ConvNeXtV2`` params.
    Returns (params, consumed keys)."""
    if cfg is None:
        cfg = infer_convnext_config_timm(sd)
    consumed: set[str] = set()
    p: dict = {
        "stem_conv": _take_conv(sd, "stem.0", consumed),
        "stem_norm": _take_ln(sd, "stem.1", consumed),
    }
    for s in range(1, cfg.num_stages):
        p[f"down{s}_norm"] = _take_ln(sd, f"stages.{s}.downsample.0", consumed)
        p[f"down{s}_conv"] = _take_conv(sd, f"stages.{s}.downsample.1", consumed)
    for s in range(cfg.num_stages):
        for b in range(cfg.depths[s]):
            t = f"stages.{s}.blocks.{b}"
            p[f"stage{s}_block{b}"] = {
                "dwconv": _take_conv(sd, f"{t}.conv_dw", consumed),
                "norm": _take_ln(sd, f"{t}.norm", consumed),
                "pwconv1": _take_dense(sd, f"{t}.mlp.fc1", consumed),
                "pwconv2": _take_dense(sd, f"{t}.mlp.fc2", consumed),
                "grn": {
                    "gamma": _np(sd[f"{t}.mlp.grn.weight"]).reshape(-1),
                    "beta": _np(sd[f"{t}.mlp.grn.bias"]).reshape(-1),
                },
            }
            consumed.update({f"{t}.mlp.grn.weight", f"{t}.mlp.grn.bias"})
    return p, consumed


def _convert_encoder(sd: Mapping[str, np.ndarray]) -> tuple[ConvNeXtConfig, dict, set[str]]:
    """Detect the encoder's naming, convert it, return the consumed FULL keys."""
    for prefix in ("encoder.model.", "encoder."):
        sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        if "stem.0.weight" in sub:  # timm naming
            cfg = infer_convnext_config_timm(sub)
            p, consumed = convert_convnextv2_timm(sub, cfg)
            return cfg, p, {prefix + k for k in consumed}
        if "downsample_layers.0.0.weight" in sub:  # official FCMAE naming
            cfg = infer_convnext_config(sub)
            variables, left = convert_convnextv2(sub, cfg)
            return cfg, variables["params"], {prefix + k for k in sub if k not in left}
    return _encoder_cfg(sd), {}, set()  # raises: no encoder


def convert_real_hovernext(
    sd: Mapping[str, np.ndarray], cfg: RealHoverNeXtConfig | None = None
) -> tuple[RealHoverNeXtConfig, dict, dict]:
    """Full published-layout state dict → (cfg, {"params": ...}, unconsumed),
    the JAX package's ``RealHoverNeXt`` tree."""
    sd = _strip_wrapper(sd)
    if cfg is None:
        cfg = infer_real_config(sd)

    _, enc_params, consumed = _convert_encoder(sd)
    p: dict = {"encoder": enc_params}

    decoders = _discover_decoders(sd)
    heads = _discover_heads(sd, decoders)
    san2orig = {_sanitize(d): d for d in decoders} | {_sanitize(h): h for h in heads}

    for dec_san, head_san, _ in cfg.branches:
        dec = san2orig.get(dec_san, dec_san)
        head = san2orig.get(head_san, head_san)
        if dec_san not in p:
            p[dec_san] = {
                f"block{i}": {
                    f"conv{j}": {
                        "conv": _take_conv(sd, f"{dec}.blocks.{i}.conv{j}.0", consumed),
                        "bn": _take_bn(sd, f"{dec}.blocks.{i}.conv{j}.1", consumed),
                    } for j in (1, 2)
                } for i in range(len(cfg.decoder_channels))
            }
        p[head_san] = {"conv": _take_conv(sd, f"{head}.0", consumed)}

    unconsumed = {k: v for k, v in sd.items() if k not in consumed}
    return cfg, {"params": p}, unconsumed
