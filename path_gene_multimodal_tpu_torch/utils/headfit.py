"""Analytic head fitting for runs without a published checkpoint.

Counterpart of the JAX package's ``utils/headfit.py``: with random weights
the forward finds no nuclei, and the flood and stats kernels would run on
empty maps. The NP/HV/TP heads are 1x1 convs over a shared 64-dim feature
map; everything upstream (random encoder + decoder) is a fixed feature
extractor. Ground truth comes from the synthetic slide's nucleus colour
(connected components → centroids → HV offsets) and the heads are solved
in closed form (ridge regression on balanced pixel samples, all four
rotations included so the fit holds under TTA). The compute of the
forward is unchanged; only the head weights differ.
"""

from __future__ import annotations

import numpy as np
import torch

from path_gene_multimodal_tpu_torch.config import HoverNeXtConfig
from path_gene_multimodal_tpu_torch.models.hovernext import HoverNeXt
from path_gene_multimodal_tpu_torch.pipeline.nuclei import NucleiModel

NUCLEUS_COLOR = (96, 50, 130)  # io.slide.synthetic_wsi default nucleus fill
_COLOR_TOL = 60.0  # L2 radius around the nucleus colour
_LOGIT_MARGIN = 6.0  # target logit gap: sigmoid(6) ≈ 0.998
_MAX_PIXELS = 100_000  # balanced fitting sample (half nucleus, half not)
_MAX_TRIES = 400  # random tile draws of sample_tissue_tiles


def _nucleus_mask(tiles: np.ndarray) -> np.ndarray:
    d = np.linalg.norm(np.asarray(tiles, np.float32) - np.float32(NUCLEUS_COLOR), axis=-1)
    return d < _COLOR_TOL


def nuclei_ground_truth(tiles_u8: np.ndarray):
    """Per-pixel ground truth from the nucleus colour: ``(np_mask (B,S,S)
    f32 {0,1}, hv (B,S,S,2) f32 in [-1,1], tp (B,S,S) int32 {0,1})``. HV is
    the x/y offset from the instance centroid over the instance's extent
    (the HoVer-Net target)."""
    from scipy import ndimage

    mask = _nucleus_mask(tiles_u8)
    tp = mask.astype(np.int32)
    b, s = mask.shape[0], mask.shape[1]
    hv = np.zeros((b, s, s, 2), np.float32)
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    for bi in range(b):
        lbl, n = ndimage.label(mask[bi])
        if n == 0:
            continue
        ids = np.arange(1, n + 1)
        cy = ndimage.mean(yy, lbl, ids)
        cx = ndimage.mean(xx, lbl, ids)
        py, px = np.nonzero(lbl)
        inst = lbl[py, px] - 1
        dx = px - cx[inst]
        dy = py - cy[inst]
        extx = np.maximum(ndimage.maximum(np.abs(dx), lbl[py, px], ids), 1.0)
        exty = np.maximum(ndimage.maximum(np.abs(dy), lbl[py, px], ids), 1.0)
        hv[bi, py, px, 0] = np.clip(dx / extx[inst], -1, 1)
        hv[bi, py, px, 1] = np.clip(dy / exty[inst], -1, 1)
    return mask.astype(np.float32), hv, tp


@torch.inference_mode()
def _head_features(model: HoverNeXt, tiles_u8: np.ndarray, flat_idx: np.ndarray,
                   device, batch: int = 64) -> np.ndarray:
    """Rows ``flat_idx`` of the (B*S*S, D) pre-head feature map, gathered on
    the device batch by batch."""
    s = tiles_u8.shape[1]
    per = s * s
    out = []
    idx = torch.from_numpy(flat_idx.astype(np.int64)).to(device)
    for start in range(0, len(tiles_u8), batch):
        px = torch.from_numpy(np.ascontiguousarray(tiles_u8[start : start + batch])).to(device)
        f = model.features(px.float() / 255.0).float()
        f = f.reshape(-1, f.shape[-1])
        lo, hi = start * per, start * per + f.shape[0]
        sel = (idx >= lo) & (idx < hi)
        out.append((sel.nonzero()[:, 0], f[idx[sel] - lo]))
    rows = torch.empty((len(flat_idx), out[0][1].shape[-1]), device=device)
    for pos, vals in out:
        rows[pos] = vals
    return rows.cpu().numpy()


def _ridge(x: np.ndarray, y: np.ndarray, lam: float = 1e-2) -> np.ndarray:
    """Closed-form ridge with a bias column: returns (D+1, O)."""
    xb = np.concatenate([x, np.ones((len(x), 1), np.float32)], axis=1)
    a = xb.T @ xb
    a[np.diag_indices_from(a)] += lam * len(x) / a.shape[0]
    return np.linalg.solve(a, xb.T @ y).astype(np.float32)


def fit_heads(
    cfg: HoverNeXtConfig,
    state_dict: dict,
    tiles_u8: np.ndarray,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> dict[str, torch.Tensor]:
    """Ridge-fit the NP/HV/TP heads so the forward detects the synthetic
    slide's nuclei. Returns a new ``state_dict`` (only the ``head_*``
    entries change). The features come from the same forward that
    inference runs (``NucleiModel.build``: K1 blocks when ``dtype`` is
    bf16) on ``device``."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    tiles = np.concatenate([np.rot90(np.asarray(tiles_u8), k=k, axes=(1, 2)) for k in range(4)])
    np_t, hv_t, _ = nuclei_ground_truth(tiles)
    m = np_t.reshape(-1)
    hvf = hv_t.reshape(-1, 2)

    pos = np.nonzero(m > 0.5)[0]
    neg = np.nonzero(m <= 0.5)[0]
    if len(pos) == 0:
        raise ValueError("fitting tiles contain no nucleus pixels")
    n_each = min(len(pos), len(neg), _MAX_PIXELS // 2)
    pos = rng.choice(pos, n_each, replace=False)
    neg = rng.choice(neg, n_each, replace=False)
    sel = np.concatenate([pos, neg])
    cal = rng.choice(len(m), min(len(m), 2 * _MAX_PIXELS), replace=False)

    model = NucleiModel.build(cfg, state_dict=state_dict, dtype=dtype, device=device).model
    gathered = _head_features(model, tiles, np.concatenate([sel, cal]), device)
    f_sel, f_cal = gathered[: len(sel)], gathered[len(sel):]

    # NP: one signed-margin readout → antisymmetric 2-logit head, its
    # threshold re-biased to the true foreground prior
    y_np = np.where(m[sel] > 0.5, _LOGIT_MARGIN, -_LOGIT_MARGIN)[:, None]
    w_np = _ridge(f_sel, y_np)
    s_all = f_cal @ w_np[:-1, 0] + w_np[-1, 0]
    w_np[-1, 0] -= float(np.quantile(s_all, 1.0 - float(m[cal].mean())))
    w_hv = _ridge(f_sel, hvf[sel])
    # TP: background mirrors the NP margin, type 1 (the one colour) gets
    # the positive margin, every other type is pushed down; then the same
    # prior calibration for the foreground argmax
    y_tp = np.full((len(sel), cfg.tp_channels), -_LOGIT_MARGIN, np.float32)
    y_tp[:, 0] = -y_np[:, 0]
    y_tp[m[sel] > 0.5, 1] = _LOGIT_MARGIN
    w_tp = _ridge(f_sel, y_tp)
    s_fg = f_cal @ w_tp[:-1, 1] + w_tp[-1, 1]
    s_bg = f_cal @ w_tp[:-1, 0] + w_tp[-1, 0]
    d_tp = float(np.quantile(s_fg - s_bg, 1.0 - float(m[cal].mean())))
    w_tp[-1, 1] -= d_tp / 2
    w_tp[-1, 0] += d_tp / 2

    def head(w: np.ndarray, antisym: bool = False):
        k, bias = w[:-1], w[-1]
        if antisym:
            k = np.concatenate([-k / 2, k / 2], axis=1)
            bias = np.array([-bias[0] / 2, bias[0] / 2], np.float32)
        return torch.from_numpy(np.ascontiguousarray(k.T[:, :, None, None])), torch.from_numpy(bias)

    out = dict(state_dict)
    for name, (k, bias) in (
        ("head_np", head(w_np, antisym=True)), ("head_hv", head(w_hv)), ("head_tp", head(w_tp)),
    ):
        out[f"{name}.weight"], out[f"{name}.bias"] = k, bias
    return out


def sample_tissue_tiles(slide, n: int, size: int, seed: int = 0) -> np.ndarray:
    """Sample ``n`` level-0 tiles of which at least 1% is nucleus colour."""
    rng = np.random.default_rng(seed)
    w, h = slide.level_dimensions[0]
    out: list[np.ndarray] = []
    for _ in range(_MAX_TRIES):
        if len(out) >= n:
            break
        x = int(rng.integers(0, w - size))
        y = int(rng.integers(0, h - size))
        tile = slide.read_region((x, y), 0, (size, size))
        if _nucleus_mask(tile).mean() >= 0.01:
            out.append(tile)
    if len(out) < n:
        raise ValueError(f"found only {len(out)}/{n} tissue tiles in {_MAX_TRIES} tries")
    return np.stack(out)
