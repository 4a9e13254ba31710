"""Slide reading: a copy of ``SlideReader``, ``ArraySlide`` (thumbnails
included), ``synthetic_wsi`` and ``open_slide`` from the JAX package's
``io/slide.py``.

``synthetic_wsi`` must stay byte-identical to the JAX package's for the
same seed: the tests feed one slide to both packages. The JAX package
resizes with cv2; the port does not use cv2, and ``resize_area`` /
``resize_nearest`` reproduce ``cv2.resize`` with ``INTER_AREA`` (downscale)
and ``INTER_NEAREST`` in numpy, bit for bit on the shapes the tests check.
``open_slide`` routes TIFF suffixes to ``io/tiff.py::TiffTileSlide``; the
whole-image fallback for other files (and TIFFs that reader cannot parse)
decodes through PIL where the JAX package uses cv2.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Protocol, Sequence, runtime_checkable

import numpy as np


def best_level_for_downsample(
    level_downsamples: "Sequence[float]", downsample: float
) -> int:
    """Highest pyramid level whose downsample ≤ requested (openslide
    semantics). ONE definition shared by every reader backend — the epsilon
    must not drift between reader backends."""
    best = 0
    for i, ds in enumerate(level_downsamples):
        if ds <= downsample + 1e-9:
            best = i
    return best


@runtime_checkable
class SlideReader(Protocol):
    @property
    def level_dimensions(self) -> Sequence[tuple[int, int]]:
        """Per-level (width, height); level 0 = full resolution."""
        ...

    @property
    def level_downsamples(self) -> Sequence[float]:
        ...

    @property
    def mpp(self) -> float | None:
        """Microns per pixel at level 0, if known."""
        ...

    def read_region(
        self, location: tuple[int, int], level: int, size: tuple[int, int]
    ) -> np.ndarray:
        """RGB uint8 (H, W, 3). ``location`` = (x, y) in LEVEL-0 pixels,
        ``size`` = (width, height) in LEVEL pixels — openslide semantics."""
        ...

    def get_thumbnail(self, max_size: tuple[int, int]) -> np.ndarray:
        ...

    def get_best_level_for_downsample(self, downsample: float) -> int:
        ...


def _area_tab(ssize: int, dsize: int, scale: float):
    """cv2's ``computeResizeAreaTab``: (destination, source, weight)
    triples in cv2's order, each weight a source cell's fractional coverage
    over the destination cell's width, rounded to float32."""
    di, si, al = [], [], []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            di.append(dx), si.append(sx1 - 1), al.append((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            di.append(dx), si.append(sx), al.append(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            di.append(dx), si.append(sx2), al.append(min(min(fsx2 - sx2, 1.0), cell) / cell)
    di = np.asarray(di, np.int64)
    # per destination: its sources in order, padded with weight 0 (adding
    # +0.0 to a float32 sum is exact)
    counts = np.bincount(di, minlength=dsize)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(di)) - start[di]
    idx = np.zeros((dsize, counts.max()), np.int64)
    wts = np.zeros((dsize, counts.max()), np.float32)
    idx[di, pos] = si
    wts[di, pos] = np.asarray(al, np.float64).astype(np.float32)
    return idx, wts


def resize_area(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_AREA)`` for
    a uint8 (H, W) or (H, W, C) image, downscaling only. Integer factors
    average whole blocks (cv2's fast path: (sum + 2) >> 2 at 2x2, else the
    float32 mean); other factors sum fractional coverage weights in float32
    in cv2's order, rows first, then columns. Rounded half to even."""
    src = np.asarray(img)
    sh, sw = src.shape[:2]
    if (sh, sw) == (out_h, out_w):
        return src.copy()
    if out_w > sw or out_h > sh or out_w < 1 or out_h < 1:
        raise ValueError(f"resize_area downscales only: {sw}x{sh} -> {out_w}x{out_h}")
    scale_x, scale_y = 1.0 / (out_w / sw), 1.0 / (out_h / sh)  # cv2's arithmetic
    kx, ky = round(scale_x), round(scale_y)
    if abs(scale_x - kx) < 2.220446049250313e-16 and abs(scale_y - ky) < 2.220446049250313e-16:
        blocks = src[: out_h * ky, : out_w * kx].reshape((out_h, ky, out_w, kx) + src.shape[2:])
        tot = blocks.astype(np.int64).sum(axis=(1, 3))
        if kx == 2 and ky == 2:
            return ((tot + 2) >> 2).astype(np.uint8)
        mean = tot.astype(np.float32) * np.float32(1.0 / (kx * ky))
        return np.clip(np.rint(mean), 0, 255).astype(np.uint8)
    xi, xw = _area_tab(sw, out_w, scale_x)
    yi, yw = _area_tab(sh, out_h, scale_y)
    tail = (1,) * (src.ndim - 2)
    s = src.astype(np.float32)
    buf = np.zeros((sh, out_w) + src.shape[2:], np.float32)
    for j in range(xi.shape[1]):
        buf = buf + s[:, xi[:, j]] * xw[:, j].reshape((1, out_w) + tail)
    acc = np.zeros((out_h, out_w) + src.shape[2:], np.float32)
    for j in range(yi.shape[1]):
        acc = acc + yw[:, j].reshape((out_h, 1) + tail) * buf[yi[:, j]]
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8)


def resize_nearest(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_NEAREST)``:
    source index floor(dst * (1 / (out / in))), clamped."""
    src = np.asarray(img)
    sh, sw = src.shape[:2]
    ifx, ify = 1.0 / (out_w / sw), 1.0 / (out_h / sh)
    xs = np.minimum(np.floor(np.arange(out_w) * ifx).astype(np.int64), sw - 1)
    ys = np.minimum(np.floor(np.arange(out_h) * ify).astype(np.int64), sh - 1)
    return src[ys[:, None], xs[None, :]]


class ArraySlide:
    """In-memory pyramidal slide over a level-0 RGB uint8 array."""

    def __init__(
        self,
        level0: np.ndarray,
        num_levels: int = 4,
        mpp: float | None = 0.25,
        path: str | Path | None = None,
    ):
        level0 = np.ascontiguousarray(level0, dtype=np.uint8)
        if level0.ndim != 3 or level0.shape[2] != 3:
            raise ValueError(f"level0 must be (H, W, 3) uint8, got {level0.shape}")
        self._levels = [level0]
        for _ in range(1, num_levels):
            prev = self._levels[-1]
            if min(prev.shape[:2]) < 2:
                break
            h, w = prev.shape[0] // 2 * 2, prev.shape[1] // 2 * 2
            ds = prev[:h, :w].reshape(h // 2, 2, w // 2, 2, 3).mean(axis=(1, 3))
            self._levels.append(ds.astype(np.uint8))
        self._mpp = mpp
        self.path = Path(path) if path is not None else None

    @property
    def level_dimensions(self) -> list[tuple[int, int]]:
        return [(lv.shape[1], lv.shape[0]) for lv in self._levels]

    @property
    def level_downsamples(self) -> list[float]:
        w0 = self._levels[0].shape[1]
        return [w0 / lv.shape[1] for lv in self._levels]

    @property
    def mpp(self) -> float | None:
        return self._mpp

    def read_region(
        self, location: tuple[int, int], level: int, size: tuple[int, int]
    ) -> np.ndarray:
        x0, y0 = location
        w, h = size
        ds = self.level_downsamples[level]
        lx, ly = int(round(x0 / ds)), int(round(y0 / ds))
        lv = self._levels[level]
        out = np.full((h, w, 3), 255, dtype=np.uint8)  # pad beyond bounds with white
        sy0, sy1 = max(ly, 0), min(ly + h, lv.shape[0])
        sx0, sx1 = max(lx, 0), min(lx + w, lv.shape[1])
        if sy1 > sy0 and sx1 > sx0:
            out[sy0 - ly : sy1 - ly, sx0 - lx : sx1 - lx] = lv[sy0:sy1, sx0:sx1]
        return out

    def get_thumbnail(self, max_size: tuple[int, int]) -> np.ndarray:
        """Highest pyramid level that fits, then area-resize to fit max_size
        preserving aspect (tiffslide get_thumbnail semantics)."""
        tw, th = max_size
        w0, h0 = self.level_dimensions[0]
        scale = min(tw / w0, th / h0, 1.0)
        out_w, out_h = max(int(w0 * scale), 1), max(int(h0 * scale), 1)
        level = self.get_best_level_for_downsample(1.0 / scale if scale < 1 else 1.0)
        return resize_area(self._levels[level], out_w, out_h)

    def get_best_level_for_downsample(self, downsample: float) -> int:
        return best_level_for_downsample(self.level_downsamples, downsample)

    # -- npz persistence (synthetic fixture format) ---------------------------

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        if not path.name.endswith(".npz"):
            # np.savez appends '.npz' itself; return the path it actually
            # wrote (and append, don't with_suffix — dotted stems survive)
            path = path.parent / (path.name + ".npz")
        np.savez_compressed(
            path, level0=self._levels[0], mpp=np.float64(self._mpp or np.nan)
        )
        return path

    @classmethod
    def load(cls, path: str | Path) -> "ArraySlide":
        with np.load(path) as z:
            mpp = float(z["mpp"])
            return cls(
                z["level0"], mpp=None if np.isnan(mpp) else mpp, path=path
            )


#: Distinct nucleus fill colors for multi-type synthetic slides — mutually
#: ≥89 L2 apart (and ≥190 from the tissue pink), so color-based type ground
#: truth (utils.headfit) is unambiguous at its tol=60 matching radius.
#: Index i ↔ nucleus type i+1 (TYPE_NAMES, aggregated_hovernet_run.py:76-82).
NUCLEUS_TYPE_COLORS: tuple[tuple[int, int, int], ...] = (
    (96, 50, 130),   # purple (the classic single-type fill)
    (30, 110, 110),  # teal
    (150, 40, 60),   # maroon
)


def synthetic_wsi(
    width: int = 4096,
    height: int = 4096,
    seed: int = 0,
    n_blobs: int = 6,
    nuclei_per_blob: int = 300,
    mpp: float = 0.25,
    nucleus_colors: tuple[tuple[int, int, int], ...] | None = None,
) -> ArraySlide:
    """Deterministic H&E-like synthetic slide: white background, elliptical
    pink tissue blobs with purple nuclei dots. Used as the golden fixture for
    end-to-end tests and benchmarks (the reference ships none — SURVEY.md §4).

    ``nucleus_colors``: optional fill palette — each nucleus draws a uniform
    type from it (type i+1 = color i), giving downstream type-aware stages
    (TP head fitting, interaction enrichment, tumor–immune metrics) a real
    multi-type population. Default (None) keeps the original single purple
    fill AND the exact original rng stream, so existing goldens are
    unchanged."""
    # NOTE: every change here must keep the output BYTE-IDENTICAL for a
    # given seed (rng call order, float dtypes, cast order) — tests and
    # bench baselines treat these slides as golden fixtures. The work is
    # restricted to blob bboxes / tissue pixels (the original full-frame
    # formulation cost minutes at 8192²: per-blob 67-MP ellipse evals, a
    # float64 kron texture and a full float32 frame), but the per-pixel
    # arithmetic is the exact original expression.
    rng = np.random.default_rng(seed)
    img = np.full((height, width, 3), 243, dtype=np.uint8)
    yy = np.arange(height, dtype=np.float32)
    xx = np.arange(width, dtype=np.float32)
    tissue_mask = np.zeros((height, width), dtype=bool)
    for _ in range(n_blobs):
        cx = rng.uniform(0.15, 0.85) * width
        cy = rng.uniform(0.15, 0.85) * height
        rx = rng.uniform(0.08, 0.22) * width
        ry = rng.uniform(0.08, 0.22) * height
        theta = rng.uniform(0, np.pi)
        # the ellipse fits in the disk of radius max(rx, ry) around its
        # center — evaluate only that bbox (identical elementwise math on
        # the identical coordinate values → identical mask bits)
        r = max(rx, ry)
        by0, by1 = max(int(cy - r) - 1, 0), min(int(cy + r) + 2, height)
        bx0, bx1 = max(int(cx - r) - 1, 0), min(int(cx + r) + 2, width)
        dx = xx[bx0:bx1][None, :] - cx
        dy = yy[by0:by1][:, None] - cy
        u = dx * np.cos(theta) + dy * np.sin(theta)
        v = -dx * np.sin(theta) + dy * np.cos(theta)
        blob = (u / rx) ** 2 + (v / ry) ** 2 <= 1.0
        tissue_mask[by0:by1, bx0:bx1] |= blob
    # eosin-pink tissue with low-frequency texture: the texture grid is
    # gathered per tissue pixel ((y//16, x//16) block lookup — what the
    # original kron-upsampled frame evaluated to), and the original cast
    # chain (f64 clip → f32 frame → u8) is reproduced exactly
    tex_small = rng.normal(0, 6, size=(height // 16 + 1, width // 16 + 1, 3))
    tissue_color = np.array([228, 160, 185], dtype=np.float32)
    tis_y, tis_x = np.nonzero(tissue_mask)
    if len(tis_y):
        vals = np.clip(tissue_color + tex_small[tis_y >> 4, tis_x >> 4], 0, 255)
        img[tis_y, tis_x] = vals.astype(np.float32).astype(np.uint8)
    # purple nuclei: small filled disks inside tissue
    if len(tis_y):
        n_nuc = n_blobs * nuclei_per_blob
        pick = rng.integers(0, len(tis_y), size=n_nuc)
        radii = rng.integers(3, 8, size=n_nuc)
        palette = np.array(
            nucleus_colors if nucleus_colors else NUCLEUS_TYPE_COLORS[:1],
            dtype=np.float32,
        )
        if len(palette) > 1:
            # drawn AFTER pick/radii so the single-type rng stream (and
            # therefore every existing golden) is untouched by the default
            types = rng.integers(0, len(palette), size=n_nuc)
        else:
            types = np.zeros(n_nuc, dtype=np.int64)
        palette_u8 = palette.astype(np.uint8)  # exact ints in f32 → u8
        disk_cache = {
            rr: (
                (np.arange(2 * rr + 1)[:, None] - rr) ** 2
                + (np.arange(2 * rr + 1)[None, :] - rr) ** 2
                <= rr * rr
            )
            for rr in range(3, 8)
        }
        for cy, cx, r, t in zip(tis_y[pick], tis_x[pick], radii, types):
            y0, y1 = max(cy - r, 0), min(cy + r + 1, height)
            x0, x1 = max(cx - r, 0), min(cx + r + 1, width)
            if y1 - y0 == 2 * r + 1 and x1 - x0 == 2 * r + 1:
                disk = disk_cache[int(r)]  # unclipped: shared mask
            else:
                py = np.arange(y0, y1)[:, None] - cy
                px = np.arange(x0, x1)[None, :] - cx
                disk = py**2 + px**2 <= r**2
            img[y0:y1, x0:x1][disk] = palette_u8[t]
    return ArraySlide(img, mpp=mpp)


def open_slide(path: str | Path) -> SlideReader:
    """Open a slide file by extension: ``.npz`` (synthetic fixture), ``.npy``
    (an (H, W, 3) or (H, W) array), tiled TIFF/SVS through
    ``TiffTileSlide``, else a whole-image decode through PIL."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".npz":
        return ArraySlide.load(path)
    if suffix == ".npy":
        # the reference's "npy" input type (hovernet_inference.py:72-74):
        # grayscale broadcasts to RGB; unit-range floats scale to [0,255];
        # values outside [0,255] are rejected rather than wrapped by a cast
        arr = np.load(path)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        if arr.dtype != np.uint8 and arr.size:
            lo, hi = float(arr.min()), float(arr.max())
            if np.issubdtype(arr.dtype, np.floating) and 0.0 <= lo and hi <= 1.0:
                arr = arr * 255.0
            elif lo < 0.0 or hi > 255.0:
                raise ValueError(
                    f"{path}: {arr.dtype} image values span [{lo:g}, {hi:g}] "
                    f"— expected uint8, [0,255], or unit-range float"
                )
            arr = np.rint(arr)
        try:
            return ArraySlide(arr, path=path)  # casts + validates (H, W, 3)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    if suffix in {".svs", ".tif", ".tiff", ".ndpi"}:
        from path_gene_multimodal_tpu_torch.io.tiff import TiffTileSlide

        try:
            return TiffTileSlide(path)
        except Exception as e:
            # keep the diagnostic: the fallback decodes the whole image
            # (gigabytes for a real WSI) and would mask the parse error
            from path_gene_multimodal_tpu_torch.utils.log import get_logger

            get_logger().warning(
                "%s: tiled-TIFF parse failed (%s: %s) — falling back to "
                "whole-image decode", path, type(e).__name__, e,
            )
    from PIL import Image

    try:
        with Image.open(path) as img:
            rgb = np.asarray(img.convert("RGB"))
    except (OSError, SyntaxError, ValueError) as e:
        raise ValueError(f"cannot open slide: {path}") from e
    return ArraySlide(rgb, path=path)
