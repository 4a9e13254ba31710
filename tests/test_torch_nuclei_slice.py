"""The ported nuclei stage as a whole against the JAX package's, on the CPU.

One synthetic slide (byte-identical from both packages), a small HoverNeXt
whose heads the JAX ``fit_heads`` fitted (so the probabilities sit far from
the 0.5 threshold), and ``run_hovernet_pipeline_on_wsi_tiles`` in both
packages. The JAX side takes its XLA paths here (no TPU); the port takes
its kernels' plain versions."""

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from path_gene_multimodal_tpu.config import default_config as j_default_config
from path_gene_multimodal_tpu.io.slide import synthetic_wsi as j_synthetic_wsi
from path_gene_multimodal_tpu.models.convnext import ConvNeXtConfig as JConvNeXtConfig
from path_gene_multimodal_tpu.models.hovernext import HoverNeXt as JHoverNeXt
from path_gene_multimodal_tpu.models.hovernext import HoverNeXtConfig as JHoverNeXtConfig
from path_gene_multimodal_tpu.ops import watershed as jws
from path_gene_multimodal_tpu.ops.instances import compact_labels_device
from path_gene_multimodal_tpu.pipeline import nuclei as jnuc
from path_gene_multimodal_tpu.utils.headfit import fit_heads as j_fit_heads
from path_gene_multimodal_tpu.utils.headfit import sample_tissue_tiles
from path_gene_multimodal_tpu_torch.config import ConvNeXtConfig, HoverNeXtConfig
from path_gene_multimodal_tpu_torch.config import default_config
from path_gene_multimodal_tpu_torch.io.slide import synthetic_wsi
from path_gene_multimodal_tpu_torch.models.weights_hovernext import params_from_jax
from path_gene_multimodal_tpu_torch.ops.cc_sizes import cc_sizes_adaptive
from path_gene_multimodal_tpu_torch.ops import watershed as tws
from path_gene_multimodal_tpu_torch.ops.components import INF
from path_gene_multimodal_tpu_torch.ops.flood import marker_watershed_plain
from path_gene_multimodal_tpu_torch.pipeline import nuclei as tnuc

# the small configuration of tests/test_headfit.py (128 input, 112 tiles):
# the smaller one of tests/test_nuclei_pipeline.py:125-127 has too few
# features for the head fit to find nuclei
DEPTHS, DIMS, DEC = (2, 2, 4, 2), (32, 64, 128, 256), (128, 64, 32, 32)
SIZE, TILE, MAX_INST = 128, 112, 128


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg = JHoverNeXtConfig(encoder=JConvNeXtConfig(depths=DEPTHS, dims=DIMS),
                            decoder_dims=DEC, input_size=SIZE)
    tcfg = HoverNeXtConfig(encoder=ConvNeXtConfig(depths=DEPTHS, dims=DIMS),
                           decoder_dims=DEC, input_size=SIZE)
    jslide = j_synthetic_wsi(1024, 1024, seed=3, n_blobs=4, nuclei_per_blob=120)
    tslide = synthetic_wsi(1024, 1024, seed=3, n_blobs=4, nuclei_per_blob=120)
    assert np.array_equal(jslide._levels[0], tslide._levels[0])
    params = JHoverNeXt(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    tiles = sample_tissue_tiles(jslide, 6, SIZE, seed=1)
    params = j_fit_heads(jcfg, params, tiles, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, params)

    # tissue tiles of a TILE grid, in the TME ROI
    coords = [(x, y) for y in range(0, 1024 - TILE, TILE) for x in range(0, 1024 - TILE, TILE)]
    keep = [(x, y) for x, y in coords
            if (jslide._levels[0][y : y + TILE, x : x + TILE] != 243).mean() > 0.5][:7]
    assert len(keep) >= 4
    classes = list(j_default_config().classes)
    ann = tmp_path_factory.mktemp("ann") / "s_annotations_with_coords.csv"
    pd.DataFrame([
        {"tile_index": i, "x": x, "y": y, "predicted_class": classes[0], "in_tme_roi": True}
        for i, (x, y) in enumerate(keep)
    ]).to_csv(ann, index=False)
    return jcfg, tcfg, jslide, tslide, params, ann


def _tables(setup, tmp_path):
    jcfg, tcfg, jslide, tslide, params, ann = setup
    jmodel = jnuc.NucleiModel.build(jcfg, params=params, dtype=jnp.float32, tta=4,
                                    max_instances=MAX_INST)
    tmodel = tnuc.NucleiModel.build(tcfg, state_dict=params_from_jax(params, tcfg),
                                    dtype=torch.float32, tta=4, device="cpu",
                                    max_instances=MAX_INST)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jt = jnuc.run_hovernet_pipeline_on_wsi_tiles(
        jslide, ann, tmp_path / "j", "s", jmodel, j_default_config(patch_size=TILE), batch_size=4)
    tt = tnuc.run_hovernet_pipeline_on_wsi_tiles(
        tslide, ann, tmp_path / "t", "s", tmodel, default_config(patch_size=TILE), batch_size=4)
    return jmodel, tmodel, jt, tt


def test_nuclei_table_matches_jax(setup, tmp_path):
    """Row for row: ids, types, tiles, areas, bboxes and polygons
    identical; centroids at 1e-4; the moment-derived columns at 2e-3 rel
    (the JAX CPU path takes second moments about each centroid, the port
    about the tile centre, as the TPU kernel does); orientation modulo pi
    where the instance is elongated enough for it to be defined."""
    _, _, jt, tt = _tables(setup, tmp_path)
    _assert_tables_match(jt, tt)


def test_planar_feed_nuclei_table_matches_jax(setup, tmp_path, monkeypatch):
    """The same slide as a JPEG TIFF (JAX writer, 256-px tiles, q90) read
    by each package's ``TiffTileSlide``, both nuclei stages on their planar
    feed (every chunk planar on both sides): the rows meet the bar above."""
    from path_gene_multimodal_tpu.io.tiff import TiffTileSlide as JSlide
    from path_gene_multimodal_tpu.io.tiff_write import write_tiled_tiff
    from path_gene_multimodal_tpu_torch.io.tiff import TiffTileSlide

    jcfg, tcfg, jslide, _, params, ann = setup
    tif = write_tiled_tiff(tmp_path / "s.svs", [jslide._levels[0]], tile_size=256,
                           compression=7, description="Aperio |MPP = 0.25|")
    jplanar = []
    real = jnuc._planar_seg_prep
    monkeypatch.setattr(jnuc, "_planar_seg_prep", lambda *a: jplanar.append(1) or real(*a))
    jmodel = jnuc.NucleiModel.build(jcfg, params=params, dtype=jnp.float32, tta=4,
                                    max_instances=MAX_INST)
    tmodel = tnuc.NucleiModel.build(tcfg, state_dict=params_from_jax(params, tcfg),
                                    dtype=torch.float32, tta=4, device="cpu",
                                    max_instances=MAX_INST)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jt = jnuc.run_hovernet_pipeline_on_wsi_tiles(
        JSlide(tif), ann, tmp_path / "j", "s", jmodel, j_default_config(patch_size=TILE),
        batch_size=4)
    tslide = TiffTileSlide(tif)
    tt = tnuc.run_hovernet_pipeline_on_wsi_tiles(
        tslide, ann, tmp_path / "t", "s", tmodel, default_config(patch_size=TILE), batch_size=4)
    assert len(jplanar) == 2 and tt.attrs["feed_routes"] == {"planar": 2, "rgb": 0}
    assert tslide.decoder_refusals == 0
    _assert_tables_match(jt, tt)


def _assert_tables_match(jt, tt):
    assert len(tt) == len(jt) > 20
    assert list(tt.columns) == list(jt.columns)
    key = ["tile_y", "tile_x", "inst_id"]
    jt = jt.sort_values(key).reset_index(drop=True)
    tt = tt.sort_values(key).reset_index(drop=True)
    for col in ["inst_id", "type", "type_name", "tile_x", "tile_y", "tile_name", "area",
                "bbox_xmin", "bbox_ymin", "bbox_xmax", "bbox_ymax", "wsi_bbox_xmin",
                "wsi_bbox_ymax"]:
        assert tt[col].tolist() == jt[col].tolist(), col
    assert tt["polygon"].tolist() == jt["polygon"].tolist()
    assert tt["wsi_polygon"].tolist() == jt["wsi_polygon"].tolist()
    for col in ["centroid_x", "centroid_y", "wsi_centroid_x", "wsi_centroid_y",
                "perimeter", "solidity"]:
        np.testing.assert_allclose(tt[col], jt[col], rtol=1e-5, atol=1e-4, err_msg=col)
    for col in ["major_axis_length", "minor_axis_length", "eccentricity"]:
        np.testing.assert_allclose(tt[col], jt[col], rtol=2e-3, atol=2e-3, err_msg=col)
    sel = jt["eccentricity"].to_numpy() > 0.5
    d = np.abs(tt["orientation"].to_numpy() - jt["orientation"].to_numpy())
    d = np.minimum(d, np.abs(d - np.pi))
    assert (d[sel] < 0.02).all()


def test_hover_instances_batch_matches_jax(setup):
    """The post-processing alone on one set of maps (the JAX model's
    outputs): identical labels. The flood's round cap does not bind on
    these maps (checked), so the JAX XLA flood (64 rounds) and the port
    (65, as the Pallas kernel) must agree."""
    jcfg, tcfg, jslide, _, params, _ = setup
    jmodel = jnuc.NucleiModel.build(jcfg, params=params, dtype=jnp.float32, tta=4)
    tiles = sample_tissue_tiles(jslide, 4, SIZE, seed=5)
    np_prob, hv, _ = map(np.array, jmodel._infer(jmodel.params, jnp.asarray(tiles)))
    jl = np.asarray(compact_labels_device(
        jws.hover_instances_batch(jnp.asarray(np_prob), jnp.asarray(hv)))).astype(np.int32)
    tl, n_over = tws.hover_instances_batch(torch.from_numpy(np_prob), torch.from_numpy(hv))
    tl = torch.where(tl < INF, tl, 0).numpy()
    assert int(n_over[0]) == 0 and jl.max() > 0
    np.testing.assert_array_equal(tl, jl)

    # the cap does not bind: an uncapped flood gives the same labels
    blb = torch.from_numpy(np_prob) > 0.5
    _, sizes, _, _ = cc_sizes_adaptive(blb)
    blb = blb & (sizes >= 10)
    overall, dist = tws.hv_energy(torch.from_numpy(hv[..., 0]), torch.from_numpy(hv[..., 1]), blb)
    _, _, md, _ = cc_sizes_adaptive(blb & (overall < 0.4), min_size=3)
    markers = torch.where(md > 0, md, INF)
    capped = marker_watershed_plain(dist, markers, blb)
    uncapped = marker_watershed_plain(dist, markers, blb, max_rounds=100_000)
    assert torch.equal(capped, uncapped)


def test_headfit_matches_jax(setup):
    """The port's head fit on the CPU: the same ground truth and tissue
    tiles as the JAX package's, and fitted heads that detect the same
    foreground on fitting-size tiles (f32, plain blocks)."""
    from path_gene_multimodal_tpu.utils.headfit import nuclei_ground_truth as j_gt
    from path_gene_multimodal_tpu_torch.utils import headfit as th

    jcfg, tcfg, jslide, tslide, params, _ = setup
    tiles = th.sample_tissue_tiles(tslide, 6, SIZE, seed=1)  # the setup's fitting tiles
    np.testing.assert_array_equal(tiles, sample_tissue_tiles(jslide, 6, SIZE, seed=1))
    for a, b in zip(th.nuclei_ground_truth(tiles), j_gt(tiles)):
        np.testing.assert_array_equal(a, b)

    sd = th.fit_heads(tcfg, params_from_jax(params, tcfg), tiles, dtype=torch.float32,
                      device="cpu")
    jmodel = jnuc.NucleiModel.build(jcfg, params=params, dtype=jnp.float32, tta=4)
    tmodel = tnuc.NucleiModel.build(tcfg, state_dict=sd, dtype=torch.float32, tta=4,
                                    device="cpu")
    eval_tiles = sample_tissue_tiles(jslide, 4, SIZE, seed=7)
    jfg = np.asarray(jmodel._infer(jmodel.params, jnp.asarray(eval_tiles))[0]) > 0.5
    with torch.inference_mode():
        out = tnuc.tta_forward(tmodel.model, torch.from_numpy(eval_tiles).float() / 255.0)
    tfg = (torch.softmax(out["np"], -1)[..., 1] > 0.5).numpy()
    iou = (jfg & tfg).sum() / max((jfg | tfg).sum(), 1)
    assert jfg.mean() > 0.01 and iou > 0.95, (jfg.mean(), iou)
