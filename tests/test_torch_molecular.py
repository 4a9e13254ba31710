"""The port's molecular step against the JAX package's on the CPU: the
probability-map splat (the golden, out-of-bounds and overlap cases of
``tests/test_molecular.py``, then against JAX's ``splat_prob_map`` on
seeded coordinates: counts exact, maps within 1e-6), the thumbnail at an
objective power with and without an mpp, ``extract_molecular_features``
on one synthetic slide, CSV and set of weights (small ResNets in f32: the
same columns, probabilities within atol 5e-4 / rtol 1e-3, maps within 1e-6,
the same artifact names), the overlays' ``jet`` against matplotlib's, and
``cli.molecular_loop`` on a temporary tree with ``--device cpu``."""

import dataclasses
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from path_gene_multimodal_tpu.config import default_config as j_default_config
from path_gene_multimodal_tpu.core.checkpoints import save_converted
from path_gene_multimodal_tpu.io.slide import synthetic_wsi
from path_gene_multimodal_tpu.models.clip import VisionConfig as JVisionConfig
from path_gene_multimodal_tpu.models.resnet import IDaRSEnsemble as JEnsemble
from path_gene_multimodal_tpu.models.resnet import ResNetConfig as JResNetConfig
from path_gene_multimodal_tpu.models.weights_resnet import convert_resnet34
from path_gene_multimodal_tpu.ops.scatter import splat_prob_map as j_splat
from path_gene_multimodal_tpu.pipeline import molecular as jmol
from path_gene_multimodal_tpu_torch.cli import molecular_loop as ml
from path_gene_multimodal_tpu_torch.config import default_config
from path_gene_multimodal_tpu_torch.io.slide import ArraySlide
from path_gene_multimodal_tpu_torch.models.resnet import IDaRSEnsemble, ResNetConfig, seeded_resnet
from path_gene_multimodal_tpu_torch.ops.scatter import footprint_counts, splat_prob_map
from path_gene_multimodal_tpu_torch.pipeline import molecular as tmol
from test_torch_hovernext_infer import _cpu_shards, _dp_not_dividing_exits_2

ATOL, RTOL = 5e-4, 1e-3
MAP_ATOL = 1e-6
SMALL = ((1, 1, 1, 1), 2, 8)
TASKS = ["msi", "hm"]
ROI = [(0, 0), (224, 224), (448, 0), (672, 224), (224, 448)]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _golden(coords, probs, h, w, box):
    accum, count = np.zeros((len(probs), h, w)), np.zeros((h, w))
    for i, (x, y) in enumerate(coords):
        y0, y1, x0, x1 = max(y, 0), min(y + box, h), max(x, 0), min(x + box, w)
        if y1 > y0 and x1 > x0:
            accum[:, y0:y1, x0:x1] += probs[:, i, None, None]
            count[y0:y1, x0:x1] += 1
    return np.clip(accum / np.maximum(count, 1), 0, 1), count


@pytest.mark.parametrize("case", ["overlap", "out_of_bounds", "corners"])
def test_splat_golden(case):
    coords, probs = {
        "overlap": ([[0, 0], [4, 0], [2, 2]], [[0.2, 0.6, 1.0]]),
        "out_of_bounds": ([[8, 6]], [[1.0]]),
        "corners": ([[-2, -3], [9, 7], [3, 3]], [[0.3, 0.9, 0.5], [1.0, 0.0, 0.25]]),
    }[case]
    coords, probs = np.array(coords, np.int32), np.array(probs, np.float32)
    out = splat_prob_map(torch.from_numpy(coords), torch.from_numpy(probs), 8, 10, 4).numpy()
    want, count = _golden(coords, probs, 8, 10, 4)
    assert out.shape == (len(probs), 8, 10) and out.dtype == np.float32
    np.testing.assert_allclose(out, want, atol=MAP_ATOL)
    np.testing.assert_array_equal(footprint_counts(torch.from_numpy(coords), 8, 10, 4).numpy(),
                                  count)
    if case == "out_of_bounds":
        assert out[0, 7, 9] == 1.0


def test_splat_matches_jax_on_seeded_coordinates():
    rng = np.random.default_rng(3)
    h, w, box = 61, 77, 7
    coords = rng.integers(-5, 80, (300, 2)).astype(np.int32)
    probs = rng.random((6, 300)).astype(np.float32)
    ref = np.asarray(j_splat(jnp.asarray(coords), jnp.asarray(probs), h, w, box))
    got = splat_prob_map(torch.from_numpy(coords), torch.from_numpy(probs), h, w, box).numpy()
    np.testing.assert_allclose(got, ref, atol=MAP_ATOL)
    _, count = _golden(coords, probs, h, w, box)
    np.testing.assert_array_equal(footprint_counts(torch.from_numpy(coords), h, w, box).numpy(),
                                  count)


@pytest.fixture(scope="module")
def slides():
    js = synthetic_wsi(1024, 768, seed=4, n_blobs=2, nuclei_per_blob=20)
    return js, ArraySlide(js._levels[0], mpp=js.mpp)


@pytest.mark.parametrize("mpp", [0.25, 0.5, None])
def test_overview_matches_jax(slides, mpp):
    js, _ = slides
    from path_gene_multimodal_tpu.io.slide import ArraySlide as JArraySlide

    jslide, tslide = JArraySlide(js._levels[0], mpp=mpp), ArraySlide(js._levels[0], mpp=mpp)
    jt, jds = jmol.get_wsi_overview_and_dims(jslide, power=4.0)
    tt, tds = tmol.get_wsi_overview_and_dims(tslide, power=4.0)
    assert tds == jds
    np.testing.assert_array_equal(tt, jt)


def _csv(path, classes):
    rows = [{"tile_index": i, "x": x, "y": y, "predicted_class": classes[0],
             "in_tme_roi": True} for i, (x, y) in enumerate(ROI)]
    rows.append({"tile_index": len(ROI), "x": 448, "y": 448, "predicted_class": classes[1],
                 "in_tme_roi": False})
    pd.DataFrame(rows).to_csv(path, index=False)
    return path


def _weights():
    cfg = ResNetConfig(*SMALL)
    sds = [seeded_resnet(cfg, 10 + i, device="cpu").state_dict() for i in range(len(TASKS))]
    return cfg, sds, [convert_resnet34(sd, JResNetConfig(*SMALL)) for sd in sds]


def test_extract_molecular_features_matches_jax(slides, tmp_path):
    js, ts = slides
    cfg, sds, jvars = _weights()
    jcfg, tcfg = j_default_config(), default_config()
    jcfg = jcfg.replace(molecular=dataclasses.replace(jcfg.molecular, save_prob_maps=True))
    tcfg = tcfg.replace(molecular=dataclasses.replace(tcfg.molecular, save_prob_maps=True))
    csv = _csv(tmp_path / "m_annotations_with_coords.csv", list(tcfg.classes))
    jens = JEnsemble(TASKS, jvars, cfg=JResNetConfig(*SMALL), dtype=jnp.float32)
    tens = IDaRSEnsemble(TASKS, sds, cfg=cfg, dtype=torch.float32, device="cpu")
    jres = jmol.extract_molecular_features(js, csv, tmp_path / "j", "m", jens, jcfg, batch_size=2)
    tres = tmol.extract_molecular_features(ts, csv, tmp_path / "t", "m", tens, tcfg,
                                           batch_size=2)
    jf, tf = jres.features, tres.features
    assert list(tf.columns) == list(jf.columns) and len(tf) == len(ROI)
    probs = [f"{t}_prob" for t in TASKS]
    pd.testing.assert_frame_equal(tf.drop(columns=probs), jf.drop(columns=probs))
    np.testing.assert_allclose(tf[probs].to_numpy(), jf[probs].to_numpy(), atol=ATOL, rtol=RTOL)
    assert tres.prob_maps.shape == jres.prob_maps.shape and tres.prob_maps[0].max() > 0
    np.testing.assert_allclose(tres.prob_maps, jres.prob_maps, atol=MAP_ATOL)
    np.testing.assert_array_equal(tres.thumb, jres.thumb)
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(
        p.name for p in (tmp_path / "j").iterdir())
    written = pd.read_csv(tmp_path / "t" / "m_molecular_features.csv")
    np.testing.assert_allclose(written[probs].to_numpy(), tf[probs].to_numpy(), rtol=1e-6)
    with np.load(tmp_path / "t" / "m_prob_maps.npz") as z, \
            np.load(tmp_path / "j" / "m_prob_maps.npz") as zj:
        assert sorted(z.files) == sorted(zj.files) == sorted(TASKS)
        for t in TASKS:
            np.testing.assert_allclose(z[t], zj[t], atol=MAP_ATOL)


def test_overlay_colours_are_matplotlibs_jet():
    import matplotlib

    cmap = matplotlib.colormaps["jet"]
    np.testing.assert_allclose(tmol.jet_lut(), cmap(np.arange(256))[:, :3], atol=1e-12)
    prob = np.array([[0.0, 0.2, 0.5], [0.999, 1.0, 1e-4]], np.float32)
    thumb = np.full((2, 3, 3), 200, np.uint8)
    img = tmol.overlay_prob_map(thumb, prob, alpha=0.5)
    want = np.rint(0.5 * 200 + 0.5 * 255 * cmap(prob)[..., :3])
    want[0, 0] = 200  # p = 0 is not drawn
    np.testing.assert_array_equal(img, want.astype(np.uint8))


@pytest.fixture
def tree(slides, tmp_path, monkeypatch):
    js, _ = slides
    data = tmp_path / "data"
    data.mkdir()
    paths = [js.save(data / "caseA.npz"), js.save(data / "caseB.npz")]
    monkeypatch.setattr(ml, "slide_paths", lambda p: paths)  # .npz is no WSI extension
    outroot = tmp_path / "out"
    (outroot / "caseA").mkdir(parents=True)
    _csv(outroot / "caseA" / "caseA_annotations_with_coords.csv", list(default_config().classes))
    wdir = tmp_path / "weights"
    _, _, jvars = _weights()
    save_converted("resnet34", None, jvars[0], wdir / "msi")
    bad = tmp_path / "bad"
    save_converted("clip", JVisionConfig(image_size=32, patch_size=16, width=32, layers=1,
                                         heads=2, out_dim=8), {"w": np.zeros(1)}, bad / "msi")
    base = ["--data-path", str(data), "--outroot", str(outroot), "--tasks", "msi"]
    return dict(outroot=outroot, wdir=wdir, bad=bad, base=base)


def test_molecular_loop_cli_dp_equals_run_without_dp(tree, tmp_path):
    """``--dp --device cpu`` over 8 CPU shards (each tile batch split over
    them): the molecular CSV and the overlays of the run without ``--dp``,
    byte for byte."""
    outs = {}
    for dp in ([], ["--dp"]):
        out = outs[bool(dp)] = tmp_path / ("dp" if dp else "one")
        shutil.copytree(tree["outroot"], out)
        args = tree["base"][:2] + ["--outroot", str(out), "--tasks", "msi", "--weights-dir",
                                   str(tree["wdir"]), "--device", "cpu", *dp]
        with _cpu_shards(8) as built:
            assert ml.main(args) == 0
        assert [m.size for m in built] == ([8] if dp else [])
    for name in ("caseA_molecular_features.csv", "caseA_msi_overlay.png",
                 "caseA_molecular_grid.png"):
        assert (outs[True] / "caseA" / name).read_bytes() == (
            outs[False] / "caseA" / name).read_bytes(), name


def test_molecular_loop_cli(tree, monkeypatch):
    base, outroot = tree["base"], tree["outroot"]
    args = base + ["--weights-dir", str(tree["wdir"])]
    if not torch.cuda.is_available():
        assert ml.main(args) == 2  # no card, no --device cpu
        assert not outroot.joinpath("success_slides.txt").exists()
    # a molecular batch (256) that does not divide the --dp mesh (3 CPU
    # shards here) exits 2 with JAX's message, before anything is written
    _dp_not_dividing_exits_2(ml, args + ["--dp", "--device", "cpu"], outroot / "caseA" / "x",
                             "molecular batch", 256, monkeypatch)
    assert not outroot.joinpath("success_slides.txt").exists()
    assert ml.main(base + ["--weights-dir", str(tree["bad"]), "--device", "cpu"]) == 2
    assert ml.main(args + ["--device", "cpu"]) == 0
    out = outroot / "caseA"
    df = pd.read_csv(out / "caseA_molecular_features.csv")
    assert "msi_prob" in df and len(df) == len(ROI) and df["msi_prob"].between(0, 1).all()
    assert json.loads((out / "caseA._DONE_MOLECULAR.json").read_text())["status"] == "done"
    for name in ("caseA_msi_overlay.png", "caseA_molecular_grid.png"):
        assert (out / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert (outroot / "success_slides.txt").read_text() == "caseA\n"  # caseB: no CSV
    assert not (outroot / "caseB").exists()
    before = (out / "caseA_molecular_features.csv").stat().st_mtime_ns
    assert ml.main(args + ["--device", "cpu"]) == 0  # done: skipped
    assert (outroot / "success_slides.txt").read_text() == "caseA\n"
    assert (out / "caseA_molecular_features.csv").stat().st_mtime_ns == before
