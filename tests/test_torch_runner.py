"""The port's 8-step runner against the JAX package's on the CPU, on one
synthetic ``.npz`` slide with the small towers of ``test_runner_e2e.py``
(f32, the JAX weights carried across, ``FallbackTokenizer`` in both, every
class seeding the TME ROI, ``area_min_tiles`` 1 so that K5's plain version
runs): coords identical, features within atol 5e-4 / rtol 1e-3; steps 3-8
fed the JAX run's features give the JAX run's CSV rows, TME flags, rings
and artifact names; the done flags have the same keys; the lock, error
file, rerun skip and resume behave as in ``test_runner_e2e.py`` /
``test_resume_faults.py``; and ``cli.main``'s exit codes."""

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from path_gene_multimodal_tpu.config import default_config as j_default_config
from path_gene_multimodal_tpu.core.checkpoints import save_converted
from path_gene_multimodal_tpu.io.slide import ArraySlide, synthetic_wsi
from path_gene_multimodal_tpu.models import clip as jclip
from path_gene_multimodal_tpu.models.tokenizer import FallbackTokenizer as JTok
from path_gene_multimodal_tpu.models.vit_timm import TimmViTConfig
from path_gene_multimodal_tpu.pipeline import runner as jrunner
from path_gene_multimodal_tpu_torch.cli import main as tcli
from path_gene_multimodal_tpu_torch.config import default_config
from path_gene_multimodal_tpu_torch.io.slide import ArraySlide as TArraySlide
from path_gene_multimodal_tpu_torch.core.artifacts import (
    load_geojson,
    read_features_h5,
    read_tessellation_h5,
)
from path_gene_multimodal_tpu_torch.models import clip as tclip
from path_gene_multimodal_tpu_torch.models.tokenizer import FallbackTokenizer
from path_gene_multimodal_tpu_torch.models.vit_timm import TimmViT
from path_gene_multimodal_tpu_torch.models.vit_timm import TimmViTConfig as TVirchowConfig
from path_gene_multimodal_tpu_torch.models.weights_clip import (
    text_state_dict_from_jax,
    vision_state_dict_from_jax,
)
from path_gene_multimodal_tpu_torch.pipeline import overlay as toverlay
from path_gene_multimodal_tpu_torch.pipeline import runner as trunner
from test_torch_hovernext_infer import _cpu_shards, _dp_not_dividing_exits_2

ATOL, RTOL = 5e-4, 1e-3
V = dict(image_size=224, patch_size=32, width=64, layers=2, heads=2, out_dim=32)
T = dict(vocab_size=49408, context_length=77, width=32, layers=2, heads=2, out_dim=32)
STEM = "case01"
TIMING = {"timestamp", "stage_report"}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs():
    out = []
    for c in (j_default_config(), default_config()):
        out.append(c.replace(
            embedding=dataclasses.replace(c.embedding, batch_size=16, dtype="float32"),
            polygon=dataclasses.replace(c.polygon, min_polygon_area_px=0, area_min_tiles=1),
            # seeded towers predict arbitrary classes: let any class seed the ROI
            tme_classes=c.classes,
        ))
    return out


def _models(jcfg, tcfg):
    jm = jrunner.PipelineModels.build(jcfg, vision_cfg=jclip.VisionConfig(**V),
                                      text_cfg=jclip.TextConfig(**T), tokenizer=JTok())
    np_tree = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    vcfg, tcfg_t = tclip.VisionConfig(**V), tclip.TextConfig(**T)
    tm = trunner.PipelineModels.build(
        tcfg, vision_cfg=vcfg, text_cfg=tcfg_t, tokenizer=FallbackTokenizer(), device="cpu",
        vision_state_dict=vision_state_dict_from_jax(np_tree(jm.image_encoder.params), vcfg),
        text_state_dict=text_state_dict_from_jax(np_tree(jm.text_encoder.params), tcfg_t))
    return jm, tm


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("runner")
    slide = synthetic_wsi(1792, 1344, seed=13, n_blobs=4, nuclei_per_blob=40)
    path = slide.save(root / f"{STEM}.npz")
    jcfg, tcfg = _cfgs()
    jm, tm = _models(jcfg, tcfg)
    jres = jrunner.run_one_wsi(path, root / "j", jcfg, models=jm)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    tres = trunner.run_one_wsi(path, root / "t", tcfg, models=tm)
    torch.set_num_threads(n)
    return dict(root=root, path=path, slide=slide, jcfg=jcfg, tcfg=tcfg, jm=jm, tm=tm,
                jres=jres, tres=tres)


def test_runs_complete_with_equal_coords_and_features(runs):
    jres, tres = runs["jres"], runs["tres"]
    assert jres.status == tres.status == "done", (jres.error, tres.error)
    assert tres.num_tiles == jres.num_tiles > 0 and tres.num_features == tres.num_tiles
    jd, td = jres.out_dir, tres.out_dir
    a, b = read_tessellation_h5(td / f"{STEM}.h5"), read_tessellation_h5(jd / f"{STEM}.h5")
    np.testing.assert_array_equal(a["coords"], b["coords"])
    fa, fb = read_features_h5(td / f"{STEM}_features.h5"), read_features_h5(
        jd / f"{STEM}_features.h5")
    assert fa["features"].shape == fb["features"].shape and fa["features"].dtype == np.float32
    np.testing.assert_allclose(fa["features"], fb["features"], atol=ATOL, rtol=RTOL)
    assert fa["attrs"]["model_type"] == fb["attrs"]["model_type"] == "CLIP"


def _listing(d):
    return sorted(p.name for p in d.iterdir() if not p.name.startswith(".processing"))


def test_artifacts_and_done_flag_match_jax(runs):
    jd, td = runs["jres"].out_dir, runs["tres"].out_dir
    assert _listing(td) == _listing(jd)
    for name in ("mask.png", "thumbnail.png", f"{STEM}_all_classes_overlay.png"):
        assert (td / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    a = json.loads((td / f"{STEM}._DONE.json").read_text())
    b = json.loads((jd / f"{STEM}._DONE.json").read_text())
    assert set(a) == set(b)
    assert set(a["stage_report"]) == set(b["stage_report"])
    rel = lambda v, d: v.replace(str(d), "<out>") if isinstance(v, str) else v  # noqa: E731
    for k in set(a) - TIMING:
        if k == "per_class_outputs":
            assert {c: rel(p, td) for c, p in a[k].items()} == {
                c: rel(p, jd) for c, p in b[k].items()}
        elif k in ("wsi_path",):
            assert a[k] == b[k]
        else:
            assert rel(a[k], td) == rel(b[k], jd), k


def _frames_equal(a: pd.DataFrame, b: pd.DataFrame, classes):
    assert list(a.columns) == list(b.columns)
    exact = [c for c in a.columns if c not in classes]
    pd.testing.assert_frame_equal(a[exact], b[exact])
    np.testing.assert_allclose(a[classes].to_numpy(), b[classes].to_numpy(), atol=ATOL,
                               rtol=RTOL)


def test_steps_3_to_8_on_jax_features_match_jax(runs, tmp_path):
    jd, slide = runs["jres"].out_dir, runs["slide"]
    classes = list(runs["tcfg"].classes)
    shutil.copy(jd / f"{STEM}.h5", tmp_path / f"{STEM}.h5")
    feats = read_features_h5(jd / f"{STEM}_features.h5")["features"]
    features, gj = trunner.run_steps_3_to_7(feats, runs["tm"], runs["tcfg"], tmp_path, STEM)
    ov = toverlay.run_overlays(TArraySlide(slide._levels[0], mpp=slide.mpp), features, classes,
                               tmp_path, STEM, thumb_size=runs["tcfg"].thumb_size)
    np.testing.assert_allclose(np.load(tmp_path / f"{STEM}_classes.npy"),
                               np.load(jd / f"{STEM}_classes.npy"), atol=ATOL, rtol=RTOL)
    for name in (f"{STEM}_annotations.csv", f"{STEM}_annotations_with_coords.csv"):
        _frames_equal(pd.read_csv(tmp_path / name), pd.read_csv(jd / name), classes)
    flags = pd.read_csv(tmp_path / f"{STEM}_annotations_with_coords.csv")["in_tme_roi"]
    assert flags.any()
    got, want = load_geojson(gj), load_geojson(jd / f"{STEM}.geojson")
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["class_name"] == w["class_name"]
        np.testing.assert_array_equal(g["exterior"], w["exterior"])
        assert (g["area_px2"], g["perimeter_px"]) == (w["area_px2"], w["perimeter_px"])
    done = json.loads((jd / f"{STEM}._DONE.json").read_text())
    assert sorted(p.name for p in ov["per_class_outputs"].values()) == sorted(
        os.path.basename(p) for p in done["per_class_outputs"].values())
    assert ov["overlay_all_path"].name == os.path.basename(done["overlay_all_path"])


def test_overlay_fills_rings(tmp_path):
    thumb = np.full((40, 60, 3), 200, np.uint8)
    ring = np.array([[10.0, 10.0], [50.0, 10.0], [50.0, 30.0], [10.0, 30.0]])
    inside = toverlay.fill_ring(thumb.shape[:2], ring)
    assert inside.sum() == 40 * 20 and inside[10:30, 10:50].all()
    donut = toverlay.fill_ring((40, 60), np.concatenate([ring, ring[::-1] * 0 + [[20, 15]]]))
    assert donut.any()
    img = toverlay.draw_overlay(thumb, [("#ff0000", [ring])], alpha=0.4)
    assert tuple(img[20, 30]) == (200 * 0.6 + 255 * 0.4, 200 * 0.6, 200 * 0.6)
    assert tuple(img[10, 30]) == (255, 0, 0) and tuple(img[0, 0]) == (200, 200, 200)


def test_rerun_skips_and_locks(runs):
    tcfg, tm = runs["tcfg"], runs["tm"]
    again = trunner.run_one_wsi(runs["path"], runs["root"] / "t", tcfg, models=tm)
    assert again.status == "already_done"
    other = runs["root"] / "locked"
    (other / STEM).mkdir(parents=True)
    (other / STEM / f".processing.{STEM}.lock").write_text("{}")
    assert trunner.run_one_wsi(runs["path"], other, tcfg, models=tm).status == "locked"
    assert (other / STEM / f".processing.{STEM}.lock").exists()


def test_error_path_writes_error_file(tmp_path, runs):
    blank = tmp_path / "blank.npz"
    ArraySlide(np.full((600, 600, 3), 250, np.uint8)).save(blank)
    r = trunner.run_one_wsi(blank, tmp_path / "out", runs["tcfg"], models=runs["tm"])
    assert r.status == "error" and "no foreground tiles" in r.error
    err = tmp_path / "out" / "blank" / "blank_ERROR.txt"
    assert err.exists() and "no foreground tiles" in err.read_text()
    assert not (tmp_path / "out" / "blank" / ".processing.blank.lock").exists()


def test_crash_then_resume(runs, tmp_path, monkeypatch):
    """A fault at step 5 writes the error file and releases the lock; the
    rerun takes steps 1-2 from the manifest; a config change recomputes."""
    tcfg, tm = runs["tcfg"], runs["tm"]
    calls = {"tessellation": 0, "features": 0}
    real_tess, real_feats = (trunner.tess_stage.run_tessellation,
                             trunner.embed_stage.run_extract_features)
    real_spatial = trunner.spatial_stage.run_spatial_join

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(trunner.tess_stage, "run_tessellation", counting("tessellation",
                                                                         real_tess))
    monkeypatch.setattr(trunner.embed_stage, "run_extract_features", counting("features",
                                                                              real_feats))

    def boom(*a, **k):
        raise RuntimeError("injected fault at spatial join")

    monkeypatch.setattr(trunner.spatial_stage, "run_spatial_join", boom)
    r1 = trunner.run_one_wsi(runs["path"], tmp_path / "out", tcfg, models=tm)
    assert r1.status == "error" and "injected fault" in r1.error
    out = tmp_path / "out" / STEM
    assert "injected fault" in (out / f"{STEM}_ERROR.txt").read_text()
    assert not (out / f".processing.{STEM}.lock").exists()
    assert calls == {"tessellation": 1, "features": 1}
    monkeypatch.setattr(trunner.spatial_stage, "run_spatial_join", real_spatial)
    r2 = trunner.run_one_wsi(runs["path"], tmp_path / "out", tcfg, models=tm)
    assert r2.status == "done", r2.error
    assert calls == {"tessellation": 1, "features": 1}
    assert r2.stage_report["tessellation"]["resumed"] and r2.stage_report[
        "extract_features"]["resumed"]
    (out / f"{STEM}._DONE.json").unlink()
    for p in out.glob(f"{STEM}*overlay*.png"):
        p.unlink()
    changed = tcfg.replace(tessellation=dataclasses.replace(tcfg.tessellation,
                                                            min_foreground_frac=0.4))
    r3 = trunner.run_one_wsi(runs["path"], tmp_path / "out", changed, models=tm)
    assert r3.status == "done" and calls == {"tessellation": 2, "features": 2}


def test_timm_virchow2_builds_and_embeds():
    """A small timm Virchow2 tower (not the full ViT-H on the CPU) builds with
    the ImageNet statistics and embeds: concat(cls, patch mean), 2 x width."""
    vcfg = TVirchowConfig(image_size=56, width=64, layers=2, heads=2, mlp_hidden=384)
    models = trunner.PipelineModels.build(default_config(), vision_cfg=vcfg,
                                          text_cfg=tclip.TextConfig(**T),
                                          tokenizer=FallbackTokenizer(), device="cpu")
    enc = models.image_encoder
    assert isinstance(enc.model, TimmViT) and enc.out_dim == 128
    assert enc._mean is tclip.IMAGENET_MEAN and enc._std is tclip.IMAGENET_STD
    tiles = np.random.default_rng(0).integers(0, 256, (3, 224, 224, 3), dtype=np.uint8)
    out = enc(tiles)
    assert out.shape == (3, 128) and out.dtype == torch.float32 and torch.isfinite(out).all()


def test_cli_exit_codes(runs, tmp_path, monkeypatch):
    monkeypatch.delenv("WSI_PATH", raising=False)
    assert tcli.main([]) == 2  # no slide
    assert tcli.main(["--wsi", str(tmp_path / "nope.svs")]) == 2
    (tmp_path / "x.png").write_bytes(b"")
    assert tcli.main(["--wsi", str(tmp_path / "x.png")]) == 2
    # an embedding batch (512) that does not divide the --dp mesh (3 CPU
    # shards here) exits 2 with JAX's message, before anything is written
    _dp_not_dividing_exits_2(tcli, ["--wsi", str(runs["path"]), "--dp", "--device", "cpu",
                                    "--outroot", str(tmp_path / "o3")], tmp_path / "o3",
                             "embedding batch", 512, monkeypatch)
    if not torch.cuda.is_available():
        assert tcli.main(["--wsi", str(runs["path"]), "--outroot", str(tmp_path / "o")]) == 2
        assert not (tmp_path / "o").exists()
    # a converted timm Virchow2 artifact whose params do not fit its config
    # exits 2 (a well-formed one runs: test_torch_virchow2.py); a converted
    # CLIP one runs
    vpath = save_converted("virchow2", TimmViTConfig(layers=1), {"w": np.zeros(1)},
                           tmp_path / "v2.npz")
    assert tcli.main(["--wsi", str(runs["path"]), "--weights", str(vpath),
                      "--device", "cpu"]) == 2
    jm = runs["jm"]
    cpath = save_converted("clip", jclip.VisionConfig(**V), jm.image_encoder.params,
                           tmp_path / "clip.npz")
    save_converted("clip_text", jclip.TextConfig(**T), jm.text_encoder.params,
                   tmp_path / "clip_text.npz")
    base = runs["tcfg"]
    monkeypatch.setattr(tcli, "default_config", lambda **kw: base)
    for var in ("PGM_CLIP_BPE", "PGM_CLIP_VOCAB_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "no_hub"))
    monkeypatch.setenv("WSI_PATH", str(runs["path"]))
    rc = tcli.main(["--outroot", str(tmp_path / "cli"), "--weights", str(cpath),
                    "--device", "cpu", "--no-locks"])
    assert rc == 0
    got = read_features_h5(tmp_path / "cli" / STEM / f"{STEM}_features.h5")["features"]
    np.testing.assert_allclose(got, read_features_h5(
        runs["jres"].out_dir / f"{STEM}_features.h5")["features"], atol=ATOL, rtol=RTOL)
    assert (tmp_path / "cli" / STEM / f"{STEM}.geojson").exists()
    assert tcli.main(["--outroot", str(tmp_path / "cli"), "--device", "cpu"]) == 0  # done
    # --dp over 8 CPU shards: the run's artifacts (features and scores at the
    # bar, the rest byte for byte)
    with _cpu_shards(8) as built:
        assert tcli.main(["--outroot", str(tmp_path / "dp"), "--weights", str(cpath),
                          "--device", "cpu", "--no-locks", "--dp"]) == 0
    assert [m.size for m in built] == [8]
    _dp_artifacts_equal(tmp_path / "dp" / STEM, tmp_path / "cli" / STEM, list(base.classes))


def _dp_artifacts_equal(got, want, classes):
    """A ``--dp`` run's slide directory against the run's without it: the
    same files; features within 1e-5 (the shards' products are smaller); the
    score columns at the file's bar and every other column exact; the
    GeoJSON, masks and overlays byte for byte."""
    assert _listing(got) == _listing(want)
    fa = read_features_h5(got / f"{STEM}_features.h5")["features"]
    fb = read_features_h5(want / f"{STEM}_features.h5")["features"]
    np.testing.assert_allclose(fa, fb, atol=1e-5)
    for name in (f"{STEM}_annotations.csv", f"{STEM}_annotations_with_coords.csv"):
        _frames_equal(pd.read_csv(got / name), pd.read_csv(want / name), classes)
    for name in _listing(want):
        if name.endswith((".geojson", ".png")):
            assert (got / name).read_bytes() == (want / name).read_bytes(), name
