"""The port's multi-slide runner (``cli/batch_run.py``) on the CPU with the
small towers of ``tests/test_torch_runner.py``: two slides through one
model bundle with the success and error logs, the lock/done protocol on a
rerun, a slide that fails giving exit 1, ``--limit 0``, no slides (exit 2),
and ``--dp`` over 8 CPU shards equal to ``cli.main``'s run of the same
slide (a batch that does not divide the mesh exits 2 with JAX's
message)."""

import dataclasses
import json

import numpy as np
import pandas as pd
import pytest
import torch

from path_gene_multimodal_tpu_torch.cli import batch_run as brun
from path_gene_multimodal_tpu_torch.cli import main as tcli
from path_gene_multimodal_tpu_torch.config import default_config
from path_gene_multimodal_tpu_torch.core.artifacts import read_features_h5
from path_gene_multimodal_tpu_torch.io.slide import synthetic_wsi
from path_gene_multimodal_tpu_torch.models import clip as tclip
from path_gene_multimodal_tpu_torch.models.tokenizer import FallbackTokenizer
from path_gene_multimodal_tpu_torch.pipeline import runner as trunner
from test_torch_hovernext_infer import _cpu_shards, _dp_not_dividing_exits_2

V = dict(image_size=224, patch_size=32, width=64, layers=2, heads=2, out_dim=32)
T = dict(vocab_size=49408, context_length=77, width=32, layers=2, heads=2, out_dim=32)


@pytest.fixture(autouse=True)
def small(monkeypatch):
    """Both CLIs on the runner tests' configuration (batch 16, f32, every
    class in the TME) and small seeded towers; the meshes the bundle was
    built with are recorded."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    c = default_config()
    cfg = c.replace(
        embedding=dataclasses.replace(c.embedding, batch_size=16, dtype="float32"),
        polygon=dataclasses.replace(c.polygon, min_polygon_area_px=0, area_min_tiles=1),
        tme_classes=c.classes)
    for mod in (brun, tcli):
        monkeypatch.setattr(mod, "default_config", lambda **kw: cfg)
    real = trunner.PipelineModels.build.__func__
    meshes = []

    def build(cls, *a, **k):
        meshes.append(k.get("mesh"))
        k.update(vision_cfg=tclip.VisionConfig(**V), text_cfg=tclip.TextConfig(**T),
                 tokenizer=FallbackTokenizer())
        return real(cls, *a, **k)

    monkeypatch.setattr(trunner.PipelineModels, "build", classmethod(build))
    yield meshes
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def slides(tmp_path_factory):
    root = tmp_path_factory.mktemp("slides")
    a = synthetic_wsi(1024, 768, seed=13, n_blobs=3, nuclei_per_blob=20).save(root / "caseA.npz")
    b = synthetic_wsi(896, 672, seed=14, n_blobs=2, nuclei_per_blob=20).save(root / "caseB.npz")
    bad = root / "caseBad.npz"
    bad.write_bytes(b"not a slide")
    return a, b, bad


def _list(tmp_path, *paths):
    f = tmp_path / "slides.txt"
    f.write_text("".join(f"{p}\n" for p in paths) + "\n")
    return ["--slide-list", str(f), "--device", "cpu"]


def test_two_slides_one_bundle_and_the_logs(slides, tmp_path, small):
    a, b, _ = slides
    out = tmp_path / "out"
    argv = _list(tmp_path, a, b) + ["--outroot", str(out)]
    assert brun.main(argv) == 0
    assert small == [None]  # one bundle for the list, no mesh
    assert (out / "success_slides.txt").read_text() == "caseA\ncaseB\n"
    assert (out / "error_slides.txt").read_text() == ""
    for stem in ("caseA", "caseB"):
        done = json.loads((out / stem / f"{stem}._DONE.json").read_text())
        assert done["status"] == "done"
        assert (out / stem / f"{stem}.geojson").exists()
    # a rerun finds both done (the lock/done protocol): nothing logged, exit 0
    before = (out / "caseA" / "caseA_features.h5").stat().st_mtime_ns
    assert brun.main(argv) == 0
    assert (out / "success_slides.txt").read_text() == "caseA\ncaseB\n"
    assert (out / "caseA" / "caseA_features.h5").stat().st_mtime_ns == before


def test_a_failing_slide_exits_1(slides, tmp_path):
    a, _, bad = slides
    out = tmp_path / "out"
    assert brun.main(_list(tmp_path, bad, a) + ["--outroot", str(out), "--no-locks"]) == 1
    assert (out / "success_slides.txt").read_text() == "caseA\n"
    err = (out / "error_slides.txt").read_text()
    assert err.startswith("caseBad\t") and err.count("\n") == 1
    assert "WSI: " in (out / "caseBad" / "caseBad_ERROR.txt").read_text()


def test_limit_zero_and_no_slides(slides, tmp_path, small):
    a, b, _ = slides
    out = tmp_path / "out"
    assert brun.main(_list(tmp_path, a, b) + ["--outroot", str(out), "--limit", "0"]) == 0
    assert (out / "success_slides.txt").read_text() == ""
    assert sorted(p.name for p in out.iterdir()) == ["error_slides.txt", "success_slides.txt"]
    empty = tmp_path / "empty"
    empty.mkdir()
    assert brun.main(["--data-path", str(empty), "--outroot", str(tmp_path / "o2"),
                      "--device", "cpu"]) == 2
    assert brun.main(_list(tmp_path) + ["--outroot", str(tmp_path / "o2")]) == 2
    assert not (tmp_path / "o2").exists()
    if not torch.cuda.is_available():  # no card, no --device cpu
        assert brun.main(["--slide-list", str(tmp_path / "slides.txt"), "--outroot",
                          str(tmp_path / "o3")]) == 2
        assert not (tmp_path / "o3").exists()


def test_dp_equals_cli_main(slides, tmp_path, small, monkeypatch):
    """``--dp`` over 8 CPU shards: one bundle over the mesh, and the slide's
    artifacts those of ``cli.main`` without ``--dp`` (features within 1e-5,
    scores within 1e-5, everything else exact, the GeoJSON and PNGs byte
    for byte). An embedding batch (16) that does not divide a 3-shard mesh
    exits 2 with JAX's message."""
    a, _, _ = slides
    monkeypatch.setenv("WSI_PATH", str(a))
    assert tcli.main(["--outroot", str(tmp_path / "main"), "--device", "cpu"]) == 0
    with _cpu_shards(8):
        assert brun.main(_list(tmp_path, a) + ["--outroot", str(tmp_path / "dp"), "--dp"]) == 0
    assert [m.size if m else None for m in small] == [None, 8]
    assert (tmp_path / "dp" / "success_slides.txt").read_text() == "caseA\n"
    got, want = tmp_path / "dp" / "caseA", tmp_path / "main" / "caseA"
    names = sorted(p.name for p in want.iterdir() if not p.name.startswith(".processing"))
    assert sorted(p.name for p in got.iterdir() if not p.name.startswith(".processing")) == names
    np.testing.assert_allclose(read_features_h5(got / "caseA_features.h5")["features"],
                               read_features_h5(want / "caseA_features.h5")["features"],
                               atol=1e-5)
    classes = list(default_config().classes)
    for name in ("caseA_annotations.csv", "caseA_annotations_with_coords.csv"):
        g, w = pd.read_csv(got / name), pd.read_csv(want / name)
        pd.testing.assert_frame_equal(g.drop(columns=classes), w.drop(columns=classes))
        np.testing.assert_allclose(g[classes].to_numpy(), w[classes].to_numpy(), atol=1e-5)
    for name in names:
        if name.endswith((".geojson", ".png")):
            assert (got / name).read_bytes() == (want / name).read_bytes(), name
    _dp_not_dividing_exits_2(brun, _list(tmp_path, a) + ["--outroot", str(tmp_path / "o3"),
                                                          "--dp"],
                             tmp_path / "o3", "embedding batch", 16, monkeypatch)
