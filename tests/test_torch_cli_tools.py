"""The port's remaining CLIs against the JAX package's on the CPU, run
in-process through ``main(argv)`` on inputs made from a seed with numpy:

- ``graph_build`` (``--device cpu``): the three outputs equal JAX's
  exactly (JSON text, npz arrays); exit 2 on a missing, empty or wholly
  filtered table;
- ``cohort_summary``: the CSV equal JAX's text for text over an OUTROOT
  with a complete slide, a half-written one and an errored one; exit 2 on
  a missing or empty OUTROOT;
- ``slide_info``: the dict, the ``--json`` line and the human output equal
  JAX's (but for the decoder each package reports); exit 2 on an
  unreadable file;
- ``generate_slide_list``: the list equal JAX's; exit 1 on no slides;
- ``validate_setup``: the checks' verdicts equal JAX's on the same config;
  exit 1 under ``--require-accelerator`` without a CUDA device, and a
  kernel build that fails on a CUDA machine fails the runtime check;
- the walkthrough (``cli/full_pipeline_demo``) on a quarter-area slide
  with narrow CLIP towers: done, every artifact the JAX demo lists; exit 2
  without a GPU;
- every CLI module of the port with a ``main()`` is a ``pgm-torch*``
  script in ``pyproject.toml``.
"""

import json
import tomllib
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from path_gene_multimodal_tpu.cli import cohort_summary as jcohort
from path_gene_multimodal_tpu.cli import generate_slide_list as jlist
from path_gene_multimodal_tpu.cli import graph_build as jgraph
from path_gene_multimodal_tpu.cli import slide_info as jinfo
from path_gene_multimodal_tpu.cli import validate_setup as jvalidate
from path_gene_multimodal_tpu.config import default_config as j_default_config
from path_gene_multimodal_tpu_torch.cli import cohort_summary as tcohort
from path_gene_multimodal_tpu_torch.cli import full_pipeline_demo as tdemo
from path_gene_multimodal_tpu_torch.cli import generate_slide_list as tlist
from path_gene_multimodal_tpu_torch.cli import graph_build as tgraph
from path_gene_multimodal_tpu_torch.cli import slide_info as tinfo
from path_gene_multimodal_tpu_torch.cli import validate_setup as tvalidate
from path_gene_multimodal_tpu_torch.config import default_config
from path_gene_multimodal_tpu_torch.io import slide as tslide
from path_gene_multimodal_tpu_torch.io.tiff_write import write_tiled_tiff
from path_gene_multimodal_tpu_torch.models.clip import TextConfig, VisionConfig
from path_gene_multimodal_tpu_torch.pipeline import runner
from path_gene_multimodal_tpu_torch.utils.log import get_logger

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nuclei(n=300, seed=7):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "nuc_id": [f"n{i}" for i in range(n)],
        "type": rng.integers(1, 6, n),
        "type_name": rng.choice(["neoplastic", "inflammatory", "connective"], n),
        "wsi_centroid_x": rng.uniform(0, 3000, n),
        "wsi_centroid_y": rng.uniform(0, 2000, n),
        "area": rng.uniform(40, 200, n),
        "perimeter": rng.uniform(20, 70, n),
        "eccentricity": rng.uniform(0, 0.9, n),
        "solidity": rng.uniform(0.7, 1.0, n),
        "major_axis_length": rng.uniform(8, 20, n),
        "minor_axis_length": rng.uniform(4, 10, n),
        "orientation": rng.uniform(-1.5, 1.5, n),
    })


# --------------------------------------------------------------- graph_build


@pytest.mark.parametrize("extra", [[], ["--type-filter", "1", "2", "--knn-k", "4",
                                        "--radius-um", "40", "--mpp", "0.5"]])
def test_graph_build_outputs_equal_jax(tmp_path, extra):
    table = tmp_path / "s1_hovernet_nuclei_wsi.csv"
    _nuclei().to_csv(table, index=False)
    args = ["--nuclei", str(table), "--n-perms", "20", *extra]
    assert jgraph.main([*args, "--output", str(tmp_path / "jax")]) == 0
    assert tgraph.main([*args, "--output", str(tmp_path / "port"), "--device", "cpu"]) == 0
    j, t = tmp_path / "jax", tmp_path / "port"
    assert (t / "s1_graph_stats.json").read_text() == (j / "s1_graph_stats.json").read_text()
    for name in ("s1_cell_graph.npz", "s1_graph_node_stats.npz"):
        with np.load(t / name, allow_pickle=True) as a, np.load(j / name, allow_pickle=True) as b:
            assert sorted(a.files) == sorted(b.files)
            for f in b.files:
                assert a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f]), (name, f)


def test_graph_build_exit_codes_as_jax(tmp_path):
    empty = tmp_path / "empty.csv"
    _nuclei().iloc[:0].to_csv(empty, index=False)
    table = tmp_path / "t.parquet"
    _nuclei(50).to_parquet(table, index=False)
    for argv in (["--nuclei", str(tmp_path / "missing.csv")], ["--nuclei", str(empty)],
                 ["--nuclei", str(table), "--type-filter", "9"]):
        argv += ["--output", str(tmp_path / "o")]
        assert jgraph.main(argv) == 2, argv
        assert tgraph.main([*argv, "--device", "cpu"]) == 2, argv
    if not torch.cuda.is_available():
        assert tgraph.main(["--nuclei", str(table), "--output", str(tmp_path / "o")]) == 2


# ------------------------------------------------------------ cohort_summary


def _outroot(root: Path) -> Path:
    rng = np.random.default_rng(9)
    a = root / "case_a"
    a.mkdir(parents=True)
    (a / "case_a._DONE.json").write_text(json.dumps(
        {"status": "done", "num_tiles": 40, "num_features": 40, "model_type": "CLIP"}))
    pd.DataFrame({"tile_index": range(40), "in_tme_roi": rng.random(40) > 0.4,
                  "predicted_class": rng.choice(["Tumor", "Stroma", "TILs"], 40)}
                 ).to_csv(a / "case_a_annotations_with_coords.csv", index=False)
    pd.DataFrame({"tile_index": range(12), "msi_prob": rng.random(12),
                  "tp53_prob": rng.random(12)}).to_csv(a / "case_a_molecular_features.csv",
                                                       index=False)
    _nuclei(80).to_parquet(a / "case_a_hovernet_nuclei_wsi.parquet", index=False)
    (a / "case_a_graph_stats.json").write_text(json.dumps(
        {"n_edges": 321, "mean_degree": 4.5, "mean_clustering": 0.31,
         "tumor_immune": {"immune_infiltration_frac": 0.2, "mixing_score": 0.7}}))
    b = root / "case_b"  # mid-run: an H5, a half-written table, a corrupt flag
    b.mkdir()
    (b / "case_b.h5").write_bytes(b"")
    (b / "case_b._DONE.json").write_text("{not json")
    (b / "case_b_molecular_features.csv").write_text("")
    _nuclei(20).to_csv(b / "case_b_hovernet_nuclei_wsi.csv", index=False)
    (b / "case_b_graph_stats.json").write_text("{")
    c = root / "case_c"
    c.mkdir()
    (c / "case_c_ERROR.txt").write_text("boom")
    (root / "not_a_slide").mkdir()
    return root


def test_cohort_summary_equal_jax(tmp_path):
    root = _outroot(tmp_path / "out")
    assert jcohort.main(["--outroot", str(root), "--output", str(tmp_path / "jax.csv")]) == 0
    assert tcohort.main(["--outroot", str(root), "--output", str(tmp_path / "port.csv")]) == 0
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
    df = pd.read_csv(tmp_path / "port.csv")
    assert list(df["stem"]) == ["case_a", "case_b", "case_c"]
    assert df.loc[0, "n_nuclei"] == 80 and df.loc[2, "status"] == "error"
    assert tcohort.main(["--outroot", str(root)]) == 0
    assert (root / "cohort_summary.csv").read_text() == (tmp_path / "jax.csv").read_text()


def test_cohort_summary_exit_codes_as_jax(tmp_path):
    (tmp_path / "empty").mkdir()
    for root in (tmp_path / "missing", tmp_path / "empty"):
        assert jcohort.main(["--outroot", str(root)]) == 2
        assert tcohort.main(["--outroot", str(root)]) == 2


# --------------------------------------------------------------- slide_info


@pytest.fixture(scope="module")
def slides(tmp_path_factory):
    d = tmp_path_factory.mktemp("slides")
    js = tslide.synthetic_wsi(1024, 768, seed=3, n_blobs=2, nuclei_per_blob=30)
    write_tiled_tiff(d / "a.svs", [js._levels[0], js._levels[1]], tile_size=256,
                     compression=7, description="Aperio |MPP = 0.2500|\nline two\nthree")
    write_tiled_tiff(d / "b.tif", [js._levels[0]], tile_size=128, compression=8)
    (d / "sub").mkdir()
    write_tiled_tiff(d / "sub" / "c.tiff", [js._levels[1]], tile_size=128, compression=1)
    (d / "notes.txt").write_text("not a slide")
    return d


def _without_decoder(info: dict) -> dict:
    return {k: v for k, v in info.items() if k != "native_decoder"}


def test_slide_info_equal_jax(slides, capsys):
    paths = [str(slides / "a.svs"), str(slides / "b.tif"), str(slides / "sub" / "c.tiff")]
    for p in paths:
        got, want = tinfo.slide_info(p), jinfo.slide_info(p)
        assert _without_decoder(got) == _without_decoder(want), p
        assert got["native_decoder"] is True
    assert tinfo.main([*paths, "--json"]) == 0
    got = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert jinfo.main([*paths, "--json"]) == 0
    want = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [_without_decoder(g) for g in got] == [_without_decoder(w) for w in want]
    assert tinfo.main(paths) == 0
    human = capsys.readouterr().out.splitlines()
    assert jinfo.main(paths) == 0
    jhuman = capsys.readouterr().out.splitlines()

    def drop(lines):
        return [ln for ln in lines if "native decoder" not in ln]

    assert drop(human) == drop(jhuman) and len(human) == len(jhuman)
    assert tinfo.main([str(slides / "notes.txt"), paths[0]]) == 2
    assert "UNREADABLE" in capsys.readouterr().err
    assert jinfo.main([str(slides / "notes.txt"), paths[0]]) == 2


# ------------------------------------------------ generate_slide_list, validate


def test_generate_slide_list_equal_jax(slides, tmp_path):
    assert tlist.main(["--data-path", str(slides), "--output", str(tmp_path / "t.txt")]) == 0
    assert jlist.main(["--data-path", str(slides), "--output", str(tmp_path / "j.txt")]) == 0
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    assert len((tmp_path / "t.txt").read_text().split()) == 3
    (tmp_path / "none").mkdir()
    for mod in (tlist, jlist):
        assert mod.main(["--data-path", str(tmp_path / "none"),
                         "--output", str(tmp_path / "x.txt")]) == 1


def test_validate_setup_checks_as_jax(slides, tmp_path, monkeypatch):
    logger = get_logger()
    for data_path in (str(slides), str(tmp_path / "missing"), str(tmp_path)):
        t = default_config().replace(data_path=data_path)
        j = j_default_config().replace(data_path=data_path)
        assert tvalidate.check_paths(t, logger) == jvalidate.check_paths(j, logger)
    bad = default_config().replace(tme_classes=("nope",))
    jbad = j_default_config().replace(tme_classes=("nope",))
    assert tvalidate.check_config(bad, logger) is jvalidate.check_config(jbad, logger) is False
    assert tvalidate.check_config(default_config(), logger) is True
    assert tvalidate.check_imports(logger) is True
    assert len(tvalidate.PIPELINE_MODULES) >= len(jvalidate.PIPELINE_MODULES)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tvalidate.main(["--data-path", str(slides)]) == 0
    assert tvalidate.main(["--data-path", str(slides), "--require-accelerator"]) == 1
    assert tvalidate.main(["--data-path", str(tmp_path / "missing")]) == 1

    from path_gene_multimodal_tpu_torch.ops import cuda

    def refuse(names=cuda.KERNELS):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(cuda, "build_all", refuse)
    assert tvalidate.check_runtime_components(logger, require=True) is True  # no CUDA: warns
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tvalidate.check_runtime_components(logger, require=False) is True
    assert tvalidate.check_runtime_components(logger, require=True) is False


# ------------------------------------------------------------- walkthrough


def test_walkthrough_on_cpu_writes_the_jax_demos_artifacts(tmp_path, monkeypatch, capsys):
    """The walkthrough's steps end to end at narrow widths: a quarter of the
    CPU slide's area and CLIP towers of width 64 (its CPU sizes take the
    full-width towers; the card's run is its check at full size)."""
    real = tslide.synthetic_wsi
    monkeypatch.setattr(tslide, "synthetic_wsi", lambda w, h, **kw: real(w // 2, h // 2, **kw))
    build = runner.PipelineModels.build
    narrow = dict(vision_cfg=VisionConfig(width=64, layers=2, heads=1, out_dim=32),
                  text_cfg=TextConfig(width=64, layers=2, heads=1, out_dim=32))
    monkeypatch.setattr(runner.PipelineModels, "build",
                        classmethod(lambda cls, cfg, **kw: build(cfg, **narrow, **kw)))
    assert tdemo.main([str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "status=done" in out and "[6] islands + burden metrics" in out
    names = {p.name for p in (tmp_path / tdemo.STEM).iterdir()}
    want = {n.format(s=tdemo.STEM) for n in tdemo.ARTIFACTS}
    assert want <= names, sorted(want - names)
    if not torch.cuda.is_available():
        assert tdemo.main([str(tmp_path / "gpu")]) == 2


def test_every_port_cli_module_has_a_script():
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"]
    modules = {
        f"path_gene_multimodal_tpu_torch.cli.{p.stem}"
        for p in (ROOT / "path_gene_multimodal_tpu_torch" / "cli").glob("*.py")
        if p.stem != "__init__" and "def main(" in p.read_text()
    }
    registered = {t.split(":")[0]: name for name, t in scripts.items()}
    assert len(modules) == 12 and modules <= set(registered), modules - set(registered)
    assert all(registered[m].startswith("pgm-torch") for m in modules)
