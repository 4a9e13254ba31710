"""The port's nuclei CLI (``cli/hovernext_infer.py``) and its checkpoint
loaders (``core/checkpoints.py``, ``models/weights*.py``) against the JAX
package's: usage errors, input resolution, a ``--device cpu`` WSI run
equal to a direct ``run_hovernext_wsi`` call, a JAX converted-checkpoint
``.npz``, and the refusals (the published real layout, ``--dp``, no GPU)."""

import logging

import numpy as np
import pandas as pd
import pytest
import torch

from path_gene_multimodal_tpu.cli import hovernext_infer as jcli
from path_gene_multimodal_tpu_torch.cli import hovernext_infer as tcli
from path_gene_multimodal_tpu_torch.config import ConvNeXtConfig, HoverNeXtConfig, default_config
from path_gene_multimodal_tpu_torch.core import checkpoints as tck
from path_gene_multimodal_tpu_torch.io.slide import synthetic_wsi
from path_gene_multimodal_tpu_torch.models.hovernext import HoverNeXt, init_weights
from path_gene_multimodal_tpu_torch.models.weights_hovernext import params_from_jax

SMALL = HoverNeXtConfig(encoder=ConvNeXtConfig(depths=(1, 1, 1, 1), dims=(32, 32, 64, 64)),
                        decoder_dims=(64, 32, 32, 32), input_size=256)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The bf16 CPU forward runs ~20x slower when its threads outnumber the
    free cores, as they do while the suite's workers run side by side; two
    threads keep it at a few seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A small slide (.npz) and a head-fitted small HoverNeXt saved as a
    torch state dict (.pt)."""
    from path_gene_multimodal_tpu_torch.utils.headfit import fit_heads, sample_tissue_tiles

    d = tmp_path_factory.mktemp("cli")
    slide = synthetic_wsi(600, 500, seed=9, n_blobs=2, nuclei_per_blob=40)
    net = HoverNeXt(SMALL)
    init_weights(net, torch.Generator().manual_seed(0))
    sd = fit_heads(SMALL, net.state_dict(), sample_tissue_tiles(slide, 4, 256, seed=1),
                   dtype=torch.float32, device="cpu")
    torch.save({"state_dict": {k: v.cpu() for k, v in sd.items()}}, d / "sd.pt")
    return slide.save(d / "cli.npz"), d / "sd.pt", slide


def _usage_cases(tmp_path, p):
    lst = tmp_path / "two.txt"
    lst.write_text(f"{p}\n{p}\n")
    empty = tmp_path / "empty.txt"
    empty.write_text("\n")
    return {
        "tiles_without_csv": ["--input", str(p), "--output", str(tmp_path), "--mode", "tiles"],
        "missing_input": ["--input", str(tmp_path / "nope.svs"), "--output", str(tmp_path)],
        "unmatched_glob": ["--input", str(tmp_path / "*.nothere"), "--output", str(tmp_path)],
        "empty_list": ["--input", str(empty), "--output", str(tmp_path)],
        "tiles_several_inputs": ["--input", str(lst), "--output", str(tmp_path), "--mode",
                                 "tiles", "--annotations-csv", "x.csv"],
    }


def test_usage_errors_exit_2_as_jax(tmp_path, small):
    p, _, _ = small
    for name, argv in _usage_cases(tmp_path, p).items():
        assert tcli.main(argv) == 2, name
        assert jcli.main(argv) == 2, name
    # not ported: --dp (multi-device) exits 2 before anything is built
    assert tcli.main(["--input", str(p), "--output", str(tmp_path), "--dp"]) == 2


def test_cuda_default_refused_without_a_gpu(tmp_path, small):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a GPU")
    p, ckpt, _ = small
    rc = tcli.main(["--input", str(p), "--output", str(tmp_path / "o"),
                    "--checkpoint", str(ckpt)])
    assert rc == 2
    assert not (tmp_path / "o" / "cli_hovernet_nuclei_wsi.csv").exists()


def test_resolve_inputs_matches_jax(tmp_path):
    for n in ("b.svs", "a.svs", "c.tif"):
        (tmp_path / n).write_bytes(b"x")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "d.svs").write_bytes(b"x")
    lst = tmp_path / "list.txt"
    lst.write_text(f"  {tmp_path / 'a.svs'}\n\n{tmp_path / 'nope.svs'}\n")
    for spec in [str(tmp_path / "*.svs"), str(tmp_path / "a.svs"), str(tmp_path / "**" / "*.svs"),
                 str(lst), str(tmp_path / "*.svs") + "  "]:
        assert tcli.resolve_inputs(spec) == jcli.resolve_inputs(spec), spec
    for spec, err in [(str(tmp_path / "nope.txt"), FileNotFoundError),
                      (str(tmp_path / "*.ndpi"), ValueError)]:
        with pytest.raises(err):
            jcli.resolve_inputs(spec)
        with pytest.raises(err):
            tcli.resolve_inputs(spec)


def test_cli_wsi_on_cpu_equals_direct_run(tmp_path, small):
    """``--device cpu --mode wsi --checkpoint sd.pt`` writes the table and
    the map (npz and zip) of a direct ``run_hovernext_wsi`` call with the
    model the CLI builds (bf16, the checkpoint's config), and logs the
    slide's stage report; the direct call's ``timer`` holds one record of
    the segment stage, its items the windows."""
    from path_gene_multimodal_tpu_torch.pipeline.nuclei import NucleiModel
    from path_gene_multimodal_tpu_torch.pipeline.nuclei_wsi import (
        iter_windows,
        load_instance_map,
        run_hovernext_wsi,
    )
    from path_gene_multimodal_tpu_torch.utils.log import StageTimer, get_logger

    p, ckpt, slide = small
    out = tmp_path / "out"
    logged = []
    handler = logging.Handler()
    handler.emit = lambda record: logged.append(record.getMessage())
    get_logger().addHandler(handler)
    try:
        rc = tcli.main(["--input", str(p), "--output", str(out), "--mode", "wsi", "--device",
                        "cpu", "--batch-size", "4", "--tta", "1", "--checkpoint", str(ckpt)])
    finally:
        get_logger().removeHandler(handler)
    assert rc == 0
    assert any(m.startswith("cli: stage report {'hovernext_wsi_segment'") for m in logged)
    cfg, sd = tck.load_hovernext_from_torch(ckpt)
    assert cfg == SMALL
    model = NucleiModel.build(cfg, state_dict=sd, tta=1, dtype=torch.bfloat16, device="cpu")
    direct = tmp_path / "direct"
    timer = StageTimer()
    _, want = run_hovernext_wsi(slide, direct, "cli", model, default_config(), batch_size=4,
                                timer=timer)
    (rec,) = timer.records
    assert rec.name == "hovernext_wsi_segment" and rec.seconds > 0
    assert rec.items == len(iter_windows(*slide.level_dimensions[0], 256, 248))
    assert rec.extra == {"cc_slot_overflow_tiles": 0}
    report = timer.report()["hovernext_wsi_segment"]
    assert report["items"] == rec.items and report["items_per_sec"] == rec.items / rec.seconds
    got = pd.read_parquet(out / "cli_hovernet_nuclei_wsi.parquet")
    ref = pd.read_parquet(direct / "cli_hovernet_nuclei_wsi.parquet")
    assert len(got) == len(want) > 5
    assert (out / "cli_hovernet_nuclei_wsi.csv").exists()
    pd.testing.assert_frame_equal(got.drop(columns=["nuc_id", "tile_path"]),
                                  ref.drop(columns=["nuc_id", "tile_path"]))
    for suffix in (".npz", ".zip"):
        np.testing.assert_array_equal(load_instance_map(out / f"cli_pinst_pp{suffix}"),
                                      load_instance_map(direct / f"cli_pinst_pp{suffix}"))


def test_jax_converted_npz_loads_to_params_from_jax(tmp_path, small):
    """The fitted state dict through the JAX package's ``convert_hovernext``
    and ``save_converted("hovernext", ...)`` → the port's
    ``load_converted`` → ``params_from_jax``: the JAX parameters'
    ``params_from_jax``, and the state dict itself. The CLI given that
    ``.npz`` writes the table it writes given the ``.pt``."""
    from path_gene_multimodal_tpu.core.checkpoints import save_converted
    from path_gene_multimodal_tpu.models.weights_hovernext import convert_hovernext

    _, ckpt, slide = small
    sd = torch.load(ckpt, weights_only=True)["state_dict"]
    jcfg, variables, leftover = convert_hovernext({k: v.numpy() for k, v in sd.items()})
    assert leftover == {}
    path = save_converted("hovernext", jcfg, variables, tmp_path / "hn.npz")
    kind, cfg, loaded = tck.load_converted(path)
    assert kind == "hovernext" and cfg == SMALL
    got = params_from_jax(loaded, cfg)
    assert list(got) == list(params_from_jax(variables, SMALL)) == list(sd)
    for k in sd:
        assert torch.equal(got[k], sd[k]), k
    one = tmp_path / "one.npy"  # one window
    np.save(one, slide._levels[0][:256, :256])
    tables = []
    for ck in (path, ckpt):
        out = tmp_path / ck.suffix[1:]
        assert tcli.main(["--input", str(one), "--output", str(out), "--device", "cpu",
                          "--batch-size", "1", "--tta", "1", "--checkpoint", str(ck)]) == 0
        tables.append(pd.read_parquet(out / "one_hovernet_nuclei_wsi.parquet")
                      .drop(columns=["nuc_id", "tile_path"]))
    assert len(tables[0]) > 0
    pd.testing.assert_frame_equal(*tables)


def test_checkpoint_refusals(tmp_path, small):
    """The published smp/timm layout raises, naming its queue item; an
    unconsumed key raises; a wrapped ``module.`` prefix is taken off."""
    _, ckpt, _ = small
    sd = torch.load(ckpt, weights_only=True)["state_dict"]
    real = dict(sd, **{"decoder.blocks.0.conv1.0.weight": torch.zeros(4, 4, 3, 3)})
    torch.save(real, tmp_path / "real.pt")
    with pytest.raises(NotImplementedError, match="item 16"):
        tck.load_hovernext_from_torch(tmp_path / "real.pt")
    assert tcli.main(["--input", str(small[0]), "--output", str(tmp_path / "r"), "--device",
                      "cpu", "--checkpoint", str(tmp_path / "real.pt")]) == 2
    wrapped = {f"module.{k}": v for k, v in sd.items()}
    torch.save({"model": wrapped}, tmp_path / "wrapped.pt")
    cfg, state = tck.load_hovernext_from_torch(tmp_path / "wrapped.pt")
    assert cfg == SMALL and sorted(state) == sorted(sd)
    extra = dict(wrapped, **{"module.aux_head.weight": torch.zeros(3)})
    torch.save({"model": extra}, tmp_path / "extra.pt")
    with pytest.raises(ValueError, match="aux_head.weight"):
        tck.load_hovernext_from_torch(tmp_path / "extra.pt")
    missing = {k: v for k, v in sd.items() if k != "final_conv.bias"}
    torch.save(missing, tmp_path / "missing.pt")
    with pytest.raises(RuntimeError, match="final_conv.bias"):
        tck.load_hovernext_from_torch(tmp_path / "missing.pt")


def test_stage_timer_report_matches_jax():
    """The port's ``StageTimer`` (its ``stage`` context inside a profiler
    range, and ``report``'s aggregation of repeated names) gives the JAX
    package's report on the same records."""
    from path_gene_multimodal_tpu.utils import log as jlog
    from path_gene_multimodal_tpu_torch.utils import log as tlog

    reports = []
    for mod in (jlog, tlog):
        timer = mod.StageTimer()
        with timer.stage("hovernext_tiles", step=(1, 2)) as info:
            info["items"] = 7
            info["cc_slot_overflow_tiles"] = 0
        with mod.stage("standalone"):
            pass
        timer.records.append(mod.StageRecord("hovernext_tiles", 2.0, items=3, extra={"x": 1}))
        timer.records.append(mod.StageRecord("hovernext_wsi_segment", 0.0))
        rep = timer.report()
        assert rep["hovernext_tiles"]["seconds"] > 2.0
        rep["hovernext_tiles"]["seconds"] = round(rep["hovernext_tiles"]["seconds"])
        rep["hovernext_tiles"]["items_per_sec"] = None
        reports.append(rep)
    assert reports[0] == reports[1]
    assert reports[1]["hovernext_tiles"] == {"cc_slot_overflow_tiles": 0, "seconds": 2,
                                              "items": 10, "items_per_sec": None}
