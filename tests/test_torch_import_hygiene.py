"""The port stands alone: importing any of its modules (or chip_smoke.py)
loads neither ``jax`` nor anything of the JAX package, nor cv2,
matplotlib or h5py (the port writes and reads its H5 files through its own
``io/hdf5.py``; the machine with the card has no h5py), and its sources
(Python, CUDA and the host C++ of the tile decoder) import none of them
and include no libjpeg header. Importing builds no kernel and needs no
card."""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "path_gene_multimodal_tpu_torch"

_PROBE = r"""
import importlib, pkgutil, sys
import path_gene_multimodal_tpu_torch as port

names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_smoke  # noqa: F401  (defines functions only; runs under __main__)

bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "optax", "path_gene_multimodal_tpu", "cv2",
                                    "matplotlib", "h5py"))
print("MODULES=" + str(len(names)))
print("NAMES=" + ",".join(names))
print("BAD=" + ",".join(bad))
"""

_FORBIDDEN = [
    re.compile(r"^\s*(import|from)\s+(jax|flax|optax)\b", re.M),
    re.compile(r"path_gene_multimodal_tpu\."),
    re.compile(r"^\s*(import|from)\s+path_gene_multimodal_tpu(\s|$)", re.M),
    re.compile(r"^\s*(import|from)\s+(cv2|matplotlib|h5py)\b", re.M),
    re.compile(r"(__import__|import_module|find_spec)\(\s*[\"'](cv2|matplotlib|h5py)"),
]
# the C++ and CUDA sources link no libjpeg
_FORBIDDEN_NATIVE = re.compile(r"#\s*include\s*[<\"](jpeglib|turbojpeg)\.h")


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True, timeout=300,
        cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = dict(line.partition("=")[::2] for line in proc.stdout.splitlines() if "=" in line)
    assert int(lines["MODULES"]) >= 50
    names = set(lines["NAMES"].split(","))
    for mod in ("ops.decoder", "models.hovernext_fn", "models.hovernext", "ops.convnext_block",
                "ops.cc", "ops.masking", "ops.morphology", "pipeline.morphology",
                "models.layers", "models.clip", "models.weights_clip", "pipeline.tessellate",
                "pipeline.embed", "ops.neighbors", "pipeline.graph", "pipeline.graph_stats",
                "io.native", "io.tiff", "io.tiff_write", "ops.jpegcolor", "io.zarrzip",
                "pipeline.nuclei_wsi", "cli.hovernext_infer", "core.checkpoints",
                "models.weights", "models.weights_convnext", "utils.log", "io.hdf5", "io.png",
                "ops.gridops", "ops.tme", "models.tokenizer", "pipeline.spatial",
                "pipeline.polygons", "pipeline.overlay", "pipeline.runner", "core.jobs",
                "core.artifacts", "cli.main", "models.hovernext_real",
                "models.weights_hovernext_real", "models.resnet", "models.weights_resnet",
                "ops.scatter", "pipeline.molecular", "cli.molecular_loop", "models.vit_timm",
                "models.weights_vit_timm", "pipeline.legacy", "pipeline.altpaths",
                "models.fusion", "models.weights_fusion", "parallel.train",
                "cli.fusion_train_demo", "parallel.mesh", "parallel.halo", "cli.batch_run"):
        assert f"path_gene_multimodal_tpu_torch.{mod}" in names, mod
    assert lines["BAD"] == "", lines["BAD"]


def test_port_sources_name_no_jax():
    files = (sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu*")) + sorted(PORT.rglob("*.cpp"))
             + [ROOT / "chip_smoke.py"])
    assert len(files) > 20
    assert PORT / "csrc" / "tiledecode.cpp" in files
    assert PORT / "csrc" / "decoder_conv.cu" in files
    assert PORT / "csrc" / "upsample_conv.cu" in files
    assert PORT / "csrc" / "cc.cu" in files
    assert PORT / "csrc" / "hopper.cuh" in files
    for f in files:
        text = f.read_text()
        pats = _FORBIDDEN + ([_FORBIDDEN_NATIVE] if f.suffix != ".py" else [])
        for pat in pats:
            m = pat.search(text)
            assert m is None, f"{f.relative_to(ROOT)}: {m.group(0)!r}"
