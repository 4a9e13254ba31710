"""Cohort-level summary table, in the port: one row per slide across an
OUTROOT tree. A copy of the JAX package's ``cli/cohort_summary.py`` (pandas
only, no card): the same columns, the same soft failures, exit 2 on a
missing OUTROOT or one without per-slide directories.

The reference operates per-slide (``main.py`` + the batch loops in
``run_molecular_loop.py:101-155``) and leaves cohort assembly to ad-hoc
notebook joins; its per-slide TXT metrics (``untitled.py:45-112``) stop at
single-slide scope. This CLI walks the OUTROOT layout (reference
``CLAUDE.md`` "Output Directory Structure") and joins every per-slide
artifact this framework writes into one analysis-ready CSV:

- run metadata from ``<stem>._DONE.json`` (status, tile/feature counts);
- tile-class composition + TME fraction from
  ``<stem>_annotations_with_coords.csv``;
- per-task molecular probability means from
  ``<stem>_molecular_features.csv``;
- nuclei counts per type from ``<stem>_hovernet_nuclei_wsi.parquet``/.csv;
- spatial-graph statistics from ``<stem>_graph_stats.json``
  (degree/clustering/tumor-immune mixing).

Missing artifacts leave their columns empty — partial cohorts are the
normal case mid-run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from path_gene_multimodal_tpu_torch.utils.log import get_logger


def _slide_row(slide_dir: Path, stem: str) -> dict:
    import pandas as pd

    row: dict = {"stem": stem, "out_dir": str(slide_dir)}
    read_errors: list[str] = []

    flag = slide_dir / f"{stem}._DONE.json"
    if flag.exists():
        try:
            meta = json.loads(flag.read_text())
            row["status"] = meta.get("status")
            row["num_tiles"] = meta.get("num_tiles")
            row["num_features"] = meta.get("num_features")
            row["model_type"] = meta.get("model_type")
        except (json.JSONDecodeError, OSError):
            row["status"] = "corrupt_done_flag"
    elif (slide_dir / f"{stem}_ERROR.txt").exists():
        row["status"] = "error"

    # A half-written table (another worker mid-write; the module docstring
    # calls partial cohorts "the normal case") must cost ITS columns only,
    # never the whole cohort run — so every artifact read fails soft into
    # the row's read_errors note.
    ann = slide_dir / f"{stem}_annotations_with_coords.csv"
    if ann.exists():
        try:
            df = pd.read_csv(ann)
            row["n_annotated_tiles"] = len(df)
            if "in_tme_roi" in df.columns and len(df):
                row["tme_roi_frac"] = float(
                    df["in_tme_roi"].astype(bool).mean()
                )
            if "predicted_class" in df.columns and len(df):
                for cls, frac in (
                    df["predicted_class"].value_counts(normalize=True).items()
                ):
                    row[f"tile_frac[{cls}]"] = float(frac)
        except Exception:
            read_errors.append(ann.name)

    mol = slide_dir / f"{stem}_molecular_features.csv"
    if mol.exists():
        try:
            df = pd.read_csv(mol)
            for c in df.columns:
                if c.endswith("_prob"):
                    row[f"mean_{c}"] = float(df[c].mean()) if len(df) else None
        except Exception:
            read_errors.append(mol.name)

    nuc_pq = slide_dir / f"{stem}_hovernet_nuclei_wsi.parquet"
    nuc_csv = slide_dir / f"{stem}_hovernet_nuclei_wsi.csv"
    try:
        nuc = None
        if nuc_pq.exists():
            nuc = pd.read_parquet(nuc_pq)
        elif nuc_csv.exists():
            nuc = pd.read_csv(nuc_csv)
        if nuc is not None:
            row["n_nuclei"] = len(nuc)
            if "type_name" in nuc.columns and len(nuc):
                for t, n in nuc["type_name"].value_counts().items():
                    row[f"n_nuclei[{t}]"] = int(n)
    except Exception:
        read_errors.append(nuc_pq.name if nuc_pq.exists() else nuc_csv.name)

    gstats = slide_dir / f"{stem}_graph_stats.json"
    if gstats.exists():
        try:
            g = json.loads(gstats.read_text())
            row["graph_edges"] = g.get("n_edges")
            row["graph_mean_degree"] = g.get("mean_degree")
            row["graph_mean_clustering"] = g.get("mean_clustering")
            ti = g.get("tumor_immune") or {}
            row["immune_infiltration_frac"] = ti.get("immune_infiltration_frac")
            row["mixing_score"] = ti.get("mixing_score")
        except (json.JSONDecodeError, OSError):
            read_errors.append(gstats.name)

    if read_errors:
        row["read_errors"] = ";".join(read_errors)
    return row


def discover_slides(outroot: Path) -> list[tuple[Path, str]]:
    """Per-slide output dirs under OUTROOT: any subdirectory holding a done
    flag, an error file, or a tessellation H5 named after the directory."""
    found = []
    for d in sorted(p for p in outroot.iterdir() if p.is_dir()):
        stem = d.name
        if (
            (d / f"{stem}._DONE.json").exists()
            or (d / f"{stem}_ERROR.txt").exists()
            or (d / f"{stem}.h5").exists()
        ):
            found.append((d, stem))
    return found


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--outroot", required=True, help="pipeline output root")
    ap.add_argument("--output", default=None,
                    help="summary CSV path (default <outroot>/cohort_summary.csv)")
    args = ap.parse_args(argv)
    logger = get_logger()

    import pandas as pd

    outroot = Path(args.outroot)
    if not outroot.is_dir():
        logger.error("outroot does not exist: %s", outroot)
        return 2
    slides = discover_slides(outroot)
    if not slides:
        logger.error("no per-slide output directories under %s", outroot)
        return 2

    rows = [_slide_row(d, stem) for d, stem in slides]
    df = pd.DataFrame(rows)
    out = Path(args.output) if args.output else outroot / "cohort_summary.csv"
    out.parent.mkdir(parents=True, exist_ok=True)
    df.to_csv(out, index=False)
    done = int((df.get("status") == "done").sum()) if "status" in df else 0
    logger.info(
        "cohort summary: %d slides (%d done), %d columns → %s",
        len(df), done, len(df.columns), out,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
