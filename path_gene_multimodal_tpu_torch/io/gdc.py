"""GDC (Genomic Data Commons) slide download tooling, in the port: a copy
of the JAX package's ``io/gdc.py``.

Rebuild of the reference's ``download_lung_cancer_data.ipynb`` (SURVEY.md
§2 C25): query TCGA cases by project, resolve each case's Diagnostic
Slide SVS files, and stream-download with skip-if-exists. Network access is
optional tooling, taken through ``requests`` only when a download or a
listing is asked for: functions raise a clear error when ``requests`` is
missing, and the payload functions and ``parse_hits`` are pure, so they
work offline.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

GDC_CASES = "https://api.gdc.cancer.gov/cases"
GDC_FILES = "https://api.gdc.cancer.gov/files"
GDC_DATA = "https://api.gdc.cancer.gov/data"


def _requests():
    try:
        import requests  # type: ignore

        return requests
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "GDC download needs the 'requests' package and network access"
        ) from e


def cases_query_payload(project: str = "TCGA-LUAD", size: int = 200) -> dict[str, Any]:
    """The cases-endpoint filter payload (notebook cell 0)."""
    return {
        "filters": json.dumps(
            {
                "op": "in",
                "content": {"field": "cases.project.project_id", "value": [project]},
            }
        ),
        "fields": "case_id,submitter_id",
        "format": "JSON",
        "size": str(size),
    }


def files_query_payload(case_id: str, size: int = 50) -> dict[str, Any]:
    """Diagnostic-Slide SVS files for one case (notebook cell 2)."""
    return {
        "filters": json.dumps(
            {
                "op": "and",
                "content": [
                    {"op": "in", "content": {"field": "cases.case_id", "value": [case_id]}},
                    {"op": "in", "content": {"field": "data_type", "value": ["Slide Image"]}},
                    {
                        "op": "in",
                        "content": {
                            "field": "experimental_strategy",
                            "value": ["Diagnostic Slide"],
                        },
                    },
                ],
            }
        ),
        "fields": "file_id,file_name,file_size",
        "format": "JSON",
        "size": str(size),
    }


def parse_hits(response_json: dict[str, Any]) -> list[dict[str, Any]]:
    """Extract the hits list from a GDC API response (pure; testable)."""
    return list(response_json.get("data", {}).get("hits", []))


def list_case_ids(project: str = "TCGA-LUAD", size: int = 200) -> list[str]:
    r = _requests().get(GDC_CASES, params=cases_query_payload(project, size), timeout=60)
    r.raise_for_status()
    return [h["case_id"] for h in parse_hits(r.json())]


def list_slide_files(case_id: str) -> list[dict[str, Any]]:
    r = _requests().get(GDC_FILES, params=files_query_payload(case_id), timeout=60)
    r.raise_for_status()
    return parse_hits(r.json())


def download_file(
    file_id: str, file_name: str, out_dir: str | Path, chunk_bytes: int = 1 << 20
) -> Path:
    """Streamed download with skip-if-exists (notebook cell 2)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    dest = out_dir / file_name
    if dest.exists() and dest.stat().st_size > 0:
        return dest
    requests = _requests()
    with requests.get(f"{GDC_DATA}/{file_id}", stream=True, timeout=300) as r:
        r.raise_for_status()
        tmp = dest.with_suffix(dest.suffix + ".part")
        with open(tmp, "wb") as f:
            for chunk in r.iter_content(chunk_size=chunk_bytes):
                f.write(chunk)
        tmp.rename(dest)
    return dest


def download_project_slides(
    project: str, out_dir: str | Path, max_cases: int | None = None
) -> list[Path]:
    paths = []
    for case_id in list_case_ids(project)[: max_cases or None]:
        for f in list_slide_files(case_id):
            paths.append(download_file(f["file_id"], f["file_name"], out_dir))
    return paths
