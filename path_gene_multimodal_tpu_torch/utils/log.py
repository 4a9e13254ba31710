"""Structured stage logging (a copy of ``get_logger``, ``StageRecord``,
``StageTimer`` and ``stage`` from the JAX package's utils/log.py).

Every pipeline stage can run inside a ``StageTimer`` that (a) logs wall
time and items/s, (b) opens a ``torch.profiler.record_function`` range so
stages show up in profiles, and (c) accumulates a per-run stage report.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field
from typing import Iterator

_LOGGER_NAME = "pgm_torch"


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s", "%H:%M:%S")
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


@dataclass
class StageRecord:
    name: str
    seconds: float
    items: int | None = None
    # free-form counters surfaced into the stage report (e.g. the CC
    # slot-overflow tile count)
    extra: dict | None = None

    @property
    def items_per_sec(self) -> float | None:
        if self.items is None or self.seconds <= 0:
            return None
        return self.items / self.seconds


@dataclass
class StageTimer:
    """Collects per-stage timings across one slide run."""

    records: list[StageRecord] = field(default_factory=list)

    @contextlib.contextmanager
    def stage(self, name: str, step: tuple[int, int] | None = None) -> Iterator[dict]:
        """``with timer.stage("embed", step=(2, 8)) as info: info["items"] = N``"""
        logger = get_logger()
        prefix = f"[{step[0]}/{step[1]}] " if step else ""
        logger.info("%s%s ...", prefix, name)
        info: dict = {"items": None}
        t0 = time.perf_counter()
        with _trace_annotation(name):
            yield info
        dt = time.perf_counter() - t0
        extra = {k: v for k, v in info.items() if k != "items" and v is not None}
        rec = StageRecord(name=name, seconds=dt, items=info.get("items"), extra=extra or None)
        self.records.append(rec)
        rate = f" ({rec.items_per_sec:.1f}/s)" if rec.items_per_sec else ""
        logger.info("%s✓ %s: %.2fs%s", prefix, name, dt, rate)

    def report(self) -> dict[str, dict]:
        """Per-stage summary. Repeated stage names aggregate (seconds and
        items sum); extras cannot shadow the timing fields."""
        out: dict[str, dict] = {}
        for r in self.records:
            entry = out.get(r.name)
            if entry is None:
                entry = dict(r.extra or {})
                entry.update(seconds=r.seconds, items=r.items)
                out[r.name] = entry
            else:
                entry["seconds"] += r.seconds
                if r.items is not None:
                    entry["items"] = (entry.get("items") or 0) + r.items
            entry["items_per_sec"] = (
                entry["items"] / entry["seconds"]
                if entry.get("items") and entry["seconds"] > 0 else None
            )
        return out


def _trace_annotation(name: str):
    """A profiler range named after the stage (the JAX package opens a
    ``jax.profiler.TraceAnnotation``)."""
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """Standalone stage context (no record collection)."""
    timer = StageTimer()
    with timer.stage(name):
        yield
