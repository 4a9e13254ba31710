"""Shared-filesystem job protocol: locks, done flags, error files.

A copy of the JAX package's ``core/jobs.py``. It re-implements the reference's fleet-coordination contract
(``main.py:60-125, 291-353``) so array jobs (LSF/Slurm/k8s) processing one
slide each never collide:

- ``.processing.<slide>.lock`` — atomic acquire via ``O_EXCL`` create, JSON
  payload ``{pid, host, timestamp}``; stale locks older than
  ``stale_hours`` (default 48 h, main.py:85-92) are reaped.
- ``<slide>._DONE.json`` — run-metadata done flag (main.py:291-308), with a
  heuristic artifact fallback (overlay PNG ∧ geojson, main.py:110-114).
- ``<slide>_ERROR.txt`` — full traceback on failure (main.py:341-353).

Extension over the reference: a step-granular resume manifest
(``<slide>._steps.json``) recording per-step artifact paths + config hash,
so a crashed slide re-runs only the steps whose inputs changed (SURVEY.md §5
"checkpoint/resume" recommends this).
"""

from __future__ import annotations

import json
import os
import socket
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Mapping

from path_gene_multimodal_tpu_torch.core.artifacts import json_safe


@dataclass
class SlideJob:
    """Paths + flag names for one slide's run."""

    wsi_path: Path
    out_dir: Path
    done_flag_name: str = "_DONE.json"
    stale_hours: float = 48.0

    def __post_init__(self) -> None:
        self.wsi_path = Path(self.wsi_path)
        self.out_dir = Path(self.out_dir)

    @property
    def stem(self) -> str:
        return self.wsi_path.stem

    @property
    def lock_path(self) -> Path:
        return self.out_dir / f".processing.{self.stem}.lock"

    @property
    def done_path(self) -> Path:
        # reference main.py:65-66: "<stem>.<flag>" → e.g. "SLIDE123._DONE.json"
        return self.out_dir / f"{self.stem}.{self.done_flag_name.lstrip('.')}"

    @property
    def error_path(self) -> Path:
        return self.out_dir / f"{self.stem}_ERROR.txt"

    @property
    def steps_path(self) -> Path:
        return self.out_dir / f"{self.stem}._steps.json"


def try_acquire_lock(job: SlideJob) -> bool:
    """Atomically create the lock file; reap if stale. Returns True on
    acquisition (semantics of main.py:73-92)."""
    job.out_dir.mkdir(parents=True, exist_ok=True)
    lock = job.lock_path
    try:
        st = lock.stat()
    except FileNotFoundError:
        st = None
    if st is not None:
        age_h = (time.time() - st.st_mtime) / 3600.0
        if age_h <= job.stale_hours:
            return False
        # Reap via rename-to-tombstone + inode verification. A bare unlink()
        # races: worker B could delete the FRESH lock worker A re-created
        # after reaping the same stale file. rename() hands the path to
        # exactly one reaper — but rename is by path, not inode, so the
        # renamed file may already be someone's fresh lock; verify the
        # tombstone is the SAME file we statted as stale before discarding
        # it, and restore it (link() refuses to clobber) if it is not.
        # (inode + mtime_ns: inodes are recycled immediately on some
        # filesystems, but a re-created lock always carries a fresh mtime —
        # that is the very field staleness is judged by)
        tomb = lock.parent / f"{lock.name}.reap.{os.getpid()}.{time.time_ns()}"
        try:
            os.rename(lock, tomb)
        except OSError:
            pass  # another reaper won the rename (or it vanished)
        else:
            try:
                t_st = os.stat(tomb)
                if (t_st.st_ino, t_st.st_mtime_ns) != (st.st_ino, st.st_mtime_ns):
                    # we captured a fresh lock created between our stat and
                    # rename — put it back; if the path was re-created
                    # meanwhile, leave that newer lock alone
                    try:
                        os.link(tomb, lock)
                    except FileExistsError:
                        pass
                    os.unlink(tomb)
                    return False
                os.unlink(tomb)
            except OSError:
                pass
    try:
        fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    with os.fdopen(fd, "w") as f:
        json.dump(
            {"pid": os.getpid(), "host": socket.gethostname(), "timestamp": time.time()},
            f,
        )
        f.flush()
        my_st = os.fstat(f.fileno())
    # a concurrent reaper in the residual stat→rename window could still have
    # stolen the lock we just created; holding it is only real if the path
    # still resolves to our file
    try:
        now = os.stat(lock)
        return (now.st_ino, now.st_mtime_ns) == (my_st.st_ino, my_st.st_mtime_ns)
    except FileNotFoundError:
        return False


def release_lock(job: SlideJob) -> None:
    try:
        job.lock_path.unlink()
    except FileNotFoundError:
        pass


def write_done_flag(job: SlideJob, metadata: Mapping[str, Any]) -> Path:
    payload = dict(metadata)
    payload.setdefault("status", "done")
    payload.setdefault("id", job.stem)
    payload.setdefault("wsi_stem", job.stem)
    payload.setdefault("timestamp", time.time())
    job.done_path.write_text(json.dumps(json_safe(payload), indent=2))
    return job.done_path


def already_done(job: SlideJob, fallback_globs: tuple[str, ...] = ()) -> bool:
    """Done if the flag exists, or (fallback, main.py:110-114) if every
    heuristic artifact glob matches at least one file."""
    if job.done_path.exists():
        return True
    if fallback_globs:
        return all(any(job.out_dir.glob(g)) for g in fallback_globs)
    return False


def write_error_file(job: SlideJob, exc: BaseException) -> Path:
    job.out_dir.mkdir(parents=True, exist_ok=True)
    tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
    job.error_path.write_text(
        f"WSI: {job.wsi_path}\nTime: {time.strftime('%Y-%m-%d %H:%M:%S')}\n\n{tb}"
    )
    return job.error_path


# ---------------------------------------------------------------------------
# Step-granular resume manifest
# ---------------------------------------------------------------------------


def _load_steps(job: SlideJob) -> dict[str, Any]:
    if job.steps_path.exists():
        try:
            return json.loads(job.steps_path.read_text())
        except (json.JSONDecodeError, OSError):
            return {}
    return {}


def step_is_done(job: SlideJob, step: str, config_hash: str) -> bool:
    """A step may be skipped iff its manifest entry matches the current config
    hash and every recorded artifact still exists."""
    entry = _load_steps(job).get(step)
    if not entry or entry.get("config_hash") != config_hash:
        return False
    return all(Path(p).exists() for p in entry.get("artifacts", []))


def mark_step_done(
    job: SlideJob, step: str, config_hash: str, artifacts: list[str | Path]
) -> None:
    steps = _load_steps(job)
    steps[step] = {
        "config_hash": config_hash,
        "artifacts": [str(p) for p in artifacts],
        "timestamp": time.time(),
    }
    job.out_dir.mkdir(parents=True, exist_ok=True)
    job.steps_path.write_text(json.dumps(steps, indent=2))
