"""Cross-process persistence of observed buffer capacities.

Counterpart of ``sculptmate_tpu/runtime/capacity_cache.py``. The wire
extraction dispatches with a fixed vertex capacity; the default is sized
for any asset and a fresh process otherwise starts from it, so the first
large asset pays an overflow retry (a second density grid and compaction)
before the in-memory cache (``TSR._wire_cap_cache``) has learned its size.
This module keeps those capacities on disk, so a fresh process starts at
the steady-state values.

Stale entries are harmless by construction: every consumer detects
overflow from exact wire counters and retries with a grown capacity (never
truncates), so a too-small value costs one retry and a too-large one only
bytes.

The store is ``capacity_cache.json`` in the port's build directory
(``sculptmate_tpu_torch/_build``). Set ``SCULPTMATE_CAP_CACHE`` to a
directory to relocate it, or to ``0`` to disable persistence.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional, Sequence, Tuple

_FILENAME = "capacity_cache.json"
_DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")


def _path() -> Optional[str]:
    d = os.environ.get("SCULPTMATE_CAP_CACHE")
    if d == "0":
        return None
    return os.path.join(d or _DEFAULT_DIR, _FILENAME)


def _read_all(path: str) -> dict:
    try:
        with open(path) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}


def load(key: str) -> Optional[Tuple[int, ...]]:
    """Persisted capacities for ``key``, or None. Values are ints."""
    path = _path()
    if path is None:
        return None
    vals = _read_all(path).get(key)
    if not isinstance(vals, list) or not all(isinstance(v, int) and v >= 0 for v in vals):
        return None
    return tuple(vals)


def tighten(current: int, observed: int, *, slack: float = 1.35, bucket: int = 65536, shrink_at: float = 2.0) -> int:
    """Capacity to keep after a successful run that observed ``observed``
    live entries: shrink toward ``slack * observed`` (bucket-rounded) only
    when the overshoot exceeds ``shrink_at`` x that target, so one giant
    asset cannot inflate every later buffer and normal variation does not
    flap the capacity. A later bigger asset costs one detected-overflow
    retry, never a truncation."""
    target = max(bucket, bucket * -(-int(slack * observed) // bucket))
    return target if current > shrink_at * target else current


def store(key: str, caps: Sequence[int]) -> None:
    """Read-modify-write with an atomic replace; a lost race between two
    processes drops one update, never corrupts the file. Best effort: an
    unwritable directory is ignored."""
    path = _path()
    if path is None:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        data = _read_all(path)
        data[key] = [int(v) for v in caps]
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".capcache-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(data, f)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except OSError:
        pass
