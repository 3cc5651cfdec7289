"""The extraction capacity policy (``Capacities``) and its store on disk.

Counterpart of ``sculptmate_tpu/runtime/capacity_cache.py``. An extraction
writes into buffers of fixed capacities whose counters are exact, so an
overflow is detected and retried with grown capacities, never decoded
truncated. Capacities that worked are kept on disk, so a fresh process
starts at the steady-state values; a stale entry costs one retry, or only
bytes.

The store is ``capacity_cache.json`` in the port's build directory
(``sculptmate_tpu_torch/_build``). Set ``SCULPTMATE_CAP_CACHE`` to a
directory to relocate it, or to ``0`` to disable persistence.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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


class Capacities:
    """The capacity policy of one extraction path, kept per resolution in
    memory and on disk under ``<name>_r<resolution>``:

    - ``dispatch``: each capacity the caller gives (> 0), else the one kept
      (in this process, else read once from the store), else
      ``default(resolution)``; with ``at_least_default``, never below it;
    - ``grow``: after an overflow (any count above its capacity), each
      capacity to 1.2x its count in buckets of 65 536, never below its own;
    - ``keep``: after a success, each capacity ``tighten``-ed toward its
      count, remembered and stored; ``keep_batch`` once for a batch, from
      its element-wise largest counts and capacities.

    ``at_least_default`` is the owners' one difference: the TSR's paths set
    it, the SF3D's marching tets do not. ROADMAP queue 2 item D is where to
    decide whether they should differ."""

    def __init__(self, name: str, default: Callable[[int], Tuple[int, ...]], at_least_default: bool):
        self.name, self.default, self.at_least_default = name, default, at_least_default
        self._kept: Dict[int, Optional[Tuple[int, ...]]] = {}

    def key(self, resolution: int) -> str:
        return f"{self.name}_r{resolution}"

    def kept(self, resolution: int) -> Optional[Tuple[int, ...]]:
        """The capacities kept at ``resolution``, or None."""
        if resolution not in self._kept:
            self._kept[resolution] = load(self.key(resolution))
        return self._kept[resolution]

    def dispatch(self, resolution: int, given: Sequence[int] = ()) -> Tuple[int, ...]:
        default = self.default(resolution)
        kept = self.kept(resolution)
        if kept is None or len(kept) != len(default):
            kept = default
        if self.at_least_default:
            kept = tuple(map(max, kept, default))
        return tuple(g if g > 0 else k for g, k in zip(given or (0,) * len(kept), kept))

    @staticmethod
    def grow(counts: Sequence[int], caps: Sequence[int]) -> Optional[Tuple[int, ...]]:
        """None when every capacity held, else the capacities to retry with."""
        if all(n <= c for n, c in zip(counts, caps)):
            return None
        return tuple(max(c, 65536 * -(-int(1.2 * n) // 65536)) for n, c in zip(counts, caps))

    def keep(self, resolution: int, counts: Sequence[int], caps: Sequence[int]) -> None:
        caps = tuple(tighten(c, n) for c, n in zip(caps, counts))
        self._kept[resolution] = caps
        store(self.key(resolution), caps)

    def keep_batch(self, resolution: int, runs: List[Tuple[Sequence[int], Sequence[int]]]) -> None:
        """``keep`` once for a batch's (counts, capacities) runs."""
        counts, caps = (tuple(map(max, zip(*column))) for column in zip(*runs))
        self.keep(resolution, counts, caps)
