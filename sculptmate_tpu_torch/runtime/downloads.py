"""Checkpoint download layer with retry + progress.

A copy of ``sculptmate_tpu/runtime/downloads.py`` on the port's checkpoint
directory (``runtime/checkpoint.py:CHECKPOINT_DIR``). It replaces the
reference's ad-hoc worker-thread downloader
(``__init__.py:226-260``: urllib for u2net.onnx / model.ckpt, gdown for the
SF3D safetensors) with a structured, retryable fetcher. Default URLs point at
the same artifacts the reference uses.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import urllib.request
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from sculptmate_tpu_torch.runtime.checkpoint import CHECKPOINT_DIR

# artifact name -> URL (reference: __init__.py:241-251)
DEFAULT_ARTIFACTS: Dict[str, str] = {
    "u2net.onnx": "https://github.com/danielgatis/rembg/releases/download/v0.0.0/u2net.onnx",
    "model.ckpt": "https://github.com/shravan-d/SculptMate/releases/download/v0.3.0/model.ckpt",
}


@dataclass
class DownloadResult:
    path: str
    ok: bool
    error: Optional[str] = None


def fetch(
    url: str,
    dest_path: str,
    retries: int = 3,
    timeout: float = 30.0,
    progress: Optional[Callable[[int, int], None]] = None,
) -> DownloadResult:
    """Atomic download: stream to a temp file, rename on success."""
    os.makedirs(os.path.dirname(dest_path) or ".", exist_ok=True)
    last = None
    for _ in range(retries):
        tmp = None
        try:
            req = urllib.request.Request(url, headers={"User-Agent": "sculptmate-tpu"})
            with urllib.request.urlopen(req, timeout=timeout) as r:
                total = int(r.headers.get("Content-Length") or 0)
                fd, tmp = tempfile.mkstemp(dir=os.path.dirname(dest_path) or ".")
                done = 0
                with os.fdopen(fd, "wb") as f:
                    while True:
                        chunk = r.read(1 << 20)
                        if not chunk:
                            break
                        f.write(chunk)
                        done += len(chunk)
                        if progress:
                            progress(done, total)
            shutil.move(tmp, dest_path)
            return DownloadResult(dest_path, True)
        except Exception as e:  # noqa: BLE001 - retried
            last = e
            if tmp and os.path.exists(tmp):
                os.remove(tmp)
    return DownloadResult(dest_path, False, error=f"{type(last).__name__}: {last}")


def ensure_checkpoint(
    name: str,
    url: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    progress: Optional[Callable[[int, int], None]] = None,
) -> DownloadResult:
    """Download ``name`` into the checkpoint dir unless already present."""
    checkpoint_dir = checkpoint_dir or CHECKPOINT_DIR
    dest = os.path.join(checkpoint_dir, name)
    if os.path.isfile(dest):
        return DownloadResult(dest, True)
    url = url or DEFAULT_ARTIFACTS.get(name)
    if url is None:
        return DownloadResult(dest, False, error=f"no known URL for {name}")
    return fetch(url, dest, progress=progress)
