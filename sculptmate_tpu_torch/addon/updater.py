"""Add-on auto-updater: GitHub-release check / download / staged install.

A copy of ``sculptmate_tpu/addon/updater.py``.

Compact replacement for the reference's vendored CGCookie engine
(``addon_updater.py:50+``, ``addon_updater_ops.py:1336``): checks the GitHub
releases API for a newer tag, downloads the zip, stages it next to the
install, backs up the current tree, and swaps — with structured error
reporting instead of silent failure. Runs on a worker thread from the
preferences UI; safe to import outside Blender.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import urllib.request
import zipfile
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple


def _parse_version(tag: str) -> Tuple[int, ...]:
    tag = tag.lstrip("vV")
    parts = []
    for tok in tag.split("."):
        num = ""
        for ch in tok:  # leading digits only: "0-rc1" -> 0
            if ch.isdigit():
                num += ch
            else:
                break
        parts.append(int(num) if num else 0)
    return tuple(parts)


@dataclass
class AddonUpdater:
    user: str
    repo: str
    current_version: Tuple[int, ...]
    install_dir: str
    api_url: str = "https://api.github.com/repos/{user}/{repo}/releases/latest"
    timeout: float = 15.0
    retries: int = 3
    on_progress: Optional[Callable[[str], None]] = None
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def _report(self, msg: str) -> None:
        if self.on_progress:
            self.on_progress(msg)

    def _fetch_json(self, url: str):
        last = None
        for _ in range(self.retries):
            try:
                with urllib.request.urlopen(url, timeout=self.timeout) as r:
                    return json.loads(r.read().decode())
            except Exception as e:  # noqa: BLE001 - retryable network layer
                last = e
        raise RuntimeError(f"update check failed after {self.retries} tries: {last}")

    def check(self):
        """Returns (update_available, latest_tag, zip_url)."""
        url = self.api_url.format(user=self.user, repo=self.repo)
        data = self._fetch_json(url)
        tag = data.get("tag_name", "0")
        zip_url = data.get("zipball_url")
        newer = _parse_version(tag) > tuple(self.current_version)
        return newer, tag, zip_url

    def download_and_stage(self, zip_url: str, staging_dir: Optional[str] = None) -> str:
        staging_dir = staging_dir or os.path.join(self.install_dir, "_update_staging")
        os.makedirs(staging_dir, exist_ok=True)
        zip_path = os.path.join(staging_dir, "update.zip")
        self._report("downloading update...")
        with urllib.request.urlopen(zip_url, timeout=self.timeout) as r, open(
            zip_path, "wb"
        ) as f:
            shutil.copyfileobj(r, f)
        with zipfile.ZipFile(zip_path) as z:
            z.extractall(staging_dir)
        os.remove(zip_path)
        # GitHub zipballs nest a single top-level directory
        entries = [e for e in os.listdir(staging_dir) if not e.startswith(".")]
        root = (
            os.path.join(staging_dir, entries[0])
            if len(entries) == 1 and os.path.isdir(os.path.join(staging_dir, entries[0]))
            else staging_dir
        )
        return root

    def apply(self, staged_root: str) -> str:
        """Back up the current install and swap in the staged tree.
        Returns the backup path (for restore)."""
        with self._lock:
            backup = self.install_dir + "_backup"
            if os.path.isdir(backup):
                shutil.rmtree(backup)
            self._report("backing up current version...")
            shutil.copytree(self.install_dir, backup, ignore=shutil.ignore_patterns("_update_staging", "__pycache__"))
            self._report("installing update...")
            for name in os.listdir(staged_root):
                src = os.path.join(staged_root, name)
                dst = os.path.join(self.install_dir, name)
                if os.path.isdir(dst):
                    shutil.rmtree(dst)
                elif os.path.isfile(dst):
                    os.remove(dst)
                shutil.move(src, dst)
            return backup

    def restore(self, backup: str) -> None:
        with self._lock:
            for name in os.listdir(backup):
                src = os.path.join(backup, name)
                dst = os.path.join(self.install_dir, name)
                if os.path.isdir(dst):
                    shutil.rmtree(dst)
                elif os.path.isfile(dst):
                    os.remove(dst)
                shutil.copytree(src, dst) if os.path.isdir(src) else shutil.copy2(src, dst)

    def run_update_async(self, done: Optional[Callable[[Optional[str]], None]] = None):
        """Background check+download+apply; calls done(error_or_None)."""

        def work():
            try:
                newer, tag, zip_url = self.check()
                if not newer:
                    self._report("already up to date")
                    if done:
                        done(None)
                    return
                root = self.download_and_stage(zip_url)
                self.apply(root)
                self._report(f"updated to {tag}; restart Blender")
                if done:
                    done(None)
            except Exception as e:  # noqa: BLE001 - surfaced to UI
                self._report(f"update failed: {e}")
                if done:
                    done(str(e))

        threading.Thread(target=work, daemon=True).start()
