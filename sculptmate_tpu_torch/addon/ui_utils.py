"""Blender UI text utilities (reference ``utils.py:1-69``).

A copy of ``sculptmate_tpu/addon/ui_utils.py``.
"""

from __future__ import annotations

import textwrap


def label_multiline(layout, text: str = "", icon: str = "NONE", width: int = 0):
    """Word-wrap a long message into multiple panel labels.

    Mirrors the reference helper: estimates characters per line from the
    region width (~7 px/char), wraps, and emits one label per line with the
    icon on the first line only.
    """
    if not text:
        return
    chars_per_line = max(int((width or 240) / 7), 10)
    lines = []
    for paragraph in text.split("\n"):
        lines.extend(textwrap.wrap(paragraph, chars_per_line) or [""])
    for i, line in enumerate(lines):
        layout.label(text=line, icon=icon if i == 0 else "NONE")
