"""File enumeration helpers (K/io/IOUtil.java:49-124 and
K/Global.java:509-545)."""

from __future__ import annotations

import os
from pathlib import Path


def create_file_list(target: str, skip_links: bool = False,
                     skip_dot_files: bool = False) -> list[Path]:
    """Recursively enumerate files, with symlink-cycle detection."""
    root = Path(target)
    if root.is_file():
        if skip_dot_files and root.name.startswith("."):
            return []
        return [root]
    files: list[Path] = []
    seen: set = set()

    def walk(d: Path) -> None:
        try:
            key = os.stat(d).st_ino, os.stat(d).st_dev
        except OSError:
            return
        if key in seen:
            return  # cycle
        seen.add(key)
        try:
            entries = sorted(d.iterdir())
        except OSError:
            return
        for e in entries:
            if skip_dot_files and e.name.startswith("."):
                continue
            if e.is_symlink() and skip_links:
                continue
            if e.is_dir():
                walk(e)
            elif e.is_file():
                files.append(e)

    walk(root)
    return files


def sort_files_by_path_and_size(files: list[Path], sort_by_size: bool) -> None:
    """In-place sort: by path, or by (parent dir, size desc)
    (K/Global.java:509-545)."""
    if not sort_by_size:
        files.sort()
        return

    def key(p: Path):
        try:
            size = p.stat().st_size
        except OSError:
            size = -1
        return (str(p.parent), -size)

    files.sort(key=key)
