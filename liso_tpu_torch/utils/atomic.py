"""Whole-file publishes.

A file that another process polls for, or that a later run resumes from
by its name alone, is written under a temporary name in its own directory
and then renamed onto its final name with `os.replace`, which is atomic
within one file system. A reader then sees no file or the whole file,
never an empty or truncated one. The temporary name starts with a dot and
ends in `.tmp`, so no name or pattern that a reader looks for matches it;
a process killed mid-write leaves it behind, and every reader ignores it.
"""
from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Callable


def temp_path(path: Path) -> Path:
    """The temporary name of `path`: beside it, unique to this process."""
    return path.with_name(f".{path.name}.{os.getpid()}.tmp")


def _remove(path: Path) -> None:
    if path.is_dir():
        shutil.rmtree(path)
    else:
        path.unlink(missing_ok=True)


def publish(path, write: Callable[[Path], object]) -> Path:
    """`write(tmp)` makes the file or directory at a temporary path beside
    `path`, which then replaces `path`. If `write` raises, the temporary
    is removed and `path` stays as it was. A directory that `path` already
    names is removed just before the rename (`os.replace` moves no
    directory onto a non-empty one)."""
    path = Path(path)
    tmp = temp_path(path)
    _remove(tmp)  # a leftover of a killed write under this process id
    try:
        write(tmp)
        if tmp.is_dir() and path.exists():
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        _remove(tmp)
        raise
    return path


def publish_text(path, text: str) -> Path:
    return publish(path, lambda tmp: tmp.write_text(text))
