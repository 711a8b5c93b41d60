"""Git-LFS pointer detection
(counterpart of ``anomod/io/lfs.py``).

Most SN_data/TT_data payloads in the reference checkout are LFS pointer stubs
(.gitattributes:1-5), e.g. a 3-line file starting with
``version https://git-lfs.github.com/spec/v1``.  Loaders detect these and fall
back to the deterministic synthetic generator (anomod_torch.synth).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

_LFS_MAGIC = b"version https://git-lfs.github.com/spec/v1"


def is_lfs_pointer(path: Path) -> bool:
    try:
        if path.stat().st_size > 512:
            return False
        with open(path, "rb") as f:
            return f.read(len(_LFS_MAGIC)) == _LFS_MAGIC
    except OSError:
        return False


def lfs_real_size(path: Path) -> Optional[int]:
    """Declared payload size from the pointer file, if this is one."""
    if not is_lfs_pointer(path):
        return None
    for line in path.read_text().splitlines():
        if line.startswith("size "):
            return int(line.split()[1])
    return None


def read_text_or_none(path: Path) -> Optional[str]:
    """Read text content; None if missing or an LFS pointer stub."""
    p = Path(path)
    if not p.is_file() or is_lfs_pointer(p):
        return None
    return p.read_text(errors="replace")
