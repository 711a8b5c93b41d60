"""The data layer's settings, read from the environment (the ingest half
of ``anomod/config.py``).

The same variables as the JAX package's ``Config``, with its validation;
reference-style ``{PLACEHOLDER}`` values count as unset:

- ``ANOMOD_DATA_ROOT``: the archive root holding ``SN_data/`` and
  ``TT_data/``.  Unset: no archive, every modality comes from the
  synthetic generator.
- ``ANOMOD_SYNTH_ON_LFS``: synth-fill modalities that are missing or
  git-LFS pointer stubs (default on; ``0`` / ``false`` turn it off).
- ``ANOMOD_CACHE_DIR``: the ingest cache root; ``0`` / ``off`` / ``none``
  / ``disabled`` / ``false`` disable the cache.  Unset: ``build/
  anomod_torch_cache`` inside the checkout, so the port writes nothing
  outside it.
- ``ANOMOD_INGEST_WORKERS``: the corpus loader's process-pool size (0 or
  1: serial); anything but a non-negative integer raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Optional

#: the cache root when ``ANOMOD_CACHE_DIR`` is unset
DEFAULT_CACHE_DIR = (Path(__file__).resolve().parent.parent / "build"
                     / "anomod_torch_cache")

_CACHE_OFF = ("0", "off", "none", "disabled", "false")


def _env(name: str, default: str) -> str:
    val = os.environ.get(name, "").strip()
    if not val or (val.startswith("{") and val.endswith("}")):
        return default
    return val


def _data_root_env() -> Optional[Path]:
    raw = _env("ANOMOD_DATA_ROOT", "")
    return Path(raw) if raw else None


def _cache_dir_env() -> Optional[Path]:
    raw = _env("ANOMOD_CACHE_DIR", "")
    if raw.lower() in _CACHE_OFF:
        return None
    if raw:
        return Path(raw).expanduser()
    return DEFAULT_CACHE_DIR


def _ingest_workers_env() -> int:
    raw = _env("ANOMOD_INGEST_WORKERS", "0")
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"ANOMOD_INGEST_WORKERS must be a non-negative integer "
            f"(0/1 = serial), got {raw!r}")
    if n < 0:
        raise ValueError(
            f"ANOMOD_INGEST_WORKERS must be >= 0, got {n}")
    return n


@dataclasses.dataclass
class DataConfig:
    """Where experiments come from and how they are loaded."""

    data_root: Optional[Path] = dataclasses.field(
        default_factory=_data_root_env)
    synth_on_lfs: bool = dataclasses.field(
        default_factory=lambda: _env("ANOMOD_SYNTH_ON_LFS", "1")
        not in ("0", "false"))
    cache_dir: Optional[Path] = dataclasses.field(
        default_factory=_cache_dir_env)
    ingest_workers: int = dataclasses.field(
        default_factory=_ingest_workers_env)

    @property
    def sn_data(self) -> Optional[Path]:
        return None if self.data_root is None else \
            Path(self.data_root) / "SN_data"

    @property
    def tt_data(self) -> Optional[Path]:
        return None if self.data_root is None else \
            Path(self.data_root) / "TT_data"


_DEFAULT: Optional[DataConfig] = None


def get_config() -> DataConfig:
    """The process's settings, read from the environment once."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = DataConfig()
    return _DEFAULT
