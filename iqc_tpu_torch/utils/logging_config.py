"""Logging configuration from the ``logging:`` block of the config.

``configure_logging`` applies the root format and level, an optional
rotating file handler, and per-component (``iqc_tpu_torch.models`` /
``inference`` / ``analytics`` / ``serving``) level overrides.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
from typing import Dict, Optional

DEFAULT_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"

_COMPONENT_PREFIX = {
    "models": "iqc_tpu_torch.models",
    "inference": "iqc_tpu_torch.inference",
    "analytics": "iqc_tpu_torch.analytics",
    "api": "iqc_tpu_torch.serving",
    "train": "iqc_tpu_torch.train",
    "spc": "iqc_tpu_torch.analytics.spc",
}


def configure_logging(
    level: str = "INFO",
    fmt: str = DEFAULT_FORMAT,
    file_path: Optional[str] = None,
    max_file_size_mb: int = 100,
    backup_count: int = 5,
    component_levels: Optional[Dict[str, str]] = None,
) -> None:
    handlers = [logging.StreamHandler()]
    if file_path:
        os.makedirs(os.path.dirname(file_path) or ".", exist_ok=True)
        handlers.append(
            logging.handlers.RotatingFileHandler(
                file_path, maxBytes=max_file_size_mb * 2**20,
                backupCount=backup_count,
            )
        )
    logging.basicConfig(level=getattr(logging, level.upper(), logging.INFO),
                        format=fmt, handlers=handlers, force=True)
    for component, lvl in (component_levels or {}).items():
        name = _COMPONENT_PREFIX.get(component, component)
        logging.getLogger(name).setLevel(getattr(logging, lvl.upper(), logging.INFO))


def configure_from_config(extra: Dict) -> None:
    """Apply the reference-shaped ``logging:`` config block."""
    block = (extra or {}).get("logging", {})
    configure_logging(
        level=block.get("level", "INFO"),
        fmt=block.get("format", DEFAULT_FORMAT),
        file_path=block.get("file_path"),
        max_file_size_mb=int(block.get("max_file_size_mb", 100)),
        backup_count=int(block.get("backup_count", 5)),
        component_levels=block.get("loggers"),
    )
