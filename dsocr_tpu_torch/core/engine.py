"""Model kinds and loader arguments (dsocr_tpu/core/engine.py:23-60).

``ModelKind`` names the four OCR families; ``ModelLoadArgs`` carries what
a loader needs (models/registry.py: load_engine). The port runs on one
CUDA card: ``device`` None means the card, "cpu" the host when asked for
by name (core/device.py); ``dtype`` a dtype name that
registry.resolve_dtype reads ("bfloat16", "float32", ...).
"""

from __future__ import annotations

import dataclasses
import enum
import pathlib
from typing import Optional


class ModelKind(enum.Enum):
    DEEPSEEK = "deepseek"
    PADDLE_OCR_VL = "paddle_ocr_vl"
    DOTS_OCR = "dots_ocr"
    GLM_OCR = "glm_ocr"


@dataclasses.dataclass
class ModelLoadArgs:
    """Inputs to a model loader (the reference's, with a torch device)."""

    kind: ModelKind
    config_path: Optional[pathlib.Path] = None
    weights_path: Optional[pathlib.Path] = None
    snapshot_path: Optional[pathlib.Path] = None
    device: Optional[str] = None
    dtype: str = "bfloat16"
    mesh: Optional[str] = None  # "dp=N,mp=M[,ep]": rank processes (models/registry.py)
