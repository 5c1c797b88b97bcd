"""Host-side image preprocessing without Pillow: Pillow-exact bicubic
resampling (native, with its NumPy twin), the letterboxed global view
and dynamic crop tiles (dsocr_tpu/image, bit-exact with it)."""

from .ops import build_global_view_with_box, round_ties_to_even
from .resample import resize_bicubic, resize_bicubic_numpy
from .tiling import DynamicPreprocessResult, PreprocessParams, dynamic_preprocess, select_target_ratio

__all__ = [
    "DynamicPreprocessResult",
    "PreprocessParams",
    "build_global_view_with_box",
    "dynamic_preprocess",
    "resize_bicubic",
    "resize_bicubic_numpy",
    "round_ties_to_even",
    "select_target_ratio",
]
