"""Native (C++) host code, built at first use with g++ and bound with
ctypes: the Pillow-exact bicubic resampler (dsocr_tpu/native's
counterpart, without its fall-backs), PNG unfiltering (png.cpp) and JPEG
scan decoding and output (jpeg.cpp), the last two for image/decode.py."""

from .resample import resize_bicubic_native, resize_normalize_chw_native

__all__ = ["resize_bicubic_native", "resize_normalize_chw_native"]
