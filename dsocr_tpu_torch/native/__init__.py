"""Native (C++) host code, built at first use with g++ and bound with
ctypes: the Pillow-exact bicubic resampler (dsocr_tpu/native's
counterpart, without its fall-backs), and the image decoders' codecs:
PNG unfiltering (png.cpp), JPEG scan decoding and output (jpeg.cpp),
TIFF's LZW, PackBits and CCITT decoders (tiff.cpp), its Zstandard frames
(zstd.cpp) and its YCbCr and CIELab conversions (tiff_color.cpp), BMP's
run-length data (bmp.cpp), GIF's LZW (gif.cpp), WebP's lossless and lossy
bitstreams (webp_lossless.cpp, webp_lossy.cpp) and plain PNM samples
(pnm.cpp), for image/decode.py, tiff.py, bmp.py, gif.py, webp.py and
pnm.py.

Every native and CUDA build of the package (resample.py's ``build``,
ops/kernels/_lib.py) goes to ``build_dir()``, read at each build."""

import os
import pathlib

# where builds go without DSOCR_NATIVE_CACHE (git-ignored)
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"


def build_dir() -> pathlib.Path:
    """``DSOCR_NATIVE_CACHE`` (the reference's knob) if set, else BUILD_DIR."""
    cache = os.environ.get("DSOCR_NATIVE_CACHE")
    return pathlib.Path(cache) if cache else BUILD_DIR


from .resample import resize_bicubic_native, resize_normalize_chw_native  # noqa: E402  (resample reads build_dir)

__all__ = ["BUILD_DIR", "build_dir", "resize_bicubic_native", "resize_normalize_chw_native"]
