"""Packed quantization for serving (dsocr_tpu/dsq): the Q8_0 half."""
