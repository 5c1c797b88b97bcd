"""dsocr_tpu_torch: PyTorch/CUDA port of dsocr_tpu for one NVIDIA H100."""
