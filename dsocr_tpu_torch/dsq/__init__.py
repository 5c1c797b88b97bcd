"""The DSQ stack of the port (dsocr_tpu/dsq): ggml byte codecs and the
torch quantizers (quant.py), packing for serving with the snapshot's raw
payloads (serve_quant.py), the ``.dsq`` container (format.py), the
snapshot-aware weight source (runtime.py), model adapters (adapters.py)
and the info/stats/export CLI (cli.py, ``python -m dsocr_tpu_torch.dsq``)."""
