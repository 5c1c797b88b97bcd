"""Model families of the port (DeepSeek-OCR v1 so far)."""
