"""The per-frame step and the chunked sequence runner."""
