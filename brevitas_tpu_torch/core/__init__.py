"""Fake-quant math, restrictions and statistics (port of
``brevitas_tpu/core``)."""
