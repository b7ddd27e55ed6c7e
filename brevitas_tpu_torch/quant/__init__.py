"""Declarative quantizer configs and the modules they resolve into (port of
``brevitas_tpu/quant``)."""
