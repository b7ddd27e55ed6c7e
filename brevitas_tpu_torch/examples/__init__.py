"""Example entry points (port of ``brevitas_tpu/examples``)."""
