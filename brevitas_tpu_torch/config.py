"""Process-wide serving switches (port of ``brevitas_tpu/config.py``; ported:
packed int4 serving weights and the int4 KV-cache policy).

They read the environment once at import, under the JAX package's names, so
one setting gives both packages the same serving twins for the same model;
tests and scripts may also assign the attributes directly.

``INT4_PACKED_SERVING`` (default on): ``Int8InferenceLinear`` stores weights
of 4 bits or fewer two per byte and serves them with ``int4_matmul``. The
JAX package packs only shapes its Pallas kernel tiles; the port packs every
such weight whose input width is even.

``INT4_KV_CACHE`` decides whether ``Int8InferenceAttention`` packs a decode
cache whose K/V codes fit a nibble two positions per byte:

- ``"auto"`` (default): pack when the head dimension is at least
  ``INT4_KV_MIN_HEAD_DIM``, or when the model asked for a nibble KV grid
  (``QuantLlama(kv_bit_width=4)``);
- ``"1"`` / ``"true"`` / ``"on"``: always pack when the codes fit;
- ``"0"`` / ``"false"`` / ``"off"``: never pack.

The boundary of 128 was measured for the JAX package on a TPU v5e, where
the nibble unpack cost more than it saved at head dimension 64. It is kept
so that both packages build the same cache; on the H100 it is still to be
measured.
"""

import os


def env_to_bool(name: str, default: bool = False) -> bool:
    return os.environ.get(name, str(default).upper()).upper() in ("1", "TRUE", "ON")


INT4_PACKED_SERVING: bool = env_to_bool("BREVITAS_TPU_INT4_PACKED", True)
INT4_KV_CACHE: str = os.environ.get("BREVITAS_TPU_INT4_KV", "auto").lower()
INT4_KV_MIN_HEAD_DIM: int = int(
    os.environ.get("BREVITAS_TPU_INT4_KV_MIN_HEAD_DIM", "128"))
