"""brevitas_tpu_torch — the PyTorch/CUDA port of ``brevitas_tpu``.

A second package beside the JAX one, with the same module layout file for
file (``brevitas_tpu_torch/graph/convert_int.py`` ports
``brevitas_tpu/graph/convert_int.py``). It imports ``torch`` and never JAX or
``brevitas_tpu``. Each Pallas TPU kernel on a ported path becomes a CUDA
kernel written by hand for Hopper (``csrc/``), bound with ``ctypes``; a plain
PyTorch version sits beside each kernel and serves CPU tensors.

Entry points (``models.fc.FC``/``lfc``, ``examples.serve``) default to
``device="cuda"`` and raise when CUDA is absent unless given ``device="cpu"``.
"""

__version__ = "0.1.0"
