"""Models (port of ``brevitas_tpu/models``; ported: the FC family)."""

from brevitas_tpu_torch.models.fc import FC, lfc, sfc, tfc

__all__ = ["FC", "lfc", "sfc", "tfc"]
