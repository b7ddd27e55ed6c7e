"""Interop with the JAX package's state (numpy arrays only)."""

from brevitas_tpu_torch.interop.jax_state import load_jax_state

__all__ = ["load_jax_state"]
