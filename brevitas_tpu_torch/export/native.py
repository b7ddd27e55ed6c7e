"""Native integer serving artifact (port of ``brevitas_tpu/export/native.py``).

One ``.npz`` holds every INT-weight linear and conv: the integer weights,
their scales and zero points, the raw bias and a JSON manifest of the
layers. The arrays are in the JAX package's layout, so the two packages
write the same artifact and each reads the other's: a linear's codes (in,
out), a conv's (*kernel, in, out), a per-channel scale or zero point with
its channels last, and weights of at most 4 bits packed two a byte along
the last axis (low nibble first) where that axis is even.
"""

import json
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from brevitas_tpu_torch.nn.conv import _QuantConvNd
from brevitas_tpu_torch.nn.linear import QuantLinear
from brevitas_tpu_torch.quant.config import QuantType


def pack_int4_np(values: np.ndarray) -> np.ndarray:
    """Two 4-bit codes a byte along the last axis, the even one low."""
    v = values.astype(np.int8)
    lo = v[..., 0::2] & 0x0F
    hi = (v[..., 1::2] & 0x0F) << 4
    return (lo | hi).astype(np.int8)


def unpack_int4_np(packed: np.ndarray, signed: bool = True) -> np.ndarray:
    p = packed.astype(np.int8)
    if signed:
        lo = ((p << 4).astype(np.int8) >> 4)
        hi = p >> 4
    else:
        lo = p & 0x0F
        hi = (p >> 4) & 0x0F
    out = np.stack([lo, hi], axis=-1)
    return out.reshape(*p.shape[:-1], p.shape[-1] * 2)


def _jax_layout(v, weight_ndim: int) -> np.ndarray:
    """A weight-shaped array (output channel on axis 0) in the JAX
    package's channels-last layout; a per-tensor value as a 0-d array."""
    a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)
    if a.size == 1 and a.ndim <= 1:
        return a.reshape(())
    if a.ndim == weight_ndim and a.ndim > 1:
        a = np.moveaxis(a, 0, -1)
        if weight_ndim > 2:  # (*kernel, in, out): the kernel axes lead
            a = np.moveaxis(a, 0, -2)
    return np.ascontiguousarray(a)


def export_native(model: nn.Module, path: str) -> Dict:
    """Serialize every INT-weight quant linear and conv to ``path``."""
    model.eval()
    arrays: Dict[str, np.ndarray] = {}
    manifest: List[Dict] = []
    for mod_path, mod in model.named_modules():
        if not isinstance(mod, (QuantLinear, _QuantConvNd)):
            continue
        if mod.weight_quant.quant_type != QuantType.INT:
            continue
        with torch.no_grad():
            qw = mod.quant_weight()
        bw = float(qw.bit_width)
        key = mod_path.replace(".", "/")
        ndim = qw.value.ndim
        w_int = _jax_layout(qw.int() if bw <= 8 else qw.int(float_datatype=True), ndim)
        packed = False
        if bw <= 4 and w_int.shape[-1] % 2 == 0:
            w_int = pack_int4_np(w_int)  # halves an int4 artifact
            packed = True
        arrays[f"{key}/w_int"] = w_int
        arrays[f"{key}/w_scale"] = _jax_layout(qw.scale, ndim)
        arrays[f"{key}/w_zero_point"] = _jax_layout(qw.zero_point, ndim)
        if mod.bias is not None:
            arrays[f"{key}/bias"] = mod.bias.detach().cpu().numpy()
        entry = {
            "path": mod_path,
            "kind": "linear" if isinstance(mod, QuantLinear) else "conv",
            "bit_width": bw,
            "signed": bool(qw.signed),
            "int4_packed": packed,
        }
        if isinstance(mod, _QuantConvNd):
            entry.update(stride=list(mod.stride), groups=mod.groups,
                         padding=mod.padding if isinstance(mod.padding, str)
                         else [list(p) for p in mod.padding])
        manifest.append(entry)
    arrays["__manifest__"] = np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8)
    np.savez(path, **arrays)
    return {"layers": len(manifest), "path": path}


def load_native(path: str) -> Dict:
    """Load a native artifact (either package's) into {path: {meta, w_int,
    w_scale, w_zero_point, bias}}, the codes unpacked."""
    data = np.load(path)
    manifest = json.loads(bytes(data["__manifest__"]).decode())
    out = {}
    for entry in manifest:
        key = entry["path"].replace(".", "/")
        w_int = data[f"{key}/w_int"]
        if entry.get("int4_packed"):
            w_int = unpack_int4_np(w_int, signed=entry["signed"])
        out[entry["path"]] = {
            "meta": entry,
            "w_int": w_int,
            "w_scale": data[f"{key}/w_scale"],
            "w_zero_point": data[f"{key}/w_zero_point"],
            "bias": data.get(f"{key}/bias"),
        }
    return out
