"""Weight-only int8 quantization of torch state dicts for the int8 engines.

Counterpart of ``ursabench_tpu/profiling/quantize.py``, with the same scheme:
symmetric, 127 levels, one scale per output channel (and per member for a
stacked ensemble), ``scale = max(amax, 1e-12) / 127``, round half to even,
clip to [-127, 127]. Entries that are not floating point, or have fewer than
``min_ndim`` dimensions besides the member axis (biases, BatchNorm
parameters and statistics), stay raw.

The output channel sits where torch keeps it: axis 0 of a conv weight (OIHW)
or a linear weight (out, in), axis 1 behind a leading member axis. (Flax
keeps it last, in HWIO and (in, out).) So the amax is reduced over every
axis except the member axis and the output-channel axis.

An encoded state maps each name to ``{"q8": int8, "scale": float32}`` or
``{"raw": tensor}``. The engines dequantize inside the forward, as
``q.to(dtype) * scale.to(dtype)``: the scale is rounded to the compute dtype
before the product, as the JAX package does.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

__all__ = ["quantize_state", "dequantize_state", "quantization_error"]

Encoded = Dict[str, Dict[str, torch.Tensor]]


def quantize_tensor(x: torch.Tensor, channel_axis: int):
    """``(q8, scale)`` of ``x`` with one scale per index of every axis up to
    and including ``channel_axis``; the scale keeps ``x``'s number of
    dimensions."""
    xf = x.to(torch.float32)
    red = tuple(range(channel_axis + 1, x.dim()))
    amax = xf.abs().amax(dim=red, keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_state(state: Mapping[str, torch.Tensor], *, member_axis: bool = False,
                   min_ndim: int = 2) -> Encoded:
    """Encode a state dict: quantizable weights -> ``{"q8", "scale"}``, all
    else -> ``{"raw"}``. ``member_axis=True`` treats axis 0 as a stacked
    ensemble axis (per-member scales)."""
    lo = 1 if member_axis else 0
    out: Encoded = {}
    for name, x in state.items():
        if not x.is_floating_point() or x.dim() < min_ndim + lo:
            out[name] = {"raw": x}
            continue
        q, scale = quantize_tensor(x, channel_axis=lo)
        out[name] = {"q8": q, "scale": scale}
    return out


def dequantize_state(encoded: Encoded, dtype: torch.dtype = torch.bfloat16
                     ) -> Dict[str, torch.Tensor]:
    """Decode to dense tensors in ``dtype``; raw entries that are not
    floating point keep their own dtype."""
    out = {}
    for name, node in encoded.items():
        if "raw" in node:
            x = node["raw"]
            out[name] = x.to(dtype) if x.is_floating_point() else x
        else:
            out[name] = node["q8"].to(dtype) * node["scale"].to(dtype)
    return out


def quantization_error(state: Mapping[str, torch.Tensor], *,
                       member_axis: bool = False) -> float:
    """Largest relative L2 error over the entries (a sanity metric: the
    127-level grid sits around 0.5% rms)."""
    decoded = dequantize_state(quantize_state(state, member_axis=member_axis),
                               torch.float32)
    worst = 0.0
    for name, a in state.items():
        if not a.is_floating_point():
            continue
        a = a.to(torch.float32)
        denom = float(torch.linalg.vector_norm(a)) or 1.0
        worst = max(worst, float(torch.linalg.vector_norm(a - decoded[name])) / denom)
    return worst
