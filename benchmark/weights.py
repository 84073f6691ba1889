"""Seeded weights, made on the device in one draw, shared by the port and
the reference.

Every floating tensor of the model's state (parameters and BatchNorm
statistics, fp32 as the port keeps them) is cut from one `normal_` draw of
a `torch.Generator` on the device, then scaled by a rule on its name:
lecun-normal kernels (1/sqrt(fan_in)), with the residual decoders at a
tenth of that (the camera decoder at a hundredth) so that the regressed
pose and shape depend on every layer above them while the camera stays
near its mean; 0.02 biases and position embedding; norm scales 1 +/- 0.1;
running means 0 +/- 0.1 and variances 1 + |0.1 n|.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...]]]

_DECODERS = {"decpose": 0.1, "decshape": 0.1, "decrot": 0.1, "deccam": 0.01}


def spec_of(state: Dict[str, torch.Tensor]) -> Spec:
    """The (name, shape) of each floating tensor of a state dict, in order."""
    return [(k, tuple(v.shape)) for k, v in state.items() if v.is_floating_point()]


def _rule(name: str, shape: Tuple[int, ...]) -> Tuple[float, float, bool]:
    """(mean, std, absolute) of a tensor's values."""
    parts = name.split(".")
    last, module = parts[-1], parts[-2] if len(parts) > 1 else ""
    if last == "pos_embed":
        return 0.0, 0.02, False
    if last == "running_mean":
        return 0.0, 0.1, False
    if last == "running_var":
        return 1.0, 0.1, True
    if len(shape) == 1:
        return (1.0, 0.1, False) if last == "weight" else (0.0, 0.02, False)
    if name.startswith("deconv_layers"):
        fan_in = shape[0] * math.prod(shape[2:]) / 4.0  # stride 2: a quarter of the taps reach each output
    else:
        fan_in = shape[1] * math.prod(shape[2:])
    return 0.0, _DECODERS.get(module, 1.0) / math.sqrt(fan_in), False


def generate(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> fp32 tensor on `device`, the same for the same seed."""
    total = sum(math.prod(s) for _, s in spec)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.empty(total, dtype=torch.float32, device=device).normal_(generator=gen)
    out, off = {}, 0
    for name, shape in spec:
        n = math.prod(shape)
        mean, std, absolute = _rule(name, shape)
        v = flat[off:off + n].view(shape)
        v = v.abs() if absolute else v
        out[name] = v.mul(std).add_(mean)
        off += n
    return out
