"""DensePose IUV codec: IUV image (3 channels) <-> one-hot part/U/V/Ann maps.

Counterpart of `whmr_tpu/ops/iuv.py` (reference `utils/iuvmap.py`,
iuv_img2map :67, iuv_map2img :5), NHWC and batched. Channel 0 of an IUV
image is the part index / 24 (25 parts with the background), channels 1-2
are U and V. The 15-way annotation index groups the 25 parts by the
DensePose Index2mask table.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

# DensePose 25-part -> 15-annotation grouping (iuvmap.py:74-75).
INDEX2MASK = [
    [0], [1, 2], [3], [4], [5], [6], [7, 9], [8, 10], [11, 13], [12, 14],
    [15, 17], [16, 18], [19, 21], [20, 22], [23, 24],
]

_ANN_MATRIX = np.zeros((25, 15), np.float32)
for _ann_i, _parts in enumerate(INDEX2MASK):
    for _p in _parts:
        _ANN_MATRIX[_p, _ann_i] = 1.0


def one_hot(idx: torch.Tensor, k: int, dtype) -> torch.Tensor:
    """(...,) integer or integral-valued index -> (..., k) one-hot in `dtype`."""
    ids = torch.arange(k, dtype=idx.dtype, device=idx.device)
    return (idx[..., None] == ids).to(dtype)


def iuv_img2map(iuv_images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(B, H, W, 3) IUV image -> 'u', 'v', 'index' (B, H, W, 25) and 'ann'
    (B, H, W, 15). The part channel is rounded to the nearest index
    (`torch.round` rounds half to even, as `jnp.round`); U/V are masked per
    part."""
    part_ind = torch.round(iuv_images[..., 0] * 24.0)
    onehot = one_hot(part_ind, 25, iuv_images.dtype)
    u = onehot * iuv_images[..., 1:2]
    v = onehot * iuv_images[..., 2:3]
    # non_blocking: a copy from pageable memory that does not wait for the card.
    ann_matrix = torch.from_numpy(_ANN_MATRIX).to(iuv_images.device, non_blocking=True)
    ann_matrix = ann_matrix.to(iuv_images.dtype)
    return {"u": u, "v": v, "index": onehot, "ann": onehot @ ann_matrix}


def iuv_map2img(
    u_map: torch.Tensor,
    v_map: torch.Tensor,
    index_map: torch.Tensor,
    ann_map: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One-hot/logit maps (B, H, W, K) -> (B, H, W, 3) IUV image: the argmax
    part picks the U/V channels, part 0 (background) gives zeros, and an
    `ann_map` whose argmax is 0 gates the part to background."""
    k = index_map.shape[-1]
    idx = index_map.argmax(dim=-1)
    if ann_map is not None:
        idx = idx * (ann_map.argmax(dim=-1) > 0).to(idx.dtype)
    onehot = one_hot(idx, k, u_map.dtype)
    u = (onehot * u_map).sum(dim=-1)
    v = (onehot * v_map).sum(dim=-1)
    i = idx.to(u_map.dtype) / float(k - 1)
    return torch.stack([i, u, v], dim=-1)
