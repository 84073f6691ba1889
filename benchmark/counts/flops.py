"""Model FLOPs of one crop, counted from a configuration's sizes.

Every product and convolution of the published forward, two FLOPs a
multiply-add: the ViT (patch embed; per block 24*N*D^2 for qkv, proj and
the 4x MLP, and 4*N^2*D for the two attention products), the deconv
pyramid (a stride-2 transposed convolution does Cin*Cout*k^2 multiply-adds
per input pixel), the Tz head's VALID convolutions and its token block,
the IUV head's four 3x3 convolutions, the MAF point MLPs and regressors,
the global-orientation head (three passes in training, one in eval), and
the SMPL geometry (blend shapes, joint regression, skinning, and the dense
mesh downsampling of each regressor step). Elementwise work, softmax and
normalisation are not counted. A training step counts three forwards (the
backward's two products per forward product); the recompute of `vit.remat`,
the GT targets and the optimizer are not model FLOPs.
"""

from __future__ import annotations

from typing import Dict

V, NPOSE = 6890, 216


def _conv(cin, cout, k, h_out, w_out):
    return 2 * cin * cout * k * k * h_out * w_out


def _smpl(dmaps: bool, n_sub=1723, n_temp=431):
    f = 2 * V * 3 * 10 + 2 * 24 * V * 3 + 2 * 207 * 3 * V + 2 * V * 24 * 12 + 2 * V * 12 + 2 * 9 * V * 3
    if dmaps:
        f += 2 * n_sub * V * 3 + 2 * n_temp * n_sub * 3
    return f


def forward_parts(s: Dict, train: bool = False) -> Dict[str, int]:
    """FLOPs of one crop's forward by part, for sizes by the port's dotted keys."""
    d, depth = s["vit.embed_dim"], s["vit.depth"]
    patch, pad = s["vit.patch_size"], s["vit.patch_padding"]
    h, w = s["vit.img_size"]
    hp, wp = (h + 2 * pad - patch) // patch + 1, (w + 2 * pad - patch) // patch + 1
    n = hp * wp
    hidden = int(d * s["vit.mlp_ratio"])
    block = 2 * n * (3 * d * d + d * d + 2 * d * hidden) + 4 * n * n * d
    parts = {"vit": _conv(3, d, patch, hp, wp) + depth * block}

    deconv, c_in, fh, fw = 0, d, hp, wp
    for f, k in zip(s["deconv.num_filters"], s["deconv.num_kernels"]):
        deconv += 2 * c_in * f * k * k * fh * fw
        c_in, fh, fw = f, fh * 2, fw * 2
    parts["deconv"] = deconv

    h1, w1 = (fh - 7) // 3 + 1, (fw - 7) // 3 + 1
    h2, w2 = (h1 - 7) // 2 + 1, (w1 - 7) // 2 + 1
    tok = h2 * w2
    tz_block = 2 * 5 * (4 * tok * tok + 2 * tok * 4 * tok) + 4 * 5 * 5 * tok
    parts["tz_head"] = _conv(c_in, 64, 7, h1, w1) + _conv(64, 5, 7, h2, w2) + tz_block + 2 * (tok * 12 + 12)
    parts["iuv_head"] = _conv(c_in, 25 + 25 + 15 + 25, 3, fh, fw)

    mlp = s["pymaf.mlp_dim"]
    n_iter, markers = s["pymaf.n_iter"], 67
    point_mlp = sum(2 * (mlp[0] if i == 0 else mlp[i] + mlp[0]) * mlp[i + 1] for i in range(len(mlp) - 1))
    maf = point_mlp * (63 + markers * (n_iter - 1))
    regress = 0
    for i in range(n_iter):
        feat = (63 if i == 0 else markers) * mlp[-1]
        regress += 2 * ((feat + 5 + NPOSE + 13) * 1024 + 1024 * 1024 + 1024 * (NPOSE + 13))
    parts["maf_regressors"] = maf + regress
    g_in = markers * mlp[-1] + 5 + 15
    parts["global_orient"] = (3 if train else 1) * 2 * (g_in * 2048 + 2048 * 2048 + 2048 * 9)
    parts["smpl"] = (n_iter + 1) * _smpl(True) + _smpl(False)
    return parts


def forward_flops(s: Dict, train: bool = False) -> int:
    return sum(forward_parts(s, train).values())


def train_flops(s: Dict) -> int:
    """Model FLOPs of one crop's training step: three train forwards."""
    return 3 * forward_flops(s, train=True)
