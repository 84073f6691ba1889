"""The plain W-HMR reference: the whole forward in float32 PyTorch, in eval
and in train mode, at a configuration's published widths.

Written from the published W-HMR graph (arXiv:2311.17460; reference
models/whmr.py) and frozen from the test suite's `TorchWHMROracle`, widened
to the configurations' sizes and given the training mode: ViTPose backbone
(padded 16x16 patch embed, cls-folded position embedding, pre-LN blocks,
drop path rising linearly to the configured rate), the three-level deconv
pyramid, the Tz head, three MAF steps (grid_sample at the fixed grid, then
at the projected markers), the residual SMPL regressors, the world
global-orientation head and world SMPL, and the IUV head.

It imports nothing of the port, runs with TF32 off, and reads its weights
from the benchmark's seeded weight dictionary by the reference's parameter
names. Training draws its drop-path and dropout masks as fp32 uniforms
from the `torch.Generator` it is handed, shape by shape in the order the
published forward applies them (each block's two drop-path masks, then
each regressor's two dropout masks, then the global-orientation head's
three passes of two), so that it follows the same generator state as the
system under test does.

`fp8=True` computes every product and convolution of the network (not the
SMPL geometry) from operands rounded to float8 with one scale per tensor,
e4m3 in the forward and e5m2 for the gradients that flow back into it, as
fp8 training does: the precision below the configuration's bfloat16, used
as the control of the comparison that decides `correct`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.smpl import SMPLArrays, smpl49

FOCAL_LENGTH = 1000.0
IMG_RES = 256.0
NPOSE = 216


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to the float8 `dtype` at a per-tensor scale."""
    scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    """Forward: x in e4m3. Backward: the incoming gradient in e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


class _Q:
    fp8 = False

    def ops(self, *ts):
        return tuple(_Fp8.apply(t) if (self.fp8 and t is not None) else t for t in ts)


class Linear(_Q, nn.Linear):
    def forward(self, x):
        x, w = self.ops(x, self.weight)
        return F.linear(x, w, self.bias)


class Conv2d(_Q, nn.Conv2d):
    def forward(self, x):
        x, w = self.ops(x, self.weight)
        return self._conv_forward(x, w, self.bias)


class ConvTranspose2d(_Q, nn.ConvTranspose2d):
    def forward(self, x):
        x, w = self.ops(x, self.weight)
        return F.conv_transpose2d(x, w, self.bias, self.stride, self.padding)


class Conv1d(_Q, nn.Conv1d):
    def forward(self, x):
        x, w = self.ops(x, self.weight)
        return self._conv_forward(x, w, self.bias)


class Attention(_Q, nn.Module):
    def __init__(self, dim, heads, qkv_bias=True):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        q, k = self.ops(q, k)
        attn = (q @ k.transpose(-2, -1)) * (c // self.heads) ** -0.5
        attn, v = self.ops(attn.softmax(dim=-1), v)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim, heads, mlp_ratio=4.0, qkv_bias=True, eps=1e-6, drop_path=0.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.p = drop_path

    def draw(self, x, generator=None):
        """The block's two drop-path masks (attention's, then the MLP's)."""
        if not (self.training and self.p > 0):
            return [None, None]
        return [torch.rand((x.shape[0], 1, 1), generator=generator, device=x.device) < 1.0 - self.p
                for _ in range(2)]

    def forward(self, x, masks=(None, None)):
        def path(y, m):
            return y if m is None else y / (1.0 - self.p) * m.to(y.dtype)

        x = x + path(self.attn(self.norm1(x)), masks[0])
        return x + path(self.mlp(self.norm2(x)), masks[1])


class PatchEmbed(nn.Module):
    def __init__(self, dim, patch, pad):
        super().__init__()
        self.proj = Conv2d(3, dim, patch, stride=patch, padding=pad)


class ViT(nn.Module):
    def __init__(self, dim, depth, heads, mlp_ratio, n_tokens, drop_path_rate, patch, pad):
        super().__init__()
        self.patch_embed = PatchEmbed(dim, patch, pad)
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tokens + 1, dim))
        self.blocks = nn.ModuleList(
            Block(dim, heads, mlp_ratio, drop_path=drop_path_rate * i / max(depth - 1, 1)) for i in range(depth)
        )
        self.last_norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, generator=None):
        x = self.patch_embed.proj(x)
        b, c, hp, wp = x.shape
        x = x.flatten(2).transpose(1, 2) + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        for blk in self.blocks:
            masks = blk.draw(x, generator)
            # Recomputed in the backward, so that the reference fits beside
            # large batches; the masks are drawn outside, once.
            x = checkpoint(blk, x, masks, use_reentrant=False) if torch.is_grad_enabled() else blk(x, masks)
        return self.last_norm(x).transpose(1, 2).reshape(b, c, hp, wp)


class FeatureExtractor(nn.Module):
    def __init__(self, vit):
        super().__init__()
        self.backbone = vit


def dropout(x, p, training, generator):
    if not training:
        return x
    keep = 1.0 - p
    return torch.where(torch.rand(x.shape, generator=generator, device=x.device) < keep, x / keep, 0.0)


def projection(points, cam):
    """Crop-frame weak perspective, normalised to [-1, 1] (geometry.py:289-307)."""
    t = torch.stack([cam[:, 1], cam[:, 2], 2 * FOCAL_LENGTH / (IMG_RES * cam[:, 0] + 1e-9)], dim=-1)
    p = points + t[:, None]
    return p[..., :2] / p[..., 2:3] * FOCAL_LENGTH / (IMG_RES / 2.0)


def gram_schmidt(x):
    """The reference's unbiased Gram-Schmidt (geometry.py:260-273)."""
    shape = x.shape
    x = x.reshape(-1, 3, 3)
    t1, t2, t3 = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    r1 = F.normalize((torch.linalg.cross(t2, t3, dim=-1) + t1) / 2.0, dim=-1)
    r2_ = (torch.linalg.cross(t3, r1, dim=-1) + t2) / 2.0
    r2 = F.normalize(r2_ - (r2_ * r1).sum(-1, keepdim=True) * r1, dim=-1)
    return torch.stack([r1, r2, torch.linalg.cross(r1, r2, dim=-1)], dim=-1).reshape(shape)


class MAF(nn.Module):
    """maf_extractor.py:17-143: grid_sample pooling and the skip-concat 1x1 MLP."""

    def __init__(self, mlp_dim):
        super().__init__()
        self.n = len(mlp_dim) - 1
        for i in range(self.n):
            setattr(self, f"conv{i}", Conv1d(mlp_dim[0] if i == 0 else mlp_dim[i] + mlp_dim[0], mlp_dim[i + 1], 1))

    def sample(self, im_feat, points):
        feat = F.grid_sample(im_feat, points.unsqueeze(2), align_corners=True)[..., 0]  # (B, C, N)
        y = feat
        for i in range(self.n):
            y = getattr(self, f"conv{i}")(y if i == 0 else torch.cat([y, feat], 1))
            if i != self.n - 1:
                y = F.leaky_relu(y)
        return F.relu(y).reshape(y.shape[0], -1)


class Regressor(nn.Module):
    def __init__(self, feat_dim):
        super().__init__()
        self.fc1 = Linear(feat_dim + 5 + NPOSE + 13, 1024)
        self.fc2 = Linear(1024, 1024)
        self.decpose = Linear(1024, NPOSE)
        self.decshape = Linear(1024, 10)
        self.deccam = Linear(1024, 3)

    def forward(self, feat, bbox_info, pose, shape, cam, generator=None):
        x = torch.cat([feat, bbox_info], dim=1)
        xc = dropout(self.fc1(torch.cat([x, pose, shape, cam], 1)), 0.5, self.training, generator)
        xc = dropout(self.fc2(xc), 0.5, self.training, generator)
        return self.decpose(xc) + pose, self.decshape(xc) + shape, self.deccam(xc) + cam, x


class GlobalOrient(nn.Module):
    def __init__(self, feat_dim):
        super().__init__()
        self.fc1 = Linear(feat_dim + 6 + 9, 2048)
        self.fc2 = Linear(2048, 2048)
        self.decrot = Linear(2048, 9)

    def forward(self, x, cam_rotmat, local, generator=None):
        b = x.shape[0]
        xc0 = torch.cat([x, cam_rotmat[:, :, :2].reshape(b, 6), local.reshape(b, 9)], dim=1)
        for _ in range(3):  # the prediction is never fed back: the last pass counts
            xc = dropout(self.fc1(xc0), 0.5, self.training, generator)
            xc = dropout(self.fc2(xc), 0.5, self.training, generator)
            rot = self.decrot(xc) + local.reshape(b, 9)
        rot = rot.reshape(b, 1, 3, 3)
        return rot if self.training else gram_schmidt(rot)


class IUVHead(nn.Module):
    def __init__(self, ch):
        super().__init__()
        for name, k in (("predict_u", 25), ("predict_v", 25), ("predict_ann_index", 15), ("predict_uv_index", 25)):
            setattr(self, name, Conv2d(ch, k, 3, padding=1))

    def forward(self, x):
        return {k: getattr(self, k)(x).permute(0, 2, 3, 1)
                for k in ("predict_u", "predict_v", "predict_ann_index", "predict_uv_index")}


class RefWHMR(nn.Module):
    """The reference graph at the sizes of a configuration's `model` block
    (the port's dotted `WHMRConfig` keys)."""

    def __init__(self, sizes: Dict, smpl: SMPLArrays):
        super().__init__()
        self.smpl = smpl
        d, depth, heads = sizes["vit.embed_dim"], sizes["vit.depth"], sizes["vit.num_heads"]
        patch, pad = sizes["vit.patch_size"], sizes["vit.patch_padding"]
        h, w = sizes["vit.img_size"]
        hp, wp = (h + 2 * pad - patch) // patch + 1, (w + 2 * pad - patch) // patch + 1
        self.feature_extractor = FeatureExtractor(
            ViT(d, depth, heads, sizes["vit.mlp_ratio"], hp * wp, sizes["vit.drop_path_rate"], patch, pad))
        filters, kernels = sizes["deconv.num_filters"], sizes["deconv.num_kernels"]
        layers, c_in = [], d
        for f, k in zip(filters, kernels):
            layers += [ConvTranspose2d(c_in, f, k, stride=2, padding=(k - 2) // 2, bias=False),
                       nn.BatchNorm2d(f), nn.ReLU()]
            c_in = f
        self.deconv_layers = nn.Sequential(*layers)
        mlp = sizes["pymaf.mlp_dim"]
        self.n_iter = sizes["pymaf.n_iter"]
        self.maf_extractor = nn.ModuleList(MAF(mlp) for _ in range(self.n_iter))
        gw, gh = 7, 9  # the ViT backbone's fixed grid (whmr.py:338-347)
        xv, yv = torch.meshgrid(torch.linspace(-1, 1, gw), torch.linspace(-1, 1, gh), indexing="ij")
        self.register_buffer("points_grid", torch.stack([xv.reshape(-1), yv.reshape(-1)], -1), persistent=False)
        n_markers = smpl.ssm.shape[0]
        self.regressor = nn.ModuleList(
            Regressor(gw * gh * mlp[-1] if i == 0 else n_markers * mlp[-1]) for i in range(self.n_iter))
        up = 2 ** len(filters)
        hf, wf = hp * up, wp * up
        h1, w1 = (hf - 7) // 3 + 1, (wf - 7) // 3 + 1
        tok = ((h1 - 7) // 2 + 1) * ((w1 - 7) // 2 + 1)
        self.conv = nn.Sequential(Conv2d(filters[-1], 64, 7, stride=3, bias=False),
                                  Conv2d(64, 5, 7, stride=2, bias=False))
        self.transformer_decoder = Block(tok, 2, qkv_bias=False, eps=1e-5)
        self.est_Tz = nn.Sequential(Linear(tok, 12), Linear(12, 1), nn.BatchNorm1d(1), nn.Sigmoid())
        self.global_orient = GlobalOrient(n_markers * mlp[-1] + 5)
        self.dp_head = IUVHead(filters[-1])

    def set_fp8(self, on: bool):
        for m in self.modules():
            if isinstance(m, _Q):
                m.fp8 = on

    def _bundle(self, rotmat, shape, cam, cs):
        verts, joints, _ = smpl49(self.smpl, shape, rotmat)
        sub = torch.matmul(self.smpl.dmap0, verts)
        out = {"verts": verts, "sub_verts": sub, "temp_verts": torch.matmul(self.smpl.dmap1, sub),
               "kp_3d": joints, "rotmat": rotmat, "pred_shape": shape, "pred_cam": cam,
               "markers": verts[:, self.smpl.ssm]}
        if cs is not None:
            c = cam.detach()
            img_h, img_w = cs["orig_shape"][:, 0], cs["orig_shape"][:, 1]
            cx = 2 * (cs["center"][:, 0] - img_w / 2.0) / (c[:, 0] * cs["bbox_height"])
            cy = 2 * (cs["center"][:, 1] - img_h / 2.0) / (c[:, 0] * cs["bbox_height"])
            out["pred_cam_t"] = torch.stack([c[:, 1] + cx, c[:, 2] + cy, cs["tz"]], dim=-1)
            out["focal_length"] = c[:, 0] * cs["bbox_height"] * cs["tz"] / 2.0
        return out

    def forward(self, x, center, scale, bbox_height, orig_shape, bbox_info, cam_rotmat,
                generator: Optional[torch.Generator] = None):
        """x: (B, H, W, 3) normalised crops. Returns the smpl_out list, the
        world outputs and the IUV maps."""
        train = self.training
        b = x.shape[0]
        s_feat = self.feature_extractor.backbone(x.permute(0, 3, 1, 2), generator)
        state = self._bundle(self.smpl.mean_rotmat.expand(b, 24, 3, 3), self.smpl.mean_shape.expand(b, 10),
                             self.smpl.mean_cam.expand(b, 3), None)
        out_smpl = [state]
        levels, n_layers = [], len(self.deconv_layers) // 3
        bounds = [round(n_layers * k / self.n_iter) for k in range(self.n_iter + 1)]
        for k in range(self.n_iter):
            for i in range(bounds[k], bounds[k + 1]):
                s_feat = self.deconv_layers[3 * i: 3 * i + 3](s_feat)
            levels.append(s_feat)
        t = self.conv(s_feat)
        t = self.transformer_decoder(t.reshape(b, 5, -1)).mean(dim=1)  # no drop path in this block
        tz = 10.0 * self.est_Tz(t)[:, 0]
        cs = {"center": center, "bbox_height": bbox_height, "orig_shape": orig_shape, "tz": tz}
        body_feat = None
        for i in range(self.n_iter):
            cam = state["pred_cam"].detach()
            if i == 0:
                pts = self.points_grid[None].expand(b, -1, -1)
            else:
                pts = projection(state["markers"].detach(), cam)
            feat = self.maf_extractor[i].sample(levels[i], pts)
            pose, shape, cam_new, xf = self.regressor[i](
                feat, bbox_info, state["rotmat"].detach().reshape(b, -1), state["pred_shape"].detach(), cam, generator)
            rotmat = pose.reshape(b, 24, 3, 3)
            if not train:
                rotmat = gram_schmidt(rotmat)
            state = self._bundle(rotmat, shape, cam_new, cs)
            if i > 0:
                body_feat = xf
            out_smpl.append(state)
        g_rot = self.global_orient(body_feat, cam_rotmat, state["rotmat"][:, 0], generator)
        g_full = torch.cat([g_rot, state["rotmat"][:, 1:]], dim=1)
        g_verts, g_joints, _ = smpl49(self.smpl, state["pred_shape"], g_full)
        return {"smpl_out": out_smpl, "global_verts": g_verts, "global_kp_3d": g_joints,
                "global_rotmat": g_full, "dp_out": self.dp_head(s_feat)}


def build_reference(sizes: Dict, smpl: SMPLArrays, weights: Dict[str, torch.Tensor], device) -> RefWHMR:
    """The reference on `device` with `weights` by parameter name (every
    parameter and BatchNorm statistic the reference has must be there)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device("meta"):
        model = RefWHMR(sizes, smpl)
    model = model.to_empty(device=device)
    gw, gh = 7, 9
    xv, yv = torch.meshgrid(torch.linspace(-1, 1, gw, device=device),
                            torch.linspace(-1, 1, gh, device=device), indexing="ij")
    model.points_grid = torch.stack([xv.reshape(-1), yv.reshape(-1)], -1)
    state = model.state_dict()
    missing = [k for k in state if k not in weights and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"weights lack the reference's {missing[:5]}")
    with torch.no_grad():
        for k, v in state.items():
            if k.endswith("num_batches_tracked"):
                v.zero_()
            else:
                v.copy_(weights[k].reshape(v.shape))
    return model

