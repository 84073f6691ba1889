"""The W-HMR forward: CamCalib -> ViT -> deconv pyramid -> Tz head -> MAF
loop -> global orientation -> world SMPL -> aux heads.

Counterpart of `whmr_tpu/models/whmr.py` (reference models/whmr.py:308-678).
`WHMR.forward` keeps whmr_tpu's interface: NHWC crops, the same keyword
arguments and the same output keys; `train=True` (with `model.train()`) runs
batch-statistics BatchNorm, drop path, dropout and the stage gating, with
random draws from the `generator` passed in. Inside, the conv stacks run NCHW
on channels-last memory, so the NHWC views handed to the MAF sampler are
free. Submodule names are the reference's, so `state_dict()` keys are those
of the published `w-hmr-p-vitpose_checkpoint.pt` (including its flat Tz-head
names `conv`, `transformer_decoder`, `est_Tz`).

Both backbones of whmr_tpu are here: "vitpose" (ViT-B, 256x192 crops) and
"res50" (the COCO PoseResNet encoder, 256x256 crops, 2048 channels at H/32,
whose Tz head takes stride 2 and width 10). With `pymaf.grph_on` the
Graphormer refiner runs as a stage appended after the MAF loop, as in
whmr_tpu (whmr.py:137-147, 383-450).

`build_model` makes the model and its constants on the card, with weights
drawn from a seeded `torch.Generator`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from whmr_tpu_torch.config import WHMRConfig
from whmr_tpu_torch.data.assets import SMPLAssets, synthetic_smpl_assets
from whmr_tpu_torch.models.heads import (
    DepthHead,
    IUVHead,
    TzHead,
    tz_head_forward,
    tz_tokens,
)
from whmr_tpu_torch.models.graphormer import GraphConvolution, GraphLinear, GraphormerBodyNetwork
from whmr_tpu_torch.models.hmr import HMR
from whmr_tpu_torch.models.layers import DeconvBlock
from whmr_tpu_torch.models.maf import MAFExtractor
from whmr_tpu_torch.models.regressor import (
    BodyConsts,
    CamState,
    GlobalOrientRegressor,
    Regressor,
    body_consts_from_assets,
    forward_init,
)
from whmr_tpu_torch.models.resnet import CamCalibNet, PoseResNetEncoder
from whmr_tpu_torch.models.smpl import joints_from_vertices, select_h36m_j14, smpl_forward
from whmr_tpu_torch.models.vit import ViTFeatureExtractor
from whmr_tpu_torch.ops.camera import decode_cam_angles, perspective_projection, weak_perspective_projection
from whmr_tpu_torch.ops.rotation import euler_to_rotmat, rotmat_to_angle_axis
from whmr_tpu_torch.utils import profiling


def make_points_grid(grid_wh) -> np.ndarray:
    """Fixed (gw*gh, 2) sample grid of MAF step 0 (whmr.py:345-347)."""
    gw, gh = grid_wh
    xv, yv = np.meshgrid(
        np.linspace(-1, 1, gw, dtype=np.float32),
        np.linspace(-1, 1, gh, dtype=np.float32),
        indexing="ij",
    )
    return np.stack([xv.reshape(-1), yv.reshape(-1)], axis=-1)


class WHMR(nn.Module):
    def __init__(self, cfg: WHMRConfig, dtype=torch.float32):
        super().__init__()
        c = cfg
        if c.pymaf.backbone not in ("vitpose", "res50"):
            raise ValueError(f"pymaf.backbone must be 'vitpose' or 'res50', got {c.pymaf.backbone!r}")
        if not 2 <= c.pymaf.n_iter <= 3:
            raise ValueError(f"pymaf.n_iter must be 2 or 3, got {c.pymaf.n_iter}")
        self.cfg = cfg
        vit = c.pymaf.backbone == "vitpose"
        if vit:
            self.feature_extractor = ViTFeatureExtractor(c.vit, dtype=dtype)
            feat_ch, (hp, wp) = c.vit.embed_dim, c.vit.grid_hw
        else:
            # The COCO PoseResNet encoder (whmr.py:317, pose_resnet.py:287-305).
            self.feature_extractor = PoseResNetEncoder(dtype=dtype)
            feat_ch, (hp, wp) = 2048, (c.crop_hw[0] // 32, c.crop_hw[1] // 32)

        # Flat Sequential of [ConvT, BN, ReLU] x L: keys deconv_layers.{0,1,3,4,...}.
        ins = (feat_ch,) + tuple(c.deconv.num_filters[:-1])
        blocks = [
            DeconvBlock(ins[i], c.deconv.num_filters[i], c.deconv.num_kernels[i],
                        use_bias=c.deconv.with_bias, dtype=dtype)
            for i in range(c.deconv.num_layers)
        ]
        self.deconv_layers = nn.Sequential(*(m for blk in blocks for m in blk))

        mlp = tuple(c.pymaf.mlp_dim)
        self.maf_extractor = nn.ModuleList(
            MAFExtractor(mlp, c.img_res, dtype=dtype) for _ in range(c.pymaf.n_iter)
        )
        gw, gh = c.points_grid_wh
        grid_feat = gw * gh * mlp[-1]
        marker_feat = c.pymaf.n_markers * mlp[-1]
        self.regressor = nn.ModuleList(
            Regressor(grid_feat if i == 0 else marker_feat, c.img_res, stage=c.train.stage, dtype=dtype)
            for i in range(c.pymaf.n_iter)
        )

        up = 2 ** c.deconv.num_layers
        # First stride and width: 3 and 12 for vitpose (whmr.py:417-430), 2 and 10 for res50 (:404-416).
        stride, hidden = (3, 12) if vit else (2, 10)
        tz = TzHead(c.deconv.num_filters[-1], tz_tokens(hp * up, wp * up, stride), stride, hidden, dtype=dtype)
        self.conv, self.transformer_decoder, self.est_Tz = tz.conv, tz.transformer_decoder, tz.est_Tz

        self.cam_model = CamCalibNet(dtype=dtype)
        self.global_orient = GlobalOrientRegressor(marker_feat + 5, dtype=dtype)
        if c.pymaf.grph_on:
            # The non-parametric refiner, APPENDED as a stage after the MAF
            # loop (whmr_tpu's design; the reference's commented slot,
            # whmr.py:363/613-626, would substitute it for the last step).
            self.transformer = nn.ModuleList(
                [GraphormerBodyNetwork(marker_feat + 5, c.deconv.num_filters[-1], dtype=dtype)]
            )
        if c.pymaf.aux_supv_on:
            self.dp_head = IUVHead(
                c.deconv.num_filters[-1], with_uv=c.loss.point_regression_weights > 0, dtype=dtype
            )
        if c.pymaf.depth_supv_on:
            self.dpth_head = DepthHead(c.deconv.num_filters[-1], dtype=dtype)
        # A constant of the model, not a checkpoint entry.
        self.register_buffer(
            "points_grid", torch.from_numpy(make_points_grid(c.points_grid_wh)), persistent=False
        )

    def _pyramid_levels(self, s_feat):
        """Run ALL deconv layers; n_iter only regroups them into levels
        (whmr.py:537-543). Returns the n_iter level maps (NCHW)."""
        n_layers, n_iter = self.cfg.deconv.num_layers, self.cfg.pymaf.n_iter
        bounds = [round(n_layers * k / n_iter) for k in range(n_iter + 1)]
        levels = []
        for k in range(n_iter):
            for i in range(bounds[k], bounds[k + 1]):
                s_feat = self.deconv_layers[3 * i: 3 * i + 3](s_feat)
            levels.append(s_feat)
        return levels

    def forward(
        self,
        consts: BodyConsts,
        x: torch.Tensor,
        center: torch.Tensor,
        scale: torch.Tensor,
        bbox_height: torch.Tensor,
        orig_shape: torch.Tensor,
        bbox_info: torch.Tensor,
        train: bool = False,
        j_regressor: Optional[torch.Tensor] = None,
        full_x: Optional[torch.Tensor] = None,
        cam_rotmat: Optional[torch.Tensor] = None,
        meta_masks: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Any]:
        """x: (B, H, W, 3) normalized crops (NHWC); full_x: (B or 1, Hc, Wc, 3)
        full frames for CamCalib; cam_rotmat: (B, 3, 3). `train` must match
        the module's mode (`model.train()` / `model.eval()`); `generator`
        draws the training's drop path and dropout masks (on the inputs'
        device). `meta_masks` (B, 431, 1) feeds the Graphormer stage's
        masked vertex modelling in training.

        Spans (utils/profiling.py): `whmr.forward` around the call,
        `whmr.backbone`, `whmr.heads` (the init, pyramid and Tz head, then
        the aux heads: two intervals) and `whmr.maf` (the MAF loop, the
        Graphormer stage, global orientation and the world SMPL)."""
        with profiling.span("whmr.forward"):
            return self._forward(consts, x, center, scale, bbox_height, orig_shape, bbox_info, train,
                                 j_regressor, full_x, cam_rotmat, meta_masks, generator)

    def _forward(self, consts, x, center, scale, bbox_height, orig_shape, bbox_info, train, j_regressor,
                 full_x, cam_rotmat, meta_masks, generator) -> Dict[str, Any]:
        if train != self.training:
            raise ValueError(
                f"forward(train={train}) on a module in {'train' if self.training else 'eval'} "
                "mode: call model.train() or model.eval() first"
            )
        c = self.cfg
        batch_size = x.shape[0]

        # 1. Camera calibration (whmr.py:191-206).
        if cam_rotmat is None:
            if full_x is not None:
                cam_rotmat, render_rotmat = self.camcalib(full_x)
                if full_x.shape[0] == 1 and batch_size > 1:
                    # One frame for all crops: broadcast its rotation.
                    cam_rotmat = cam_rotmat.expand(batch_size, 3, 3)
                    render_rotmat = render_rotmat.expand(batch_size, 3, 3)
            else:
                cam_rotmat = torch.eye(3, dtype=x.dtype, device=x.device).expand(batch_size, 3, 3)
                render_rotmat = cam_rotmat
        else:
            render_rotmat = cam_rotmat

        # 2-4. Backbone, mean-parameter init, deconv pyramid.
        with profiling.span("whmr.backbone"):
            s_feat = self._features(x, generator)
        with profiling.span("whmr.heads"):
            smpl_output = forward_init(consts, batch_size, c.img_res, j_regressor)
            out_smpl = [smpl_output]
            levels = self._pyramid_levels(s_feat)
            s_feat = levels[-1]

            # 5. Tz head; stage-1 training detaches the pyramid (whmr.py:567-570).
            tz_in = s_feat.detach() if (train and c.train.stage == 1) else s_feat
            tz = tz_head_forward(self.conv, self.transformer_decoder, self.est_Tz, tz_in)
            cam_state = CamState(bbox_info, center, scale, bbox_height, orig_shape, tz)

        with profiling.span("whmr.maf"):
            # 6. MAF loop (whmr.py:580-627).
            body_feat = None
            for rf_i in range(c.pymaf.n_iter):
                pred_cam = smpl_output["pred_cam"].detach()
                pred_shape = smpl_output["pred_shape"].detach()
                pred_pose = smpl_output["rotmat"].detach().reshape(batch_size, -1)
                level = levels[rf_i].permute(0, 2, 3, 1)  # NHWC view
                maf = self.maf_extractor[rf_i]
                if rf_i == 0:
                    pts = self.points_grid[None].expand(batch_size, -1, -1).to(level.dtype)
                    ref_feature, _ = maf.sampling(level, pts)
                else:
                    ref_feature, _ = maf(level, smpl_output["markers"].detach(), pred_cam)
                smpl_output, feat_cat = self.regressor[rf_i](
                    consts, ref_feature, cam_state, pred_pose, pred_shape, pred_cam, j_regressor,
                    generator,
                )
                if rf_i > 0:
                    body_feat = feat_cat
                out_smpl.append(smpl_output)

            # 6b. Graphormer vertex refinement on the finest level (whmr.py:274-283).
            if c.pymaf.grph_on:
                out_smpl.append(self._graphormer_stage(
                    consts, levels[-1].permute(0, 2, 3, 1), smpl_output, body_feat, cam_state,
                    meta_masks, train, j_regressor, generator,
                ))

            # 7. Global orientation (from the last PARAMETRIC step) -> world SMPL (whmr.py:630-654).
            global_rotmat1 = self.global_orient(
                body_feat, cam_rotmat.to(body_feat.dtype), smpl_output["rotmat"][:, 0], generator
            )
            global_aa = rotmat_to_angle_axis(global_rotmat1.reshape(-1, 3, 3)).reshape(-1, 3)
            global_pose = torch.cat([global_aa, smpl_output["pose"][:, 3:]], dim=1)
            global_full_rotmat = torch.cat([global_rotmat1, smpl_output["rotmat"][:, 1:]], dim=1)
            world_out = smpl_forward(consts.smpl, smpl_output["pred_shape"], global_full_rotmat)
            global_kp_3d = (
                world_out.joints if j_regressor is None
                else select_h36m_j14(j_regressor, world_out.vertices)
            )

        out: Dict[str, Any] = {
            "smpl_out": out_smpl,
            "global_output": {
                "global_pose": global_pose,
                "global_shape": smpl_output["pred_shape"],
                "global_rotmat": global_full_rotmat,
                "global_kp_3d": global_kp_3d,
                "global_verts": world_out.vertices,
            },
            "dp_out": [],
            "dpth_out": [],
        }
        # 8. Aux heads on the finest level (NHWC outputs).
        with profiling.span("whmr.heads"):
            if c.pymaf.aux_supv_on:
                out["dp_out"].append(self.dp_head(s_feat))
            if c.pymaf.depth_supv_on:
                out["dpth_out"].append(self.dpth_head(s_feat))
        if c.pymaf.grph_on:
            out["refined"] = out_smpl[-1]
        out["vis"] = {
            "local_smpl_vertices": smpl_output["verts"],
            "smpl_vertices": world_out.vertices,
            "pred_cam_t": smpl_output["pred_cam_t"],
            "focal_length": smpl_output["focal_length"],
            "cam_rotmat": cam_rotmat,
            "render_rotmat": render_rotmat,
            "shape": smpl_output["pred_shape"],
            "global_pose": global_pose,
            "local_pose": smpl_output["pose"],
        }
        return out

    def camcalib(self, full_x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full frames (B, Hc, Wc, 3) -> (cam_rotmat, render_rotmat) (whmr.py:509-524)."""
        return camcalib(self.cam_model, full_x)

    def iuv_logits(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) frames -> (B, Hm, Wm, 15) ann-index logits through the
        FULL pyramid (whmr.py:363-381)."""
        if not self.cfg.pymaf.aux_supv_on:
            raise ValueError("iuv_logits needs pymaf.aux_supv_on (dp_head not built)")
        s_feat = self.deconv_layers(self._features(x))
        return self.dp_head(s_feat)["predict_ann_index"]

    def _features(self, x, generator=None):
        """NHWC crops -> the backbone's NCHW map (drop path draws from
        `generator` in the ViT)."""
        x = x.permute(0, 3, 1, 2)
        if self.cfg.pymaf.backbone == "vitpose":
            return self.feature_extractor(x, generator)
        return self.feature_extractor(x)

    def _graphormer_stage(self, consts, im_feat, smpl_output, body_feat, cam_state, meta_masks,
                          train, j_regressor, generator):
        """One Graphormer refinement -> a smpl_out-style dict (whmr.py:383-450).

        The last MAF extractor samples the finest level at the DETACHED 431
        coarse vertices of the last parametric step (with its detached
        camera); the refined mesh's joints and projections are recomputed
        with the carried camera, under the `train.stage` detaches of
        e2e:97-124, and the parametric fields (rotmat, cam, shape, pose)
        carry over (e2e:131-150)."""
        c = self.cfg
        temp_verts = smpl_output["temp_verts"].detach()
        _, grid_feat = self.maf_extractor[-1](im_feat, temp_verts, smpl_output["pred_cam"].detach())
        refined = self.transformer[0](body_feat, grid_feat, temp_verts, consts.adj431, meta_masks, generator)
        # Geometry in fp32 (whmr_tpu's fp32 regressors promote the compute dtype).
        verts = refined["verts"].float()
        joints49, joints_smpl = joints_from_vertices(consts.smpl, verts)
        kp_src = joints49 if (c.train.stage == 1 or not train) else joints49.detach()
        kp_2d = weak_perspective_projection(kp_src, smpl_output["pred_cam"], c.img_res)
        kp_w_src = joints49.detach() if (c.train.stage == 1 and train) else joints49
        img_h, img_w = cam_state.orig_shape[:, 0], cam_state.orig_shape[:, 1]
        camera_center = torch.stack([img_w, img_h], dim=-1) / 2.0
        kp_2d_w = perspective_projection(
            kp_w_src, smpl_output["pred_cam_t"], smpl_output["focal_length"], camera_center
        )
        output = dict(smpl_output)
        output.update({
            "verts": verts,
            "sub_verts": refined["sub_verts"].float(),
            "temp_verts": refined["temp_verts"].float(),
            "kp_2d": kp_2d,
            "kp_2d_w": kp_2d_w / camera_center[:, None, :] - 1.0,
            "kp_3d": joints49 if j_regressor is None else select_h36m_j14(j_regressor, verts),
            "smpl_kp_3d": joints_smpl,
            "pelvis": joints_smpl[:, :1, :],
            "markers": verts[:, consts.ssm],
        })
        return output


def camcalib(cam_model: CamCalibNet, full_x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`WHMR.camcalib` on the CamCalib network alone (a serving export holds
    only that network). The bin logits are decoded in fp32 whatever the
    compute dtype: the angles and rotations are geometry."""
    logits, _ = cam_model(full_x.permute(0, 3, 1, 2))
    _, pitch, roll = decode_cam_angles(*(l.detach().float() for l in logits))
    zeros = torch.zeros_like(pitch)
    cam_rotmat = euler_to_rotmat(torch.stack([pitch, zeros, roll], dim=-1))
    render_rotmat = euler_to_rotmat(torch.stack([-pitch, zeros, roll], dim=-1))
    return cam_rotmat, render_rotmat


_DECODERS = ("decpose", "decshape", "deccam", "decrot")
# lecun_normal's truncated-normal std correction (truncation at 2 sigma).
_TRUNC_STD = 0.87962566103423978


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights: lecun-normal kernels, zero biases, xavier(0.01)
    residual decoders (whmr.py:55-57), 0.02 truncated-normal ViT position
    embedding, 0.02 normal Graphormer position embeddings, identity norms —
    the distributions of whmr_tpu's init. For WHMR and the HMR baseline."""

    def lecun(w, in_dim):
        std = 1.0 / math.sqrt(in_dim) / _TRUNC_STD
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)

    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, GraphLinear):
                lecun(m.W, m.W.shape[1])
                m.b.zero_()
            elif isinstance(m, GraphConvolution):
                lecun(m.weight, m.weight.shape[0])
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 0.02, generator=generator)
            if not isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d)):
                continue
            w = m.weight
            if name.rsplit(".", 1)[-1] in _DECODERS:
                bound = 0.01 * math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
                w.uniform_(-bound, bound, generator=generator)
            else:
                in_dim = w.shape[0] if isinstance(m, nn.ConvTranspose2d) else w.shape[1]
                lecun(w, in_dim * w[0, 0].numel())
            if m.bias is not None:
                m.bias.zero_()
        pos = getattr(getattr(model, "feature_extractor", None), "backbone", None)
        if pos is not None:
            nn.init.trunc_normal_(pos.pos_embed, std=0.02, a=-0.04, b=0.04, generator=generator)


def _device(device) -> torch.device:
    """`device`, or the card when None, never a silent fall back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the port on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        # TF32 off: fp32 products and convolutions in full fp32 (the torch
        # form of whmr_tpu's precision=HIGHEST rule for geometry).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def build_model(
    cfg: WHMRConfig, dtype=torch.bfloat16, device=None, seed: int = 0,
    assets: Optional[SMPLAssets] = None, adjacency_dir: Optional[str] = None,
) -> Tuple[WHMR, BodyConsts]:
    """The model, in eval mode, with seeded random weights, and its BodyConsts
    from `assets` (the synthetic SMPL assets when None; the Graphormer
    adjacency from `adjacency_dir`, else the ring), both on `device`: the
    card when None, never a silent fall back to the CPU."""
    device = _device(device)
    model = WHMR(cfg, dtype=dtype)
    init_parameters(model, torch.Generator().manual_seed(seed))
    consts = body_consts_from_assets(
        assets if assets is not None else synthetic_smpl_assets(0), device=device, adjacency_dir=adjacency_dir
    )
    return model.to(device).eval(), consts


def build_hmr(
    dtype=torch.bfloat16, device=None, seed: int = 0, assets: Optional[SMPLAssets] = None,
) -> Tuple[HMR, BodyConsts]:
    """`build_model` for the HMR baseline (`regressor="hmr"`)."""
    device = _device(device)
    model = HMR(dtype=dtype)
    init_parameters(model, torch.Generator().manual_seed(seed))
    consts = body_consts_from_assets(assets if assets is not None else synthetic_smpl_assets(0), device=device)
    return model.to(device).eval(), consts
