"""Exact key inventory of the published `w-hmr-p-vitpose_checkpoint.pt`
(the port's own copy of `whmr_tpu/utils/real_ckpt_manifest.py`; the port's
state_dict keys are the reference's torch names, so the manifest is what
`Trainer.load_pretrained` and `utils/convert.py` meet in a real checkpoint).

The reference loads this checkpoint with ``load_state_dict(ckpt['model'],
strict=True)`` (demo/tester.py:61-66), so its key set is exactly the
params+buffers of ``whmr_net()``'s module tree. The torch stack needed to
instantiate that tree (pare, smplx, timm, mmcv) is no dependency of this
package, so this module vendors the inventory statically, derived line-by-line from the
reference constructors:

- ViT backbone wrapped as ``feature_extractor.backbone``
  (models/pose_vit.py:8-23; models/ViTPose/mmpose/models/backbones/vit.py:
  patch_embed.proj, pos_embed (cls slot kept, vit.py:231), blocks.N
  {norm1,norm2,attn.qkv,attn.proj,mlp.fc1,mlp.fc2}, last_norm)
- deconv pyramid ``deconv_layers.{0,3,6}`` ConvT + ``{1,4,7}`` BN
  (models/whmr.py:459-501, DECONV_WITH_BIAS=False)
- ``maf_extractor.{0..2}.conv{0,1,2}`` Conv1d k=1 + merged ``Dmap`` buffer
  (models/maf_extractor.py:33-75)
- ``regressor.{0..2}`` fc/dec heads, init_* mean-param buffers, Dmap0/Dmap1
  buffers, smplx SMPL subtree and VertexJointSelector
  (models/whmr.py:42-98; smplx body_models SMPL params betas/global_orient/
  body_pose (create_transl=False) + buffers faces_tensor/v_template/
  shapedirs/J_regressor/posedirs/parents/lbs_weights; pare SMPL subclass
  adds the J_regressor_extra buffer)
- Tz head ``conv.{0,1}`` / ``transformer_decoder`` (timm Block dim=216,
  qkv_bias=False) / ``est_Tz`` (models/whmr.py:417-430 vitpose branch)
- ``cam_model`` CameraRegressorNetwork: torchvision-layout resnet50 backbone
  incl. its unused ``fc`` classifier + fc_{vfov,pitch,roll} 256-bin heads
  (models/cam_model.py:24-57)
- ``global_orient`` regressor + init_pose buffer (models/whmr.py:272-287)
- ``points_grid`` WHMR-level buffer (models/whmr.py:345-347)
- ``dp_head`` IUV head, present because AUX_SUPV_ON=True and
  POINT_REGRESSION_WEIGHTS=0.125>0 in the published config
  (configs/pymaf_config.yaml:34-40, models/iuv_predictor.py:15-51);
  ``dpth_head`` absent because DEPTH_SUPV_ON=False. ``transformer`` (the
  Graphormer list) is empty at N_ITER=3 (models/whmr.py:364) — no keys.

Non-keys worth recording: ``Regressor.J_regressor``/``ssm`` are plain
attributes, never registered (whmr.py:75,100) — NOT in the state_dict;
same for smplx's unregistered ``joint_map``-style tensors.
"""

from __future__ import annotations

from typing import Dict, Tuple

from whmr_tpu_torch.config import WHMRConfig, default_config

# Keys stored as integer tensors (torch.long / BN step counters); everything
# else is float32.
INT_KEY_SUFFIXES = (
    "faces_tensor",
    "parents",
    "extra_joints_idxs",
    "num_batches_tracked",
)


def _smpl_subtree(prefix: str, shapes: Dict[str, Tuple[int, ...]], n_betas: int):
    """smplx SMPL(create_transl=False) + pare subclass key set."""
    shapes[prefix + "betas"] = (1, n_betas)
    shapes[prefix + "global_orient"] = (1, 3)
    shapes[prefix + "body_pose"] = (1, 69)
    shapes[prefix + "faces_tensor"] = (13776, 3)
    shapes[prefix + "v_template"] = (6890, 3)
    shapes[prefix + "shapedirs"] = (6890, 3, n_betas)
    shapes[prefix + "J_regressor"] = (24, 6890)
    shapes[prefix + "posedirs"] = (207, 20670)
    shapes[prefix + "parents"] = (24,)
    shapes[prefix + "lbs_weights"] = (6890, 24)
    # pare/models/head/smpl_head.py SMPL subclass buffer
    shapes[prefix + "J_regressor_extra"] = (9, 6890)
    # smplx-internal VertexJointSelector (smplh vertex ids -> 21 extras)
    shapes[prefix + "vertex_joint_selector.extra_joints_idxs"] = (21,)


def _bn(prefix: str, shapes: Dict[str, Tuple[int, ...]], ch: int):
    shapes[prefix + ".weight"] = (ch,)
    shapes[prefix + ".bias"] = (ch,)
    shapes[prefix + ".running_mean"] = (ch,)
    shapes[prefix + ".running_var"] = (ch,)
    shapes[prefix + ".num_batches_tracked"] = ()


def _linear(prefix: str, shapes: Dict[str, Tuple[int, ...]], out_f: int, in_f: int, bias=True):
    shapes[prefix + ".weight"] = (out_f, in_f)
    if bias:
        shapes[prefix + ".bias"] = (out_f,)


def real_checkpoint_manifest(cfg: WHMRConfig = None) -> Dict[str, Tuple[int, ...]]:
    """key -> torch shape for every entry of ckpt['model'].

    At ``default_config()`` this is the published ViT-B model's inventory;
    cfg-dependent dimensions are computed so the manifest stays consistent
    with alternative (e.g. tiny test) configs too.
    """
    cfg = cfg or default_config()
    assert cfg.pymaf.backbone == "vitpose", "manifest covers the published vitpose model"
    shapes: Dict[str, Tuple[int, ...]] = {}

    # --- ViT backbone ----------------------------------------------------
    e = cfg.vit.embed_dim
    p = cfg.vit.patch_size
    hp, wp = cfg.vit.grid_hw
    hid = int(e * cfg.vit.mlp_ratio)
    vp = "feature_extractor.backbone."
    shapes[vp + "patch_embed.proj.weight"] = (e, 3, p, p)
    shapes[vp + "patch_embed.proj.bias"] = (e,)
    shapes[vp + "pos_embed"] = (1, hp * wp + 1, e)
    for i in range(cfg.vit.depth):
        b = f"{vp}blocks.{i}."
        for nrm in ("norm1", "norm2"):
            shapes[b + nrm + ".weight"] = (e,)
            shapes[b + nrm + ".bias"] = (e,)
        _linear(b + "attn.qkv", shapes, 3 * e, e)
        _linear(b + "attn.proj", shapes, e, e)
        _linear(b + "mlp.fc1", shapes, hid, e)
        _linear(b + "mlp.fc2", shapes, e, hid)
    shapes[vp + "last_norm.weight"] = (e,)
    shapes[vp + "last_norm.bias"] = (e,)

    # --- deconv pyramid --------------------------------------------------
    fs = cfg.deconv.num_filters
    ins = (e, fs[0], fs[1])
    for i, base in enumerate((0, 3, 6)):
        k = cfg.deconv.num_kernels[i]
        shapes[f"deconv_layers.{base}.weight"] = (ins[i], fs[i], k, k)
        _bn(f"deconv_layers.{base + 1}", shapes, fs[i])

    # --- MAF extractors --------------------------------------------------
    m = cfg.pymaf.mlp_dim
    for i in range(cfg.pymaf.n_iter):
        pre = f"maf_extractor.{i}."
        dims_in = (m[0],) + tuple(m[l] + m[0] for l in range(1, len(m) - 1))
        for l in range(len(m) - 1):
            shapes[pre + f"conv{l}.weight"] = (m[l + 1], dims_in[l], 1)
            shapes[pre + f"conv{l}.bias"] = (m[l + 1],)
        shapes[pre + "Dmap"] = (cfg.smpl.n_temp_verts, cfg.smpl.n_verts)

    # --- regressors ------------------------------------------------------
    gw, gh = cfg.points_grid_wh
    npose = 24 * 9
    for i in range(3):
        feat = gw * gh * m[-1] if i == 0 else cfg.pymaf.n_markers * m[-1]
        pre = f"regressor.{i}."
        _linear(pre + "fc1", shapes, 1024, feat + npose + 13 + 5)
        _linear(pre + "fc2", shapes, 1024, 1024)
        _linear(pre + "decpose", shapes, npose, 1024)
        _linear(pre + "decshape", shapes, cfg.smpl.n_betas, 1024)
        _linear(pre + "deccam", shapes, 3, 1024)
        shapes[pre + "init_pose"] = (1, npose)
        shapes[pre + "init_shape"] = (1, cfg.smpl.n_betas)
        shapes[pre + "init_cam"] = (1, 3)
        shapes[pre + "Dmap0"] = (cfg.smpl.n_sub_verts, cfg.smpl.n_verts)
        shapes[pre + "Dmap1"] = (cfg.smpl.n_temp_verts, cfg.smpl.n_sub_verts)
        _smpl_subtree(pre + "smpl.", shapes, cfg.smpl.n_betas)
        shapes[pre + "vertex_joint_selector.extra_joints_idxs"] = (21,)

    # --- Tz head (vitpose branch) ---------------------------------------
    hf, wf = hp * 8, wp * 8
    h1, w1 = (hf - 7) // 3 + 1, (wf - 7) // 3 + 1
    tok = ((h1 - 7) // 2 + 1) * ((w1 - 7) // 2 + 1)
    shapes["conv.0.weight"] = (64, fs[-1], 7, 7)
    shapes["conv.1.weight"] = (5, 64, 7, 7)
    td = "transformer_decoder."
    for nrm in ("norm1", "norm2"):
        shapes[td + nrm + ".weight"] = (tok,)
        shapes[td + nrm + ".bias"] = (tok,)
    _linear(td + "attn.qkv", shapes, 3 * tok, tok, bias=False)  # timm default
    _linear(td + "attn.proj", shapes, tok, tok)
    _linear(td + "mlp.fc1", shapes, 4 * tok, tok)
    _linear(td + "mlp.fc2", shapes, tok, 4 * tok)
    tz_hidden = 12
    _linear("est_Tz.0", shapes, tz_hidden, tok)
    _linear("est_Tz.1", shapes, 1, tz_hidden)
    _bn("est_Tz.2", shapes, 1)

    # --- global orient ---------------------------------------------------
    go_in = cfg.pymaf.n_markers * m[-1] + 5 + 6 + 9
    _linear("global_orient.fc1", shapes, 2048, go_in)
    _linear("global_orient.fc2", shapes, 2048, 2048)
    _linear("global_orient.decrot", shapes, 9, 2048)
    shapes["global_orient.init_pose"] = (1, 9)

    shapes["points_grid"] = (1, 2, gw * gh)

    # --- aux heads -------------------------------------------------------
    if cfg.pymaf.aux_supv_on:
        for name, ch in (("predict_u", 25), ("predict_v", 25),
                         ("predict_uv_index", 25), ("predict_ann_index", 15)):
            shapes[f"dp_head.{name}.weight"] = (ch, fs[-1], 3, 3)
            shapes[f"dp_head.{name}.bias"] = (ch,)
    if cfg.pymaf.depth_supv_on:
        shapes["dpth_head.predict_depth.weight"] = (1, fs[-1], 3, 3)
        shapes["dpth_head.predict_depth.bias"] = (1,)

    # --- CamCalib --------------------------------------------------------
    cb = "cam_model.backbone."
    shapes[cb + "conv1.weight"] = (64, 3, 7, 7)
    _bn(cb + "bn1", shapes, 64)
    in_c = 64
    for stage, (n_blocks, planes) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        for blk in range(n_blocks):
            pre = f"{cb}layer{stage + 1}.{blk}."
            shapes[pre + "conv1.weight"] = (planes, in_c, 1, 1)
            _bn(pre + "bn1", shapes, planes)
            shapes[pre + "conv2.weight"] = (planes, planes, 3, 3)
            _bn(pre + "bn2", shapes, planes)
            shapes[pre + "conv3.weight"] = (planes * 4, planes, 1, 1)
            _bn(pre + "bn3", shapes, planes * 4)
            if blk == 0:
                shapes[pre + "downsample.0.weight"] = (planes * 4, in_c, 1, 1)
                _bn(pre + "downsample.1", shapes, planes * 4)
            in_c = planes * 4
    _linear(cb + "fc", shapes, 1000, 2048)
    for angle in ("vfov", "pitch", "roll"):
        _linear(f"cam_model.fc_{angle}", shapes, 256, 2048)

    return shapes


def manifest_state_dict(cfg: WHMRConfig = None, seed: int = 0):
    """Random numpy state_dict with the manifest's exact names+shapes."""
    import numpy as np

    rng = np.random.RandomState(seed)
    sd = {}
    for key, shape in real_checkpoint_manifest(cfg).items():
        if key.endswith(INT_KEY_SUFFIXES):
            sd[key] = np.zeros(shape, np.int64)
        elif key.endswith("running_var"):
            sd[key] = np.ones(shape, np.float32)
        else:
            sd[key] = (rng.randn(*shape) * 0.05).astype(np.float32)
    return sd
