"""Static configuration tree for whmr_tpu_torch.

A copy of `whmr_tpu/config.py`'s dataclasses (the port imports nothing of
whmr_tpu): frozen, hashable dataclasses replacing the reference's yacs
singleton (`core/cfgs.py:22`, `configs/pymaf_config.yaml`). Field names and
defaults are identical to whmr_tpu's, so one config value means the same
model in both packages; `tests/test_torch_assets.py` holds them equal.

YAML loading (`load_yaml`, the reference-style schema) and the CLIs'
layering (`config_from_args`: a `--cfg_file` base, then dotted `--misc`
overrides) are copies of whmr_tpu's too.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Tuple

# Normalization constants shared with the reference (core/constants.py:4-8).
FOCAL_LENGTH = 1000.0
IMG_NORM_MEAN = (0.485, 0.456, 0.406)
IMG_NORM_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class LossConfig:
    """Loss weights (reference configs/pymaf_config.yaml:13-24)."""

    kp_2d_w: float = 0.0
    kp_3d_w: float = 300.0
    shape_w: float = 0.06
    pose_w: float = 60.0
    vert_w: float = 15.0
    index_weights: float = 2.0
    part_weights: float = 0.3
    point_regression_weights: float = 0.125
    focal_weights: float = 1e-6
    openpose_train_weight: float = 0.0
    gt_train_weight: float = 1.0


@dataclass(frozen=True)
class PyMAFConfig:
    """Core model knobs (reference configs/pymaf_config.yaml:32-41)."""

    backbone: str = "vitpose"  # 'vitpose' | 'res50'
    mlp_dim: Tuple[int, ...] = (256, 128, 64, 32)
    n_iter: int = 3
    maf_on: bool = False
    aux_supv_on: bool = True
    depth_supv_on: bool = False
    focal_supv_on: bool = False
    # Graphormer non-parametric vertex refiner. The reference architecture
    # slot exists but ships dormant (whmr.py:363 builds it for
    # range(3, N_ITER) under N_ITER=3; invocation commented at :613-626);
    # here it is a first-class stage appended after the MAF loop.
    grph_on: bool = False
    dp_heatmap_size: Tuple[int, int] = (128, 128)
    # GT IUV/depth rasterization mesh: "full" (6890 verts, reference
    # protocol — utils/renderer.py:289-533 renders the full surface) or
    # "sub" (the 1723-vert dmap0 mesh; ~4x fewer faces, faster aux-on train
    # step, slightly coarser dense supervision — opt-in numerics change).
    gt_render_mesh: str = "full"
    # Number of surface markers pooled per MAF step (reference whmr.py:100,336:
    # 67 SSM markers from data/smpl/smpl_ssm.npy).
    n_markers: int = 67


@dataclass(frozen=True)
class DeconvConfig:
    """Deconv feature pyramid (reference configs/pymaf_config.yaml:42-52)."""

    with_bias: bool = False
    num_layers: int = 3
    num_filters: Tuple[int, ...] = (256, 256, 256)
    num_kernels: Tuple[int, ...] = (4, 4, 4)


@dataclass(frozen=True)
class ViTConfig:
    """ViTPose-B/16 backbone (reference models/ViTPose/.../ViTPose_base_coco_256x192.py:43-57)."""

    img_size: Tuple[int, int] = (256, 192)  # (H, W)
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_path_rate: float = 0.3
    # Padded patch embed (vit.py:158): pad=4 -> 16x12 tokens at 256x192.
    patch_padding: int = 4

    # Rematerialize each block in the backward pass (jax.checkpoint):
    # trades ~30% more FLOPs for O(depth) less activation memory — the knob
    # for ViT-L/H training (SURVEY §7 step 10).
    remat: bool = False

    # Inner attention formulation (models/layers.Attention.impl): "einsum"
    # (plain torch) or "pallas" (the hand-written CUDA kernel of
    # ops/attention.py, named after the TPU kernel it replaces).
    attn_impl: str = "einsum"

    @property
    def grid_hw(self) -> Tuple[int, int]:
        h = (self.img_size[0] + 2 * self.patch_padding - self.patch_size) // self.patch_size + 1
        w = (self.img_size[1] + 2 * self.patch_padding - self.patch_size) // self.patch_size + 1
        return (h, w)


def vit_base() -> "ViTConfig":
    return ViTConfig()


def vit_large() -> "ViTConfig":
    """ViTPose-L geometry (embed 1024, depth 24, heads 16)."""
    return ViTConfig(embed_dim=1024, depth=24, num_heads=16, drop_path_rate=0.5, remat=True)


def vit_huge() -> "ViTConfig":
    """ViTPose-H geometry (embed 1280, depth 32, heads 16) — the scale the
    'model' mesh axis (Megatron TP) is sized for."""
    return ViTConfig(embed_dim=1280, depth=32, num_heads=16, drop_path_rate=0.55, remat=True)


@dataclass(frozen=True)
class TrainConfig:
    """Training schedule (reference configs/pymaf_config.yaml:1-7,25-29)."""

    stage: int = 2  # TRAIN.STAGE gates stop_gradient patterns (whmr.py:142-171,567-570)
    batch_size: int = 64
    base_lr: float = 5e-5
    max_iter: int = 500_000
    num_epochs: int = 170
    lr_gamma: float = 0.1
    lr_decay_epochs: Tuple[int, ...] = ()
    seed: int = 0
    # Gradient accumulation: split each batch into K sequential
    # microbatches per optimizer step (net-new vs the reference). Same
    # mean-of-means convention as DDP across ranks; activation memory
    # drops ~K× so bigger global batches fit one chip. batch_size % K == 0.
    grad_accum: int = 1
    # Exponential moving average of the params (net-new): ema = d*ema +
    # (1-d)*params after every optimizer step, updated in-graph. Saved to
    # <run>/checkpoints_ema as a weights-only checkpoint that every CLI
    # (--checkpoint) can serve/evaluate directly. 0 = off; 0.999-0.9999
    # are the usual production values.
    ema_decay: float = 0.0
    # Mixed precision: compute in bf16 on MXU, accumulate/params in fp32.
    use_bf16: bool = True
    # Opt-in global-norm gradient clipping (net-new; the reference trains
    # without clipping, so 0 = off stays protocol-faithful). From-scratch
    # runs see init grad norms ~2e4 and the HMR baseline diverges at
    # lr 2e-4 without it (loss 36 -> 97, round-5 overfit run); 1.0 is a
    # sane production value.
    grad_clip_norm: float = 0.0
    # Flat-buffer fused Adam (training/optim.py): bit-equal to optax.adam.
    # Measured SLOWER on v5e (154 vs 136 ms B=64 step — see optim.py);
    # kept as a documented negative-result experiment. Single-chip /
    # pure-DP only — flat moments can't be FSDP/TP-sharded (Trainer
    # enforces this).
    fused_adam: bool = False


@dataclass(frozen=True)
class SMPLConfig:
    """Body-model dimensions (fixed by the SMPL family)."""

    n_verts: int = 6890
    n_joints: int = 24
    n_betas: int = 10
    n_sub_verts: int = 1723  # Dmap0 output (whmr.py:93-96)
    n_temp_verts: int = 431  # Dmap1 output
    n_model_joints: int = 49  # pare-SMPL joint set (core/constants.py:74-92)


@dataclass(frozen=True)
class WHMRConfig:
    pymaf: PyMAFConfig = field(default_factory=PyMAFConfig)
    deconv: DeconvConfig = field(default_factory=DeconvConfig)
    vit: ViTConfig = field(default_factory=ViTConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    smpl: SMPLConfig = field(default_factory=SMPLConfig)
    # Crop resolution fed to the crop-frame weak-perspective projection
    # (reference configs/pymaf_config.yaml:83-85; IMG_RES).
    img_res: Tuple[int, int] = (256, 256)  # (W, H)
    # CamCalib full-image input resolution (reference demo/tester.py:100-104).
    cam_img_size: Tuple[int, int] = (600, 600)

    @property
    def crop_hw(self) -> Tuple[int, int]:
        """Actual network input (H, W): vitpose slices 256x256 -> 256x192
        (reference datasets/base_dataset.py:291-292)."""
        if self.pymaf.backbone == "vitpose":
            return (256, 192)
        return (self.img_res[1], self.img_res[0])

    @property
    def points_grid_wh(self) -> Tuple[int, int]:
        """Fixed sample-grid size of MAF step 0 (reference whmr.py:338-346).

        Returns (grid_width, grid_height) — note the reversed order vs
        ViTConfig.grid_hw, matching the reference's own naming."""
        if self.pymaf.backbone == "vitpose":
            return (7, 9)  # grid_width=7, grid_height=9 (whmr.py:341-343)
        return (8, 8)

    def with_overrides(self, **kv: Any) -> "WHMRConfig":
        """Dotted-key overrides, e.g. with_overrides(**{'pymaf.n_iter': 2})."""
        cfg = self
        for key, value in kv.items():
            parts = key.split(".")
            cfg = _replace_path(cfg, parts, value)
        return cfg


def _replace_path(obj: Any, parts: list, value: Any) -> Any:
    if len(parts) == 1:
        current = getattr(obj, parts[0])
        if isinstance(value, str):
            if isinstance(current, bool):
                value = value.lower() in ("1", "true", "yes", "on")
            elif isinstance(current, int):
                value = int(value)
            elif isinstance(current, float):
                value = float(value)
            elif isinstance(current, tuple):
                # comma/space-separated tuple override, e.g.
                # --misc pymaf.mlp_dim 256,128,64,32
                elem = type(current[0]) if current else float
                items = value.replace("(", "").replace(")", "").replace(",", " ").split()
                value = tuple(elem(v) for v in items)
        elif isinstance(value, list) and isinstance(current, tuple):
            # Lists become tuples, so the frozen config stays hashable.
            value = tuple(value)
        return replace(obj, **{parts[0]: value})
    child = getattr(obj, parts[0])
    return replace(obj, **{parts[0]: _replace_path(child, parts[1:], value)})


def default_config() -> WHMRConfig:
    return WHMRConfig()


def load_yaml(path: str) -> WHMRConfig:
    """Load a reference-style YAML (best-effort key mapping) into WHMRConfig."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    cfg = WHMRConfig()
    mapping = {
        ("MODEL", "PyMAF", "BACKBONE"): "pymaf.backbone",
        ("MODEL", "PyMAF", "N_ITER"): "pymaf.n_iter",
        ("MODEL", "PyMAF", "AUX_SUPV_ON"): "pymaf.aux_supv_on",
        ("MODEL", "PyMAF", "DEPTH_SUPV_ON"): "pymaf.depth_supv_on",
        ("MODEL", "PyMAF", "FOCAL_SUPV_ON"): "pymaf.focal_supv_on",
        ("TRAIN", "STAGE"): "train.stage",
        ("TRAIN", "BATCH_SIZE"): "train.batch_size",
        ("SOLVER", "BASE_LR"): "train.base_lr",
        ("SOLVER", "MAX_ITER"): "train.max_iter",
        ("LOSS", "KP_2D_W"): "loss.kp_2d_w",
        ("LOSS", "KP_3D_W"): "loss.kp_3d_w",
        ("LOSS", "SHAPE_W"): "loss.shape_w",
        ("LOSS", "POSE_W"): "loss.pose_w",
        ("LOSS", "VERT_W"): "loss.vert_w",
        ("LOSS", "POINT_REGRESSION_WEIGHTS"): "loss.point_regression_weights",
        ("LOSS", "FOCAL_WEIGHTS"): "loss.focal_weights",
        ("LOSS", "INDEX_WEIGHTS"): "loss.index_weights",
        ("LOSS", "PART_WEIGHTS"): "loss.part_weights",
        ("LOSS", "OPENPOSE_TRAIN_WEIGHT"): "loss.openpose_train_weight",
        ("LOSS", "GT_TRAIN_WEIGHT"): "loss.gt_train_weight",
        ("SOLVER", "GAMMA"): "train.lr_gamma",
        ("SOLVER", "EPOCHS"): "train.lr_decay_epochs",
        # backbone-scale section (net-new: the reference configures ViT via a
        # vendored mmcv file, ViTPose_base_coco_256x192.py:43-57; here the
        # L/H variants are first-class YAML — see configs/vit-l.yaml)
        ("MODEL", "VIT", "EMBED_DIM"): "vit.embed_dim",
        ("MODEL", "VIT", "DEPTH"): "vit.depth",
        ("MODEL", "VIT", "NUM_HEADS"): "vit.num_heads",
        ("MODEL", "VIT", "MLP_RATIO"): "vit.mlp_ratio",
        ("MODEL", "VIT", "DROP_PATH_RATE"): "vit.drop_path_rate",
        ("MODEL", "VIT", "REMAT"): "vit.remat",
    }
    overrides = {}
    for keys, dst in mapping.items():
        node = raw
        ok = True
        for k in keys:
            if not isinstance(node, dict) or k not in node:
                ok = False
                break
            node = node[k]
        if ok:
            overrides[dst] = node
    if "MODEL" in raw and "PyMAF" in raw.get("MODEL", {}):
        mlp = raw["MODEL"]["PyMAF"].get("MLP_DIM")
        if mlp:
            cfg = replace(cfg, pymaf=replace(cfg.pymaf, mlp_dim=tuple(mlp)))
    return cfg.with_overrides(**overrides)


def config_from_args(args) -> WHMRConfig:
    """Shared CLI config resolution: `--cfg_file` YAML base (reference-style
    schema, incl. the MODEL.VIT L/H sections) + dotted `--misc` overrides.
    Mirrors the reference's parse_args_extend layering (core/cfgs.py:72-96)
    across every console script."""
    cfg_file = getattr(args, "cfg_file", None)
    cfg = load_yaml(cfg_file) if cfg_file else WHMRConfig()
    misc = getattr(args, "misc", None)
    if misc:
        cfg = cfg.with_overrides(**dict(zip(misc[::2], misc[1::2])))
    return cfg
