"""The port's config loading (whmr_tpu_torch/config.py) against whmr_tpu's.

The three YAMLs of configs/, a reference-style YAML with every mapped key,
the ViT presets and the CLIs' `--cfg_file` + `--misc` layering give configs
equal to whmr_tpu's, field by field.
"""

import argparse
import dataclasses
from pathlib import Path

import pytest

from whmr_tpu import config as jconfig
from whmr_tpu_torch import config as tconfig

from torch_port_util import release_memory  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parent.parent

REFERENCE_YAML = """
MODEL:
  PyMAF:
    BACKBONE: 'vitpose'
    N_ITER: 2
    AUX_SUPV_ON: False
    DEPTH_SUPV_ON: True
    FOCAL_SUPV_ON: True
    MLP_DIM: [128, 64, 32, 16]
  VIT:
    EMBED_DIM: 384
    DEPTH: 6
    NUM_HEADS: 6
    MLP_RATIO: 2.0
    DROP_PATH_RATE: 0.1
    REMAT: True
TRAIN:
  STAGE: 1
  BATCH_SIZE: 16
SOLVER:
  BASE_LR: 0.0001
  MAX_ITER: 1000
  GAMMA: 0.5
  EPOCHS: [10, 20]
LOSS:
  KP_2D_W: 1.0
  KP_3D_W: 200.0
  SHAPE_W: 0.1
  POSE_W: 50.0
  VERT_W: 10.0
  POINT_REGRESSION_WEIGHTS: 0.5
  FOCAL_WEIGHTS: 0.001
  INDEX_WEIGHTS: 1.5
  PART_WEIGHTS: 0.2
  OPENPOSE_TRAIN_WEIGHT: 0.1
  GT_TRAIN_WEIGHT: 2.0
UNMAPPED:
  KEY: 1
"""


def _same(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.crop_hw == b.crop_hw and a.points_grid_wh == b.points_grid_wh and a.vit.grid_hw == b.vit.grid_hw


@pytest.mark.parametrize("name", ["default.yaml", "vit-l.yaml", "vit-h.yaml", "reference"])
def test_load_yaml_matches_whmr_tpu(tmp_path, name):
    if name == "reference":
        path = tmp_path / "reference.yaml"
        path.write_text(REFERENCE_YAML)
    else:
        path = ROOT / "configs" / name
    got, want = tconfig.load_yaml(str(path)), jconfig.load_yaml(str(path))
    _same(got, want)
    assert got != tconfig.WHMRConfig() or name == "default.yaml"


def test_presets_and_default_match_whmr_tpu():
    for name in ("vit_base", "vit_large", "vit_huge"):
        assert dataclasses.asdict(getattr(tconfig, name)()) == dataclasses.asdict(getattr(jconfig, name)()), name
    _same(tconfig.default_config(), jconfig.default_config())
    assert tconfig.load_yaml(str(ROOT / "configs" / "vit-l.yaml")).vit == tconfig.vit_large()


@pytest.mark.parametrize("layers", ["misc", "cfg_file", "cfg_file+misc", "none"])
def test_config_from_args_layering(tmp_path, layers):
    path = tmp_path / "reference.yaml"
    path.write_text(REFERENCE_YAML)
    args = argparse.Namespace(
        cfg_file=str(path) if "cfg_file" in layers else None,
        misc=(["vit.depth", "3", "pymaf.mlp_dim", "8,4,2,1", "pymaf.aux_supv_on", "true",
               "train.base_lr", "2e-4", "vit.attn_impl", "pallas"] if "misc" in layers else []),
    )
    got, want = tconfig.config_from_args(args), jconfig.config_from_args(args)
    _same(got, want)
    if "misc" in layers:
        assert got.vit.depth == 3 and got.pymaf.mlp_dim == (8, 4, 2, 1) and got.vit.attn_impl == "pallas"
    if layers == "cfg_file+misc":
        assert got.vit.embed_dim == 384 and got.train.lr_decay_epochs == (10, 20)  # the YAML base stays
