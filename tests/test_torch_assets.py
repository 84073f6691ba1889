"""whmr_tpu_torch's copies of the jax-free modules equal whmr_tpu's:
synthetic SMPL assets, config defaults, and the example-input fixtures."""

import dataclasses

import numpy as np
import pytest

from whmr_tpu import config as jcfg
from whmr_tpu.data import assets as jassets
from whmr_tpu.utils import testing as jtesting
from whmr_tpu_torch import config as tcfg
from whmr_tpu_torch.data import assets as tassets
from whmr_tpu_torch.utils import testing as ttesting


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_assets_bit_identical(seed):
    ja, ta = jassets.synthetic_smpl_assets(seed), tassets.synthetic_smpl_assets(seed)
    for f in dataclasses.fields(jassets.SMPLAssets):
        a, b = getattr(ja, f.name), getattr(ta, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    np.testing.assert_array_equal(jassets.SMPL_PARENTS, tassets.SMPL_PARENTS)
    assert jassets.H36M_TO_J14 == tassets.H36M_TO_J14


def test_config_defaults_equal():
    assert dataclasses.asdict(jcfg.WHMRConfig()) == dataclasses.asdict(tcfg.WHMRConfig())
    assert dataclasses.asdict(jtesting.tiny_config()) == dataclasses.asdict(ttesting.tiny_config())
    j = jcfg.WHMRConfig()
    tc = tcfg.WHMRConfig()
    assert (j.crop_hw, j.points_grid_wh, j.vit.grid_hw) == (tc.crop_hw, tc.points_grid_wh, tc.vit.grid_hw)
    over = {"vit.attn_impl": "pallas", "pymaf.n_iter": "2", "pymaf.mlp_dim": "8,4,2,1"}
    assert dataclasses.asdict(j.with_overrides(**over)) == dataclasses.asdict(tc.with_overrides(**over))


@pytest.mark.parametrize("full", [False, True])
def test_example_inputs_equal(full):
    cfg_j, cfg_t = jtesting.tiny_config(), ttesting.tiny_config()
    a = jtesting.make_example_inputs(cfg_j, 3, seed=5, with_full_img=full)
    b = ttesting.make_example_inputs(cfg_t, 3, seed=5, with_full_img=full)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
