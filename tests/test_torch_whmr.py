"""The whole slice: whmr_tpu_torch's WHMR forward against whmr_tpu's at
`tiny_config`, fp32, on `model.init` variables carried across by
`state_dict_from_flax`, under attn_impl "einsum" and "pallas", without a
CamCalib frame, with one 64x64 frame broadcast to all crops, and with a
given camera rotation.

Tolerance: atol 1e-4 (ARCHITECTURE.md "Testing model"), plus rtol 1e-6 for
the O(1e3) focal length and full-image translation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whmr_tpu.data.assets import synthetic_smpl_assets as j_assets
from whmr_tpu.models import regressor as jreg
from whmr_tpu.models.whmr import WHMR as JWHMR
from whmr_tpu.utils.testing import make_example_inputs, tiny_config
from whmr_tpu_torch.models import whmr as twhmr
from whmr_tpu_torch.utils import testing as ttesting
from whmr_tpu_torch.utils.convert import state_dict_from_flax

from torch_port_util import release_memory, n, random_batch_stats, t  # noqa: F401 (autouse fixture)

BATCH = 2


@pytest.fixture(scope="module")
def carried():
    """flax variables (CamCalib branch included) and the port's state_dict."""
    cfg = tiny_config()
    args = {k: jnp.asarray(v) for k, v in make_example_inputs(cfg, BATCH).items()}
    args["full_x"] = jnp.zeros((BATCH, 64, 64, 3), jnp.float32)
    consts = jreg.body_consts_from_assets(j_assets(0))
    variables = jax.jit(lambda c, a: JWHMR(cfg).init(jax.random.PRNGKey(0), c, **a))(consts, args)
    variables = random_batch_stats(jax.device_get(variables))
    return consts, variables, state_dict_from_flax(variables)


def _inputs(case):
    inp = make_example_inputs(tiny_config(), BATCH, seed=1)
    rng = np.random.RandomState(2)
    if case == "frame":
        inp["full_x"] = rng.randn(1, 64, 64, 3).astype(np.float32)
    elif case == "cam_rotmat":
        a = rng.uniform(-0.4, 0.4, (BATCH, 2))
        rot = np.zeros((BATCH, 3, 3), np.float32)
        for i, (pitch, roll) in enumerate(a):
            cp, sp, cr, sr = np.cos(pitch), np.sin(pitch), np.cos(roll), np.sin(roll)
            rot[i] = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]]) @ np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
        inp["cam_rotmat"] = rot
    return inp


def _outputs(out):
    last = out["smpl_out"][-1]
    res = {
        "verts": last["verts"],
        "pred_cam_t": last["pred_cam_t"],
        "focal_length": last["focal_length"],
        "global_verts": out["global_output"]["global_verts"],
        "cam_rotmat": out["vis"]["cam_rotmat"],
    }
    res.update({f"dp_{k}": v for k, v in out["dp_out"][0].items()})
    return res


@pytest.mark.parametrize("case", ["none", "frame", "cam_rotmat"])
@pytest.mark.parametrize("impl", ["einsum", "pallas"])
def test_forward_matches_whmr_tpu(carried, impl, case):
    consts, variables, sd = carried
    inp = _inputs(case)
    jcfg = tiny_config().with_overrides(**{"vit.attn_impl": impl})
    want = _outputs(jax.jit(JWHMR(jcfg).apply)(variables, consts, **{k: jnp.asarray(v) for k, v in inp.items()}))

    tcfg = ttesting.tiny_config().with_overrides(**{"vit.attn_impl": impl})
    model, tconsts = twhmr.build_model(tcfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = _outputs(model(tconsts, **{k: t(v) for k, v in inp.items()}))
    assert got["verts"].shape == got["global_verts"].shape == (BATCH, 6890, 3)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(n(got[k]), n(want[k]), atol=1e-4, rtol=1e-6, err_msg=k)


def test_iuv_logits_matches_whmr_tpu(carried):
    consts, variables, sd = carried
    x = make_example_inputs(tiny_config(), BATCH, seed=3)["x"]
    want = jax.jit(lambda v, x: JWHMR(tiny_config()).apply(v, x, method="iuv_logits"))(variables, jnp.asarray(x))
    model, _ = twhmr.build_model(ttesting.tiny_config(), dtype=torch.float32, device="cpu")
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model.iuv_logits(t(x))
    np.testing.assert_allclose(n(got), n(want), atol=1e-4)


def test_bf16_forward_is_close_to_fp32(carried):
    """The compute-dtype contract: a bf16 forward on the same weights stays
    near the fp32 one (geometry is fp32 in both)."""
    _, _, sd = carried
    inp = {k: t(v) for k, v in _inputs("frame").items()}
    outs = {}
    for dtype in (torch.float32, torch.bfloat16):
        model, consts = twhmr.build_model(ttesting.tiny_config(), dtype=dtype, device="cpu")
        model.load_state_dict(sd, strict=True)
        with torch.no_grad():
            outs[dtype] = model(consts, **inp)
    v32 = outs[torch.float32]["global_output"]["global_verts"]
    v16 = outs[torch.bfloat16]["global_output"]["global_verts"]
    assert v16.dtype == torch.float32 and torch.isfinite(v16).all()
    assert (v16 - v32).abs().max().item() < 0.05  # metres, tiny random model


def test_unported_options_raise():
    # grph_on and the res50 backbone are ported (test_torch_graphormer.py,
    # test_torch_res50.py): they build; an unknown backbone raises
    cfg = ttesting.tiny_config()
    assert isinstance(twhmr.WHMR(cfg.with_overrides(**{"pymaf.grph_on": True})).transformer[0],
                      twhmr.GraphormerBodyNetwork)
    assert isinstance(twhmr.WHMR(ttesting.tiny_config("res50")).feature_extractor, twhmr.PoseResNetEncoder)
    with pytest.raises(ValueError, match="backbone"):
        twhmr.WHMR(cfg.with_overrides(**{"pymaf.backbone": "res101"}))
    model, consts = twhmr.build_model(cfg, dtype=torch.float32, device="cpu")
    inp = {k: t(v) for k, v in make_example_inputs(tiny_config(), 1).items()}
    # The train-mode forward is ported; its flag must match the module's mode.
    with pytest.raises(ValueError, match="model.train"):
        model(consts, **inp, train=True)
