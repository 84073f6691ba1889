"""The res50 PyMAF backbone: whmr_tpu_torch against whmr_tpu at
`tiny_config("res50")` (256x256 crops, the full ResNet-50 trunk, 8x8 sample
grid), on flax variables carried across by `state_dict_from_flax`.

The variables are drawn with numpy in the shapes of whmr_tpu's init
(`torch_port_util.numpy_variables`), so no flax init is compiled. The res50
model trains with `pymaf.dp_heatmap_size` (64, 64), the size of its IUV
head's output at 256x256 (the 128x128 default is the ViT's).

Tolerances: the eval-mode forwards in fp32, atol 1e-4 (rtol 1e-5 for the
O(1e3) focal length and translation: the res50 Tz head's 144-token block
moves Tz by a few fp32 ulps); the train step's losses 1e-4
relative. The train-mode trunk is held in float64 on both sides, 1e-6 of
each leaf's largest gradient: in fp32 a random ResNet-50's batch-statistics
BatchNorm at B=2 amplifies the rounding of its reductions about a million
times (whmr_tpu's fp32 and float64 gradients differ by 20% on layer4), so
fp32 gradients of the trunk compare the two frameworks' summation orders,
not the port.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whmr_tpu.data.assets import synthetic_smpl_assets as j_assets
from whmr_tpu.models import regressor as jreg
from whmr_tpu.models import resnet as jresnet
from whmr_tpu.models.whmr import WHMR as JWHMR
from whmr_tpu.training import gt_renderer as jgt
from whmr_tpu.training import train_step as jts
from whmr_tpu.utils.testing import make_example_inputs, make_example_train_batch, tiny_config
from whmr_tpu_torch.data.assets import synthetic_smpl_assets as t_assets
from whmr_tpu_torch.models import layers as tlayers
from whmr_tpu_torch.models import resnet as tresnet
from whmr_tpu_torch.models import whmr as twhmr
from whmr_tpu_torch.training import gt_renderer as tgt
from whmr_tpu_torch.training import train_step as tts
from whmr_tpu_torch.utils import testing as ttesting
from whmr_tpu_torch.utils.convert import conv_from_flax, state_dict_from_flax

from torch_port_util import (  # noqa: F401 (autouse fixture)
    float64_module,
    n,
    numpy_variables,
    release_memory,
    t,
)

BATCH = 2
RES50 = {"pymaf.dp_heatmap_size": (64, 64)}


def _cfgs():
    return tiny_config("res50").with_overrides(**RES50), ttesting.tiny_config("res50").with_overrides(**RES50)


@pytest.fixture(scope="module")
def carried():
    """flax variables of whmr_tpu's res50 WHMR (CamCalib included) and the
    port's state_dict of the same weights."""
    cfg = _cfgs()[0]
    args = {k: jnp.asarray(v) for k, v in make_example_inputs(cfg, BATCH).items()}
    args["full_x"] = jnp.zeros((BATCH, 64, 64, 3), jnp.float32)
    consts = jreg.body_consts_from_assets(j_assets(0))
    variables = numpy_variables(lambda c, a: JWHMR(cfg).init(jax.random.PRNGKey(0), c, **a), consts, args)
    return consts, variables, state_dict_from_flax(variables)


@pytest.fixture(scope="module")
def port(carried):
    """The port's fp32 res50 model on the carried weights (built once: the
    train-step test, which updates its BatchNorm statistics, runs last)."""
    model, consts = twhmr.build_model(_cfgs()[1], dtype=torch.float32, device="cpu")
    model.load_state_dict(carried[2], strict=True)
    return model, consts


def test_state_dict_from_flax_res50(carried, port):
    """The res50 trunk lands under the PoseResNet encoder's torchvision
    names, and every key of the port's res50 model is filled."""
    _, variables, sd = carried
    model = port[0]
    assert set(sd) == set(model.state_dict())
    assert isinstance(model.feature_extractor, tresnet.PoseResNetEncoder)
    trunk = variables["params"]["feature_extractor"]["trunk"]
    np.testing.assert_array_equal(sd["feature_extractor.conv1.weight"].numpy(),
                                  conv_from_flax(trunk["ConvBN_0"]["Conv_0"]["kernel"]))
    # Bottleneck_15 is the last block of the fourth stage (3 + 4 + 6 + 3 blocks)
    np.testing.assert_array_equal(sd["feature_extractor.layer4.2.conv3.weight"].numpy(),
                                  conv_from_flax(trunk["Bottleneck_15"]["ConvBN_2"]["Conv_0"]["kernel"]))
    stats = variables["batch_stats"]["feature_extractor"]["trunk"]["Bottleneck_3"]["ConvBN_3"]["BatchNorm_0"]
    np.testing.assert_array_equal(sd["feature_extractor.layer2.0.downsample.1.running_var"].numpy(), stats["var"])
    # the res50 Tz head: first stride 2 and width 10 (whmr.py:404-416)
    assert model.conv[0].stride == (2, 2) and model.est_Tz[0].out_features == 10
    assert sd["deconv_layers.0.weight"].shape[0] == 2048


@pytest.mark.parametrize("module", ["PoseResNetEncoder", "ResNetBackbone"])
def test_resnet_modules_match_flax_eval(module):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 64, 96, 3).astype(np.float32)
    jm = getattr(jresnet, module)()
    variables = numpy_variables(lambda x: jm.init(jax.random.PRNGKey(0), x), jnp.asarray(x), seed=4)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    tree = {c: {"feature_extractor": variables[c]} for c in ("params", "batch_stats")}
    sd = {k[len("feature_extractor."):]: v for k, v in state_dict_from_flax(tree).items()}
    port = getattr(tresnet, module)()
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port.eval()(t(x).permute(0, 3, 1, 2))
    if module == "ResNetBackbone":
        np.testing.assert_allclose(n(got[1]), n(want[1]), atol=1e-4)
        got, want = got[0], want[0]
    assert got.shape == (2, 2048, 2, 3)
    np.testing.assert_allclose(n(got.permute(0, 2, 3, 1)), n(want), atol=1e-4)


def test_pose_resnet_encoder_train_mode_float64():
    """Train mode: the batch-statistics output, the running statistics it
    leaves and the gradients of a random linear functional, in float64."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 64, 64, 3)
    r = rng.randn(2, 2, 2, 2048)
    with jax.enable_x64(True):
        jm = jresnet.PoseResNetEncoder(dtype=jnp.float64)
        variables = numpy_variables(lambda x: jm.init(jax.random.PRNGKey(0), x), jnp.asarray(x), seed=6)

        def f(params):
            y, upd = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
                              train=True, mutable=["batch_stats"])
            return jnp.sum(y * r), (y, upd["batch_stats"])

        (_, (want, stats)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables["params"]))
        want, stats, grads = jax.device_get((want, stats, grads))

    tree = {c: {"feature_extractor": variables[c]} for c in ("params", "batch_stats")}
    sd = {k[len("feature_extractor."):]: v for k, v in state_dict_from_flax(tree).items()}
    port = tresnet.PoseResNetEncoder()
    port.load_state_dict(sd, strict=True)
    float64_module(port).train()
    y = port(torch.as_tensor(x).permute(0, 3, 1, 2))
    (y * torch.as_tensor(r).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=1e-6)
    # the float64 gradients and statistics, leaf by leaf through the
    # converter's names (its fp32 cast is far below the tolerance)
    want_grads = state_dict_from_flax({"params": {"feature_extractor": grads},
                                       "batch_stats": {"feature_extractor": stats}})
    assert len(jax.tree_util.tree_leaves(grads)) == len(list(port.named_parameters()))
    for k, p in port.named_parameters():
        w = want_grads["feature_extractor." + k].numpy()
        assert np.abs(p.grad.numpy() - w).max() <= 1e-6 * np.abs(w).max(), k
    for k, b in port.named_buffers():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), want_grads["feature_extractor." + k].numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=k)


def _inputs():
    inp = make_example_inputs(_cfgs()[0], BATCH, seed=1)
    inp["full_x"] = np.random.RandomState(2).randn(1, 64, 64, 3).astype(np.float32)
    return inp


def _outputs(out):
    res = {}
    for i, step in enumerate(out["smpl_out"][1:], start=1):
        for k in ("verts", "kp_2d", "kp_2d_w", "pred_cam_t", "focal_length"):
            res[f"{k}_{i}"] = step[k]
    res["global_verts"] = out["global_output"]["global_verts"]
    res.update({f"dp_{k}": v for k, v in out["dp_out"][0].items()})
    return res


def test_res50_forward_matches_whmr_tpu(carried, port):
    consts, variables, _ = carried
    inp = _inputs()
    want = _outputs(jax.jit(JWHMR(_cfgs()[0]).apply)(
        variables, consts, **{k: jnp.asarray(v) for k, v in inp.items()}))
    model, tconsts = port
    with torch.no_grad():
        out = model(tconsts, **{k: t(v) for k, v in inp.items()})
        # iuv_logits runs the res50 extractor and the whole pyramid too
        logits = model.iuv_logits(t(inp["x"]))
    got = _outputs(out)
    assert got["verts_3"].shape == (BATCH, 6890, 3) and got["dp_predict_ann_index"].shape == (BATCH, 64, 64, 15)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(n(got[k]), n(want[k]), atol=1e-4, rtol=1e-5, err_msg=k)
    torch.testing.assert_close(logits, out["dp_out"][0]["predict_ann_index"], rtol=0, atol=0)


def test_res50_train_step_losses_match_whmr_tpu(carried, port):
    """One train step with the GT render (its maps given to whmr_tpu as
    targets, as in test_torch_train_step.py): every loss term, and the
    running statistics move."""
    jconsts, variables, _ = carried
    jcfg, tcfg = _cfgs()
    consts0 = twhmr.body_consts_from_assets(t_assets(0))
    batch = ttesting.make_keypoints_consistent(consts0, make_example_train_batch(jcfg, BATCH, seed=1))
    model, consts = port
    for m in model.modules():
        if isinstance(m, tlayers.Dropout):
            m.p = 0.0
    rc = tgt.build_render_consts(t_assets(0))
    tb = {k: t(v) for k, v in batch.items()}
    uvia_gt = tts.gt_targets(tcfg, consts, tb, rc)[3]
    assert uvia_gt["index"].shape[1:3] == (64, 64)
    jbatch = dict(batch, uvia_gt={k: n(v) for k, v in uvia_gt.items()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
        fn = jax.jit(lambda p, s, c, b: jts._microbatch_grads(
            jcfg, JWHMR(jcfg), p, s, c, b, jax.random.PRNGKey(0),
            render_consts=jgt.build_render_consts(j_assets(0))))
        _, jlosses, _ = jax.device_get(fn(variables["params"], variables["batch_stats"], jconsts,
                                          jax.tree_util.tree_map(jnp.asarray, jbatch)))

    state = tts.create_train_state(tcfg, model)
    before = state.batch_stats["feature_extractor.layer4.2.bn3.running_mean"].clone()
    grads, losses = tts._microbatch_grads(tcfg, model, state, consts, tb, None, rc)
    assert losses.keys() == jlosses.keys() and "loss_IndexUV" in losses
    for k in jlosses:
        np.testing.assert_allclose(n(losses[k]), n(jlosses[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    assert grads["feature_extractor.conv1.weight"].abs().max() > 0
    assert not torch.equal(state.batch_stats["feature_extractor.layer4.2.bn3.running_mean"], before)
