"""The Graphormer refiner (`pymaf.grph_on`): whmr_tpu_torch against
whmr_tpu at `tiny_config` (ViT backbone, the refiner at its full width:
4 layers, hidden 32, 431 -> 1723 -> 6890), fp32, on flax variables drawn
with numpy in the shapes of whmr_tpu's init
(`torch_port_util.numpy_variables`) and carried across by
`state_dict_from_flax`.

Train-mode cases make dropout the identity on both sides (flax's
`nn.Dropout.__call__` patched, the port's `Dropout` at p=0), as
test_torch_train_step.py does; the [MASK] tokens of `meta_masks` stay.

Tolerances: outputs atol 1e-4 (rtol 1e-5 for the O(1e3) focal length and
translation), loss terms 1e-4 relative, each gradient leaf within 1e-3 of
that leaf's largest (floored at 1e-6 of the model's largest), as in
test_torch_train_step.py; the attention key biases, whose gradients
vanish in exact arithmetic, within 1e-7 of the model's largest gradient
on both sides.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from whmr_tpu.data.assets import synthetic_smpl_assets as j_assets
from whmr_tpu.models import graphormer as jg
from whmr_tpu.models import regressor as jreg
from whmr_tpu.models.whmr import WHMR as JWHMR
from whmr_tpu.training import gt_renderer as jgt
from whmr_tpu.training import train_step as jts
from whmr_tpu.utils.testing import make_example_inputs, make_example_train_batch, tiny_config
from whmr_tpu_torch.data.assets import synthetic_smpl_assets as t_assets
from whmr_tpu_torch.models import graphormer as tg
from whmr_tpu_torch.models import layers as tlayers
from whmr_tpu_torch.models import whmr as twhmr
from whmr_tpu_torch.training import gt_renderer as tgt
from whmr_tpu_torch.training import train_step as tts
from whmr_tpu_torch.utils import testing as ttesting
from whmr_tpu_torch.utils.convert import state_dict_from_flax

from test_graphormer_oracle import TorchGraphormerBody
from torch_port_util import n, numpy_variables, release_memory, t  # noqa: F401 (autouse fixture)

BATCH = 2
# The 2D keypoint losses on, so that the refined keypoints' gating is scored.
GRPH = {"pymaf.grph_on": True, "loss.kp_2d_w": 300.0}


def _cfgs():
    return tiny_config().with_overrides(**GRPH), ttesting.tiny_config().with_overrides(**GRPH)


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, tlayers.Dropout):
            m.p = 0.0
    return model


def test_build_adjacency_ring():
    got = tg.build_adjacency(t_assets(0))
    want = jg.build_adjacency(j_assets(0))
    assert got.shape == (431, 431) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_build_adjacency_from_reference_tensors(tmp_path):
    """The reference's sparse `smpl_431_adjmat_{indices,values,size}.pt`."""
    rng = np.random.RandomState(0)
    rows = rng.randint(0, 431, 3000)
    cols = rng.randint(0, 431, 3000)
    keep = np.unique(rows * 431 + cols)
    idx = np.stack([keep // 431, keep % 431])
    torch.save(torch.as_tensor(idx, dtype=torch.int64), tmp_path / "smpl_431_adjmat_indices.pt")
    torch.save(torch.as_tensor(rng.rand(idx.shape[1]), dtype=torch.float32), tmp_path / "smpl_431_adjmat_values.pt")
    torch.save(torch.tensor([431, 431]), tmp_path / "smpl_431_adjmat_size.pt")
    got = tg.build_adjacency(t_assets(0), str(tmp_path))
    np.testing.assert_array_equal(got, jg.build_adjacency(j_assets(0), str(tmp_path)))
    assert np.count_nonzero(got) == idx.shape[1]
    consts = twhmr.body_consts_from_assets(t_assets(0), adjacency_dir=str(tmp_path))
    np.testing.assert_array_equal(consts.adj431.numpy(), got)


def _encoder_inputs(seed=4, in_dim=19):
    rng = np.random.RandomState(seed)
    return rng.randn(2, 432, in_dim).astype(np.float32) * 0.5


def test_encoder_matches_flax():
    tokens = _encoder_inputs()
    adj = jg.build_adjacency(j_assets(0))
    jm = jg.GraphormerEncoder()
    variables = numpy_variables(lambda x, a: jm.init(jax.random.PRNGKey(0), x, a), jnp.asarray(tokens),
                                jnp.asarray(adj), seed=1)
    want = jax.jit(lambda v, x, a: jm.apply(v, x, a))(variables, jnp.asarray(tokens), jnp.asarray(adj))
    sd = state_dict_from_flax({"params": {"transformer0": {
        "trans_encoder": variables["params"], "global_feat_dim": {"kernel": np.zeros((1, 19))},
        "upsampling": {"kernel": np.zeros((431, 1723))}, "upsampling2": {"kernel": np.zeros((1723, 6890))},
    }}})
    prefix = "transformer.0.trans_encoder."
    port = tg.GraphormerEncoder(19)
    port.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}, strict=True)
    with torch.no_grad():
        got = port.eval()(t(tokens), t(adj))
    np.testing.assert_allclose(n(got), n(want), atol=1e-4)


@pytest.fixture(scope="module")
def body():
    """whmr_tpu's GraphormerBodyNetwork at 37-d body features and 16-d grid
    features, its numpy-drawn variables, and the port's module on them."""
    rng = np.random.RandomState(5)
    inputs = (rng.randn(2, 37).astype(np.float32) * 0.5, rng.randn(2, 431, 16).astype(np.float32) * 0.5,
              rng.randn(2, 431, 3).astype(np.float32) * 0.3)
    adj = jg.build_adjacency(j_assets(0))
    jm = jg.GraphormerBodyNetwork()
    variables = numpy_variables(lambda *a: jm.init(jax.random.PRNGKey(0), *a), *map(jnp.asarray, inputs),
                                jnp.asarray(adj), seed=2)
    sd = state_dict_from_flax({"params": {"transformer0": variables["params"]}})
    port = tg.GraphormerBodyNetwork(37, 16)
    port.load_state_dict({k[len("transformer.0."):]: v for k, v in sd.items()}, strict=True)
    return jm, variables, port, inputs, adj


@pytest.mark.parametrize("case", ["eval", "train_meta_masks"])
def test_body_network_matches_flax(body, case):
    jm, variables, port, inputs, adj = body
    masks = (np.random.RandomState(6).rand(2, 431, 1) > 0.15).astype(np.float32)
    train = case != "eval"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
        want = jax.jit(lambda v, *a: jm.apply(v, *a, meta_masks=jnp.asarray(masks), train=train))(
            variables, *map(jnp.asarray, inputs), jnp.asarray(adj))
    _no_dropout(port).train(train)
    with torch.no_grad():
        got = port(*map(t, inputs), t(adj), meta_masks=t(masks))
    for k in ("temp_verts", "sub_verts", "verts"):
        np.testing.assert_allclose(n(got[k]), n(want[k]), atol=1e-4, err_msg=k)
    # the masks change the train-mode result (the [MASK] tokens are 0.01s)
    if train:
        with torch.no_grad():
            plain = port(*map(t, inputs), t(adj))
        assert (plain["verts"] - got["verts"]).abs().max() > 1e-4


def test_names_are_the_reference_tree(body):
    """The port's keys are those of the reference tree that
    test_graphormer_oracle.py re-declares, and its weights, loaded there
    by those names, give the re-declaration's output (which applies the
    GCN weight before the adjacency: the same product in another order)."""
    _, _, port, inputs, adj = body
    oracle = TorchGraphormerBody(37, 19)
    assert set(oracle.state_dict()) == set(port.state_dict())
    oracle.load_state_dict(port.state_dict(), strict=True)
    with torch.no_grad():
        want = oracle.eval()(*map(t, inputs), t(adj))
        got = _no_dropout(port).eval()(*map(t, inputs), t(adj))
    for w, k in zip(want, ("temp_verts", "sub_verts", "verts")):
        np.testing.assert_allclose(n(got[k]), n(w), atol=1e-4, err_msg=k)


@pytest.fixture(scope="module")
def carried():
    cfg = _cfgs()[0]
    args = {k: jnp.asarray(v) for k, v in make_example_inputs(cfg, BATCH).items()}
    args["full_x"] = jnp.zeros((BATCH, 64, 64, 3), jnp.float32)
    consts = jreg.body_consts_from_assets(j_assets(0))
    variables = numpy_variables(lambda c, a: JWHMR(cfg).init(jax.random.PRNGKey(0), c, **a), consts, args)
    sd = state_dict_from_flax(variables)
    model, tconsts = twhmr.build_model(_cfgs()[1], dtype=torch.float32, device="cpu")
    model.load_state_dict(sd, strict=True)
    return consts, variables, model, tconsts


def _stage(out, i):
    s = out["smpl_out"][i]
    return {k: s[k] for k in ("verts", "sub_verts", "temp_verts", "kp_2d", "kp_2d_w", "kp_3d", "markers",
                              "rotmat", "pred_cam_t", "focal_length")}


def test_grph_on_forward_matches_whmr_tpu(carried):
    consts, variables, model, tconsts = carried
    inp = make_example_inputs(_cfgs()[0], BATCH, seed=1)
    want = jax.jit(JWHMR(_cfgs()[0]).apply)(variables, consts, **{k: jnp.asarray(v) for k, v in inp.items()})
    with torch.no_grad():
        got = model.eval()(tconsts, **{k: t(v) for k, v in inp.items()})
    # the mean init, 3 MAF steps and the appended refinement
    assert len(got["smpl_out"]) == len(want["smpl_out"]) == 5
    assert got["refined"] is got["smpl_out"][-1]
    refined, last = got["refined"], got["smpl_out"][3]
    assert refined["verts"].shape == (BATCH, 6890, 3)
    assert (refined["verts"] - last["verts"]).abs().max() > 1e-3
    # the parametric fields carry over from the last MAF step
    assert refined["rotmat"] is last["rotmat"] and refined["pred_cam"] is last["pred_cam"]
    for i in (3, 4):
        w = _stage(want, i)
        for k, g in _stage(got, i).items():
            np.testing.assert_allclose(n(g), n(w[k]), atol=1e-4, rtol=1e-5, err_msg=f"{i}/{k}")
    np.testing.assert_allclose(n(got["global_output"]["global_verts"]),
                               n(want["global_output"]["global_verts"]), atol=1e-4)


def test_grph_on_train_step_matches_whmr_tpu(carried):
    """Losses and gradients of a train step (GT render on, meta_masks in
    the batch) against whmr_tpu's; the Graphormer stage has no parameter
    losses (the `nonparam` gate) and its parameters get gradients."""
    jconsts, variables, model, consts = carried
    jcfg, tcfg = _cfgs()
    batch = ttesting.make_keypoints_consistent(consts, make_example_train_batch(jcfg, BATCH, seed=1))
    rc = tgt.build_render_consts(t_assets(0))
    tb = {k: t(v) for k, v in batch.items()}
    uvia_gt = tts.gt_targets(tcfg, consts, tb, rc)[3]
    jbatch = dict(batch, uvia_gt={k: n(v) for k, v in uvia_gt.items()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
        fn = jax.jit(lambda p, s, c, b: jts._microbatch_grads(
            jcfg, JWHMR(jcfg), p, s, c, b, jax.random.PRNGKey(0),
            render_consts=jgt.build_render_consts(j_assets(0))))
        jgrads, jlosses, _ = jax.device_get(fn(variables["params"], variables["batch_stats"], jconsts,
                                               jax.tree_util.tree_map(jnp.asarray, jbatch)))
    want = state_dict_from_flax({"params": jgrads, "batch_stats": variables["batch_stats"]})
    want = {k: v for k, v in want.items() if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}

    _no_dropout(model)
    state = tts.create_train_state(tcfg, model)
    grads, losses = tts._microbatch_grads(tcfg, model, state, consts, tb, None, rc)
    assert losses.keys() == jlosses.keys()
    assert "loss_regr_pose_3" in losses and "loss_regr_pose_4" not in losses
    assert "loss_cam_4" not in losses and "loss_shape_4" in losses and "loss_keypoints_4" in losses
    for k in jlosses:
        np.testing.assert_allclose(n(losses[k]), n(jlosses[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(n(tts.global_norm(list(grads.values()))), float(optax.global_norm(jgrads)),
                               rtol=1e-4)
    assert grads.keys() == want.keys()
    top = max(np.abs(g.numpy()).max() for g in want.values())
    for k, w in want.items():
        w = w.numpy()
        if k.endswith("attention.self.key.bias"):
            # a key bias shifts a query's scores by one constant, which the
            # softmax removes: both gradients are rounding noise
            assert max(np.abs(w).max(), np.abs(n(grads[k])).max()) <= 1e-7 * top, k
            continue
        assert np.abs(n(grads[k]) - w).max() <= 1e-3 * max(np.abs(w).max(), 1e-6 * top), k
    assert grads["transformer.0.trans_encoder.layer.0.graph_conv.conv.weight"].abs().max() > 0
    assert grads["transformer.0.upsampling2.weight"].abs().max() > 0
