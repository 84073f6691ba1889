"""whmr_tpu_torch modules against their whmr_tpu counterparts on weights
carried across by `state_dict_from_flax`, fp32, tiny widths.

Tolerance: atol 1e-4 (the existing torch oracles', ARCHITECTURE.md "Testing
model"); the two frameworks sum in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whmr_tpu.config import ViTConfig as JViTConfig
from whmr_tpu.data.assets import synthetic_smpl_assets as j_assets
from whmr_tpu.models import heads as jheads
from whmr_tpu.models import layers as jlayers
from whmr_tpu.models import maf as jmaf
from whmr_tpu.models import regressor as jreg
from whmr_tpu.models import resnet as jresnet
from whmr_tpu.models import vit as jvit
from whmr_tpu_torch.config import ViTConfig as TViTConfig
from whmr_tpu_torch.data.assets import synthetic_smpl_assets as t_assets
from whmr_tpu_torch.models import heads as theads
from whmr_tpu_torch.models import layers as tlayers
from whmr_tpu_torch.models import maf as tmaf
from whmr_tpu_torch.models import regressor as treg
from whmr_tpu_torch.models import resnet as tresnet
from whmr_tpu_torch.models import vit as tvit

from torch_port_util import release_memory, load_from_flax, n, random_batch_stats, t  # noqa: F401 (autouse fixture)

ATOL = 1e-4


def nchw(x):
    return t(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("impl", ["einsum", "pallas"])
def test_vit_backbone(impl):
    kw = dict(img_size=(64, 48), embed_dim=64, depth=2, num_heads=2, drop_path_rate=0.0, attn_impl=impl)
    x = np.random.RandomState(0).randn(2, 64, 48, 3).astype(np.float32)
    model = jvit.ViTBackbone(JViTConfig(**kw))
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = model.apply(variables, jnp.asarray(x))
    port = load_from_flax(tvit.ViTBackbone(TViTConfig(**kw)), variables, "feature_extractor",
                          "feature_extractor.backbone.")
    with torch.no_grad():
        got = port(nchw(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(n(got), n(want), atol=ATOL)


def _saved_bytes(fn):
    """fn()'s result and the bytes autograd saved for its backward outside
    any checkpointed region."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, total[0]


def test_vit_remat_is_bit_for_bit_and_saves_less():
    """vit.remat in training with drop path on: the same outputs, gradients
    and generator stream as the plain blocks, bit for bit, with fewer bytes
    saved for the backward (each block's drop-path masks are drawn before
    its checkpointed call and reused by the recompute)."""
    kw = dict(img_size=(64, 48), embed_dim=64, depth=3, num_heads=2, drop_path_rate=0.5)
    torch.manual_seed(0)
    model = tvit.ViTBackbone(TViTConfig(**kw)).train()
    x = torch.randn(4, 3, 64, 48)
    runs = {}
    for remat in (False, True):
        model.remat = remat
        model.zero_grad()
        xi = x.clone().requires_grad_(True)
        g = torch.Generator().manual_seed(3)
        out, saved = _saved_bytes(lambda: model(xi, g))
        out.square().sum().backward()
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        runs[remat] = (out.detach(), xi.grad, grads, saved, g.get_state())
    (o0, gx0, g0, s0, st0), (o1, gx1, g1, s1, st1) = runs[False], runs[True]
    assert torch.equal(o0, o1) and torch.equal(gx0, gx1)
    assert g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0)
    assert torch.equal(st0, st1)
    with torch.no_grad():  # the masks dropped some branches: the draws were exercised
        assert not torch.equal(o0, model.eval()(x))
    assert s1 < s0 / 2, (s1, s0)


def test_vit_remat_matches_whmr_tpu():
    """The port's remat forward (autograd recording, so the blocks run
    checkpointed) and its input gradient against whmr_tpu's
    ViTBackbone(remat=True) at the same weights."""
    kw = dict(img_size=(64, 48), embed_dim=64, depth=2, num_heads=2, drop_path_rate=0.0, remat=True)
    x = np.random.RandomState(2).randn(2, 64, 48, 3).astype(np.float32)
    model = jvit.ViTBackbone(JViTConfig(**kw))
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = model.apply(variables, jnp.asarray(x))
    # a random projection of the features (a sum of their squares is
    # nearly constant after the last LayerNorm, and its gradient noise)
    r = np.random.RandomState(3).randn(*want.shape).astype(np.float32)
    want_gx = jax.grad(lambda a: jnp.sum(model.apply(variables, a) * r))(jnp.asarray(x))
    port = load_from_flax(tvit.ViTBackbone(TViTConfig(**kw)), variables, "feature_extractor",
                          "feature_extractor.backbone.")
    assert port.remat
    xt = nchw(x).requires_grad_(True)
    got = port(xt).permute(0, 2, 3, 1)
    (got * t(r)).sum().backward()
    np.testing.assert_allclose(n(got), n(want), atol=ATOL)
    gx = xt.grad.permute(0, 2, 3, 1)
    np.testing.assert_allclose(n(gx), n(want_gx), atol=ATOL * float(np.abs(n(want_gx)).max()))


def test_camcalib_net():
    x = np.random.RandomState(1).randn(1, 64, 64, 3).astype(np.float32)
    model = jresnet.CamCalibNet()
    variables = random_batch_stats(jax.jit(model.init)(jax.random.PRNGKey(1), jnp.asarray(x)))
    (jl, jpooled) = jax.jit(model.apply)(variables, jnp.asarray(x))
    port = load_from_flax(tresnet.CamCalibNet(), variables, "cam_model", "cam_model.")
    with torch.no_grad():
        tl, tpooled = port(nchw(x))
    np.testing.assert_allclose(n(tpooled), n(jpooled), atol=ATOL, rtol=1e-4)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(n(a), n(b), atol=ATOL, rtol=1e-4)


def test_deconv_block():
    x = np.random.RandomState(2).randn(2, 6, 5, 16).astype(np.float32)
    model = jlayers.DeconvBlock(8)
    variables = random_batch_stats(model.init(jax.random.PRNGKey(2), jnp.asarray(x)), seed=2)
    want = model.apply(variables, jnp.asarray(x))
    port = load_from_flax(tlayers.DeconvBlock(16, 8), variables, "deconv0", "deconv_layers.")
    with torch.no_grad():
        got = port(nchw(x)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(n(got), n(want), atol=ATOL)


def test_tz_head():
    feat = np.random.RandomState(3).randn(2, 128, 96, 32).astype(np.float32)
    model = jheads.TzHead(first_stride=3, hidden=12)
    variables = random_batch_stats(model.init(jax.random.PRNGKey(3), jnp.asarray(feat)), seed=3)
    want = model.apply(variables, jnp.asarray(feat))
    port = load_from_flax(theads.TzHead(32, theads.tz_tokens(128, 96, 3)), variables, "tz_head", "")
    with torch.no_grad():
        got = port(nchw(feat))
    np.testing.assert_allclose(n(got), n(want), atol=ATOL)


def test_iuv_head():
    feat = np.random.RandomState(4).randn(2, 16, 12, 32).astype(np.float32)
    model = jheads.IUVHead()
    variables = model.init(jax.random.PRNGKey(4), jnp.asarray(feat))
    want = model.apply(variables, jnp.asarray(feat))
    port = load_from_flax(theads.IUVHead(32), variables, "dp_head", "dp_head.")
    with torch.no_grad():
        got = port(nchw(feat))
    for k in want:
        np.testing.assert_allclose(n(got[k]), n(want[k]), atol=ATOL, err_msg=k)


def test_maf_extractor():
    rng = np.random.RandomState(5)
    feat = rng.randn(2, 32, 24, 32).astype(np.float32)
    pts3d = (rng.randn(2, 67, 3) * 0.3).astype(np.float32)
    cam = np.array([[0.9, 0.05, -0.02], [1.1, -0.1, 0.03]], np.float32)
    model = jmaf.MAFExtractor(mlp_dim=(32, 16, 8, 4))
    variables = model.init(jax.random.PRNGKey(5), jnp.asarray(feat), jnp.asarray(pts3d), jnp.asarray(cam))
    want = model.apply(variables, jnp.asarray(feat), jnp.asarray(pts3d), jnp.asarray(cam))
    port = load_from_flax(tmaf.MAFExtractor((32, 16, 8, 4)), variables, "maf0", "maf_extractor.0.")
    with torch.no_grad():
        got = port(t(feat), t(pts3d), t(cam))
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), n(b), atol=ATOL)


def _cam_state(rng, b):
    return dict(
        bbox_info=(rng.randn(b, 5) * 0.1).astype(np.float32),
        center=rng.uniform(200, 900, (b, 2)).astype(np.float32),
        scale=rng.uniform(0.8, 2.4, b).astype(np.float32),
        bbox_height=rng.uniform(150, 500, b).astype(np.float32),
        orig_shape=np.tile(np.array([[720.0, 1280.0]], np.float32), (b, 1)),
        tz=rng.uniform(2, 9, b).astype(np.float32),
    )


def test_regressor():
    rng = np.random.RandomState(6)
    b, feat_dim = 3, 268
    feat = rng.randn(b, feat_dim).astype(np.float32)
    init_pose = (np.tile(np.eye(3).reshape(1, 9), (b, 24)) + rng.randn(b, 216) * 0.1).astype(np.float32)
    init_shape = (rng.randn(b, 10) * 0.3).astype(np.float32)
    init_cam = np.array([[0.9, 0.05, -0.02]] * b, np.float32)
    state = _cam_state(rng, b)
    jc = jreg.body_consts_from_assets(j_assets(0))
    tc = treg.body_consts_from_assets(t_assets(0))
    model = jreg.Regressor()
    jargs = (jc, jnp.asarray(feat), jreg.CamState(**{k: jnp.asarray(v) for k, v in state.items()}),
             jnp.asarray(init_pose), jnp.asarray(init_shape), jnp.asarray(init_cam))
    variables = model.init(jax.random.PRNGKey(6), *jargs)
    # Weights x3 (decoders past their 0.01-gain init), so the step moves the pose.
    variables = jax.tree.map(lambda a: a * 3.0, variables)
    want, want_x = model.apply(variables, *jargs)
    port = load_from_flax(treg.Regressor(feat_dim), variables, "regressor0", "regressor.0.")
    with torch.no_grad():
        got, got_x = port(tc, t(feat), treg.CamState(**{k: t(v) for k, v in state.items()}),
                          t(init_pose), t(init_shape), t(init_cam))
    np.testing.assert_allclose(n(got_x), n(want_x), atol=ATOL)
    assert got.keys() == want.keys()
    for k in want:
        tol = ATOL * 10 if k == "focal_length" else ATOL  # O(1e3) values
        np.testing.assert_allclose(n(got[k]), n(want[k]), atol=tol, rtol=1e-5, err_msg=k)


def test_global_orient_regressor():
    rng = np.random.RandomState(7)
    b, feat_dim = 3, 273
    body_feat = rng.randn(b, feat_dim).astype(np.float32)
    cam_rotmat = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    cam_rotmat[:, 1:, 1:] = [[np.cos(0.2), -np.sin(0.2)], [np.sin(0.2), np.cos(0.2)]]
    local = (np.eye(3) + rng.randn(b, 3, 3) * 0.05).astype(np.float32)
    model = jreg.GlobalOrientRegressor()
    jargs = tuple(map(jnp.asarray, (body_feat, cam_rotmat, local)))
    variables = jax.tree.map(lambda a: a * 3.0, model.init(jax.random.PRNGKey(7), *jargs))
    want = model.apply(variables, *jargs)
    port = load_from_flax(treg.GlobalOrientRegressor(feat_dim), variables, "global_orient", "global_orient.")
    with torch.no_grad():
        got = port(t(body_feat), t(cam_rotmat), t(local))
    assert got.shape == (b, 1, 3, 3)
    np.testing.assert_allclose(n(got), n(want), atol=ATOL)
