"""The plain reference of one W-HMR training step, in float32.

Frozen copies of the published step's parts, in plain PyTorch: the GT
targets (GT SMPL, the mesh downsampling, the least-squares GT camera,
core/trainer.py:414-464), the GT IUV render on the plain z-buffer
rasterizer with the synthetic DensePose-style chart, the multi-term loss
(core/trainer.py:203-320, 466-609) and Adam (optax's form: bias
corrections at the incremented count, eps outside the square root). The
gradients come from autograd through `reference.model.RefWHMR` in train
mode. Nothing here imports the port.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from reference.smpl import SMPLArrays, batch_rodrigues, smpl49

FOCAL_LENGTH = 1000.0
_BIG = 1e9
# DensePose 25-part -> 15-annotation grouping (iuvmap.py:74-75).
INDEX2MASK = [[0], [1, 2], [3], [4], [5], [6], [7, 9], [8, 10], [11, 13], [12, 14],
              [15, 17], [16, 18], [19, 21], [20, 22], [23, 24]]


class Chart(NamedTuple):
    vertex_iuv: torch.Tensor  # (Vr, 3) part/24, U, V per render vertex
    faces: np.ndarray         # (F, 3) over render vertices, each face of one part
    vertex_map: torch.Tensor  # (Vr,) render vertex -> SMPL vertex


def synthetic_chart(assets: Dict[str, np.ndarray], device) -> Chart:
    """The synthetic chart: part = the vertex's strongest joint (1..24), UV
    from a planar projection of the template; one render vertex per used
    (vertex, part) pair, so that every face carries one part (each face
    takes its majority corner's part)."""
    part = assets["lbs_weights"].argmax(axis=1) + 1
    vt = assets["v_template"]
    lo, hi = vt.min(axis=0), vt.max(axis=0)
    uv = ((vt - lo) / np.maximum(hi - lo, 1e-6))[:, :2].astype(np.float32)
    faces = np.asarray(assets["faces"], np.int64)
    fp = part[faces]
    face_part = np.where(fp[:, 1] == fp[:, 2], fp[:, 1], fp[:, 0])
    pairs = np.stack([faces.reshape(-1), np.repeat(face_part, 3)], axis=1)
    uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
    vmap = uniq[:, 0].astype(np.int64)
    iuv = np.concatenate([uniq[:, 1:2].astype(np.float32) / 24.0, uv[vmap]], axis=1).astype(np.float32)
    return Chart(torch.as_tensor(iuv, device=device), inv.reshape(-1, 3).astype(np.int64),
                 torch.as_tensor(vmap, device=device))


def estimate_translation(joints_3d, joints_2d, focal_length, img_size):
    """Weighted least-squares camera translation (geometry.py:344-408) over
    the 24 GT joints, one (3, 3) normal-equation solve a sample."""
    joints_3d, joints_2d = joints_3d[:, 25:], joints_2d[:, 25:]
    w = torch.sqrt(joints_2d[..., 2].clamp(min=0.0))
    u = joints_2d[..., 0] - img_size[0] / 2.0
    v = joints_2d[..., 1] - img_size[1] / 2.0
    x, y, z = joints_3d[..., 0], joints_3d[..., 1], joints_3d[..., 2]
    f = float(focal_length)
    zero = torch.zeros_like(u)
    rows = torch.stack([torch.stack([zero + f, zero, -u], -1), torch.stack([zero, zero + f, -v], -1)], 2)
    rhs = torch.stack([u * z - f * x, v * z - f * y], 2)
    a = (rows * w[..., None, None]).reshape(u.shape[0], -1, 3)
    r = (rhs * w[..., None]).reshape(u.shape[0], -1)
    sol, info = torch.linalg.solve_ex(a.transpose(1, 2) @ a, (a.transpose(1, 2) @ r[..., None]))
    return torch.where(info[:, None] == 0, sol[..., 0], float("nan"))


def gt_camera(cam_t, tz_range=(1.0, 100.0), txy_max=20.0):
    """Translation -> weak GT camera [2f/(256 tz), tx, ty], clamped: a
    degenerate tz goes to the far bound."""
    lo, hi = tz_range
    tz = torch.nan_to_num(cam_t[:, 2], nan=hi, posinf=hi, neginf=hi)
    tz = torch.where(tz < lo, hi, tz.clamp(max=hi))
    txy = torch.nan_to_num(cam_t[:, :2], nan=0.0, posinf=txy_max, neginf=-txy_max).clamp(-txy_max, txy_max)
    s = torch.tensor(2.0 * FOCAL_LENGTH / 256.0, dtype=tz.dtype) / tz
    return torch.stack([s, txy[:, 0], txy[:, 1]], dim=-1)


def project_to_pixels(verts, camera, resolution):
    h, w = resolution
    s, tx, ty = camera[:, 0:1], camera[:, 1:2], camera[:, 2:3]
    tz = torch.tensor(2 * FOCAL_LENGTH, dtype=s.dtype) / (256.0 * s)
    z = verts[..., 2] + tz
    xn = (verts[..., 0] + tx) / z * FOCAL_LENGTH / 128.0
    yn = (verts[..., 1] + ty) / z * FOCAL_LENGTH / 128.0
    return torch.stack([(xn + 1.0) * 0.5 * w, (yn + 1.0) * 0.5 * h], dim=-1), z


def rasterize(verts_pix, verts_z, attrs, faces, resolution, origin, chunk=64):
    """Z-buffer rasterization, face chunk by face chunk: each pixel centre
    takes the nearest face whose barycentrics are all >= 0 (the first such
    face on a tie) and its barycentric blend of the attributes."""
    h, w = resolution
    b, _, c = attrs.shape
    dev = attrs.device
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5 + origin[0]).repeat(h)
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5 + origin[1]).repeat_interleave(w)
    px = torch.stack([xs, ys, torch.ones_like(xs)], -1)
    best_z = torch.full((b, h * w), _BIG, device=dev)
    best_a = torch.zeros((b, h * w, c), device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    fidx = torch.as_tensor(faces, device=dev)
    for f0 in range(0, fidx.shape[0], chunk):
        fc = fidx[f0:f0 + chunk]
        tri, tz, ta = verts_pix[:, fc], verts_z[:, fc], attrs[:, fc]
        p0, p1, p2 = tri[:, :, 0], tri[:, :, 1], tri[:, :, 2]
        area = (p1[..., 0] - p0[..., 0]) * (p2[..., 1] - p0[..., 1]) - (p1[..., 1] - p0[..., 1]) * (p2[..., 0] - p0[..., 0])
        valid = area.abs() > 1e-9
        inv = torch.where(valid, 1.0 / area, 0.0)

        def edge(pa, pb):
            return torch.stack([pa[..., 1] - pb[..., 1], pb[..., 0] - pa[..., 0],
                                pa[..., 0] * pb[..., 1] - pa[..., 1] * pb[..., 0]], -1)

        coefs = torch.stack([edge(p1, p2), edge(p2, p0), edge(p0, p1)], 2) * inv[..., None, None]
        bary = torch.einsum("pk,bcjk->bpcj", px, coefs)
        inside = (bary >= 0).all(-1) & valid[:, None, :]
        zpx = torch.where(inside, torch.einsum("bpcj,bcj->bpc", bary, tz), _BIG)
        arg = zpx.argmin(dim=2)
        cz = zpx.gather(2, arg[..., None])[..., 0]
        take = cz < best_z
        wb = bary.gather(2, arg[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]
        wa = torch.einsum("bpj,bpjc->bpc", wb, ta[rows, arg])
        best_z = torch.where(take, cz, best_z)
        best_a = torch.where(take[..., None], wa, best_a)
    mask = best_z < _BIG * 0.5
    return (best_a * mask[..., None]).reshape(b, h, w, c)


def iuv_maps(iuv: torch.Tensor) -> Dict[str, torch.Tensor]:
    """IUV image -> one-hot part index (25), annotation (15) and per-part U, V."""
    idx = torch.round(iuv[..., 0] * 24.0)
    onehot = (idx[..., None] == torch.arange(25, device=iuv.device, dtype=idx.dtype)).float()
    ann = torch.zeros(25, 15, device=iuv.device)
    for a, parts in enumerate(INDEX2MASK):
        ann[parts, a] = 1.0
    return {"u": onehot * iuv[..., 1:2], "v": onehot * iuv[..., 2:3], "index": onehot, "ann": onehot @ ann}


@torch.no_grad()
def gt_targets(smpl: SMPLArrays, chart: Chart, batch, heatmap=(128, 128)):
    """(gt vertices, sub, temp, IUV maps) of a batch: the GT mesh rendered
    in the ViT crop's 128x96 window (columns 16:112 of the 128x128 map)."""
    rot = batch_rodrigues(batch["pose"].reshape(-1, 3)).reshape(-1, 24, 3, 3)
    verts, joints, _ = smpl49(smpl, batch["betas"], rot)
    sub = torch.matmul(smpl.dmap0, verts)
    temp = torch.matmul(smpl.dmap1, sub)
    kp = batch["keypoints"]
    kp_pix = torch.cat([0.5 * 256.0 * (kp[..., :2] + 1.0), kp[..., 2:]], dim=-1)
    cam = gt_camera(estimate_translation(joints, kp_pix, FOCAL_LENGTH, (256.0, 256.0)))
    vp, vz = project_to_pixels(verts[:, chart.vertex_map], cam, heatmap)
    attrs = chart.vertex_iuv[None].expand(verts.shape[0], -1, -1)
    margin = heatmap[1] // 8
    iuv = rasterize(vp, vz, attrs, chart.faces, (heatmap[0], heatmap[1] - 2 * margin), (float(margin), 0.0))
    iuv = iuv * batch["has_smpl"][:, None, None, None]
    return verts, sub, temp, iuv_maps(iuv)


def _masked_mean(err, mask):
    per = err.reshape(err.shape[0], -1).mean(dim=1)
    total = mask.sum()
    return (per * mask).sum() / total.clamp(min=1.0) * total.clamp(max=1.0)


def huber(pred, target):
    a = (pred - target).abs()
    q = a.clamp(max=1.0)
    return 0.5 * q * q + (a - q)


def whmr_loss(w: Dict[str, float], preds, batch, gt_verts, gt_sub, gt_temp, uvia) -> torch.Tensor:
    """The total loss (trainer.py:466-609) for weights `w` by the port's
    loss names, keypoint 2D terms off (kp_2d_w = 0), no depth or focal
    supervision."""
    has_smpl, has_3d = batch["has_smpl"], batch["has_pose_3d"]
    gt_rot = batch_rodrigues(batch["pose"].reshape(-1, 3)).reshape(-1, 24, 3, 3)
    terms: List[torch.Tensor] = []
    smpl_out = preds["smpl_out"]
    for i in range(1, len(smpl_out)):
        out = smpl_out[i]
        terms.append(_masked_mean((out["rotmat"] - gt_rot) ** 2, has_smpl) * w["pose_w"])
        terms.append(_masked_mean((out["pred_shape"] - batch["betas"]) ** 2, has_smpl) * w["shape_w"])
        pred = out["kp_3d"][:, 25:]
        gt, conf = batch["pose_3d"][..., :3], batch["pose_3d"][..., 3:4]
        err = conf * (pred - (pred[:, 2:3] + pred[:, 3:4]) / 2 - (gt - (gt[:, 2:3] + gt[:, 3:4]) / 2)) ** 2
        terms.append(_masked_mean(err, has_3d) * w["kp_3d_w"])
        if w["vert_w"] > 0 and i > 2:
            for name, gtv in (("verts", gt_verts), ("sub_verts", gt_sub), ("temp_verts", gt_temp)):
                terms.append(_masked_mean((out[name] - gtv).abs(), has_smpl) * w["vert_w"])
        terms.append((torch.exp(-out["pred_cam"][:, 0] * 10) ** 2).mean())
    dp = preds["dp_out"]
    b = has_smpl.shape[0]
    total = has_smpl.sum()

    def ce(logits, onehot):
        per = (torch.logsumexp(logits, -1) - (logits * onehot).sum(-1)).reshape(b, -1).mean(1)
        return (per * has_smpl).sum() / total.clamp(min=1.0) * total.clamp(max=1.0)

    fg = (uvia["index"] > 0).float() * has_smpl[:, None, None, None]
    prw = w["point_regression_weights"]
    terms.append((huber(dp["predict_u"], uvia["u"]) * fg).sum() / b * prw)
    terms.append((huber(dp["predict_v"], uvia["v"]) * fg).sum() / b * prw)
    terms.append(ce(dp["predict_uv_index"], uvia["index"]) * w["index_weights"])
    terms.append(ce(dp["predict_ann_index"], uvia["ann"]) * w["part_weights"])
    return sum(terms)


class Adam:
    """Adam as optax computes it: mu = 0.9 mu + 0.1 g, nu = 0.999 nu + 0.001 g^2,
    p -= lr * (mu / (1 - 0.9^t)) / (sqrt(nu / (1 - 0.999^t)) + 1e-8)."""

    def __init__(self, params: List[torch.Tensor], lr: float):
        self.params, self.lr, self.t = params, lr, 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]):
        self.t += 1
        bc1 = float(np.float32(1.0) - np.float32(0.9) ** np.float32(self.t))
        bc2 = float(np.float32(1.0) - np.float32(0.999) ** np.float32(self.t))
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(0.9).add_(0.1 * g)
            v.mul_(0.999).add_(0.001 * g * g)
            p.add_(-self.lr * (m / bc1) / ((v / bc2).sqrt() + 1e-8))


def reference_steps(model, smpl: SMPLArrays, chart: Chart, batches, loss_w: Dict[str, float], lr: float,
                    generator: torch.Generator, names: List[str]) -> Tuple[List[float], List[torch.Tensor]]:
    """Steps `model` (train mode) over `batches` with Adam. Returns the
    losses and the first step's gradient of each leaf of `names`."""
    model.train()
    params = dict(model.named_parameters())
    leaves = [params[n] for n in names]
    opt = Adam(leaves, lr)
    losses, g1 = [], None
    for i, batch in enumerate(batches):
        gt_v, gt_s, gt_t, uvia = gt_targets(smpl, chart, batch)
        for p in leaves:
            p.grad = None
        preds = model(batch["img"], batch["center"], batch["scale"], batch["bbox_height"], batch["orig_shape"],
                      batch["bbox_info"], torch.eye(3, device=batch["img"].device).expand(batch["img"].shape[0], 3, 3),
                      generator)
        loss = whmr_loss(loss_w, preds, batch, gt_v, gt_s, gt_t, uvia)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
        if i == 0:
            g1 = [g.detach().clone() for g in grads]
        opt.step(grads)
        losses.append(float(loss.detach()))
    return losses, g1
