"""Benchmark evaluation: MPJPE / PA-MPJPE / PVE over labelled batches.

Counterpart of `whmr_tpu/inference/evaluate.py` (reference
`evaluate/eval.py:65-361` `run_evaluation` and the in-loop validation,
core/trainer.py:753-907). The whole metric pipeline (GT SMPL forward, H36M
joint regression, pelvis centering, batched Procrustes alignment) runs on
the batch's device; the per-batch metric sums stay there until a log
boundary or the end, so the host reads them back once, not once a batch.

The port's model holds its own weights, so where whmr_tpu passes
`variables` to the eval step, the port passes the model (None when a
`forward_override`, an exported bundle's program, predicts instead). With
`regressor="hmr"` the model is the HMR baseline, scored on its
camera-frame mesh (reference eval.py:174-176).

Data-parallel evaluation (`mesh=`): every rank is handed the same batches
(as whmr_tpu's device_put of a host batch) and scores its rows of each,
the batch zero-padded with valid=0 rows to a multiple of the data axis.
The per-batch sums are summed over the data group at each read-back, so
every rank returns the one-process metrics; rank 0 gathers the per-sample
arrays in dataset order and alone writes `result_file`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from whmr_tpu_torch.config import WHMRConfig
from whmr_tpu_torch.data.assets import H36M_TO_J14, H36M_TO_J17
from whmr_tpu_torch.models.hmr import HMR
from whmr_tpu_torch.models.regressor import BodyConsts
from whmr_tpu_torch.models.smpl import select_h36m_joints, smpl_forward, vertices2joints
from whmr_tpu_torch.models.whmr import WHMR
from whmr_tpu_torch.ops.procrustes import batch_compute_similarity_transform
from whmr_tpu_torch.parallel.mesh import axis_index, axis_size, data_group, is_main
from whmr_tpu_torch.ops.rotation import batch_rodrigues, rotmat_to_angle_axis


@dataclasses.dataclass
class EvalMetrics:
    mpjpe_sum: float = 0.0
    pa_mpjpe_sum: float = 0.0
    pve_sum: float = 0.0
    count: int = 0

    def update(self, mpjpe_b, pa_b, pve_b, n):
        self.mpjpe_sum += float(mpjpe_b)
        self.pa_mpjpe_sum += float(pa_b)
        self.pve_sum += float(pve_b)
        self.count += int(n)

    def result(self) -> Dict[str, float]:
        c = max(self.count, 1)
        return {
            # reported in mm, matching eval.py:322-331 prints (x1000)
            "mpjpe": self.mpjpe_sum / c * 1000.0,
            "pa_mpjpe": self.pa_mpjpe_sum / c * 1000.0,
            "pve": self.pve_sum / c * 1000.0,
            "count": self.count,
        }


def _check_model(model, regressor: str, forward_override) -> None:
    """regressor="hmr" scores an HMR model, "pymaf_net" a WHMR one."""
    if regressor not in ("pymaf_net", "hmr"):
        raise ValueError(f"regressor must be 'pymaf_net' or 'hmr', got {regressor!r}")
    if forward_override is None and isinstance(model, HMR) != (regressor == "hmr"):
        raise ValueError(f"regressor={regressor!r} does not score a {type(model).__name__} model")


def make_eval_step(
    cfg: WHMRConfig,
    model: Optional[WHMR],
    gendered_smpl=None,
    joint_mapper: str = "j14",
    save_arrays: bool = False,
    regressor: str = "pymaf_net",
    forward_override=None,
):
    """Eval step: (consts, batch) -> ((sum_mpjpe, sum_pa, sum_pve, n), extras),
    the sums as device scalars. `model` must be in eval mode.

    forward_override(consts, batch) -> (world verts, final-stage params
    {"pose", "pred_shape", "pred_cam"}): a pluggable prediction path (an
    exported eval-variant bundle's program, whmr-eval --bundle) in place of
    the live forward; `model` is then unused.

    Mirrors eval.py:155-228: model forward with the GT cam_rotmat;
    world-frame (global) vertices; H36M-regressed joints, pelvis-centered,
    sliced by `joint_mapper` ('j14' default, 'j17' for the mpi-inf-3dhp
    protocol, eval.py:150-151).

    GT vertices come from (in priority order): the batch's 'gt_vertices';
    gendered SMPL models selected per sample by batch 'gender' (0=male,
    1=female, else neutral — the 3DPW protocol, trainer.py:784-798) when
    `gendered_smpl={'male': SMPLParams, 'female': SMPLParams}` is given;
    else the neutral model.

    save_arrays=True also returns per-sample arrays for the result-file dump
    (eval.py:312-319): the 17 H36M pred joints, mapped/centered pred, gt and
    Procrustes-aligned pred, pose/betas/cam. The step scores the rows it
    is given: `run_evaluation(mesh=)` splits them over the data ranks.
    """
    _check_model(model, regressor, forward_override)
    mapper = H36M_TO_J17 if joint_mapper == "j17" else H36M_TO_J14

    @torch.no_grad()
    def step(consts: BodyConsts, batch: Dict[str, torch.Tensor]):
        if forward_override is not None:
            pred_verts, last_params = forward_override(consts, batch)
        elif regressor == "hmr":
            # HMR baseline (reference eval.py:174-176): the camera-frame mesh
            # straight from (rotmat, betas); the axis-angle pose for the
            # result file (eval.py:312-319).
            rotmat, betas, cam = (v.float() for v in model(consts, batch["img"], train=False))
            pred_verts = smpl_forward(consts.smpl, betas, rotmat).vertices
            pose_aa = rotmat_to_angle_axis(rotmat.reshape(-1, 3, 3)).reshape(-1, 72)
            last_params = {"pose": pose_aa, "pred_shape": betas, "pred_cam": cam}
        else:
            preds = model(
                consts,
                batch["img"],
                batch["center"],
                batch["scale"],
                batch["bbox_height"],
                batch["orig_shape"],
                batch["bbox_info"],
                train=False,
                cam_rotmat=batch.get("cam_rotmat"),
            )
            pred_verts = preds["global_output"]["global_verts"]
            last_params = preds["smpl_out"][-1]
        pred_verts = pred_verts.float()
        pred_j = select_h36m_joints(consts.j_regressor_h36m, pred_verts, mapper)

        # GT: either direct vertices (3dpw gendered) or pose/betas. The
        # world-frame protocol prefers global_pose when the labels carry it
        # (eval.py:157-163: predictions are world-frame global verts).
        if "gt_vertices" in batch:
            gt_verts = batch["gt_vertices"]
        else:
            gt_pose = batch.get("global_pose", batch["pose"])
            gt_rotmats = batch_rodrigues(gt_pose.reshape(-1, 3)).reshape(-1, 24, 3, 3)
            gt_verts = smpl_forward(consts.smpl, batch["betas"], gt_rotmats).vertices
            if gendered_smpl is not None and "gender" in batch:
                male = smpl_forward(gendered_smpl["male"], batch["betas"], gt_rotmats).vertices
                female = smpl_forward(gendered_smpl["female"], batch["betas"], gt_rotmats).vertices
                g = batch["gender"][:, None, None]
                gt_verts = torch.where(g == 0, male, torch.where(g == 1, female, gt_verts))
        gt_j = select_h36m_joints(consts.j_regressor_h36m, gt_verts, mapper)

        valid = batch["valid"].float()
        err = torch.sqrt(((pred_j - gt_j) ** 2).sum(dim=-1)).mean(dim=-1)
        aligned = batch_compute_similarity_transform(pred_j, gt_j)
        err_pa = torch.sqrt(((aligned - gt_j) ** 2).sum(dim=-1)).mean(dim=-1)
        # PVE is RAW per-vertex error — the reference protocol does not
        # pelvis-align vertices (eval.py:207-209, trainer.py:882; only the
        # JOINT metrics center on the pelvis).
        pve = torch.sqrt(((pred_verts - gt_verts) ** 2).sum(dim=-1)).mean(dim=-1)
        sums = torch.stack([(err * valid).sum(), (err_pa * valid).sum(), (pve * valid).sum(), valid.sum()])
        extras = None
        if save_arrays:
            extras = {
                "pred_joints": vertices2joints(consts.j_regressor_h36m, pred_verts),
                "pred": pred_j,
                "pred_pa": aligned,
                "gt": gt_j,
                "pose": last_params["pose"],
                "betas": last_params["pred_shape"],
                "camera": last_params["pred_cam"],
                "valid": valid,
            }
        return sums, extras

    return step


def run_evaluation(
    cfg: WHMRConfig,
    model: Optional[WHMR],
    consts: BodyConsts,
    batches: Iterable[Dict[str, torch.Tensor]],
    log_every: int = 10,
    gendered_smpl=None,
    joint_mapper: str = "j14",
    result_file: Optional[str] = None,
    regressor: str = "pymaf_net",
    mesh=None,
    forward_override=None,
    fixed_batch: Optional[int] = None,
) -> Dict[str, float]:
    """Drive the eval loop over an iterable of device-ready batches.

    The model runs in eval mode for the loop and goes back to its previous
    mode after it (validation inside training).
    result_file: path to dump per-sample prediction arrays as npz
    (reference eval.py:312-319 npz + mat dump).
    fixed_batch: pad every batch to exactly this size with zero rows of
    valid=0, which contribute nothing to the sums and are trimmed from the
    result-file arrays (an exported bundle's fixed batch).
    forward_override: see make_eval_step; `model` may then be None.
    mesh: data-parallel evaluation over the mesh's "data" axis (see the
    module's docstring); every rank of the data group must call it with
    the same batches.
    """
    step = make_eval_step(
        cfg, model, gendered_smpl=gendered_smpl, joint_mapper=joint_mapper,
        save_arrays=result_file is not None, regressor=regressor,
        forward_override=forward_override,
    )

    group = data_group(mesh)
    ranks, index = axis_size(mesh, "data"), axis_index(mesh, "data")

    def place(batch):
        n = batch[next(iter(batch))].shape[0]
        if fixed_batch is None and ranks == 1:
            return batch, n
        if fixed_batch is not None and n > fixed_batch:
            raise ValueError(
                f"batch of {n} exceeds the fixed eval shape {fixed_batch}; feed "
                "batches of at most that size"
            )
        size = n if fixed_batch is None else fixed_batch
        size += -size % ranks
        pad = size - n
        if pad:
            batch = {
                k: torch.cat([v, v.new_zeros((pad, *v.shape[1:]))]) for k, v in batch.items()
            }
            # THE masking mechanism: padded rows carry valid=0 so they
            # contribute nothing to any metric sum. (Zero-fill above already
            # implies it, but masking must not silently depend on the
            # padding fill value.)
            batch["valid"][n:] = 0
        if ranks > 1:
            rows = size // ranks
            batch = {k: v[index * rows:(index + 1) * rows] for k, v in batch.items()}
        return batch, n

    def gathered(v):
        """A per-sample array of the whole batch, in row order (rank 0
        keeps it)."""
        if ranks == 1:
            return v
        out = v.new_empty((v.shape[0] * ranks, *v.shape[1:]))
        dist.all_gather_into_tensor(out, v.contiguous(), group=group)
        return out

    metrics = EvalMetrics()
    collected: Dict[str, list] = {}
    # Per-batch sums stay on the device until a log boundary (or the end):
    # reading them back per batch would wait on every batch's compute.
    pending: list = []

    def flush():
        if pending:
            sums = torch.stack(pending)
            if group is not None:
                dist.all_reduce(sums, group=group)
            for s_mpjpe, s_pa, s_pve, n in sums.cpu().tolist():
                metrics.update(s_mpjpe, s_pa, s_pve, n)
        pending.clear()

    was_training = model is not None and model.training
    if model is not None:
        model.eval()
    try:
        for i, batch in enumerate(batches):
            batch, n = place(batch)
            sums, extras = step(consts, batch)
            pending.append(sums)
            if extras is not None:
                # padded rows are trimmed from the dump
                for k, v in extras.items():
                    v = gathered(v)
                    if is_main():
                        collected.setdefault(k, []).append(v[:n].float().cpu().numpy())
            if log_every and (i + 1) % log_every == 0:
                flush()
                r = metrics.result()
                if is_main():
                    print(
                    f"[eval] {metrics.count} samples  MPJPE {r['mpjpe']:.2f}  "
                    f"PA-MPJPE {r['pa_mpjpe']:.2f}  PVE {r['pve']:.2f}"
                )
        flush()
    finally:
        if model is not None:
            model.train(was_training)
    if result_file and collected:
        np.savez(result_file, **{k: np.concatenate(v) for k, v in collected.items()})
        print(f"[eval] per-sample results saved to {result_file}")
    return metrics.result()
