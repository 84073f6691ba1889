"""Benchmark evaluation: MPJPE / PA-MPJPE / PVE over labelled batches.

Counterpart of `whmr_tpu/inference/evaluate.py` (reference
`evaluate/eval.py:65-361` `run_evaluation` and the in-loop validation,
core/trainer.py:753-907). The whole metric pipeline (GT SMPL forward, H36M
joint regression, pelvis centering, batched Procrustes alignment) runs on
the batch's device; the per-batch metric sums stay there until a log
boundary or the end, so the host reads them back once, not once a batch.

The port's model holds its own weights, so where whmr_tpu passes
`variables` to the eval step, the port passes the model. The data-parallel
`mesh=`, the HMR baseline (`regressor="hmr"`) and `forward_override` (an
exported bundle's graph) are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from whmr_tpu_torch.config import WHMRConfig
from whmr_tpu_torch.data.assets import H36M_TO_J14, H36M_TO_J17
from whmr_tpu_torch.models.regressor import BodyConsts
from whmr_tpu_torch.models.smpl import select_h36m_joints, smpl_forward, vertices2joints
from whmr_tpu_torch.models.whmr import WHMR
from whmr_tpu_torch.ops.procrustes import batch_compute_similarity_transform
from whmr_tpu_torch.ops.rotation import batch_rodrigues


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


def _not_ported(regressor, mesh, forward_override):
    if mesh is not None:
        raise NotImplementedError("data-parallel evaluation (mesh=) is not ported yet (slice 5)")
    if regressor != "pymaf_net":
        raise NotImplementedError(f"regressor={regressor!r} is not ported yet (slice 6)")
    if forward_override is not None:
        raise NotImplementedError("forward_override (exported bundles) is not ported yet (slice 4)")


def make_eval_step(
    cfg: WHMRConfig,
    model: WHMR,
    gendered_smpl=None,
    joint_mapper: str = "j14",
    save_arrays: bool = False,
    regressor: str = "pymaf_net",
    mesh=None,
    forward_override=None,
):
    """Eval step: (consts, batch) -> ((sum_mpjpe, sum_pa, sum_pve, n), extras),
    the sums as device scalars. `model` must be in eval mode.

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
    Procrustes-aligned pred, pose/betas/cam.
    """
    _not_ported(regressor, mesh, forward_override)
    mapper = H36M_TO_J17 if joint_mapper == "j17" else H36M_TO_J14

    @torch.no_grad()
    def step(consts: BodyConsts, batch: Dict[str, torch.Tensor]):
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
        pred_verts = preds["global_output"]["global_verts"].float()
        last_params = preds["smpl_out"][-1]
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
    model: WHMR,
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
    result-file arrays.
    """
    step = make_eval_step(
        cfg, model, gendered_smpl=gendered_smpl, joint_mapper=joint_mapper,
        save_arrays=result_file is not None, regressor=regressor, mesh=mesh,
        forward_override=forward_override,
    )

    def place(batch):
        n = batch[next(iter(batch))].shape[0]
        if fixed_batch is None:
            return batch, n
        if n > fixed_batch:
            raise ValueError(
                f"batch of {n} exceeds the fixed eval shape {fixed_batch}; feed "
                "batches of at most that size"
            )
        pad = fixed_batch - n
        if pad:
            batch = {
                k: torch.cat([v, v.new_zeros((pad, *v.shape[1:]))]) for k, v in batch.items()
            }
            # THE masking mechanism: padded rows carry valid=0 so they
            # contribute nothing to any metric sum. (Zero-fill above already
            # implies it, but masking must not silently depend on the
            # padding fill value.)
            batch["valid"][n:] = 0
        return batch, n

    metrics = EvalMetrics()
    collected: Dict[str, list] = {}
    # Per-batch sums stay on the device until a log boundary (or the end):
    # reading them back per batch would wait on every batch's compute.
    pending: list = []

    def flush():
        if pending:
            for s_mpjpe, s_pa, s_pve, n in torch.stack(pending).cpu().tolist():
                metrics.update(s_mpjpe, s_pa, s_pve, n)
        pending.clear()

    was_training = model.training
    model.eval()
    try:
        for i, batch in enumerate(batches):
            batch, n = place(batch)
            sums, extras = step(consts, batch)
            pending.append(sums)
            if extras is not None:
                # padded rows are trimmed from the dump
                for k, v in extras.items():
                    collected.setdefault(k, []).append(v[:n].float().cpu().numpy())
            if log_every and (i + 1) % log_every == 0:
                flush()
                r = metrics.result()
                print(
                    f"[eval] {metrics.count} samples  MPJPE {r['mpjpe']:.2f}  "
                    f"PA-MPJPE {r['pa_mpjpe']:.2f}  PVE {r['pve']:.2f}"
                )
        flush()
    finally:
        model.train(was_training)
    if result_file and collected:
        np.savez(result_file, **{k: np.concatenate(v) for k, v in collected.items()})
        print(f"[eval] per-sample results saved to {result_file}")
    return metrics.result()
