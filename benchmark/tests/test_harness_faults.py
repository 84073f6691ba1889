"""A run with the timed path broken underneath reads `correct` false; a
sound one reads it true. Each cell's own limits, at the tiny widths on the
CPU in float32, past the harness's look for a card."""

from __future__ import annotations

import pytest
import torch


def test_sound_runs_are_correct(tiny_run):
    for cell in ("vitb-infer-b192", "vitb-train-b192"):
        assert tiny_run(cell)["correct"], cell


def _swap_crops(forward):
    """Answers altered where they are produced: each crop's vertices are
    its neighbour's."""
    def fwd(model, consts, b):
        out = forward(model, consts, b)
        v = out["vis"]["local_smpl_vertices"]
        v.copy_(v.roll(1, dims=0))
        return out
    return fwd


def _half_batch_forward(forward):
    """Half of the batch left out: its rows are the other half's answers."""
    def fwd(model, consts, b):
        half = b["x"].shape[0] // 2
        out = forward(model, consts, {k: v[:half] for k, v in b.items()})

        def tile(t):
            if isinstance(t, dict):
                return {k: tile(v) for k, v in t.items()}
            if isinstance(t, list):
                return [tile(v) for v in t]
            if isinstance(t, torch.Tensor) and t.dim() and t.shape[0] == half:
                return torch.cat([t, t])
            return t
        return tile(out)
    return fwd


def _one_wrong_crop(forward):
    """One answer altered: the last crop of each batch gets its neighbour's vertices."""
    def fwd(model, consts, b):
        out = forward(model, consts, b)
        v = out["vis"]["local_smpl_vertices"]
        v[-1].copy_(v[-2])
        return out
    return fwd


def test_infer_faults_fail(tiny_run):
    import run

    forward = run.load_module(run.HERE / "traffic" / "infer.py", "driver_infer").forward
    for fault in (_swap_crops, _half_batch_forward):
        line = tiny_run("vitb-infer-b192", hooks={"forward": fault(forward)})
        assert not line["correct"], fault.__name__
        assert line["checks"]["out_gap"]["value"] > line["checks"]["out_gap"]["limit"]


def test_infer_few_wrong_crops_fail(tiny_run):
    """A wrong crop in a batch fails by the share of crops over their limit,
    whatever the batch's quantile reads."""
    import run

    forward = run.load_module(run.HERE / "traffic" / "infer.py", "driver_infer").forward
    line = tiny_run("vitb-infer-b192", hooks={"forward": _one_wrong_crop(forward)})
    assert not line["correct"]
    assert line["checks"]["crops_over_pct"]["value"] > line["checks"]["crops_over_pct"]["limit"]


def _unchanged_state_step(cfg, model, state, consts, batch, generator=None, render_consts=None):
    """A step that returns its state unchanged (the gradients are taken, no update applied)."""
    from whmr_tpu_torch.training import train_step as ts

    _, losses = ts._microbatch_grads(cfg, model, state, consts, batch, generator, render_consts)
    return state, losses


def _half_batch_step(rows):
    """Half of the batch left out, the loss a mean over the rest."""
    def step(cfg, model, state, consts, batch, generator=None, render_consts=None):
        from whmr_tpu_torch.training import train_step as ts

        n = next(iter(batch.values())).shape[0]
        sl = slice(0, n // 2) if rows == "first" else slice(0, None, 2)
        return ts.train_step(cfg, model, state, consts, {k: v[sl] for k, v in batch.items()}, generator,
                             render_consts)
    return step


@pytest.mark.parametrize("rows", ["first", "even"])
def test_train_half_batch_fails(tiny_run, rows):
    """The rows' strata make a mean over half of them another loss."""
    line = tiny_run("vitb-train-b192", hooks={"train_step": _half_batch_step(rows)})
    assert not line["correct"]
    assert line["checks"]["loss_gap"]["value"] > line["checks"]["loss_gap"]["limit"]


def test_train_unchanged_state_fails(tiny_run):
    line = tiny_run("vitb-train-b192", hooks={"train_step": _unchanged_state_step})
    assert not line["correct"]
    assert line["checks"]["update_gap"]["value"] >= 0.999
    assert line["checks"]["head_grad_err"]["value"] >= 0.999
