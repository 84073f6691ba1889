"""The plain reference agrees with the port's plain paths at the tiny widths
on the CPU, in float32: the eval forward's outputs, and the training
step's losses, first gradients and changes. The training numbers carry the
GT render's sensitivity: on the synthetic body, overlapping sheets of the
posed mesh lie at nearly one depth, so rounding in the GT mesh moves some
pixels' winning face (the port and the reference compute the GT SMPL in
another order)."""

from __future__ import annotations


def test_eval_forward_agrees(tiny_run):
    line = tiny_run("vitb-infer-b192", seed=4242)
    assert line["checks"]["out_gap"]["value"] < 1e-4


def test_train_steps_agree(tiny_run):
    c = tiny_run("vitb-train-b192", seed=4242)["checks"]
    assert c["head_grad_err"]["value"] < 2e-3  # the GT render flips a few pixels
    assert c["update_gap"]["value"] < 0.1
    assert c["stray_leaves"]["value"] == 0
