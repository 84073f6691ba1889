"""The port's CheckpointManager (whmr_tpu_torch/utils/checkpoint.py).

It keeps whmr_tpu's semantics (tests/test_checkpoint.py) in torch's format:
one directory per step, max_to_keep, atomic writes, async writes drained
before the next save or read, the duplicate-step no-op that still tracks
the best metric, the best/ copy (read from where it was moved aside if a
kill falls while it is overwritten), and restore_weights over both payload
kinds. Restored values are compared exactly: a checkpoint is a copy.
"""

import os

import numpy as np
import pytest
import torch

from whmr_tpu_torch.utils.checkpoint import CheckpointManager, _tree_mismatch

from torch_port_util import release_memory  # noqa: F401 (autouse fixture)


def payload(seed, step):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(64, 64, generator=g), "b": torch.randn(7, generator=g)},
        "batch_stats": {"m": torch.randn(8, generator=g)},
        "opt_state": {"count": step, "mu": {"w": torch.randn(64, 64, generator=g)}},
        "step": step,
        "epoch": 0,
        "batch_idx": 0,
    }


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("block", [True, False])
def test_save_restore_round_trip(tmp_path, block):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    p = payload(1, 10)
    mgr.save(10, p, block=block)
    # restore with no explicit wait drains an in-flight write
    assert _equal(mgr.restore(), p)
    assert os.path.isfile(tmp_path / "ck" / "10" / "payload.pt")
    # a template brings each tensor back in its leaf's dtype
    template = payload(0, 0)
    template["params"]["w"] = template["params"]["w"].double()
    got = mgr.restore(step=10, template=template)
    assert got["params"]["w"].dtype == torch.float64 and got["step"] == 10
    np.testing.assert_array_equal(got["params"]["w"].numpy(), p["params"]["w"].double().numpy())
    bad = payload(0, 0)
    bad["params"]["w"] = torch.zeros(3)
    with pytest.raises(ValueError, match="params/w"):
        mgr.restore(template=bad)
    assert CheckpointManager(str(tmp_path / "empty")).restore() is None


def test_same_step_resave_is_noop_but_tracks_metric(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(10, payload(1, 10), block=True)            # periodic save
    mtime = os.path.getmtime(tmp_path / "ck" / "10" / "payload.pt")
    mgr.save(10, payload(2, 10), metric=5.0, block=False)  # boundary save, same step
    assert mgr.latest_step() == 10
    # the step artifact was not rewritten ...
    assert os.path.getmtime(tmp_path / "ck" / "10" / "payload.pt") == mtime
    assert _equal(mgr.restore(), payload(1, 10))
    # ... but the metric fed best tracking, from the payload given
    assert _equal(mgr.restore_best(), payload(2, 10))
    mgr.save(20, payload(3, 20), metric=1.0, block=True)
    assert mgr.restore_best()["step"] == 20


@pytest.mark.parametrize("lower_is_better", [True, False])
def test_best_tracking(tmp_path, lower_is_better):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.restore_best() is None
    for step, metric in ((1, 5.0), (2, 3.0), (3, 4.0), (4, 6.0)):
        mgr.save(step, payload(step, step), metric=metric, lower_is_better=lower_is_better)
    want = 2 if lower_is_better else 4
    assert mgr._best_metric == (3.0 if lower_is_better else 6.0)
    assert _equal(mgr.restore_best(), payload(want, want))
    assert mgr.latest_step() == 4


def test_max_to_keep_and_interrupted_writes(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, payload(step, step), block=step % 2 == 0)
    mgr.wait_until_finished()
    assert sorted(os.listdir(tmp_path / "ck")) == ["3", "4"]
    assert _equal(mgr.restore(step=3), payload(3, 3))
    # A write killed before its os.replace leaves a temporary directory and
    # a step directory without a payload; neither counts as a checkpoint.
    os.makedirs(tmp_path / "ck" / ".tmp-5-1-1")
    (tmp_path / "ck" / ".tmp-5-1-1" / "payload.pt").write_bytes(b"partial")
    os.makedirs(tmp_path / "ck" / "6")
    assert mgr.latest_step() == 4
    assert _equal(mgr.restore(), payload(4, 4))



def test_best_survives_a_kill_between_its_moves(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, payload(1, 1), metric=2.0)
    # A kill after best/ was moved aside and before the new copy took its
    # place leaves only .old-best: the last good copy is still restored.
    os.replace(tmp_path / "ck" / "best", tmp_path / "ck" / ".old-best")
    assert _equal(mgr.restore_best(), payload(1, 1))
    # The next best write puts best/ back and removes the leftover.
    mgr.save(2, payload(2, 2), metric=1.0)
    assert not os.path.exists(tmp_path / "ck" / ".old-best")
    assert _equal(mgr.restore_best(), payload(2, 2))
    # Overwriting a present best/ leaves no .old-best behind either.
    mgr.save(3, payload(3, 3), metric=0.5)
    assert sorted(os.listdir(tmp_path / "ck")) == ["1", "2", "3", "best"]
    assert _equal(mgr.restore_best(), payload(3, 3))

def test_restore_weights_both_payload_kinds(tmp_path):
    full = CheckpointManager(str(tmp_path / "full"))
    full.save(3, payload(1, 3))
    weights_only = CheckpointManager(str(tmp_path / "ema"))
    p = payload(2, 3)
    weights_only.save(3, {"params": p["params"], "batch_stats": p["batch_stats"]})
    template = payload(0, 0)
    for mgr, src in ((full, payload(1, 3)), (weights_only, p)):
        got = mgr.restore_weights(template)
        assert got.keys() == {"params", "batch_stats"}
        assert _equal(got["params"], src["params"]) and _equal(got["batch_stats"], src["batch_stats"])
    # a template without an optimizer (an eval model) restores from a full payload
    assert _equal(full.restore_weights({"params": template["params"], "batch_stats": template["batch_stats"]})["params"],
                  payload(1, 3)["params"])
    wrong = payload(0, 0)
    wrong["params"]["w"] = torch.zeros(32, 64)
    with pytest.raises(ValueError, match=r"does not match the requested model: params/w: checkpoint shape \(64, 64\) vs model \(32, 64\)"):
        full.restore_weights(wrong)
    wrong = payload(0, 0)
    del wrong["batch_stats"]["m"]
    with pytest.raises(ValueError, match=r"batch_stats: missing \[\], unexpected \['m'\]"):
        weights_only.restore_weights(wrong)
    assert CheckpointManager(str(tmp_path / "none")).restore_weights(template) is None


def test_async_save_snapshots_before_in_place_updates(tmp_path):
    """save(block=False) copies the payload before it returns: updating the
    saved tensors in place right after (as the port's Adam does at the next
    step) must not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path / "ck"))
    p = payload(1, 7)
    before = {k: v.clone() for k, v in p["params"].items()}
    mu_before = p["opt_state"]["mu"]["w"].clone()
    mgr.save(7, p, block=False)
    torch._foreach_add_(list(p["params"].values()), 1.0)
    p["opt_state"]["mu"]["w"].mul_(-3.0)
    got = mgr.restore(step=7)
    for k, v in before.items():
        assert torch.equal(got["params"][k], v)
    assert torch.equal(got["opt_state"]["mu"]["w"], mu_before)
    assert not torch.equal(p["params"]["w"], before["w"])


def test_tree_mismatch_messages():
    a = {"x": np.zeros((2, 3)), "y": {"z": np.zeros(4)}}
    assert _tree_mismatch(a, {"x": torch.zeros(2, 3), "y": {"z": torch.zeros(4, dtype=torch.float64)}}) is None
    assert _tree_mismatch(a, {"x": np.zeros((2, 3))}) == "/: missing ['y'], unexpected []"
    assert _tree_mismatch(a, {"x": np.zeros((2, 3)), "y": np.zeros(4)}) == "/y: dict in model vs ndarray in checkpoint"
    assert _tree_mismatch(a, {"x": np.zeros((3, 2)), "y": {"z": np.zeros(4)}}) == "/x: checkpoint shape (3, 2) vs model (2, 3)"
