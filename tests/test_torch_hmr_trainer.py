"""The HMR baseline through the port's Trainer and CLIs: a Trainer epoch
and a bit-for-bit resume, and whmr-train / whmr-eval `--regressor hmr`
on a written dataset against `run_evaluation` of the same weights
(metrics 1e-4 relative). The model's parity with whmr_tpu is in
test_torch_hmr.py.
"""

import shutil

import numpy as np
import pytest
import torch

from whmr_tpu_torch.config import WHMRConfig
from whmr_tpu_torch.data.assets import synthetic_smpl_assets as t_assets
from whmr_tpu_torch.data.loader import BatchLoader
from whmr_tpu_torch.data.npz_dataset import NpzDataset
from whmr_tpu_torch.inference import eval_cli as teval
from whmr_tpu_torch.inference.evaluate import run_evaluation
from whmr_tpu_torch.models.hmr import HMR
from whmr_tpu_torch.models.whmr import body_consts_from_assets, build_hmr
from whmr_tpu_torch.training import cli as tcli
from whmr_tpu_torch.training.trainer import Trainer
from whmr_tpu_torch.utils import testing as ttesting

from torch_port_util import release_memory, t  # noqa: F401 (autouse fixture)

B = 4
HW = (128, 96)


def _host_batches(n_batches, seed=0):
    for i in range(n_batches):
        batch = ttesting.make_example_train_batch(ttesting.tiny_config(), B, seed=seed + i)
        batch["img"] = np.random.RandomState(seed + i).randn(B, *HW, 3).astype(np.float32)
        yield batch


def test_trainer_epoch_and_resume(tmp_path):
    """A Trainer epoch of the HMR model (no GT render), an epoch-boundary
    checkpoint that a fresh Trainer resumes bit for bit, and the resumed
    run's next epoch."""
    cfg = ttesting.tiny_config()
    tr = Trainer(cfg, str(tmp_path / "run"), device="cpu", regressor="hmr")
    assert isinstance(tr.model, HMR) and tr.render_consts is None
    before = tr.state.params["decpose.weight"].clone()
    tr.fit(lambda epoch: _host_batches(2), num_epochs=1, log_every=1)
    assert tr.state.step == 2 and not torch.equal(tr.state.params["decpose.weight"], before)
    fresh = Trainer(cfg, str(tmp_path / "run"), device="cpu", regressor="hmr", seed=5)
    assert fresh.resume() and fresh.epoch == 1 and fresh.state.step == 2
    for k in tr.state.params:
        assert torch.equal(tr.state.params[k], fresh.state.params[k]), k
    for k in tr.state.batch_stats:
        assert torch.equal(tr.state.batch_stats[k], fresh.state.batch_stats[k]), k
    assert fresh.state.opt_state.count == 2
    for x, y in zip(tr.state.opt_state.mu + tr.state.opt_state.nu, fresh.state.opt_state.mu + fresh.state.opt_state.nu):
        assert torch.equal(x, y)
    fresh.fit(lambda epoch: _host_batches(2, seed=7), num_epochs=2, log_every=1)
    assert fresh.state.step == 4
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_whmr_train_and_eval_cli_hmr(tmp_path):
    """whmr-train --regressor hmr (2 steps of B=4 on a written dataset),
    then whmr-eval --regressor hmr on its checkpoint against
    run_evaluation of the same weights."""
    consts = body_consts_from_assets(t_assets(0), device="cpu")
    paths = ttesting.write_npz_dataset(tmp_path / "data", consts, 8, seed=0)
    trainer = tcli.main(["--train_npz", paths["npz"], "--img_dir", paths["img_dir"], "--log_dir",
                         str(tmp_path / "runs"), "--name", "hmr", "--regressor", "hmr", "--batch_size", "4",
                         "--num_epochs", "1", "--device", "cpu", "--loader_procs", "0"])
    assert isinstance(trainer.model, HMR) and trainer.state.step == 2
    ckpt = str(tmp_path / "runs" / "hmr" / "checkpoints")
    argv = ["--checkpoint", ckpt, "--dataset_npz", paths["npz"], "--img_dir", paths["img_dir"],
            "--batch_size", "4", "--regressor", "hmr", "--device", "cpu"]
    got = teval.main(argv)
    ds_model, ds_consts = build_hmr(dtype=torch.float32, device="cpu")
    ds_model.load_state_dict({k: v for k, v in trainer.model.state_dict().items()})
    ds = NpzDataset(WHMRConfig(), paths["npz"], paths["img_dir"], is_train=False)

    def batches():
        for hb in BatchLoader(ds, 4, shuffle=False, drop_last=False, num_procs=0):
            b, _ = teval.device_eval_batch(hb, extra_keys=("pose", "betas", "gender", "global_pose"), device="cpu")
            b["valid"] = t(hb["has_smpl"])
            yield b

    want = run_evaluation(WHMRConfig(), ds_model, ds_consts, batches(), log_every=0, regressor="hmr")
    assert got["count"] == want["count"] == 8
    for k in ("mpjpe", "pa_mpjpe", "pve"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    with pytest.raises(SystemExit, match="metric protocol only"):
        teval.main(argv + ["--coco_ap"])
    shutil.rmtree(tmp_path, ignore_errors=True)
