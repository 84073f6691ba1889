"""How the benchmark builds the system under test, `whmr_tpu_torch`.

The model is built on the meta device, placed on the card without
initialisation and filled from the benchmark's seeded weights (the port's
own `build_model` draws its initialisation on the host). The body
constants come from the benchmark's asset arrays. Nothing else of the
port's set-up is replaced.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

import weights as weights_mod


def port_config(model_keys: Dict, overrides: Dict):
    """The port's WHMRConfig from a configuration's dotted keys and a
    traffic mix's overrides."""
    from whmr_tpu_torch.config import WHMRConfig

    kv = {k: (tuple(v) if isinstance(v, list) else v) for k, v in {**model_keys, **overrides}.items()}
    return WHMRConfig().with_overrides(**kv)


def port_assets(assets: Dict[str, np.ndarray]):
    from whmr_tpu_torch.data.assets import SMPLAssets

    return SMPLAssets(**assets, gender="neutral")


def _meta_model(cfg, dtype=torch.float32):
    """The model on the meta device, and the tensors its constructor made
    from host arrays (constants such as the MAF sample grid), by name."""
    from whmr_tpu_torch.models.whmr import WHMR

    with torch.device("meta"):
        model = WHMR(cfg, dtype=dtype)
    keep = {k: v.clone() for k, v in list(model.named_buffers()) + list(model.named_parameters())
            if v.device.type != "meta"}
    return model, keep


def weight_spec(cfg) -> weights_mod.Spec:
    """The names and shapes of the weights the model's state takes."""
    model, keep = _meta_model(cfg)
    return weights_mod.spec_of({k: v for k, v in model.state_dict().items() if k not in keep})


def build(cfg, assets, dtype, seed: int, device):
    """(model in eval mode, body constants, the weight spec). The weights
    are `weights.generate(spec, seed)`."""
    from whmr_tpu_torch.models.regressor import body_consts_from_assets

    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model, keep = _meta_model(cfg, dtype)
    model = model.to_empty(device=device)
    state = model.state_dict(keep_vars=True)
    spec = weights_mod.spec_of({k: v for k, v in state.items() if k not in keep})
    w = weights_mod.generate(spec, seed, device)
    with torch.no_grad():
        for k, v in model.named_buffers():
            if k in keep:
                v.copy_(keep[k])
            elif k.endswith("num_batches_tracked"):
                v.zero_()
        for k, v in state.items():
            if k in w:
                v.data.copy_(w[k])
    del w
    consts = body_consts_from_assets(port_assets(assets), device=device)
    return model.eval(), consts, spec
