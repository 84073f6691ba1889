"""whmr_tpu (flax) variables -> whmr_tpu_torch state_dict.

`state_dict_from_flax` is the inverse of whmr_tpu's reference-checkpoint
converter (`whmr_tpu/utils/convert.py:79-217`): it takes the
`{"params", "batch_stats"}` trees of a whmr_tpu model (as numpy arrays) and
returns the port's state_dict, whose keys are the reference's torch names.
Any subtree may be absent; only the sections present are converted, so it
also carries single modules across (wrap them under their WHMR name).

Layout maps, each the exact inverse of whmr_tpu's:
- Linear:          flax (in, out)        -> torch (out, in)
- Conv2d:          flax (kH, kW, I, O)   -> torch (O, I, kH, kW)
- ConvTranspose2d: flax (kH, kW, I, O), spatially flipped -> torch (I, O, kH, kW)
- Conv1d k=1:      flax Dense (I, O)     -> torch (O, I, 1)
- BatchNorm:       scale/bias + mean/var -> weight/bias + running_mean/var
                   (num_batches_tracked, a step counter, is set to 0)
- LayerNorm:       scale/bias            -> weight/bias

`KNOWN_BUFFER_PATTERNS` / `is_known_buffer` are a copy of whmr_tpu's
(`whmr_tpu/utils/convert.py:53-75`): the keys of a reference checkpoint that
are constants in this design, which a load drops before it matches the rest.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


def linear_from_flax(kernel) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(kernel).T)


def conv_from_flax(kernel) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def convtranspose_from_flax(kernel) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(kernel)[::-1, ::-1], (2, 3, 0, 1)))


def conv1d_pointwise_from_flax(kernel) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(kernel).T[:, :, None])


_RESNET50_LAYERS = (3, 4, 6, 3)

# state_dict keys of a reference checkpoint that are CONSTANTS in this design
# (they ride BodyConsts or are baked in), not parameters to load:
KNOWN_BUFFER_PATTERNS = (
    r"\.smpl\.",                    # per-Regressor SMPL buffers (whmr.py:59)
    r"\.vertex_joint_selector\.",   # smplx VertexJointSelector buffer
    r"\.init_(pose|shape|cam)$",    # mean-param buffers (whmr.py:68-70,287)
    r"(^|\.)points_grid$",          # fixed sample grid (whmr.py:347)
    r"\.Dmap[01]?$",                # mesh-downsampling buffers (whmr.py:97-98)
    r"num_batches_tracked$",        # torch BN step counters
    r"^cam_model\.backbone\.fc\.",  # ImageNet classifier head, unused
)


def is_known_buffer(key: str) -> bool:
    return any(re.search(p, key) for p in KNOWN_BUFFER_PATTERNS)


def state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    params = variables.get("params", {})
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}

    def put(key, value):
        sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))

    def linear(dst, node):
        put(dst + ".weight", linear_from_flax(node["kernel"]))
        if "bias" in node:
            put(dst + ".bias", node["bias"])

    def conv(dst, node):
        put(dst + ".weight", conv_from_flax(node["kernel"]))
        if "bias" in node:
            put(dst + ".bias", node["bias"])

    def norm(dst, node):
        put(dst + ".weight", node["scale"])
        put(dst + ".bias", node["bias"])

    def bn(dst, node, stat):
        norm(dst, node)
        put(dst + ".running_mean", stat["mean"])
        put(dst + ".running_var", stat["var"])
        sd[dst + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    def block(dst, node):
        norm(dst + ".norm1", node["norm1"])
        norm(dst + ".norm2", node["norm2"])
        linear(dst + ".attn.qkv", node["attn"]["qkv"])
        linear(dst + ".attn.proj", node["attn"]["proj"])
        linear(dst + ".mlp.fc1", node["mlp"]["Dense_0"])
        linear(dst + ".mlp.fc2", node["mlp"]["Dense_1"])

    def indexed(tree, stem):
        """{i: subtree} for keys stem0, stem1, ... in index order."""
        out = {}
        for k, v in tree.items():
            m = re.fullmatch(re.escape(stem) + r"(\d+)", k)
            if m:
                out[int(m.group(1))] = v
        return dict(sorted(out.items()))

    if "feature_extractor" in params:
        fe, dst = params["feature_extractor"], "feature_extractor.backbone"
        conv(dst + ".patch_embed.proj", fe["patch_embed"])
        put(dst + ".pos_embed", fe["pos_embed"])
        for i, node in indexed(fe, "block").items():
            block(f"{dst}.blocks.{i}", node)
        norm(dst + ".last_norm", fe["last_norm"])

    for i, node in indexed(params, "deconv").items():
        ct = node["ConvTranspose_0"]
        put(f"deconv_layers.{3 * i}.weight", convtranspose_from_flax(ct["kernel"]))
        if "bias" in ct:
            put(f"deconv_layers.{3 * i}.bias", ct["bias"])
        bn(f"deconv_layers.{3 * i + 1}", node["BatchNorm_0"], stats[f"deconv{i}"]["BatchNorm_0"])

    for i, node in indexed(params, "maf").items():
        for l, layer in indexed(node, "conv").items():
            put(f"maf_extractor.{i}.conv{l}.weight", conv1d_pointwise_from_flax(layer["kernel"]))
            put(f"maf_extractor.{i}.conv{l}.bias", layer["bias"])

    for i, node in indexed(params, "regressor").items():
        for name, layer in node.items():
            linear(f"regressor.{i}.{name}", layer)

    if "tz_head" in params:
        tz = params["tz_head"]
        conv("conv.0", tz["conv1"])
        conv("conv.1", tz["conv2"])
        block("transformer_decoder", tz["decoder"])
        linear("est_Tz.0", tz["fc1"])
        linear("est_Tz.1", tz["fc2"])
        bn("est_Tz.2", tz["bn"], stats["tz_head"]["bn"])

    for name, layer in params.get("global_orient", {}).items():
        linear(f"global_orient.{name}", layer)
    for head in ("dp_head", "dpth_head"):
        for name, layer in params.get(head, {}).items():
            conv(f"{head}.{name}", layer)

    if "cam_model" in params:
        cam, cam_stats = params["cam_model"], stats["cam_model"]
        trunk, trunk_stats = cam["trunk"], cam_stats["trunk"]

        def conv_bn(conv_dst, bn_dst, node, stat):
            put(conv_dst + ".weight", conv_from_flax(node["Conv_0"]["kernel"]))
            bn(bn_dst, node["BatchNorm_0"], stat["BatchNorm_0"])

        dst = "cam_model.backbone"
        conv_bn(dst + ".conv1", dst + ".bn1", trunk["ConvBN_0"], trunk_stats["ConvBN_0"])
        k = 0
        for stage, n_blocks in enumerate(_RESNET50_LAYERS):
            for b in range(n_blocks):
                node, stat = trunk[f"Bottleneck_{k}"], trunk_stats[f"Bottleneck_{k}"]
                pre = f"{dst}.layer{stage + 1}.{b}"
                for j in range(3):
                    conv_bn(f"{pre}.conv{j + 1}", f"{pre}.bn{j + 1}", node[f"ConvBN_{j}"], stat[f"ConvBN_{j}"])
                if "ConvBN_3" in node:
                    conv_bn(f"{pre}.downsample.0", f"{pre}.downsample.1", node["ConvBN_3"], stat["ConvBN_3"])
                k += 1
        for angle in ("vfov", "pitch", "roll"):
            linear(f"cam_model.fc_{angle}", cam[f"fc_{angle}"])
    return sd


def merge_trees(base: dict, update: dict, path=""):
    """Recursively merge checkpoint leaves over the model's tree, keeping
    the model's leaf where the shapes differ. Returns (merged, report) with
    report = {"matched": count, "mismatched": [...], "extra": [...]}: keys
    whose shapes differ, and keys the model does not have (the shape-checked
    merge of whmr_tpu/utils/convert_cli.py)."""
    merged = dict(base)
    report = {"matched": 0, "mismatched": [], "extra": []}
    for k, v in update.items():
        if k not in base:
            report["extra"].append(f"{path}/{k}")
            continue
        if isinstance(v, dict):
            merged[k], sub = merge_trees(base[k], v, f"{path}/{k}")
            report["matched"] += sub["matched"]
            report["mismatched"] += sub["mismatched"]
            report["extra"] += sub["extra"]
        else:
            if tuple(getattr(base[k], "shape", ())) != tuple(v.shape):
                report["mismatched"].append(
                    f"{path}/{k}: ckpt {tuple(v.shape)} vs model {tuple(getattr(base[k], 'shape', ()))}"
                )
            else:
                merged[k] = v
                report["matched"] += 1
    return merged, report
