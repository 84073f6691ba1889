"""Graphormer non-parametric vertex refiner.

Counterpart of `whmr_tpu/models/graphormer.py` (reference
`models/e2e_body_network.py` Graphormer_Body_Network :22-150,
`models/bert/modeling_graphormer.py` Graphormer :304, EncoderBlock :208,
GraphormerLayer :124, and `models/bert/_gcnn.py` GraphResBlock :54,
GraphConvolution :123).

Tokens are the 431 coarse mesh vertices, each with its grid-sampled image
feature (3 + 256 = 259 values), and one global token (the projected body
feature). A post-LN BERT encoder (4 layers, hidden 32, 4 heads, LayerNorm
eps 1e-12, exact GELU, learned (512, 32) position embeddings) passes the
vertex tokens of each layer through a GraphResBlock, a graph convolution
over the dense 431x431 adjacency. A 3-d head plus an input residual gives
per-vertex coordinates, upsampled linearly over the vertex axis, 431 ->
1723 -> 6890.

The attention (432 tokens, head width 8) and the adjacency product are
plain matmuls, as they are einsums outside any Pallas kernel in whmr_tpu.
Dropout of 0.1 sits at whmr_tpu's four sites: the attention
probabilities, the attention output, BertOutput and the embeddings.

Module names are those of the reference tree (`trans_encoder.layer.{i}.
attention.self.query`, `graph_conv.lin1.W`, ...), as
`tests/test_graphormer_oracle.py` re-declares it. The GCN's GraphLinear
keeps the reference's (out, in) `W`, and GraphConvolution its (in, out)
`weight`.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from whmr_tpu_torch.data.assets import SMPLAssets
from whmr_tpu_torch.models.layers import Dropout, LayerNorm, Linear

# The reference encoder (whmr.py:366-394): 4 layers, hidden 32, 4 heads,
# 512 learned positions; the coarse, sub and full mesh sizes.
HIDDEN, LAYERS, HEADS, MAX_TOKENS = 32, 4, 4, 512
N_COARSE, N_SUB, N_VERTS = 431, 1723, 6890


def build_adjacency(assets: SMPLAssets, path: Optional[str] = None) -> np.ndarray:
    """The 431-vertex normalised adjacency (431, 431), fp32.

    With `path`, the reference's sparse tensors
    `smpl_431_adjmat_{indices,values,size}.pt` in that directory
    (_gcnn.py:132-138); else a ring adjacency over the coarse vertex order
    (each vertex and its two neighbours on each side, rows normalised)."""
    if path is not None:
        def load(name):
            return torch.load(os.path.join(path, f"smpl_431_adjmat_{name}.pt"), map_location="cpu")

        idx, val, size = load("indices"), load("values"), load("size")
        adj = np.zeros(tuple(int(s) for s in size), np.float32)
        adj[idx[0].numpy(), idx[1].numpy()] = val.numpy()
        return adj
    n = assets.dmap1.shape[0]
    adj = np.eye(n, dtype=np.float32)
    for off in (1, 2):
        adj += np.eye(n, k=off, dtype=np.float32) + np.eye(n, k=-off, dtype=np.float32)
    return adj / adj.sum(axis=1, keepdims=True)


class BertSelfAttention(nn.Module):
    """Keys query, key, value. Scores in the compute dtype, fp32 softmax."""

    def __init__(self, hidden: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.query = Linear(hidden, hidden, dtype=dtype)
        self.key = Linear(hidden, hidden, dtype=dtype)
        self.value = Linear(hidden, hidden, dtype=dtype)
        self.dropout = Dropout(0.1)

    def forward(self, x, generator=None):
        b, n, c = x.shape
        head = c // self.num_heads

        def split(t):
            return t.reshape(b, n, self.num_heads, head)

        q = split(self.query(x)) / torch.tensor(math.sqrt(head), dtype=x.dtype, device=x.device)
        attn = torch.einsum("bnhd,bmhd->bhnm", q, split(self.key(x)))
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        attn = self.dropout(attn, generator)
        return torch.einsum("bhnm,bmhd->bnhd", attn, split(self.value(x))).reshape(b, n, c)


class BertAttention(nn.Module):
    """Post-LN attention block: LayerNorm(dense(self(x)) + x)."""

    def __init__(self, hidden: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.self = BertSelfAttention(hidden, num_heads, dtype=dtype)
        self.dense = Linear(hidden, hidden, dtype=dtype)
        self.LayerNorm = LayerNorm(hidden, 1e-12, dtype=dtype)
        self.dropout = Dropout(0.1)

    def forward(self, x, generator=None):
        out = self.dropout(self.dense(self.self(x, generator)), generator)
        return self.LayerNorm(out + x)


class GraphLinear(nn.Module):
    """Per-vertex linear map with the reference's (out, in) `W` and `b`."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32):
        super().__init__()
        self.W = nn.Parameter(torch.empty(out_ch, in_ch))
        self.b = nn.Parameter(torch.zeros(out_ch))
        self.compute_dtype = dtype

    def forward(self, x):  # (B, V, C_in)
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.W.to(dt), self.b.to(dt))


class GraphConvolution(nn.Module):
    """adj @ x @ weight + bias with an (in, out) `weight`. The adjacency
    product runs first and in fp32 (whmr_tpu's einsum promotes the compute
    dtype against the fp32 adjacency); the weight in the compute dtype."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.compute_dtype = dtype

    def forward(self, x, adj):  # (B, V, C), (V, V)
        dt = self.compute_dtype
        y = torch.matmul(adj.float(), x.float()).to(dt)
        return torch.matmul(y, self.weight.to(dt)) + self.bias.to(dt)


class GraphResBlock(nn.Module):
    """GCN bottleneck residual block over the vertex tokens (_gcnn.py:54-83)."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        half = channels // 2
        self.pre_norm = LayerNorm(channels, 1e-12, dtype=dtype)
        self.lin1 = GraphLinear(channels, half, dtype=dtype)
        self.norm1 = LayerNorm(half, 1e-12, dtype=dtype)
        self.conv = GraphConvolution(half, half, dtype=dtype)
        self.norm2 = LayerNorm(half, 1e-12, dtype=dtype)
        self.lin2 = GraphLinear(half, channels, dtype=dtype)

    def forward(self, x, adj):
        y = self.lin1(F.relu(self.pre_norm(x)))
        y = self.conv(F.relu(self.norm1(y)), adj)
        return x + self.lin2(F.relu(self.norm2(y)))


class GraphormerLayer(nn.Module):
    """Attention, the GCN over the vertex tokens (the trailing global token
    bypasses it, modeling_graphormer.py:142-158), then the post-LN MLP."""

    def __init__(self, hidden: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.attention = BertAttention(hidden, num_heads, dtype=dtype)
        self.graph_conv = GraphResBlock(hidden, dtype=dtype)
        self.intermediate = Linear(hidden, hidden * 2, dtype=dtype)
        self.out_dense = Linear(hidden * 2, hidden, dtype=dtype)
        self.out_ln = LayerNorm(hidden, 1e-12, dtype=dtype)
        self.dropout = Dropout(0.1)

    def forward(self, x, adj, generator=None):
        x = self.attention(x, generator)
        x = torch.cat([self.graph_conv(x[:, :-1], adj), x[:, -1:]], dim=1)
        y = self.dropout(self.out_dense(F.gelu(self.intermediate(x))), generator)
        return self.out_ln(x + y)


class GraphormerEncoder(nn.Module):
    """Embedding (image projection + learned positions) -> layers ->
    cls_head + the input residual."""

    def __init__(self, in_dim: int, dtype=torch.float32):
        super().__init__()
        self.img_embedding = Linear(in_dim, HIDDEN, dtype=dtype)
        self.position_embeddings = nn.Embedding(MAX_TOKENS, HIDDEN)
        self.dropout = Dropout(0.1)
        self.layer = nn.ModuleList(GraphormerLayer(HIDDEN, HEADS, dtype=dtype) for _ in range(LAYERS))
        self.cls_head = Linear(HIDDEN, 3, dtype=dtype)
        self.residual = Linear(in_dim, 3, dtype=dtype)

    def forward(self, tokens, adj, generator=None):
        n = tokens.shape[1]
        x = self.img_embedding(tokens)
        x = self.dropout(x + self.position_embeddings.weight[None, :n].to(x.dtype), generator)
        for layer in self.layer:
            x = layer(x, adj, generator)
        return self.cls_head(x) + self.residual(tokens)


class GraphormerBodyNetwork(nn.Module):
    """The refinement stage (e2e_body_network.py:44-150 forward): body
    feature, the 431 vertices' sampled features and the vertices ->
    refined vertices at 431, 1723 and 6890, in the compute dtype."""

    def __init__(self, body_dim: int, feat_dim: int, dtype=torch.float32):
        super().__init__()
        tok_dim = 3 + feat_dim
        self.compute_dtype = dtype
        self.global_feat_dim = Linear(body_dim, tok_dim, dtype=dtype)
        self.trans_encoder = GraphormerEncoder(tok_dim, dtype=dtype)
        self.upsampling = Linear(N_COARSE, N_SUB, dtype=dtype)
        self.upsampling2 = Linear(N_SUB, N_VERTS, dtype=dtype)

    def forward(self, body_feat, grid_feat, temp_verts, adj, meta_masks=None, generator=None
                ) -> Dict[str, torch.Tensor]:
        dt = self.compute_dtype
        global_tok = self.global_feat_dim(body_feat)[:, None, :]
        vert_tok = torch.cat([temp_verts.to(dt), grid_feat.to(dt)], dim=-1)
        if self.training and meta_masks is not None:
            # Masked vertex modelling: the [MASK] token is 0.01s (e2e:66-70).
            m = meta_masks.to(dt)
            vert_tok = vert_tok * m + torch.full_like(vert_tok, 0.01) * (1 - m)
        out = self.trans_encoder(torch.cat([vert_tok, global_tok], dim=1), adj, generator)
        pred_temp = out[:, :-1]
        # Linear upsampling over the VERTEX axis (e2e:82-89).
        sub = self.upsampling(pred_temp.transpose(1, 2))
        full = self.upsampling2(sub)
        return {"temp_verts": pred_temp, "sub_verts": sub.transpose(1, 2), "verts": full.transpose(1, 2)}
