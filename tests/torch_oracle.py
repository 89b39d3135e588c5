"""Self-contained torch reference implementation of the GASFM nets.

This transcribes the reference models (code/models/layers.py:150-956,
code/models/graph_attn_sfm.py:8-185, code/models/SetOfSet.py:7-142,
code/models/baseNet.py:8-92) into plain torch with NO PyG / pytorch3d
dependency:

- PyG ``GATv2Conv`` restricted to the star graphs the reference builds
  (``RefGATv2Conv`` — semantics validated against the documented PyG
  contract in tests/test_torch_parity.py).
- pytorch3d ``quaternion_to_matrix`` / ``rotation_6d_to_matrix`` re-derived
  from their documented formulas.

Module and parameter NAMING matches the reference exactly, so
``oracle.state_dict()`` has the same keys as a reference training
checkpoint — the converter (gasfm/models/convert.py) is therefore
usable both for these oracles and for real published weights.

The graph input is an edge list in torch-COO *coalesced* (row-major:
(camera, point) lexicographic) order, which is how the reference's
``SparseMat.to_torch_hybrid_sparse_coo`` presents edges to every layer.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn


@dataclass
class OracleGraph:
    """Edge list in coalesced (camera-major) order plus validity masks."""

    values: torch.Tensor  # (nnz, d) per-edge features (observations at input)
    cam_idx: torch.Tensor  # (nnz,) int64
    pt_idx: torch.Tensor  # (nnz,) int64
    m: int
    n: int
    view_valid: torch.Tensor  # (m,) bool — >= MIN_N_POINTS_PER_VIEW obs
    pt_valid: torch.Tensor  # (n,) bool — >= MIN_N_VIEWS_PER_POINT obs

    def with_values(self, values: torch.Tensor) -> "OracleGraph":
        return OracleGraph(values, self.cam_idx, self.pt_idx, self.m, self.n,
                           self.view_valid, self.pt_valid)


def segment_softmax_aggregate(xl, logits, seg_ids, num_segments):
    """softmax over each segment of `logits`, weighted sum of `xl` rows.

    xl: (E, H, C), logits: (E, H); returns (S, H, C). Empty segments -> 0.
    """
    E, H, C = xl.shape
    m = torch.full((num_segments, H), -torch.inf, dtype=logits.dtype)
    m = m.index_reduce(0, seg_ids, logits, reduce="amax", include_self=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m[seg_ids])
    den = torch.zeros((num_segments, H), dtype=logits.dtype)
    den = den.index_add(0, seg_ids, p)
    num = torch.zeros((num_segments, H, C), dtype=xl.dtype)
    num = num.index_add(0, seg_ids, p[:, :, None] * xl)
    den = torch.where(den > 0, den, torch.ones_like(den))
    return num / den[:, :, None]


class RefGATv2Conv(nn.Module):
    """PyG GATv2Conv(in, out_per_head, heads, add_self_loops=False) on a
    star graph: sources = rows of x_src, each attending into its segment's
    single aggregation node (features = query row, or zeros)."""

    def __init__(self, in_feat, out_per_head, heads):
        super().__init__()
        self.heads = heads
        self.out_per_head = out_per_head
        self.lin_l = nn.Linear(in_feat, heads * out_per_head)
        self.lin_r = nn.Linear(in_feat, heads * out_per_head)
        self.att = nn.Parameter(torch.empty(1, heads, out_per_head))
        self.bias = nn.Parameter(torch.zeros(heads * out_per_head))
        nn.init.xavier_uniform_(self.lin_l.weight)
        nn.init.zeros_(self.lin_l.bias)
        nn.init.xavier_uniform_(self.lin_r.weight)
        nn.init.zeros_(self.lin_r.bias)
        nn.init.xavier_uniform_(self.att)

    def forward(self, x_src, seg_ids, num_segments, query=None):
        E = x_src.shape[0]
        H, C = self.heads, self.out_per_head
        xl = self.lin_l(x_src).view(E, H, C)
        if query is None:
            xr = self.lin_r.bias.view(1, H, C).expand(num_segments, H, C)
        else:
            xr = self.lin_r(query).view(num_segments, H, C)
        g = F.leaky_relu(xl + xr[seg_ids], negative_slope=0.2)
        logits = (g * self.att).sum(-1)  # (E, H)
        out = segment_softmax_aggregate(xl, logits, seg_ids, num_segments)
        return out.reshape(num_segments, H * C) + self.bias


def get_linear_layers(feats, init_activation=False, final_activation=False, norm=True):
    """Reference code/models/layers.py:10-44."""
    layers = []
    if init_activation:
        if norm:
            layers.append(nn.LayerNorm(feats[0]))
        layers.append(nn.ReLU())
    for i in range(len(feats) - 2):
        layers.append(nn.Linear(feats[i], feats[i + 1]))
        if norm:
            layers.append(nn.LayerNorm(feats[i + 1]))
        layers.append(nn.ReLU())
    layers.append(nn.Linear(feats[-2], feats[-1]))
    if final_activation:
        if norm:
            layers.append(nn.LayerNorm(feats[-1]))
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


def positional_embed(x, n_freq):
    """Reference code/utils/pos_enc_utils.py:4-58 (include-input, 2^k freqs)."""
    if n_freq <= 0:
        return x
    outs = [x]
    for k in range(n_freq):
        freq = 2.0 ** k
        outs.append(torch.sin(x * freq))
        outs.append(torch.cos(x * freq))
    return torch.cat(outs, dim=-1)


class EmbeddingLayer(nn.Module):
    """Reference layers.py:992-1015."""

    def __init__(self, pos_emb_n_freq, in_dim, post_embed_proj_dim=None):
        super().__init__()
        self.pos_emb_n_freq = pos_emb_n_freq
        self.d_out = in_dim if pos_emb_n_freq <= 0 else in_dim * (1 + 2 * pos_emb_n_freq)
        if post_embed_proj_dim is not None:
            d = self.d_out if post_embed_proj_dim == -1 else post_embed_proj_dim
            self.post_embed_lin = nn.Linear(self.d_out, d)
            self.d_out = d
        else:
            self.post_embed_lin = None

    def forward(self, values):
        x = positional_embed(values, self.pos_emb_n_freq)
        if self.post_embed_lin is not None:
            x = self.post_embed_lin(x)
        return x


def _default_agg(in_feat, n_heads):
    agg = in_feat
    if agg % n_heads:
        agg += n_heads - (agg % n_heads)
    return agg


def _norm_and_proj(d_state, d_target):
    """The stateful-query adapter Sequentials (reference layers.py:295-303)."""
    mods = [nn.LayerNorm(d_state), nn.ReLU()]
    if d_target != d_state:
        mods.append(nn.Linear(d_state, d_target))
    return nn.Sequential(*mods)


class Proj2View(nn.Module):
    """Reference layers.py:266-361."""

    def __init__(self, n_feat_proj_in, n_feat_view_out, n_heads, stateful=True,
                 n_feat_proj2view_agg=None, n_hidden_layers_view_update=0):
        super().__init__()
        self.stateful = stateful
        agg = n_feat_proj2view_agg or _default_agg(n_feat_proj_in, n_heads)
        self.agg = agg
        if stateful:
            self.norm_and_proj_view2proj = _norm_and_proj(n_feat_view_out, n_feat_proj_in)
        self.graph_conv = RefGATv2Conv(n_feat_proj_in, agg // n_heads, n_heads)
        if agg != n_feat_view_out:
            self.proj_proj2view = nn.Linear(agg, n_feat_view_out)
        self.norm_pre_mlp = nn.LayerNorm(n_feat_view_out)
        self.mlp = get_linear_layers(
            (2 + n_hidden_layers_view_update) * [n_feat_view_out], norm=False)

    def forward(self, graph: OracleGraph, prev_view_features=None):
        q = None
        if self.stateful:
            q = self.norm_and_proj_view2proj(prev_view_features)
        x = self.graph_conv(graph.values, graph.cam_idx, graph.m, query=q)
        if hasattr(self, "proj_proj2view"):
            x = self.proj_proj2view(x)
        if prev_view_features is not None:
            x = prev_view_features + x
        x_skip = x
        x = F.relu(self.norm_pre_mlp(x))
        return x_skip + self.mlp(x)


class Proj2ScenePoint(nn.Module):
    """Reference layers.py:363-458."""

    def __init__(self, n_feat_proj_in, n_feat_scenepoint_out, n_heads, stateful=True,
                 n_feat_proj2scenepoint_agg=None, n_hidden_layers_scenepoint_update=0):
        super().__init__()
        self.stateful = stateful
        agg = n_feat_proj2scenepoint_agg or _default_agg(n_feat_proj_in, n_heads)
        if stateful:
            self.norm_and_proj_scenepoint2proj = _norm_and_proj(
                n_feat_scenepoint_out, n_feat_proj_in)
        self.graph_conv = RefGATv2Conv(n_feat_proj_in, agg // n_heads, n_heads)
        if agg != n_feat_scenepoint_out:
            self.proj_proj2scenepoint = nn.Linear(agg, n_feat_scenepoint_out)
        self.norm_pre_mlp = nn.LayerNorm(n_feat_scenepoint_out)
        self.mlp = get_linear_layers(
            (2 + n_hidden_layers_scenepoint_update) * [n_feat_scenepoint_out], norm=False)

    def forward(self, graph: OracleGraph, prev_scenepoint_features=None):
        q = None
        if self.stateful:
            q = self.norm_and_proj_scenepoint2proj(prev_scenepoint_features)
        x = self.graph_conv(graph.values, graph.pt_idx, graph.n, query=q)
        if hasattr(self, "proj_proj2scenepoint"):
            x = self.proj_proj2scenepoint(x)
        if prev_scenepoint_features is not None:
            x = prev_scenepoint_features + x
        x_skip = x
        x = F.relu(self.norm_pre_mlp(x))
        return x_skip + self.mlp(x)


class ViewAndScenePoint2Global(nn.Module):
    """Reference layers.py:460-603: two single-node attention pools."""

    def __init__(self, n_feat_scenepoint_in, n_feat_view_in, n_feat_global_out,
                 n_heads, stateful=True, n_feat_scenepoint2global_agg=None,
                 n_feat_view2global_agg=None, n_hidden_layers_global_update=0):
        super().__init__()
        self.stateful = stateful
        s2g = n_feat_scenepoint2global_agg or _default_agg(n_feat_scenepoint_in, n_heads)
        v2g = n_feat_view2global_agg or _default_agg(n_feat_view_in, n_heads)
        if stateful:
            self.norm_and_proj_global2view = _norm_and_proj(n_feat_global_out, n_feat_view_in)
        self.graph_conv_view2global = RefGATv2Conv(n_feat_view_in, v2g // n_heads, n_heads)
        if stateful:
            self.norm_and_proj_global2scenepoint = _norm_and_proj(
                n_feat_global_out, n_feat_scenepoint_in)
        self.graph_conv_scenepoint2global = RefGATv2Conv(
            n_feat_scenepoint_in, s2g // n_heads, n_heads)
        if (v2g + s2g) != n_feat_global_out:
            self.proj_view_and_scenepoint2global = nn.Linear(v2g + s2g, n_feat_global_out)
        self.norm_pre_mlp = nn.LayerNorm(n_feat_global_out)
        self.mlp = get_linear_layers(
            (2 + n_hidden_layers_global_update) * [n_feat_global_out], norm=False)

    def forward(self, view_features, scenepoint_features, view_valid, pt_valid,
                prev_global_features=None):
        q_v = q_s = None
        if self.stateful:
            q_v = self.norm_and_proj_global2view(prev_global_features)
            q_s = self.norm_and_proj_global2scenepoint(prev_global_features)
        vf = view_features[view_valid]
        v_ids = torch.zeros(vf.shape[0], dtype=torch.long)
        v2g = self.graph_conv_view2global(vf, v_ids, 1, query=q_v)
        sf = scenepoint_features[pt_valid]
        s_ids = torch.zeros(sf.shape[0], dtype=torch.long)
        s2g = self.graph_conv_scenepoint2global(sf, s_ids, 1, query=q_s)
        x = torch.cat([v2g, s2g], dim=1)
        if hasattr(self, "proj_view_and_scenepoint2global"):
            x = self.proj_view_and_scenepoint2global(x)
        if prev_global_features is not None:
            x = prev_global_features + x
        x_skip = x
        x = F.relu(self.norm_pre_mlp(x))
        return x_skip + self.mlp(x)


class Global2View(nn.Module):
    """Reference layers.py:605-662."""

    def __init__(self, n_feat_global_in, n_feat_view_in_out, n_hidden_layers_view_update=0):
        super().__init__()
        self.n_hidden = n_hidden_layers_view_update
        self.view_norm_layer = nn.LayerNorm(n_feat_view_in_out)
        self.global_norm_layer = nn.LayerNorm(n_feat_global_in)
        self.lin_view = nn.Linear(n_feat_view_in_out, n_feat_view_in_out)
        self.lin_global = nn.Linear(n_feat_global_in, n_feat_view_in_out, bias=False)
        if self.n_hidden > 0:
            self.mlp = get_linear_layers(
                self.n_hidden * [n_feat_view_in_out] + [n_feat_view_in_out], norm=False)

    def forward(self, global_features, prev):
        x = self.lin_view(F.relu(self.view_norm_layer(prev)))
        g = self.lin_global(F.relu(self.global_norm_layer(global_features)))
        x = x + g
        if self.n_hidden > 0:
            x = self.mlp(F.relu(x))
        return prev + x


class Global2ScenePoint(nn.Module):
    """Reference layers.py:664-721."""

    def __init__(self, n_feat_global_in, n_feat_scenepoint_in_out,
                 n_hidden_layers_scenepoint_update=0):
        super().__init__()
        self.n_hidden = n_hidden_layers_scenepoint_update
        self.scenepoint_norm_layer = nn.LayerNorm(n_feat_scenepoint_in_out)
        self.global_norm_layer = nn.LayerNorm(n_feat_global_in)
        self.lin_scenepoint = nn.Linear(n_feat_scenepoint_in_out, n_feat_scenepoint_in_out)
        self.lin_global = nn.Linear(n_feat_global_in, n_feat_scenepoint_in_out, bias=False)
        if self.n_hidden > 0:
            self.mlp = get_linear_layers(
                self.n_hidden * [n_feat_scenepoint_in_out] + [n_feat_scenepoint_in_out],
                norm=False)

    def forward(self, global_features, prev):
        x = self.lin_scenepoint(F.relu(self.scenepoint_norm_layer(prev)))
        g = self.lin_global(F.relu(self.global_norm_layer(global_features)))
        x = x + g
        if self.n_hidden > 0:
            x = self.mlp(F.relu(x))
        return prev + x


class GraphAttnSfMGlobalFeatureUpdate(nn.Module):
    """Reference layers.py:723-870."""

    def __init__(self, n_feat_proj_in, n_feat_scenepoint_out, n_feat_view_out,
                 n_feat_proj2scenepoint_agg=None, n_feat_proj2view_agg=None,
                 n_feat_global_out=None, n_feat_scenepoint2global_agg=None,
                 n_feat_view2global_agg=None, output_global=True, n_heads=1,
                 stateful=True, global2view_and_global2scenepoint_enabled=True,
                 n_hidden_layers_scenepoint_update=0, n_hidden_layers_view_update=0,
                 n_hidden_layers_global_update=0):
        super().__init__()
        self.output_global = output_global
        self.g2vs = global2view_and_global2scenepoint_enabled
        self.proj2view = Proj2View(
            n_feat_proj_in, n_feat_view_out, n_heads, stateful=stateful,
            n_feat_proj2view_agg=n_feat_proj2view_agg,
            n_hidden_layers_view_update=n_hidden_layers_view_update)
        self.proj2scenepoint = Proj2ScenePoint(
            n_feat_proj_in, n_feat_scenepoint_out, n_heads, stateful=stateful,
            n_feat_proj2scenepoint_agg=n_feat_proj2scenepoint_agg,
            n_hidden_layers_scenepoint_update=n_hidden_layers_scenepoint_update)
        if output_global or self.g2vs:
            self.view_and_scenepoint2global = ViewAndScenePoint2Global(
                n_feat_scenepoint_out, n_feat_view_out, n_feat_global_out, n_heads,
                stateful=stateful,
                n_feat_scenepoint2global_agg=n_feat_scenepoint2global_agg,
                n_feat_view2global_agg=n_feat_view2global_agg,
                n_hidden_layers_global_update=n_hidden_layers_global_update)
        if self.g2vs:
            self.global2view = Global2View(
                n_feat_global_out, n_feat_view_out,
                n_hidden_layers_view_update=n_hidden_layers_view_update)
            self.global2scenepoint = Global2ScenePoint(
                n_feat_global_out, n_feat_scenepoint_out,
                n_hidden_layers_scenepoint_update=n_hidden_layers_scenepoint_update)

    def forward(self, graph: OracleGraph, prev_scenepoint_features=None,
                prev_view_features=None, prev_global_features=None):
        scenepoint_features = self.proj2scenepoint(
            graph, prev_scenepoint_features=prev_scenepoint_features)
        view_features = self.proj2view(graph, prev_view_features=prev_view_features)
        global_features = None
        if self.output_global or self.g2vs:
            global_features = self.view_and_scenepoint2global(
                view_features, scenepoint_features, graph.view_valid, graph.pt_valid,
                prev_global_features=prev_global_features)
        if self.g2vs:
            scenepoint_features = self.global2scenepoint(global_features, scenepoint_features)
            view_features = self.global2view(global_features, view_features)
        if not self.output_global:
            return scenepoint_features, view_features
        return scenepoint_features, view_features, global_features


class GraphAttnSfMProjectionFeatureUpdate(nn.Module):
    """Reference layers.py:873-956."""

    def __init__(self, n_feat_proj_in, n_feat_scenepoint_in, n_feat_view_in,
                 n_feat_global_in, n_feat_proj_out, n_hidden_layers_proj_update=0,
                 normalize_global_features=True):
        super().__init__()
        self.n_hidden = n_hidden_layers_proj_update
        self.normalize_global_features = normalize_global_features
        if normalize_global_features:
            self.scenepoint_norm_layer = nn.LayerNorm(n_feat_scenepoint_in)
            self.view_norm_layer = nn.LayerNorm(n_feat_view_in)
            self.global_norm_layer = nn.LayerNorm(n_feat_global_in)
        self.lin_proj = nn.Linear(n_feat_proj_in, n_feat_proj_out)
        self.lin_scenepoint = nn.Linear(n_feat_scenepoint_in, n_feat_proj_out, bias=False)
        self.lin_view = nn.Linear(n_feat_view_in, n_feat_proj_out, bias=False)
        self.lin_global = nn.Linear(n_feat_global_in, n_feat_proj_out, bias=False)
        if self.n_hidden > 0:
            self.mlp = get_linear_layers(
                self.n_hidden * [n_feat_proj_out] + [n_feat_proj_out], norm=False)

    def forward(self, scenepoint_features, view_features, global_features,
                graph: OracleGraph):
        s, v, g = scenepoint_features, view_features, global_features
        if self.normalize_global_features:
            s = F.relu(self.scenepoint_norm_layer(s))
            v = F.relu(self.view_norm_layer(v))
            g = F.relu(self.global_norm_layer(g))
        new = (self.lin_proj(graph.values) + self.lin_scenepoint(s)[graph.pt_idx]
               + self.lin_view(v)[graph.cam_idx] + self.lin_global(g)) / 4
        if self.n_hidden > 0:
            new = self.mlp(F.relu(new))
        return graph.with_values(new)


class ProjLayer(nn.Module):
    """Reference layers.py:959-968."""

    def __init__(self, d_in, d_out):
        super().__init__()
        self.lin_proj = nn.Linear(d_in, d_out)

    def forward(self, graph: OracleGraph):
        return graph.with_values(self.lin_proj(graph.values))


class GraphAttnSfMLayer(nn.Module):
    """Reference layers.py:150-263."""

    def __init__(self, n_feat_proj_in, n_feat_proj_out, n_feat_scenepoint_hidden,
                 n_feat_view_hidden, n_feat_global_hidden,
                 n_feat_proj2scenepoint_agg=None, n_feat_proj2view_agg=None,
                 n_feat_scenepoint2global_agg=None, n_feat_view2global_agg=None,
                 use_norm_proj_update=True, add_residual_skipconn_proj_update=True,
                 n_feat_skipconn_init_projfeat_in=None, n_heads=1, stateful=True,
                 global2view_and_global2scenepoint_enabled=True,
                 n_hidden_layers_scenepoint_update=0, n_hidden_layers_view_update=0,
                 n_hidden_layers_global_update=0, n_hidden_layers_proj_update=0):
        super().__init__()
        self.use_norm_proj_update = use_norm_proj_update
        self.add_residual_skipconn_proj_update = add_residual_skipconn_proj_update
        self.n_skip_in = n_feat_skipconn_init_projfeat_in or 0
        if use_norm_proj_update:
            self.prev_projfeat_norm_layer = nn.LayerNorm(n_feat_proj_in)
        self.global_feature_update = GraphAttnSfMGlobalFeatureUpdate(
            n_feat_proj_in, n_feat_scenepoint_hidden, n_feat_view_hidden,
            n_feat_proj2scenepoint_agg=n_feat_proj2scenepoint_agg,
            n_feat_proj2view_agg=n_feat_proj2view_agg,
            n_feat_global_out=n_feat_global_hidden,
            n_feat_scenepoint2global_agg=n_feat_scenepoint2global_agg,
            n_feat_view2global_agg=n_feat_view2global_agg,
            output_global=True, n_heads=n_heads, stateful=stateful,
            global2view_and_global2scenepoint_enabled=global2view_and_global2scenepoint_enabled,
            n_hidden_layers_scenepoint_update=n_hidden_layers_scenepoint_update,
            n_hidden_layers_view_update=n_hidden_layers_view_update,
            n_hidden_layers_global_update=n_hidden_layers_global_update)
        self.projection_feature_update = GraphAttnSfMProjectionFeatureUpdate(
            n_feat_proj_in + self.n_skip_in, n_feat_scenepoint_hidden,
            n_feat_view_hidden, n_feat_global_hidden, n_feat_proj_out,
            n_hidden_layers_proj_update=n_hidden_layers_proj_update,
            normalize_global_features=True)
        if add_residual_skipconn_proj_update and n_feat_proj_in != n_feat_proj_out:
            if use_norm_proj_update:
                self.residual_skipconn_proj_norm_layer = nn.LayerNorm(n_feat_proj_in)
            self.skip_projection = ProjLayer(n_feat_proj_in, n_feat_proj_out)
        else:
            self.skip_projection = None

    def forward(self, graph: OracleGraph, prev_scenepoint_features=None,
                prev_view_features=None, prev_global_features=None,
                skipconn_init_projfeat=None):
        raw = graph.values
        x = raw
        # NOTE reference layers.py:228-234: when use_norm_proj_update is
        # False there is NO normalization at all — ReLU only.
        if self.use_norm_proj_update:
            x = self.prev_projfeat_norm_layer(x)
        x = F.relu(x)
        norm_graph = graph.with_values(x)
        s, v, g = self.global_feature_update(
            norm_graph, prev_scenepoint_features=prev_scenepoint_features,
            prev_view_features=prev_view_features,
            prev_global_features=prev_global_features)
        e = x
        if self.n_skip_in:
            assert skipconn_init_projfeat is not None
            e = torch.cat([e, skipconn_init_projfeat], dim=-1)
        out = self.projection_feature_update(s, v, g, graph.with_values(e))
        new = out.values
        if self.add_residual_skipconn_proj_update:
            x_skip = raw
            if self.skip_projection is not None:
                if self.use_norm_proj_update:
                    x_skip = F.relu(self.residual_skipconn_proj_norm_layer(x_skip))
                x_skip = self.skip_projection.lin_proj(x_skip)
            new = x_skip + new
        return graph.with_values(new), s, v, g


# ---------------------------------------------------------------------------
# BaseNet heads (reference baseNet.py:8-92; pytorch3d formulas re-derived)
# ---------------------------------------------------------------------------


def quaternion_to_matrix(q):
    r, i, j, k = q.unbind(-1)
    two_s = 2.0 / (q * q).sum(-1)
    o = torch.stack([
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r), two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k), two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r), 1 - two_s * (i * i + j * j),
    ], dim=-1)
    return o.reshape(q.shape[:-1] + (3, 3))


def rotation_6d_to_matrix(d6):
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = F.normalize(a1, dim=-1)
    b2 = F.normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1, dim=-1)
    b3 = torch.cross(b1, b2, dim=-1)
    return torch.stack((b1, b2, b3), dim=-2)


def project_to_rot(m):
    u, s, v = torch.svd(m)
    vt = v.transpose(1, 2)
    det = torch.det(u @ vt).view(-1, 1, 1)
    vt = torch.cat((vt[:, :2, :], vt[:, -1:, :] * det), 1)
    return u @ vt


class BaseNet(nn.Module):
    def __init__(self, calibrated=True, rot_representation="quat", normalize_output=None):
        super().__init__()
        self.calibrated = calibrated
        self.rot_representation = rot_representation
        self.normalize_output = normalize_output
        if calibrated:
            self.out_channels = {"6d": 9, "quat": 7, "svd": 12}[rot_representation]
        else:
            self.out_channels = 12

    def extract_view_outputs(self, x):
        if self.calibrated:
            if self.rot_representation == "6d":
                RTs = rotation_6d_to_matrix(x[:, :6])
            elif self.rot_representation == "svd":
                RTs = project_to_rot(x[:, :9].reshape(-1, 3, 3))
            else:
                RTs = quaternion_to_matrix(x[:, :4])
            Ps = torch.cat((RTs, x[:, -3:].unsqueeze(-1)), dim=-1)
        else:
            Ps = x.reshape(-1, 3, 4)
            if self.normalize_output == "Chirality":
                scale = torch.sign(Ps[:, 0:3, 0:3].det()) / Ps[:, 2, 0:3].norm(dim=1)
                Ps = Ps * scale.reshape(-1, 1, 1)
            elif self.normalize_output == "Differentiable Chirality":
                scale = F.softsign(Ps[:, 0:3, 0:3].det() * 10e3) / Ps[:, 2, 0:3].norm(dim=1)
                Ps = Ps * scale.reshape(-1, 1, 1)
            elif self.normalize_output == "Frobenius":
                Ps = Ps / Ps.norm(dim=(1, 2), p="fro", keepdim=True)
        return {"Ps_norm": Ps}

    def extract_scenepoint_outputs(self, pts_3d):
        ones = torch.ones(1, pts_3d.shape[1], dtype=pts_3d.dtype)
        return {"pts3D": torch.cat((pts_3d, ones), dim=0)}

    def extract_depth_outputs(self, depths):
        return {"depths": depths}


class GraphAttnSfMNet(BaseNet):
    """Reference code/models/graph_attn_sfm.py:8-185."""

    def __init__(self, num_layers, n_heads, n_feat_proj, n_feat_scenepoint,
                 n_feat_view, n_feat_global, calibrated=True,
                 rot_representation="quat", normalize_output=None,
                 pos_emb_n_freq=0, use_norm_proj_update=True,
                 add_residual_skipconn_proj_update=True,
                 add_skipconn_from_init_projfeat=True,
                 stateful_global_features=True,
                 global2view_and_global2scenepoint_enabled=False,
                 n_hidden_layers_scenepoint_update=0, n_hidden_layers_view_update=0,
                 n_hidden_layers_global_update=0, n_hidden_layers_proj_update=0,
                 depth_head_enabled=False, depth_head_n_feat=128,
                 depth_head_n_hidden_layers=2, view_head_enabled=True,
                 view_head_n_hidden_layers=2, scenepoint_head_enabled=True,
                 scenepoint_head_n_hidden_layers=2):
        super().__init__(calibrated, rot_representation, normalize_output)
        self.stateful_global_features = stateful_global_features
        self.add_skipconn_from_init_projfeat = add_skipconn_from_init_projfeat
        self.depth_head_enabled = depth_head_enabled
        self.view_head_enabled = view_head_enabled
        self.scenepoint_head_enabled = scenepoint_head_enabled
        d_in = 2
        self.embed = EmbeddingLayer(pos_emb_n_freq, d_in, post_embed_proj_dim=-1)
        d_emb = self.embed.d_out
        skip_in = d_emb if add_skipconn_from_init_projfeat else 0

        self.equivariant_blocks = nn.ModuleList()
        for i in range(num_layers):
            first = i == 0
            last = i == num_layers - 1
            self.equivariant_blocks.append(GraphAttnSfMLayer(
                d_emb if first else n_feat_proj,
                depth_head_n_feat if depth_head_enabled and last else n_feat_proj,
                n_feat_scenepoint, n_feat_view, n_feat_global,
                use_norm_proj_update=use_norm_proj_update,
                add_residual_skipconn_proj_update=add_residual_skipconn_proj_update,
                n_feat_skipconn_init_projfeat_in=(
                    skip_in if (not first and add_skipconn_from_init_projfeat) else None),
                n_heads=n_heads,
                stateful=False if first else stateful_global_features,
                global2view_and_global2scenepoint_enabled=global2view_and_global2scenepoint_enabled,
                n_hidden_layers_scenepoint_update=n_hidden_layers_scenepoint_update,
                n_hidden_layers_view_update=n_hidden_layers_view_update,
                n_hidden_layers_global_update=n_hidden_layers_global_update,
                n_hidden_layers_proj_update=n_hidden_layers_proj_update))

        if view_head_enabled or scenepoint_head_enabled:
            self.final_global_update = GraphAttnSfMGlobalFeatureUpdate(
                depth_head_n_feat if depth_head_enabled else n_feat_proj,
                n_feat_scenepoint, n_feat_view, n_feat_global_out=n_feat_global,
                output_global=False, n_heads=n_heads,
                stateful=stateful_global_features,
                global2view_and_global2scenepoint_enabled=global2view_and_global2scenepoint_enabled,
                n_hidden_layers_scenepoint_update=n_hidden_layers_scenepoint_update,
                n_hidden_layers_view_update=n_hidden_layers_view_update,
                n_hidden_layers_global_update=n_hidden_layers_global_update)
        if depth_head_enabled:
            self.depth_head = get_linear_layers(
                (1 + depth_head_n_hidden_layers) * [depth_head_n_feat] + [1], norm=False)
        if view_head_enabled:
            self.view_head = get_linear_layers(
                (1 + view_head_n_hidden_layers) * [n_feat_view] + [self.out_channels],
                norm=False)
        if scenepoint_head_enabled:
            self.scenepoint_head = get_linear_layers(
                (1 + scenepoint_head_n_hidden_layers) * [n_feat_scenepoint] + [3],
                norm=False)

    def forward(self, graph: OracleGraph, return_intermediates=False):
        e = self.embed(graph.values)
        graph = graph.with_values(e)
        skip = e if self.add_skipconn_from_init_projfeat else None
        s = v = g = None
        inter = []
        for i, blk in enumerate(self.equivariant_blocks):
            stateful = self.stateful_global_features
            graph, s, v, g = blk(
                graph,
                prev_scenepoint_features=s if stateful else None,
                prev_view_features=v if stateful else None,
                prev_global_features=g if stateful else None,
                skipconn_init_projfeat=(
                    skip if (i > 0 and self.add_skipconn_from_init_projfeat) else None))
            inter.append((graph.values, s, v, g))

        pred = {}
        if self.view_head_enabled or self.scenepoint_head_enabled:
            n_input, m_input = self.final_global_update(
                graph,
                prev_scenepoint_features=s if self.stateful_global_features else None,
                prev_view_features=v if self.stateful_global_features else None,
                prev_global_features=g if self.stateful_global_features else None)
            m_input = F.relu(m_input)
            n_input = F.relu(n_input)
        if self.depth_head_enabled:
            pred.update(self.extract_depth_outputs(self.depth_head(graph.values)[:, 0]))
        if self.view_head_enabled:
            pred.update(self.extract_view_outputs(self.view_head(m_input)))
        if self.scenepoint_head_enabled:
            pred.update(self.extract_scenepoint_outputs(self.scenepoint_head(n_input).T))
        if return_intermediates:
            return pred, inter
        return pred


# ---------------------------------------------------------------------------
# DPESFM (SetOfSet) oracle (reference SetOfSet.py + layers.py:87-147)
# ---------------------------------------------------------------------------


def segment_mean(values, seg_ids, num_segments):
    s = torch.zeros((num_segments, values.shape[1]), dtype=values.dtype)
    s = s.index_add(0, seg_ids, values)
    cnt = torch.zeros((num_segments,), dtype=values.dtype)
    cnt = cnt.index_add(0, seg_ids, torch.ones_like(seg_ids, dtype=values.dtype))
    cnt = torch.where(cnt > 0, cnt, torch.ones_like(cnt))
    return s / cnt[:, None]


class SetOfSetGlobalFeatureUpdate(nn.Module):
    def __init__(self, d_in, d_out, output_global=True):
        super().__init__()
        self.lin_scenepoint = nn.Linear(d_in, d_out)
        self.lin_view = nn.Linear(d_in, d_out)
        self.output_global = output_global
        if output_global:
            self.lin_global = nn.Linear(d_in, d_out)

    def forward(self, graph: OracleGraph):
        s = self.lin_scenepoint(segment_mean(graph.values, graph.pt_idx, graph.n))
        v = self.lin_view(segment_mean(graph.values, graph.cam_idx, graph.m))
        if not self.output_global:
            return s, v
        g = self.lin_global(graph.values.mean(dim=0, keepdim=True))
        return s, v, g


class SetOfSetProjectionFeatureUpdate(nn.Module):
    def __init__(self, d_in, d_out):
        super().__init__()
        self.lin_proj = nn.Linear(d_in, d_out)

    def forward(self, s, v, g, graph: OracleGraph):
        new = (self.lin_proj(graph.values) + s[graph.pt_idx] + v[graph.cam_idx] + g) / 4
        return graph.with_values(new)


class SetOfSetLayer(nn.Module):
    def __init__(self, d_in, d_out):
        super().__init__()
        self.global_feature_update = SetOfSetGlobalFeatureUpdate(d_in, d_out)
        self.projection_feature_update = SetOfSetProjectionFeatureUpdate(d_in, d_out)

    def forward(self, graph: OracleGraph):
        s, v, g = self.global_feature_update(graph)
        return self.projection_feature_update(s, v, g, graph)


class SetOfSetBlock(nn.Module):
    def __init__(self, d_in, d_out, block_size, proj_feat_normalization,
                 add_skipconn_for_residual_blocks):
        super().__init__()
        self.proj_feat_normalization = proj_feat_normalization
        self.add_skipconn = add_skipconn_for_residual_blocks
        self.layers = nn.ModuleList(
            [SetOfSetLayer(d_in, d_out)]
            + [SetOfSetLayer(d_out, d_out) for _ in range(1, block_size)])
        if self.add_skipconn and d_in != d_out:
            self.skip_projection = ProjLayer(d_in, d_out)
        else:
            self.skip_projection = None

    def forward(self, graph: OracleGraph):
        xl = graph
        for i, layer in enumerate(self.layers):
            xl = layer(xl)
            if i < len(self.layers) - 1:
                val = xl.values
                if self.proj_feat_normalization:
                    val = val - val.mean(dim=0, keepdim=True)
                xl = xl.with_values(F.relu(val))
        if self.add_skipconn:
            x_skip = graph.values
            if self.skip_projection is not None:
                x_skip = self.skip_projection.lin_proj(x_skip)
                if self.proj_feat_normalization:
                    x_skip = x_skip - x_skip.mean(dim=0, keepdim=True)
            xl = xl.with_values(x_skip + xl.values)
        return xl.with_values(F.relu(xl.values))


class SetOfSetNet(BaseNet):
    """Reference code/models/SetOfSet.py:49-142."""

    def __init__(self, num_blocks, num_features, block_size, calibrated=True,
                 rot_representation="quat", normalize_output=None,
                 proj_feat_normalization=True, add_skipconn_for_residual_blocks=True,
                 pos_emb_n_freq=0, depth_head_enabled=False, depth_head_n_feat=128,
                 depth_head_n_hidden_layers=2, view_head_enabled=True,
                 view_head_n_hidden_layers=2, scenepoint_head_enabled=True,
                 scenepoint_head_n_hidden_layers=2):
        super().__init__(calibrated, rot_representation, normalize_output)
        self.depth_head_enabled = depth_head_enabled
        self.view_head_enabled = view_head_enabled
        self.scenepoint_head_enabled = scenepoint_head_enabled
        self.embed = EmbeddingLayer(pos_emb_n_freq, 2)
        d_emb = self.embed.d_out
        self.equivariant_blocks = nn.ModuleList()
        for i in range(num_blocks):
            last = i == num_blocks - 1
            self.equivariant_blocks.append(SetOfSetBlock(
                d_emb if i == 0 else num_features,
                depth_head_n_feat if depth_head_enabled and last else num_features,
                block_size, proj_feat_normalization, add_skipconn_for_residual_blocks))
        if view_head_enabled or scenepoint_head_enabled:
            self.final_global_update = SetOfSetGlobalFeatureUpdate(
                num_features, num_features, output_global=False)
        if depth_head_enabled:
            self.depth_head = get_linear_layers(
                (1 + depth_head_n_hidden_layers) * [depth_head_n_feat] + [1], norm=False)
        if view_head_enabled:
            self.view_head = get_linear_layers(
                (1 + view_head_n_hidden_layers) * [num_features] + [self.out_channels],
                norm=False)
        if scenepoint_head_enabled:
            self.scenepoint_head = get_linear_layers(
                (1 + scenepoint_head_n_hidden_layers) * [num_features] + [3], norm=False)

    def forward(self, graph: OracleGraph):
        graph = graph.with_values(self.embed(graph.values))
        for blk in self.equivariant_blocks:
            graph = blk(graph)
        pred = {}
        if self.view_head_enabled or self.scenepoint_head_enabled:
            n_input, m_input = self.final_global_update(graph)
            m_input = F.relu(m_input)
            n_input = F.relu(n_input)
        if self.depth_head_enabled:
            pred.update(self.extract_depth_outputs(self.depth_head(graph.values)[:, 0]))
        if self.view_head_enabled:
            pred.update(self.extract_view_outputs(self.view_head(m_input)))
        if self.scenepoint_head_enabled:
            pred.update(self.extract_scenepoint_outputs(self.scenepoint_head(n_input).T))
        return pred
