"""Model building blocks over the edge-centric graph.

Behavioral parity surface: reference code/models/layers.py (1015 LoC). Every
module documents the reference symbol it reproduces. Aggregations run as
masked segment reductions over the padded edge arrays instead of PyG message
passing, and all shapes are static.

Initializer parity: torch ``nn.Linear`` default init (uniform
+-1/sqrt(fan_in) for weight and bias) for plain linears; PyG's Glorot with
zero bias for the GATv2 linears/attention (PyG GATv2Conv defaults).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from gasfm.graph.view_graph import ViewGraph
from gasfm.models import nn
from gasfm.ops.edge_update import edge_combine
from gasfm.ops.gatv2 import gatv2_attend, gatv2_attend_pool
from gasfm.ops.segment import masked_mean, segment_mean

LN_EPS = 1e-5  # torch nn.LayerNorm default


class TorchDense(nn.Module):
    """Linear layer with torch nn.Linear default initialization."""

    features: int
    use_bias: bool = True

    def __call__(self, x):
        in_dim = x.shape[-1]
        bound = 1.0 / math.sqrt(in_dim)
        kernel = self.param("kernel", nn.initializers.uniform(bound), (in_dim, self.features))
        if kernel.dtype == jnp.bfloat16:
            # bf16 param storage (train.param_dtype): run the dot natively in
            # bf16 with f32 accumulation — a promoted f32 x bf16 dot would
            # materialize an f32 copy of the kernel per use, re-paying the
            # weight traffic the bf16 storage is meant to halve.
            y = jax.lax.dot_general(
                x.astype(jnp.bfloat16), kernel,
                dimension_numbers=(((x.ndim - 1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
        else:
            y = x @ kernel
        if self.use_bias:
            bias = self.param("bias", nn.initializers.uniform(bound), (self.features,))
            y = y + bias
        return y


def layer_norm(name: Optional[str] = None) -> nn.LayerNorm:
    return nn.LayerNorm(epsilon=LN_EPS, name=name)


class MLPStack(nn.Module):
    """Parity: reference ``get_linear_layers`` (code/models/layers.py:10-44).

    feats = (d_in, ..., d_out); LayerNorm+ReLU between layers iff norm=True
    (ReLU always), optional leading/trailing activation blocks.
    """

    feats: Tuple[int, ...]
    init_activation: bool = False
    final_activation: bool = False
    norm: bool = True

    def __call__(self, x):
        assert len(self.feats) >= 2
        if self.init_activation:
            if self.norm:
                x = layer_norm()(x)
            x = nn.relu(x)
        for i in range(len(self.feats) - 2):
            x = TorchDense(self.feats[i + 1])(x)
            if self.norm:
                x = layer_norm()(x)
            x = nn.relu(x)
        x = TorchDense(self.feats[-1])(x)
        if self.final_activation:
            if self.norm:
                x = layer_norm()(x)
            x = nn.relu(x)
        return x


def positional_embed(x: jnp.ndarray, n_freq: int) -> jnp.ndarray:
    """NeRF-style frequency embedding, include-input, log-sampled 2^k freqs.

    Parity: reference code/utils/pos_enc_utils.py:4-58 (ordering: input, then
    per-frequency sin, cos).
    """
    if n_freq <= 0:
        return x
    outs = [x]
    for k in range(n_freq):
        freq = 2.0 ** k
        outs.append(jnp.sin(x * freq))
        outs.append(jnp.cos(x * freq))
    return jnp.concatenate(outs, axis=-1)


def pos_embed_dim(in_dim: int, n_freq: int) -> int:
    return in_dim if n_freq <= 0 else in_dim * (1 + 2 * n_freq)


class EmbeddingLayer(nn.Module):
    """Parity: reference ``EmbeddingLayer`` (code/models/layers.py:992-1015)."""

    pos_emb_n_freq: int
    post_embed_proj_dim: Optional[int] = None  # -1 => keep embedding width

    def __call__(self, x):
        x = positional_embed(x, self.pos_emb_n_freq)
        if self.post_embed_proj_dim is not None:
            d = x.shape[-1] if self.post_embed_proj_dim == -1 else self.post_embed_proj_dim
            x = TorchDense(d, name="post_embed_lin")(x)
        return x


class GATv2SegmentConv(nn.Module):
    """PyG GATv2Conv(add_self_loops=False) over star graphs.

    Source nodes = rows of ``x_src``; each attends into its segment's single
    aggregation node whose (optional) query features are ``query``.
    Parity: PyG GATv2Conv as instantiated in reference layers.py:304-309.

    setup-style with split ``transform_src`` / ``transform_dst`` /
    ``add_bias`` methods so a parent can run the attention itself
    (:meth:`AxialAttentionAggregator.prepare`).
    """

    in_feat: int
    out_per_head: int
    heads: int

    def setup(self):
        H, C = self.heads, self.out_per_head
        glorot = nn.initializers.glorot_uniform()
        self.lin_l_kernel = self.param("lin_l_kernel", glorot, (self.in_feat, H * C))
        self.lin_l_bias = self.param("lin_l_bias", nn.initializers.zeros, (H * C,))
        self.lin_r_kernel = self.param("lin_r_kernel", glorot, (self.in_feat, H * C))
        self.lin_r_bias = self.param("lin_r_bias", nn.initializers.zeros, (H * C,))
        self.att = self.param("att", glorot, (H, C))
        self.bias = self.param("bias", nn.initializers.zeros, (H * C,))

    def transform_src(self, x_src: jnp.ndarray) -> jnp.ndarray:
        H, C = self.heads, self.out_per_head
        return (x_src @ self.lin_l_kernel + self.lin_l_bias).reshape(-1, H, C)

    def transform_dst(self, query: Optional[jnp.ndarray], num_segments: int) -> jnp.ndarray:
        H, C = self.heads, self.out_per_head
        if query is None:
            return jnp.broadcast_to(
                self.lin_r_bias, (num_segments, H * C)
            ).reshape(num_segments, H, C)
        return (query @ self.lin_r_kernel + self.lin_r_bias).reshape(num_segments, H, C)

    def add_bias(self, out: jnp.ndarray) -> jnp.ndarray:
        num_segments = out.shape[0]
        return out.reshape(num_segments, self.heads * self.out_per_head) + self.bias

    def __call__(
        self,
        x_src: jnp.ndarray,  # (E, in_feat)
        seg_ids: jnp.ndarray,  # (E,)
        num_segments: int,
        query: Optional[jnp.ndarray] = None,  # (S, in_feat); zeros if None
        edge_mask: Optional[jnp.ndarray] = None,
        indices_are_sorted: bool = False,
    ) -> jnp.ndarray:
        xl = self.transform_src(x_src)
        xr = self.transform_dst(query, num_segments)
        if num_segments == 1:
            # Single-aggregation-node pool (view->global / point->global):
            # dense masked softmax + matmul; seg_ids routing invalid rows to
            # a trash segment is subsumed by the mask.
            row_mask = seg_ids == 0
            if edge_mask is not None:
                row_mask = jnp.logical_and(row_mask, edge_mask)
            from gasfm.ops.segment import current_edge_axis, is_table_sharded

            axis = current_edge_axis()
            if axis is not None and is_table_sharded():
                # Table-sharded pool: the caller already restricted
                # edge_mask to this shard's OWNED rows; combine the softmax
                # triples across shards (O(H*C) collective volume).
                from gasfm.ops.gatv2 import gatv2_attend_pool_sharded

                out = gatv2_attend_pool_sharded(xl, xr, self.att, row_mask, axis)
            else:
                out = gatv2_attend_pool(xl, xr, self.att, row_mask)
        else:
            out = gatv2_attend(
                xl, xr, self.att, seg_ids, num_segments,
                edge_mask=edge_mask, indices_are_sorted=indices_are_sorted,
            )
        return self.add_bias(out)


def default_agg_width(in_feat: int, heads: int) -> int:
    """Aggregation width defaulting rule (reference layers.py:287-291)."""
    agg = in_feat
    if agg % heads:
        agg += heads - (agg % heads)
    return agg


class QueryAdapter(nn.Module):
    """LN + ReLU (+ Linear if widths differ): the stateful-attention query
    path (reference ``norm_and_proj_*`` Sequentials, layers.py:295-303)."""

    project_to: Optional[int]  # None => no linear

    def __call__(self, x):
        x = layer_norm()(x)
        x = nn.relu(x)
        if self.project_to is not None:
            x = TorchDense(self.project_to)(x)
        return x


class AxialAttentionAggregator(nn.Module):
    """Edge->node attention aggregation with residual MLP head.

    Parity: reference ``Proj2View`` (layers.py:266-361) and
    ``Proj2ScenePoint`` (layers.py:363-458) — both have identical structure,
    differing only in which axis the segments run over; the parent runs the
    attention between :meth:`prepare` and :meth:`finish` with its own
    segment ids.
    """

    in_feat: int
    out_feat: int
    n_heads: int
    stateful: bool = True
    agg_feat: Optional[int] = None
    n_hidden_layers: int = 0
    use_norm_pre_mlp: bool = True

    def setup(self):
        agg = self.agg_feat if self.agg_feat is not None else default_agg_width(
            self.in_feat, self.n_heads
        )
        assert agg % self.n_heads == 0
        self.agg = agg
        self.query_adapter = (
            QueryAdapter(
                project_to=self.in_feat if self.in_feat != self.out_feat else None
            )
            if self.stateful
            else None
        )
        self.graph_conv = GATv2SegmentConv(self.in_feat, agg // self.n_heads, self.n_heads)
        self.proj_agg = TorchDense(self.out_feat) if agg != self.out_feat else None
        self.norm_pre_mlp = layer_norm() if self.use_norm_pre_mlp else None
        self.mlp = MLPStack(tuple([self.out_feat] * (2 + self.n_hidden_layers)), norm=False)

    def prepare(self, x_edges: jnp.ndarray, num_segments: int, prev):
        """Source/query transforms of the attention half: (xl, xr, att)."""
        query = self.query_adapter(prev) if self.stateful else None
        xl = self.graph_conv.transform_src(x_edges)
        xr = self.graph_conv.transform_dst(query, num_segments)
        return xl, xr, self.graph_conv.att

    def finish(self, aggregated: jnp.ndarray, prev) -> jnp.ndarray:
        """Everything after the aggregation: bias, width adapter, residual,
        LN+ReLU+MLP with second residual (reference layers.py:344-357)."""
        x = self.graph_conv.add_bias(aggregated)
        if self.proj_agg is not None:
            x = self.proj_agg(x)
        if prev is not None:
            x = prev + x

        x_skip = x
        if self.norm_pre_mlp is not None:
            x = self.norm_pre_mlp(x)
            x = nn.relu(x)
        x = self.mlp(x)
        return x_skip + x


class ViewAndScenePoint2Global(nn.Module):
    """Two single-segment attention pools (views -> global, points -> global)
    concatenated. Parity: reference layers.py:460-603."""

    n_feat_scenepoint_in: int
    n_feat_view_in: int
    n_feat_global_out: int
    n_heads: int
    stateful: bool = True
    n_feat_scenepoint2global_agg: Optional[int] = None
    n_feat_view2global_agg: Optional[int] = None
    n_hidden_layers: int = 0
    use_norm_pre_mlp: bool = True

    def __call__(
        self,
        view_features: jnp.ndarray,  # (M, dv)
        scenepoint_features: jnp.ndarray,  # (N, ds)
        cam_valid: jnp.ndarray,  # (M,) bool
        pt_valid: jnp.ndarray,  # (N,) bool
        prev_global: Optional[jnp.ndarray] = None,  # (1, dg)
    ) -> jnp.ndarray:
        assert self.stateful == (prev_global is not None)
        v2g = self.n_feat_view2global_agg or default_agg_width(self.n_feat_view_in, self.n_heads)
        s2g = self.n_feat_scenepoint2global_agg or default_agg_width(
            self.n_feat_scenepoint_in, self.n_heads
        )

        q_view = q_pt = None
        if self.stateful:
            q_view = QueryAdapter(
                project_to=self.n_feat_view_in if self.n_feat_view_in != self.n_feat_global_out else None,
                name="query_adapter_view",
            )(prev_global)
            q_pt = QueryAdapter(
                project_to=self.n_feat_scenepoint_in
                if self.n_feat_scenepoint_in != self.n_feat_global_out
                else None,
                name="query_adapter_scenepoint",
            )(prev_global)

        # One segment (id 0); invalid rows routed to the trash segment (id 1).
        view_seg = jnp.where(cam_valid, 0, 1).astype(jnp.int32)
        pt_seg = jnp.where(pt_valid, 0, 1).astype(jnp.int32)

        # The VIEW pool reduces over the replicated camera-side table, so
        # edge-axis collectives are disabled (every edge shard computes the
        # identical full reduction). The POINT pool: likewise when tables
        # are replicated; under TABLE SHARDING each shard pools only its
        # OWNED point rows and the triples combine across shards.
        from gasfm.ops.segment import (
            edge_replicated,
            is_table_sharded,
            table_shard_owned,
        )

        with edge_replicated():
            view_pooled = GATv2SegmentConv(
                self.n_feat_view_in, v2g // self.n_heads, self.n_heads,
                name="graph_conv_view2global",
            )(view_features, view_seg, 1, query=q_view, edge_mask=cam_valid)  # (1, v2g)
        pt_conv = GATv2SegmentConv(
            self.n_feat_scenepoint_in, s2g // self.n_heads, self.n_heads,
            name="graph_conv_scenepoint2global",
        )
        if is_table_sharded():
            owned = table_shard_owned()
            pt_pooled = pt_conv(
                scenepoint_features, pt_seg, 1, query=q_pt,
                edge_mask=jnp.logical_and(pt_valid, owned),
            )  # (1, s2g)
        else:
            with edge_replicated():
                pt_pooled = pt_conv(
                    scenepoint_features, pt_seg, 1, query=q_pt, edge_mask=pt_valid
                )  # (1, s2g)

        x = jnp.concatenate([view_pooled, pt_pooled], axis=1)
        if (v2g + s2g) != self.n_feat_global_out:
            x = TorchDense(self.n_feat_global_out, name="proj_global")(x)
        if prev_global is not None:
            x = prev_global + x

        x_skip = x
        if self.use_norm_pre_mlp:
            x = layer_norm(name="norm_pre_mlp")(x)
            x = nn.relu(x)
        x = MLPStack(
            tuple([self.n_feat_global_out] * (2 + self.n_hidden_layers)), norm=False, name="mlp"
        )(x)
        return x_skip + x


class GlobalBroadcastUpdate(nn.Module):
    """Global -> per-view / per-point residual broadcast update.

    Parity: reference ``Global2View`` / ``Global2ScenePoint``
    (layers.py:605-721). Disabled in all shipped confs but part of the
    capability surface.
    """

    n_feat_in_out: int
    n_hidden_layers: int = 0
    use_norm: bool = True

    def __call__(self, global_features: jnp.ndarray, prev: jnp.ndarray) -> jnp.ndarray:
        x = prev
        if self.use_norm:
            x = layer_norm(name="node_norm")(x)
            x = nn.relu(x)
        x = TorchDense(self.n_feat_in_out, name="lin_node")(x)
        g = global_features
        if self.use_norm:
            g = layer_norm(name="global_norm")(g)
            g = nn.relu(g)
        g = TorchDense(self.n_feat_in_out, use_bias=False, name="lin_global")(g)
        x = x + g
        if self.n_hidden_layers > 0:
            x = nn.relu(x)
            x = MLPStack(
                tuple([self.n_feat_in_out] * self.n_hidden_layers + [self.n_feat_in_out]),
                norm=False,
                name="mlp",
            )(x)
        return prev + x


class GraphAttnGlobalFeatureUpdate(nn.Module):
    """Composes the three aggregators + optional global broadcasts.

    Parity: reference ``GraphAttnSfMGlobalFeatureUpdate``
    (layers.py:723-870).
    """

    n_feat_proj_in: int
    n_feat_scenepoint_out: int
    n_feat_view_out: int
    n_feat_global_out: Optional[int] = None
    n_feat_proj2scenepoint_agg: Optional[int] = None
    n_feat_proj2view_agg: Optional[int] = None
    n_feat_scenepoint2global_agg: Optional[int] = None
    n_feat_view2global_agg: Optional[int] = None
    output_global: bool = True
    n_heads: int = 1
    stateful: bool = True
    global2view_and_global2scenepoint_enabled: bool = True
    n_hidden_layers_scenepoint_update: int = 0
    n_hidden_layers_view_update: int = 0
    n_hidden_layers_global_update: int = 0

    def __call__(
        self,
        x_edges: jnp.ndarray,  # (E, d) edge features
        graph: ViewGraph,
        prev_scenepoint_features: Optional[jnp.ndarray] = None,
        prev_view_features: Optional[jnp.ndarray] = None,
        prev_global_features: Optional[jnp.ndarray] = None,
    ):
        need_global = self.output_global or self.global2view_and_global2scenepoint_enabled
        if need_global:
            assert self.n_feat_global_out is not None

        proj2scenepoint = AxialAttentionAggregator(
            self.n_feat_proj_in,
            self.n_feat_scenepoint_out,
            self.n_heads,
            stateful=self.stateful,
            agg_feat=self.n_feat_proj2scenepoint_agg,
            n_hidden_layers=self.n_hidden_layers_scenepoint_update,
            name="proj2scenepoint",
        )
        proj2view = AxialAttentionAggregator(
            self.n_feat_proj_in,
            self.n_feat_view_out,
            self.n_heads,
            stateful=self.stateful,
            agg_feat=self.n_feat_proj2view_agg,
            n_hidden_layers=self.n_hidden_layers_view_update,
            name="proj2view",
        )
        assert self.stateful == (prev_scenepoint_features is not None)
        assert self.stateful == (prev_view_features is not None)
        # Edges are sorted by point id (blocked point-major layout), not by
        # camera id.
        xl_p, xr_p, att_p = proj2scenepoint.prepare(
            x_edges, graph.num_pts, prev_scenepoint_features
        )
        agg_p = gatv2_attend(
            xl_p, xr_p, att_p, graph.pt_idx, graph.num_pts,
            edge_mask=graph.edge_mask, indices_are_sorted=True,
        )
        xl_c, xr_c, att_c = proj2view.prepare(x_edges, graph.num_cams, prev_view_features)
        agg_c = gatv2_attend(
            xl_c, xr_c, att_c, graph.cam_idx, graph.num_cams, edge_mask=graph.edge_mask,
        )
        scenepoint_features = proj2scenepoint.finish(agg_p, prev_scenepoint_features)
        view_features = proj2view.finish(agg_c, prev_view_features)

        global_features = None
        if need_global:
            global_features = ViewAndScenePoint2Global(
                self.n_feat_scenepoint_out,
                self.n_feat_view_out,
                self.n_feat_global_out,
                self.n_heads,
                stateful=self.stateful,
                n_feat_scenepoint2global_agg=self.n_feat_scenepoint2global_agg,
                n_feat_view2global_agg=self.n_feat_view2global_agg,
                n_hidden_layers=self.n_hidden_layers_global_update,
                name="view_and_scenepoint2global",
            )(
                view_features,
                scenepoint_features,
                graph.cam_valid,
                graph.pt_valid,
                prev_global=prev_global_features,
            )

        if self.global2view_and_global2scenepoint_enabled:
            scenepoint_features = GlobalBroadcastUpdate(
                self.n_feat_scenepoint_out,
                n_hidden_layers=self.n_hidden_layers_scenepoint_update,
                name="global2scenepoint",
            )(global_features, scenepoint_features)
            view_features = GlobalBroadcastUpdate(
                self.n_feat_view_out,
                n_hidden_layers=self.n_hidden_layers_view_update,
                name="global2view",
            )(global_features, view_features)

        if not self.output_global:
            return scenepoint_features, view_features
        return scenepoint_features, view_features, global_features


class ProjectionFeatureUpdate(nn.Module):
    """Gather-broadcast edge update
    ``(lin_p(e) + lin_s(s)[pt] + lin_v(v)[cam] + lin_g(g)) / 4``.

    Parity: reference ``GraphAttnSfMProjectionFeatureUpdate``
    (layers.py:873-956).
    """

    n_feat_proj_out: int
    n_hidden_layers: int = 0
    normalize_global_features: bool = True

    def __call__(
        self,
        scenepoint_features: jnp.ndarray,  # (N, ds)
        view_features: jnp.ndarray,  # (M, dv)
        global_features: jnp.ndarray,  # (1, dg)
        x_edges: jnp.ndarray,  # (E, de) normalized
        graph: ViewGraph,
    ) -> jnp.ndarray:
        s, v, g = scenepoint_features, view_features, global_features
        if self.normalize_global_features:
            s = nn.relu(layer_norm(name="scenepoint_norm")(s))
            v = nn.relu(layer_norm(name="view_norm")(v))
            g = nn.relu(layer_norm(name="global_norm")(g))

        ps = TorchDense(self.n_feat_proj_out, use_bias=False, name="lin_scenepoint")(s)
        pv = TorchDense(self.n_feat_proj_out, use_bias=False, name="lin_view")(v)
        pg = TorchDense(self.n_feat_proj_out, use_bias=False, name="lin_global")(g)
        pe = TorchDense(self.n_feat_proj_out, name="lin_proj")(x_edges)
        new = edge_combine(pe, ps, pv, pg, graph)
        if self.n_hidden_layers > 0:
            new = nn.relu(new)
            new = MLPStack(
                tuple([self.n_feat_proj_out] * self.n_hidden_layers + [self.n_feat_proj_out]),
                norm=False,
                name="mlp",
            )(new)
        return new


def normalize_edge_features(
    x: jnp.ndarray, edge_mask: jnp.ndarray, norm: Optional[nn.Module]
) -> jnp.ndarray:
    """LayerNorm per edge, or masked mean-centering over valid edges.

    Parity: reference ``normalize_projection_features`` (layers.py:972-979).
    """
    if norm is not None:
        return norm(x)
    mean = masked_mean(x, edge_mask, axis=0)
    return x - mean[None, :]


class GraphAttnLayer(nn.Module):
    """One GASFM message-passing round.

    Parity: reference ``GraphAttnSfMLayer`` (layers.py:150-263): LN+ReLU on
    edge features -> global feature update -> optional init-embedding concat
    -> edge update -> residual (with projected skip when widths differ).
    """

    n_feat_proj_in: int
    n_feat_proj_out: int
    n_feat_scenepoint_hidden: int
    n_feat_view_hidden: int
    n_feat_global_hidden: int
    n_feat_proj2scenepoint_agg: Optional[int] = None
    n_feat_proj2view_agg: Optional[int] = None
    n_feat_scenepoint2global_agg: Optional[int] = None
    n_feat_view2global_agg: Optional[int] = None
    use_norm_proj_update: bool = True
    add_residual_skipconn_proj_update: bool = True
    n_feat_skipconn_init_projfeat_in: Optional[int] = None
    n_heads: int = 1
    stateful: bool = True
    global2view_and_global2scenepoint_enabled: bool = True
    n_hidden_layers_scenepoint_update: int = 0
    n_hidden_layers_view_update: int = 0
    n_hidden_layers_global_update: int = 0
    n_hidden_layers_proj_update: int = 0

    def __call__(
        self,
        prev_projection_features: jnp.ndarray,  # (E, d_in)
        graph: ViewGraph,
        prev_scenepoint_features: Optional[jnp.ndarray] = None,
        prev_view_features: Optional[jnp.ndarray] = None,
        prev_global_features: Optional[jnp.ndarray] = None,
        skipconn_init_projfeat: Optional[jnp.ndarray] = None,
    ):
        raw = prev_projection_features
        if self.use_norm_proj_update:
            # The LayerNorm's params sit on the layer itself (the tree
            # layout of existing checkpoints), hence the functional form.
            d_in = raw.shape[-1]
            scale = self.param("prev_projfeat_norm_scale", nn.initializers.ones, (d_in,))
            bias = self.param("prev_projfeat_norm_bias", nn.initializers.zeros, (d_in,))
            x = nn.relu(nn.normalize(raw, scale, bias, LN_EPS))
        else:
            # Parity (reference layers.py:228-234): with use_norm_proj_update
            # False the edge features get ReLU only — no normalization.
            x = nn.relu(raw)
        s, v, g = GraphAttnGlobalFeatureUpdate(
            self.n_feat_proj_in,
            self.n_feat_scenepoint_hidden,
            self.n_feat_view_hidden,
            n_feat_global_out=self.n_feat_global_hidden,
            n_feat_proj2scenepoint_agg=self.n_feat_proj2scenepoint_agg,
            n_feat_proj2view_agg=self.n_feat_proj2view_agg,
            n_feat_scenepoint2global_agg=self.n_feat_scenepoint2global_agg,
            n_feat_view2global_agg=self.n_feat_view2global_agg,
            output_global=True,
            n_heads=self.n_heads,
            stateful=self.stateful,
            global2view_and_global2scenepoint_enabled=self.global2view_and_global2scenepoint_enabled,
            n_hidden_layers_scenepoint_update=self.n_hidden_layers_scenepoint_update,
            n_hidden_layers_view_update=self.n_hidden_layers_view_update,
            n_hidden_layers_global_update=self.n_hidden_layers_global_update,
            name="global_feature_update",
        )(
            x,
            graph,
            prev_scenepoint_features=prev_scenepoint_features,
            prev_view_features=prev_view_features,
            prev_global_features=prev_global_features,
        )

        e = x
        if self.n_feat_skipconn_init_projfeat_in is not None:
            assert skipconn_init_projfeat is not None
            assert skipconn_init_projfeat.shape[-1] == self.n_feat_skipconn_init_projfeat_in
            e = jnp.concatenate([e, skipconn_init_projfeat], axis=-1)

        e = ProjectionFeatureUpdate(
            self.n_feat_proj_out,
            n_hidden_layers=self.n_hidden_layers_proj_update,
            normalize_global_features=True,
            name="projection_feature_update",
        )(s, v, g, e, graph)

        if self.add_residual_skipconn_proj_update:
            x_skip = raw
            if self.n_feat_proj_in != self.n_feat_proj_out:
                if self.use_norm_proj_update:
                    x_skip = layer_norm(name="residual_skipconn_proj_norm")(x_skip)
                    x_skip = nn.relu(x_skip)
                x_skip = TorchDense(self.n_feat_proj_out, name="skip_projection")(x_skip)
            e = x_skip + e

        return e, s, v, g


# ---------------------------------------------------------------------------
# DPESFM (SetOfSet) blocks
# ---------------------------------------------------------------------------


class SetOfSetGlobalFeatureUpdate(nn.Module):
    """Per-point / per-view / global means through linears.

    Parity: reference layers.py:100-126.
    """

    d_out: int
    output_global: bool = True

    def __call__(self, x_edges: jnp.ndarray, graph: ViewGraph):
        mean_colwise = segment_mean(
            x_edges, graph.pt_idx, graph.num_pts, edge_mask=graph.edge_mask,
            indices_are_sorted=True,
        )  # (N, d)
        scenepoint_features = TorchDense(self.d_out, name="lin_scenepoint")(mean_colwise)
        mean_rowwise = segment_mean(
            x_edges, graph.cam_idx, graph.num_cams, edge_mask=graph.edge_mask
        )  # (M, d)
        view_features = TorchDense(self.d_out, name="lin_view")(mean_rowwise)
        if not self.output_global:
            return scenepoint_features, view_features
        global_mean = masked_mean(x_edges, graph.edge_mask, axis=0)[None, :]
        global_features = TorchDense(self.d_out, name="lin_global")(global_mean)
        return scenepoint_features, view_features, global_features


class SetOfSetLayer(nn.Module):
    """Parity: reference ``SetOfSetLayer`` (layers.py:87-97)."""

    d_out: int

    def __call__(self, x_edges: jnp.ndarray, graph: ViewGraph) -> jnp.ndarray:
        s, v, g = SetOfSetGlobalFeatureUpdate(self.d_out, name="global_feature_update")(
            x_edges, graph
        )
        pe = TorchDense(self.d_out, name="lin_proj")(x_edges)
        return edge_combine(pe, s, v, g, graph)


class SetOfSetBlock(nn.Module):
    """Parity: reference ``SetOfSetBlock`` (code/models/SetOfSet.py:7-46)."""

    d_in: int
    d_out: int
    block_size: int
    proj_feat_normalization: bool
    add_skipconn_for_residual_blocks: bool

    def __call__(self, x_edges: jnp.ndarray, graph: ViewGraph) -> jnp.ndarray:
        xl = x_edges
        for i in range(self.block_size):
            xl = SetOfSetLayer(self.d_out, name=f"layers_{i}")(xl, graph)
            if i < self.block_size - 1:
                if self.proj_feat_normalization:
                    xl = normalize_edge_features(xl, graph.edge_mask, None)
                xl = nn.relu(xl)
        if self.add_skipconn_for_residual_blocks:
            x_skip = x_edges
            if self.d_in != self.d_out:
                x_skip = TorchDense(self.d_out, name="skip_projection")(x_skip)
                if self.proj_feat_normalization:
                    x_skip = normalize_edge_features(x_skip, graph.edge_mask, None)
            xl = x_skip + xl
        return nn.relu(xl)


class Parameter3DPts(nn.Module):
    """Learnable bank of 3D points, normal-initialized with sigma=0.1.

    Parity: reference ``Parameter3DPts`` (code/models/layers.py:47-57) —
    unused by the shipped confs but part of the capability surface (direct
    structure optimization without a scenepoint head).
    """

    n_pts: int

    def __call__(self) -> jnp.ndarray:
        return self.param(
            "pts_3d", nn.initializers.normal(stddev=0.1), (3, self.n_pts)
        )
