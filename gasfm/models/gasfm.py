"""GASFM: the graph-attention SfM network.

Parity: reference ``GraphAttnSfMNet`` (code/models/graph_attn_sfm.py:8-185).
Four feature streams (per-edge projection, per-point, per-view, global),
``num_layers`` attention rounds with optional stateful global features and an
init-embedding skip concat, a final global update without the global stream,
then view / scenepoint / depth heads.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from gasfm.graph.view_graph import ViewGraph
from gasfm.models import nn
from gasfm.models.heads import (
    decode_scenepoint_outputs,
    decode_view_outputs,
    view_head_out_channels,
)
from gasfm.models.layers import (
    EmbeddingLayer,
    GraphAttnGlobalFeatureUpdate,
    GraphAttnLayer,
    MLPStack,
    pos_embed_dim,
)


class GraphAttnSfMNet(nn.Module):
    num_layers: int
    n_heads: int
    n_feat_proj: int
    n_feat_scenepoint: int
    n_feat_view: int
    n_feat_global: int
    calibrated: bool = True
    rot_representation: str = "quat"
    normalize_output: Optional[str] = None
    n_feat_proj2scenepoint_agg: Optional[int] = None
    n_feat_proj2view_agg: Optional[int] = None
    n_feat_scenepoint2global_agg: Optional[int] = None
    n_feat_view2global_agg: Optional[int] = None
    n_hidden_layers_scenepoint_update: int = 0
    n_hidden_layers_view_update: int = 0
    n_hidden_layers_global_update: int = 0
    n_hidden_layers_proj_update: int = 0
    pos_emb_n_freq: int = 0
    use_norm_proj_update: bool = True
    add_residual_skipconn_proj_update: bool = True
    add_skipconn_from_init_projfeat: bool = True
    stateful_global_features: bool = True
    global2view_and_global2scenepoint_enabled: bool = False
    depth_head_enabled: bool = False
    depth_head_n_feat: int = 128
    depth_head_n_hidden_layers: int = 2
    view_head_enabled: bool = True
    view_head_n_hidden_layers: int = 2
    scenepoint_head_enabled: bool = True
    scenepoint_head_n_hidden_layers: int = 2
    # Rematerialize each attention round in the backward pass: the jitted
    # train step then saves only the per-layer boundary streams instead of
    # every E-sized internal residual, trading ~1 extra forward of recompute
    # for O(num_layers) less activation memory, so larger scenes fit on one
    # device (the reference OOM-skips them, code/train.py:225-248).
    # Conf key: model.remat_layers.
    remat_layers: bool = False

    def __call__(self, graph: ViewGraph) -> Dict[str, Any]:
        d_in = 2
        d_emb = pos_embed_dim(d_in, self.pos_emb_n_freq)

        e = EmbeddingLayer(self.pos_emb_n_freq, post_embed_proj_dim=-1, name="embed")(graph.uv)
        skip_init = e if self.add_skipconn_from_init_projfeat else None

        layer_cls = nn.remat(GraphAttnLayer) if self.remat_layers else GraphAttnLayer

        s = v = g = None
        for i in range(self.num_layers):
            first = i == 0
            last = i == self.num_layers - 1
            e, s, v, g = layer_cls(
                n_feat_proj_in=d_emb if first else self.n_feat_proj,
                n_feat_proj_out=(
                    self.depth_head_n_feat if self.depth_head_enabled and last
                    else self.n_feat_proj
                ),
                n_feat_scenepoint_hidden=self.n_feat_scenepoint,
                n_feat_view_hidden=self.n_feat_view,
                n_feat_global_hidden=self.n_feat_global,
                n_feat_proj2scenepoint_agg=self.n_feat_proj2scenepoint_agg,
                n_feat_proj2view_agg=self.n_feat_proj2view_agg,
                n_feat_scenepoint2global_agg=self.n_feat_scenepoint2global_agg,
                n_feat_view2global_agg=self.n_feat_view2global_agg,
                use_norm_proj_update=self.use_norm_proj_update,
                add_residual_skipconn_proj_update=self.add_residual_skipconn_proj_update,
                n_feat_skipconn_init_projfeat_in=(
                    d_emb if (not first and self.add_skipconn_from_init_projfeat) else None
                ),
                n_heads=self.n_heads,
                stateful=False if first else self.stateful_global_features,
                global2view_and_global2scenepoint_enabled=self.global2view_and_global2scenepoint_enabled,
                n_hidden_layers_scenepoint_update=self.n_hidden_layers_scenepoint_update,
                n_hidden_layers_view_update=self.n_hidden_layers_view_update,
                n_hidden_layers_global_update=self.n_hidden_layers_global_update,
                n_hidden_layers_proj_update=self.n_hidden_layers_proj_update,
                name=f"equivariant_blocks_{i}",
            )(
                e,
                graph,
                prev_scenepoint_features=s if self.stateful_global_features else None,
                prev_view_features=v if self.stateful_global_features else None,
                prev_global_features=g if self.stateful_global_features else None,
                skipconn_init_projfeat=(
                    skip_init if (not first and self.add_skipconn_from_init_projfeat) else None
                ),
            )

        pred: Dict[str, Any] = {}

        if self.view_head_enabled or self.scenepoint_head_enabled:
            if not self.view_head_enabled and self.scenepoint_head_enabled:
                raise NotImplementedError(
                    "Final aggregation for scenepoint features alone is not implemented."
                )
            proj_feat_final = (
                self.depth_head_n_feat if self.depth_head_enabled else self.n_feat_proj
            )
            n_input, m_input = GraphAttnGlobalFeatureUpdate(
                proj_feat_final,
                self.n_feat_scenepoint,
                self.n_feat_view,
                n_feat_global_out=self.n_feat_global,
                n_feat_proj2scenepoint_agg=self.n_feat_proj2scenepoint_agg,
                n_feat_proj2view_agg=self.n_feat_proj2view_agg,
                n_feat_scenepoint2global_agg=self.n_feat_scenepoint2global_agg,
                n_feat_view2global_agg=self.n_feat_view2global_agg,
                output_global=False,
                n_heads=self.n_heads,
                stateful=self.stateful_global_features,
                global2view_and_global2scenepoint_enabled=self.global2view_and_global2scenepoint_enabled,
                n_hidden_layers_scenepoint_update=self.n_hidden_layers_scenepoint_update,
                n_hidden_layers_view_update=self.n_hidden_layers_view_update,
                n_hidden_layers_global_update=self.n_hidden_layers_global_update,
                name="final_global_update",
            )(
                e,
                graph,
                prev_scenepoint_features=s if self.stateful_global_features else None,
                prev_view_features=v if self.stateful_global_features else None,
                prev_global_features=g if self.stateful_global_features else None,
            )
            m_input = nn.relu(m_input)
            n_input = nn.relu(n_input)

        if self.depth_head_enabled:
            depths = MLPStack(
                tuple([self.depth_head_n_feat] * (1 + self.depth_head_n_hidden_layers) + [1]),
                norm=False,
                name="depth_head",
            )(e)
            pred["depths"] = depths[:, 0]  # (E,) per-edge depths

        if self.view_head_enabled:
            out_ch = view_head_out_channels(self.calibrated, self.rot_representation)
            m_out = MLPStack(
                tuple([self.n_feat_view] * (1 + self.view_head_n_hidden_layers) + [out_ch]),
                norm=False,
                name="view_head",
            )(m_input)
            pred["Ps_norm"] = decode_view_outputs(
                m_out,
                self.calibrated,
                self.rot_representation,
                self.normalize_output,
                cam_mask=graph.cam_mask,
            )

        if self.scenepoint_head_enabled:
            n_out = MLPStack(
                tuple([self.n_feat_scenepoint] * (1 + self.scenepoint_head_n_hidden_layers) + [3]),
                norm=False,
                name="scenepoint_head",
            )(n_input).T  # (3, N)
            pred["pts3D"] = decode_scenepoint_outputs(n_out)

        return pred

    @staticmethod
    def from_conf(conf) -> "GraphAttnSfMNet":
        """Build from a HOCON config (parity: graph_attn_sfm.py:9-41)."""
        return GraphAttnSfMNet(
            num_layers=conf.get_int("model.num_layers"),
            n_heads=conf.get_int("model.n_heads"),
            n_feat_proj=conf.get_int("model.n_feat_proj"),
            n_feat_scenepoint=conf.get_int("model.n_feat_scenepoint"),
            n_feat_view=conf.get_int("model.n_feat_view"),
            n_feat_global=conf.get_int("model.n_feat_global"),
            calibrated=conf.get_bool("dataset.calibrated"),
            rot_representation=conf.get_string("model.view_head.rot_representation", default="quat"),
            normalize_output=conf.get_string("model.view_head.normalize_output", default=None),
            n_feat_proj2scenepoint_agg=conf.get_int("model.n_feat_proj2scenepoint_agg", default=None),
            n_feat_proj2view_agg=conf.get_int("model.n_feat_proj2view_agg", default=None),
            n_feat_scenepoint2global_agg=conf.get_int(
                "model.n_feat_scenepoint2global_agg", default=None
            ),
            n_feat_view2global_agg=conf.get_int("model.n_feat_view2global_agg", default=None),
            n_hidden_layers_scenepoint_update=conf.get_int("model.n_hidden_layers_scenepoint_update"),
            n_hidden_layers_view_update=conf.get_int("model.n_hidden_layers_view_update"),
            n_hidden_layers_global_update=conf.get_int("model.n_hidden_layers_global_update"),
            n_hidden_layers_proj_update=conf.get_int("model.n_hidden_layers_proj_update"),
            pos_emb_n_freq=conf.get_int("model.pos_emb_n_freq"),
            use_norm_proj_update=conf.get_bool("model.use_norm_proj_update"),
            add_residual_skipconn_proj_update=conf.get_bool(
                "model.add_residual_skipconn_proj_update"
            ),
            add_skipconn_from_init_projfeat=conf.get_bool("model.add_skipconn_from_init_projfeat"),
            stateful_global_features=conf.get_bool("model.stateful_global_features"),
            global2view_and_global2scenepoint_enabled=conf.get_bool(
                "model.global2view_and_global2scenepoint_enabled"
            ),
            depth_head_enabled=conf.get_bool("model.depth_head.enabled", default=False),
            depth_head_n_feat=conf.get_int("model.depth_head.n_feat", default=128),
            depth_head_n_hidden_layers=conf.get_int("model.depth_head.n_hidden_layers", default=2),
            view_head_enabled=conf.get_bool("model.view_head.enabled", default=False),
            view_head_n_hidden_layers=conf.get_int("model.view_head.n_hidden_layers", default=2),
            scenepoint_head_enabled=conf.get_bool("model.scenepoint_head.enabled", default=False),
            scenepoint_head_n_hidden_layers=conf.get_int(
                "model.scenepoint_head.n_hidden_layers", default=2
            ),
            remat_layers=conf.get_bool("model.remat_layers", default=False),
        )
