"""DPESFM: the set-of-sets permutation-equivariant baseline.

Parity: reference ``SetOfSetNet`` (code/models/SetOfSet.py:49-142):
embedding -> num_blocks residual blocks of segment-mean layers -> final
global update -> heads.
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
    MLPStack,
    SetOfSetBlock,
    SetOfSetGlobalFeatureUpdate,
    pos_embed_dim,
)


class SetOfSetNet(nn.Module):
    num_blocks: int
    num_features: int
    block_size: int
    calibrated: bool = True
    rot_representation: str = "quat"
    normalize_output: Optional[str] = None
    proj_feat_normalization: bool = True
    add_skipconn_for_residual_blocks: bool = True
    pos_emb_n_freq: int = 0
    depth_head_enabled: bool = False
    depth_head_n_feat: int = 128
    depth_head_n_hidden_layers: int = 2
    view_head_enabled: bool = True
    view_head_n_hidden_layers: int = 2
    scenepoint_head_enabled: bool = True
    scenepoint_head_n_hidden_layers: int = 2

    def __call__(self, graph: ViewGraph) -> Dict[str, Any]:
        d_in = 2
        d_emb = pos_embed_dim(d_in, self.pos_emb_n_freq)

        e = EmbeddingLayer(self.pos_emb_n_freq, post_embed_proj_dim=None, name="embed")(graph.uv)
        for i in range(self.num_blocks):
            last = i == self.num_blocks - 1
            d_out = self.depth_head_n_feat if self.depth_head_enabled and last else self.num_features
            e = SetOfSetBlock(
                d_in=d_emb if i == 0 else self.num_features,
                d_out=d_out,
                block_size=self.block_size,
                proj_feat_normalization=self.proj_feat_normalization,
                add_skipconn_for_residual_blocks=self.add_skipconn_for_residual_blocks,
                name=f"equivariant_blocks_{i}",
            )(e, graph)

        pred: Dict[str, Any] = {}

        if self.view_head_enabled or self.scenepoint_head_enabled:
            if not self.view_head_enabled and self.scenepoint_head_enabled:
                raise NotImplementedError(
                    "Final aggregation for scenepoint features alone is not implemented."
                )
            n_input, m_input = SetOfSetGlobalFeatureUpdate(
                self.num_features, output_global=False, name="final_global_update"
            )(e, graph)
            m_input = nn.relu(m_input)
            n_input = nn.relu(n_input)

        if self.depth_head_enabled:
            depths = MLPStack(
                tuple([self.depth_head_n_feat] * (1 + self.depth_head_n_hidden_layers) + [1]),
                norm=False,
                name="depth_head",
            )(e)
            pred["depths"] = depths[:, 0]

        if self.view_head_enabled:
            out_ch = view_head_out_channels(self.calibrated, self.rot_representation)
            m_out = MLPStack(
                tuple([self.num_features] * (1 + self.view_head_n_hidden_layers) + [out_ch]),
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
                tuple([self.num_features] * (1 + self.scenepoint_head_n_hidden_layers) + [3]),
                norm=False,
                name="scenepoint_head",
            )(n_input).T
            pred["pts3D"] = decode_scenepoint_outputs(n_out)

        return pred

    @staticmethod
    def from_conf(conf) -> "SetOfSetNet":
        """Parity: reference SetOfSet.py:50-100."""
        return SetOfSetNet(
            num_blocks=conf.get_int("model.num_blocks"),
            num_features=conf.get_int("model.num_features"),
            block_size=conf.get_int("model.block_size"),
            calibrated=conf.get_bool("dataset.calibrated"),
            rot_representation=conf.get_string("model.view_head.rot_representation", default="quat"),
            normalize_output=conf.get_string("model.view_head.normalize_output", default=None),
            proj_feat_normalization=conf.get_bool("model.proj_feat_normalization"),
            add_skipconn_for_residual_blocks=conf.get_bool("model.add_skipconn_for_residual_blocks"),
            pos_emb_n_freq=conf.get_int("model.pos_emb_n_freq"),
            depth_head_enabled=conf.get_bool("model.depth_head.enabled", default=False),
            depth_head_n_feat=conf.get_int("model.depth_head.n_feat", default=128),
            depth_head_n_hidden_layers=conf.get_int("model.depth_head.n_hidden_layers", default=2),
            view_head_enabled=conf.get_bool("model.view_head.enabled", default=False),
            view_head_n_hidden_layers=conf.get_int("model.view_head.n_hidden_layers", default=2),
            scenepoint_head_enabled=conf.get_bool("model.scenepoint_head.enabled", default=False),
            scenepoint_head_n_hidden_layers=conf.get_int(
                "model.scenepoint_head.n_hidden_layers", default=2
            ),
        )
