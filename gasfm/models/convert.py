"""Reference-checkpoint weight conversion.

Maps a reference training checkpoint ``state_dict`` (torch naming — see
/root/reference/code/models/graph_attn_sfm.py, SetOfSet.py, layers.py; the
same naming is reproduced by tests/torch_oracle.py) onto the parameter
pytree of :class:`gasfm.models.gasfm.GraphAttnSfMNet` /
:class:`gasfm.models.set_of_set.SetOfSetNet`.

Conventions translated:
- torch ``nn.Linear.weight`` is (out, in); kernels here are (in, out).
- torch ``nn.LayerNorm.weight/bias`` -> ``scale``/``bias``.
- PyG ``GATv2Conv``: ``lin_l/lin_r`` linears -> ``lin_l_kernel``/``lin_r_bias``
  etc.; ``att`` is (1, H, C) in PyG, (H, C) here.
- ``get_linear_layers`` Sequentials index Linears at 0, 2, 4, ... (norm=False
  heads/MLPs) -> ``MLPStack``'s ``TorchDense_{k}``.

Entry point: :func:`convert_reference_state_dict`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _t(w) -> np.ndarray:
    """torch tensor/array -> numpy (transposing 2D linear weights)."""
    a = np.asarray(getattr(w, "detach", lambda: w)().cpu() if hasattr(w, "detach") else w,
                   dtype=np.float32)
    return a.T if a.ndim == 2 else a


def _arr(w) -> np.ndarray:
    a = np.asarray(getattr(w, "detach", lambda: w)().cpu() if hasattr(w, "detach") else w,
                   dtype=np.float32)
    return a


class _Mapper:
    def __init__(self, state_dict):
        self.sd = {k: v for k, v in state_dict.items()}
        self.used = set()
        self.out: Dict = {}

    def get(self, key):
        self.used.add(key)
        return self.sd[key]

    def has(self, key):
        return key in self.sd

    def put(self, path, value):
        node = self.out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def linear(self, src, dst, bias=True):
        self.put(f"{dst}/kernel", _t(self.get(f"{src}.weight")))
        if bias:
            self.put(f"{dst}/bias", _arr(self.get(f"{src}.bias")))

    def layernorm(self, src, dst):
        self.put(f"{dst}/scale", _arr(self.get(f"{src}.weight")))
        self.put(f"{dst}/bias", _arr(self.get(f"{src}.bias")))

    def gatv2(self, src, dst):
        self.put(f"{dst}/lin_l_kernel", _t(self.get(f"{src}.lin_l.weight")))
        self.put(f"{dst}/lin_l_bias", _arr(self.get(f"{src}.lin_l.bias")))
        self.put(f"{dst}/lin_r_kernel", _t(self.get(f"{src}.lin_r.weight")))
        self.put(f"{dst}/lin_r_bias", _arr(self.get(f"{src}.lin_r.bias")))
        att = _arr(self.get(f"{src}.att"))
        self.put(f"{dst}/att", att.reshape(att.shape[-2], att.shape[-1]))
        self.put(f"{dst}/bias", _arr(self.get(f"{src}.bias")))

    def mlp_stack(self, src, dst):
        """get_linear_layers(norm=False) Sequential -> MLPStack."""
        k = 0
        idx = 0
        while self.has(f"{src}.{idx}.weight"):
            self.linear(f"{src}.{idx}", f"{dst}/TorchDense_{k}")
            k += 1
            idx += 2
        assert k > 0, f"no linear layers found under {src}"

    def query_adapter(self, src, dst):
        """norm_and_proj_* Sequential: LayerNorm(0), ReLU(1), [Linear(2)]."""
        self.layernorm(f"{src}.0", f"{dst}/LayerNorm_0")
        if self.has(f"{src}.2.weight"):
            self.linear(f"{src}.2", f"{dst}/TorchDense_0")


def _axial_aggregator(m: _Mapper, src: str, dst: str, proj_name: str, adapter_name: str):
    """Proj2View / Proj2ScenePoint -> AxialAttentionAggregator."""
    if m.has(f"{src}.{adapter_name}.0.weight"):
        m.query_adapter(f"{src}.{adapter_name}", f"{dst}/query_adapter")
    m.gatv2(f"{src}.graph_conv", f"{dst}/graph_conv")
    if m.has(f"{src}.{proj_name}.weight"):
        m.linear(f"{src}.{proj_name}", f"{dst}/proj_agg")
    m.layernorm(f"{src}.norm_pre_mlp", f"{dst}/norm_pre_mlp")
    m.mlp_stack(f"{src}.mlp", f"{dst}/mlp")


def _global_broadcast(m: _Mapper, src: str, dst: str, node_lin: str, node_norm: str):
    """Global2View / Global2ScenePoint -> GlobalBroadcastUpdate."""
    m.layernorm(f"{src}.{node_norm}", f"{dst}/node_norm")
    m.layernorm(f"{src}.global_norm_layer", f"{dst}/global_norm")
    m.linear(f"{src}.{node_lin}", f"{dst}/lin_node")
    m.linear(f"{src}.lin_global", f"{dst}/lin_global", bias=False)
    if m.has(f"{src}.mlp.0.weight"):
        m.mlp_stack(f"{src}.mlp", f"{dst}/mlp")


def _global_feature_update(m: _Mapper, src: str, dst: str):
    """GraphAttnSfMGlobalFeatureUpdate (incl. the final, global-less one)."""
    _axial_aggregator(m, f"{src}.proj2view", f"{dst}/proj2view",
                      "proj_proj2view", "norm_and_proj_view2proj")
    _axial_aggregator(m, f"{src}.proj2scenepoint", f"{dst}/proj2scenepoint",
                      "proj_proj2scenepoint", "norm_and_proj_scenepoint2proj")
    g = f"{src}.view_and_scenepoint2global"
    if m.has(f"{g}.graph_conv_view2global.att"):
        d = f"{dst}/view_and_scenepoint2global"
        if m.has(f"{g}.norm_and_proj_global2view.0.weight"):
            m.query_adapter(f"{g}.norm_and_proj_global2view", f"{d}/query_adapter_view")
            m.query_adapter(f"{g}.norm_and_proj_global2scenepoint",
                            f"{d}/query_adapter_scenepoint")
        m.gatv2(f"{g}.graph_conv_view2global", f"{d}/graph_conv_view2global")
        m.gatv2(f"{g}.graph_conv_scenepoint2global", f"{d}/graph_conv_scenepoint2global")
        if m.has(f"{g}.proj_view_and_scenepoint2global.weight"):
            m.linear(f"{g}.proj_view_and_scenepoint2global", f"{d}/proj_global")
        m.layernorm(f"{g}.norm_pre_mlp", f"{d}/norm_pre_mlp")
        m.mlp_stack(f"{g}.mlp", f"{d}/mlp")
    if m.has(f"{src}.global2view.lin_view.weight"):
        _global_broadcast(m, f"{src}.global2view", f"{dst}/global2view",
                          "lin_view", "view_norm_layer")
        _global_broadcast(m, f"{src}.global2scenepoint", f"{dst}/global2scenepoint",
                          "lin_scenepoint", "scenepoint_norm_layer")


def _projection_feature_update(m: _Mapper, src: str, dst: str):
    if m.has(f"{src}.scenepoint_norm_layer.weight"):
        m.layernorm(f"{src}.scenepoint_norm_layer", f"{dst}/scenepoint_norm")
        m.layernorm(f"{src}.view_norm_layer", f"{dst}/view_norm")
        m.layernorm(f"{src}.global_norm_layer", f"{dst}/global_norm")
    m.linear(f"{src}.lin_proj", f"{dst}/lin_proj")
    m.linear(f"{src}.lin_scenepoint", f"{dst}/lin_scenepoint", bias=False)
    m.linear(f"{src}.lin_view", f"{dst}/lin_view", bias=False)
    m.linear(f"{src}.lin_global", f"{dst}/lin_global", bias=False)
    if m.has(f"{src}.mlp.0.weight"):
        m.mlp_stack(f"{src}.mlp", f"{dst}/mlp")


def convert_graph_attn_state_dict(state_dict) -> Dict:
    """Reference GraphAttnSfMNet state_dict -> params pytree."""
    m = _Mapper(state_dict)
    if m.has("embed.post_embed_lin.weight"):
        m.linear("embed.post_embed_lin", "embed/post_embed_lin")

    i = 0
    while m.has(f"equivariant_blocks.{i}.global_feature_update.proj2view.graph_conv.att"):
        src = f"equivariant_blocks.{i}"
        dst = f"equivariant_blocks_{i}"
        if m.has(f"{src}.prev_projfeat_norm_layer.weight"):
            m.put(f"{dst}/prev_projfeat_norm_scale",
                  _arr(m.get(f"{src}.prev_projfeat_norm_layer.weight")))
            m.put(f"{dst}/prev_projfeat_norm_bias",
                  _arr(m.get(f"{src}.prev_projfeat_norm_layer.bias")))
        _global_feature_update(m, f"{src}.global_feature_update",
                               f"{dst}/global_feature_update")
        _projection_feature_update(m, f"{src}.projection_feature_update",
                                   f"{dst}/projection_feature_update")
        if m.has(f"{src}.residual_skipconn_proj_norm_layer.weight"):
            m.layernorm(f"{src}.residual_skipconn_proj_norm_layer",
                        f"{dst}/residual_skipconn_proj_norm")
        if m.has(f"{src}.skip_projection.lin_proj.weight"):
            m.linear(f"{src}.skip_projection.lin_proj", f"{dst}/skip_projection")
        i += 1
    assert i > 0, "no equivariant_blocks found in state_dict"

    if m.has("final_global_update.proj2view.graph_conv.att"):
        _global_feature_update(m, "final_global_update", "final_global_update")
    for head in ("view_head", "scenepoint_head", "depth_head"):
        if m.has(f"{head}.0.weight"):
            m.mlp_stack(head, head)

    unused = set(m.sd) - m.used
    assert not unused, f"unconverted reference keys: {sorted(unused)[:10]}"
    return {"params": m.out}


def convert_set_of_set_state_dict(state_dict) -> Dict:
    """Reference SetOfSetNet state_dict -> params pytree."""
    m = _Mapper(state_dict)
    if m.has("embed.post_embed_lin.weight"):
        m.linear("embed.post_embed_lin", "embed/post_embed_lin")
    i = 0
    while m.has(f"equivariant_blocks.{i}.layers.0.global_feature_update.lin_view.weight"):
        src = f"equivariant_blocks.{i}"
        dst = f"equivariant_blocks_{i}"
        j = 0
        while m.has(f"{src}.layers.{j}.global_feature_update.lin_view.weight"):
            lsrc = f"{src}.layers.{j}.global_feature_update"
            ldst = f"{dst}/layers_{j}/global_feature_update"
            m.linear(f"{lsrc}.lin_scenepoint", f"{ldst}/lin_scenepoint")
            m.linear(f"{lsrc}.lin_view", f"{ldst}/lin_view")
            m.linear(f"{lsrc}.lin_global", f"{ldst}/lin_global")
            m.linear(f"{src}.layers.{j}.projection_feature_update.lin_proj",
                     f"{dst}/layers_{j}/lin_proj")
            j += 1
        if m.has(f"{src}.skip_projection.lin_proj.weight"):
            m.linear(f"{src}.skip_projection.lin_proj", f"{dst}/skip_projection")
        i += 1
    assert i > 0, "no equivariant_blocks found in state_dict"
    if m.has("final_global_update.lin_view.weight"):
        m.linear("final_global_update.lin_scenepoint",
                 "final_global_update/lin_scenepoint")
        m.linear("final_global_update.lin_view", "final_global_update/lin_view")
    for head in ("view_head", "scenepoint_head", "depth_head"):
        if m.has(f"{head}.0.weight"):
            m.mlp_stack(head, head)
    unused = set(m.sd) - m.used
    assert not unused, f"unconverted reference keys: {sorted(unused)[:10]}"
    return {"params": m.out}


def convert_reference_state_dict(state_dict, model_type: str) -> Dict:
    """Convert a reference checkpoint for ``model_type`` (the conf's
    ``model.type``, e.g. "graph_attn_sfm.GraphAttnSfMNet")."""
    if "GraphAttn" in model_type:
        return convert_graph_attn_state_dict(state_dict)
    if "SetOfSet" in model_type:
        return convert_set_of_set_state_dict(state_dict)
    raise ValueError(f"unknown model type {model_type!r}")
