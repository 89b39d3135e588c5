"""Model families: GASFM graph-attention net, DPESFM set-of-sets baseline.

Parity surface: reference code/models/ (baseNet.py, SetOfSet.py,
graph_attn_sfm.py, layers.py). Models are :mod:`gasfm.models.nn`
modules over the static-shape :class:`~gasfm.graph.ViewGraph`.
"""

from gasfm.models.gasfm import GraphAttnSfMNet
from gasfm.models.set_of_set import SetOfSetNet

_MODEL_REGISTRY = {
    # Reference model.type strings (reference code/main.py:134-136 resolves
    # these by reflection into code/models/).
    "graph_attn_sfm.GraphAttnSfMNet": GraphAttnSfMNet,
    "SetOfSet.SetOfSetNet": SetOfSetNet,
    "GraphAttnSfMNet": GraphAttnSfMNet,
    "SetOfSetNet": SetOfSetNet,
}


def get_model(conf):
    """Instantiate a model from ``model.type`` (reference main.py:134-136)."""
    type_str = conf.get_string("model.type")
    if type_str not in _MODEL_REGISTRY:
        raise ValueError(f"Unknown model.type {type_str!r}; known: {sorted(_MODEL_REGISTRY)}")
    return _MODEL_REGISTRY[type_str].from_conf(conf)


__all__ = ["GraphAttnSfMNet", "SetOfSetNet", "get_model"]
