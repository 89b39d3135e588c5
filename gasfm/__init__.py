"""gasfm — a JAX framework for learning Structure-from-Motion with graph
attention networks.

This is a from-scratch JAX/XLA implementation providing the full capability
surface of the CVPR 2024 GASFM reference (lucasbrynte/gasfm):

- Edge-centric, statically-shaped sparse view-graph container
  (:mod:`gasfm.graph`) instead of per-sample rebuilt COO tensors.
- Masked segment reductions and segment-softmax attention
  (:mod:`gasfm.ops`) as XLA scatters and gathers.
- Permutation-equivariant models (:mod:`gasfm.models`): the DPESFM
  set-of-sets baseline and the GASFM graph-attention network.
- Unsupervised reprojection losses with custom-VJP gradient equalization
  (:mod:`gasfm.losses`).
- Host geometry + evaluation (:mod:`gasfm.geometry`,
  :mod:`gasfm.eval`) and a native C++ bundle adjuster
  (:mod:`gasfm.ba`).
- Multi-device edge-partitioned execution over `jax.sharding.Mesh`
  (:mod:`gasfm.parallel`).
"""

__version__ = "0.1.0"
