"""Reference-checkpoint parity runbook.

One command that, the moment real reference weights (and optionally the
CVPR'24 dataset scenes) are mounted, produces the reference-vs-repo
comparison: load a torch-serialized reference checkpoint
(``model_epoch*.pt`` / ``best_model.pt`` — plain ``state_dict`` saves,
reference code/train.py:656,673,679), convert it with
``gasfm.models.convert``, verify it drops losslessly into the JAX
model, and run the evaluation battery over the requested scenes.

Usage:
  # structural parity only (no datasets needed; synthetic scene):
  python scripts/reference_parity.py --conf gasfm/confs/gasfm/optim_euc_gasfm.conf \
      --checkpoint /path/to/model_epoch000500.pt --synthetic

  # full evaluation table on real scenes (reference .npz format under
  # $DATASETS_PATH, same layout the reference uses):
  DATASETS_PATH=/datasets python scripts/reference_parity.py \
      --conf gasfm/confs/gasfm/optim_euc_gasfm.conf \
      --checkpoint /path/to/best_model.pt --scenes AlcatrazCourtyard DoorLund

The printed per-scene rows use the same metric battery as the reference's
evaluation.py tables, so they can be diffed directly against a reference
run of the same checkpoint.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

_REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_REPO))


def load_torch_state_dict(path: str):
    """Load a reference checkpoint file. Accepts a torch-serialized
    state_dict (the reference format) — torch (CPU build) is in the image.
    """
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    assert isinstance(obj, dict), f"expected a state_dict, got {type(obj)}"
    return obj


def convert_checkpoint(conf, checkpoint_path: str):
    """torch .pt -> model params, validated leaf-by-leaf against the model's
    own init tree (every converted array must land on a matching shape)."""
    import jax
    import numpy as np

    from gasfm.data.synthetic import generate_synthetic_scene
    from gasfm.models import get_model
    from gasfm.models.convert import convert_reference_state_dict

    model = get_model(conf)
    sd = load_torch_state_dict(checkpoint_path)
    params = convert_reference_state_dict(sd, conf.get_string("model.type"))

    data = generate_synthetic_scene(n_views=8, n_points=200, seed=0)
    scene = data.to_scene_graph()
    template = model.init(jax.random.PRNGKey(0), scene.graph)

    flat_t = dict(
        ("/".join(str(getattr(k, "key", k)) for k in kp), leaf)
        for kp, leaf in jax.tree_util.tree_flatten_with_path(template)[0]
    )
    flat_c = dict(
        ("/".join(str(getattr(k, "key", k)) for k in kp), leaf)
        for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    )
    missing = sorted(set(flat_t) - set(flat_c))
    extra = sorted(set(flat_c) - set(flat_t))
    assert not extra, f"converted keys with no model counterpart: {extra[:6]}"
    for key, arr in flat_c.items():
        want = flat_t[key].shape
        got = np.asarray(arr).shape
        assert got == want, f"shape mismatch at {key}: checkpoint {got} vs model {want}"
    if missing:
        # Head-key tolerance, mirroring the reference's strict=False load
        # (reference main.py:168-190): keep init values for absent heads.
        print(f"[convert] {len(missing)} model keys absent from checkpoint "
              f"(kept at init): {missing[:4]}")
        merged = jax.tree_util.tree_map(lambda x: x, template)

        def put(tree, path, value):
            node = tree
            parts = path.split("/")
            for p in parts[:-1]:
                node = node[p]
            node[parts[-1]] = value

        for key, arr in flat_c.items():
            put(merged, key, arr)
        params = merged
    print(f"[convert] OK: {len(flat_c)} arrays converted, tree matches model")
    return model, params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--conf", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--scenes", nargs="*", default=None,
                    help="real dataset scene names (requires $DATASETS_PATH)")
    ap.add_argument("--synthetic", action="store_true",
                    help="run the battery on a synthetic scene instead")
    ap.add_argument("--bundle-adjustment", action="store_true")
    args = ap.parse_args(argv)

    from gasfm.config import load_config

    conf = load_config(args.conf)
    model, params = convert_checkpoint(conf, args.checkpoint)

    from gasfm.data.dataset import SceneLoader, ScenesDataSet
    from gasfm.train.loop import TrainingSession, epoch_evaluation
    from gasfm.utils.phases import Phases

    if args.synthetic:
        from gasfm.data.synthetic import generate_synthetic_scene

        scenes = [generate_synthetic_scene(n_views=10, n_points=500, seed=0)]
    elif args.scenes:
        from gasfm.data.loaders import create_scene_data_from_list

        scenes = create_scene_data_from_list(args.scenes, conf)
    else:
        ap.error("pass --synthetic or --scenes NAME [NAME...]")

    loader = SceneLoader(ScenesDataSet(scenes, return_all=True), batch_size=1,
                         prefetch=0)
    session = TrainingSession(conf, model)
    # epoch_evaluation prints the per-scene table and its Mean row.
    return epoch_evaluation(
        loader, session, params, conf, -1, Phases.OPTIMIZATION,
        bundle_adjustment=args.bundle_adjustment,
        crash_on_scene_exhausting_memory=True,
    )


if __name__ == "__main__":
    main()
