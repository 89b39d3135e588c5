"""Data layer: scene containers, loaders, synthetic generation, sampling,
augmentation, outlier injection, batched prefetch loading.

Parity surface: reference code/datasets/ + the data parts of
code/utils/dataset_utils.py."""

from gasfm.data.augmentation import apply_rotational_homography_aug
from gasfm.data.dataset import SceneLoader, ScenesDataSet, dataloader_collate_fn
from gasfm.data.loaders import (
    correct_matches_global,
    create_scene_data,
    create_scene_data_from_list,
)
from gasfm.data.outliers import OutlierInjector, inject_outliers
from gasfm.data.sampling import get_subset, sample_data, sample_indices
from gasfm.data.scene import SceneData
from gasfm.data.synthetic import generate_synthetic_scene, synthetic_scene_from_conf

__all__ = [
    "OutlierInjector",
    "SceneData",
    "SceneLoader",
    "ScenesDataSet",
    "apply_rotational_homography_aug",
    "correct_matches_global",
    "create_scene_data",
    "create_scene_data_from_list",
    "dataloader_collate_fn",
    "generate_synthetic_scene",
    "get_subset",
    "inject_outliers",
    "sample_data",
    "sample_indices",
    "synthetic_scene_from_conf",
]
