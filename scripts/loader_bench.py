"""Host data-pipeline throughput: prefetch thread vs worker-process pool.

Measures epochs of the learning-config host work — view-window sampling +
rotational homography augmentation per sample (ScenesDataSet), plus the
outlier injector applied to each sample as epoch_train does — with
num_workers = 0 (in-process) vs a fork pool. Host-only: no device work.

Run: JAX_PLATFORMS=cpu timeout 1800 python scripts/loader_bench.py
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

_REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_REPO))

import numpy as np

from gasfm.data.dataset import SceneLoader, ScenesDataSet
from gasfm.data.outliers import inject_outliers
from gasfm.data.synthetic import generate_synthetic_scene


def main():
    # Learning-config shape: several mid-size scenes, sampled windows of
    # 10-30 views, aug 15/20 degrees, outlier rate 0.1 (reference
    # confs/gasfm/learning_euc_rhaug-15-20_outliers0.1_gasfm.conf).
    scenes = [
        generate_synthetic_scene(n_views=40, n_points=2000, visibility=0.35,
                                 seed=s, scene_name=f"s{s}")
        for s in range(8)
    ]
    rng = np.random.default_rng(0)

    for workers in (0, 2):
        ds = ScenesDataSet(
            scenes, return_all=False, min_num_views_sampled=10,
            max_num_views_sampled=30, inplane_rot_aug_max_angle=15.0,
            tilt_rot_aug_max_angle=20.0, rng=np.random.default_rng(1),
        )
        loader = SceneLoader(ds, batch_size=4, shuffle=True,
                             rng=np.random.default_rng(2), num_workers=workers)
        # Warm-up epoch (pool start-up, caches).
        for batch in loader:
            pass
        t0 = time.perf_counter()
        n_epochs, n_samples = 3, 0
        for _ in range(n_epochs):
            for batch in loader:
                for sample in batch:
                    injected = inject_outliers(sample, 0.1, rng=rng)
                    assert injected is not None
                    n_samples += 1
        dt = time.perf_counter() - t0
        loader.close()
        print(f"num_workers={workers}: {dt/n_epochs:6.2f} s/epoch "
              f"({dt/n_samples*1e3:7.1f} ms/sample incl. outlier injection)",
              flush=True)


if __name__ == "__main__":
    main()
