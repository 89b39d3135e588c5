"""Observability: TensorBoard writer singleton, result tables, prediction
dumps, source-code snapshotting.

Parity: reference code/utils/general_utils.py:16-77 (TB writer, xlsx results
with append-merge by Scene index, npz prediction dumps, code logging) and
the TB tag scheme of code/train.py:22-46,272-369. Result tables are lists of
row dicts (one per scene, keyed by column name), written as CSV plus an xlsx
twin with the reference's append-merge by the ``Scene`` column.
"""

from __future__ import annotations

import csv
import math
import os
import shutil
from typing import Dict, List, Optional

import numpy as np

from gasfm.utils import paths
from gasfm.utils.phases import Phases

_tb_writer = None


def get_tb_writer(conf):
    """Process-global TensorBoard writer (parity: general_utils.py:16-23)."""
    global _tb_writer
    if _tb_writer is None:
        from gasfm.utils.events import EventWriter

        _tb_writer = EventWriter(paths.path_to_tb_events(conf))
    return _tb_writer


def reset_tb_writer():
    global _tb_writer
    if _tb_writer is not None:
        _tb_writer.close()
    _tb_writer = None


class ProfilerWindow:
    """Conf-gated ``jax.profiler`` trace capture over a window of train epochs.

    The reference's only profiling is wall-clock inference timing
    (train.py:190-205). Setting ``observability.profile_start_epoch``
    captures ``observability.profile_n_epochs`` epochs (default 1) of the
    training loop — device kernels, XLA fusions, host callbacks — into
    ``<tb_events>/profile``, viewable in TensorBoard's profile plugin or
    Perfetto. Disabled (all methods no-ops) when the key is unset, so the
    hot loop carries no overhead by default.
    """

    def __init__(self, conf):
        self.start = conf.get_int("observability.profile_start_epoch", default=None)
        # `or 1`: ref.conf ships the key as an explicit null (the repo's
        # "unset" idiom), which get_int returns as None in preference to the
        # default — maybe_stop would then TypeError on start + None.
        self.n_epochs = conf.get_int("observability.profile_n_epochs", default=1) or 1
        self.logdir = (
            os.path.join(paths.path_to_tb_events(conf), "profile")
            if self.start is not None
            else None
        )
        self._active = False

    def maybe_start(self, epoch: int):
        if self.start is not None and epoch == self.start and not self._active:
            import jax

            os.makedirs(self.logdir, exist_ok=True)
            jax.profiler.start_trace(self.logdir)
            self._active = True

    def maybe_stop(self, epoch: int):
        """Stop after the last epoch of the window (inclusive)."""
        if self._active and epoch >= self.start + self.n_epochs - 1:
            self.close()

    def close(self):
        """Idempotent; the loop also calls it after the epoch loop so a
        window truncated by early stopping still flushes a valid trace."""
        if self._active:
            import jax

            jax.profiler.stop_trace()
            self._active = False
            print(f"[profiler] trace written to {self.logdir}")


def dump_predictions(conf, pred_dict: Dict, scene: str, phase, epoch=None, additional_identifiers=None):
    """npz prediction dumps (parity: general_utils.py:53-58)."""
    path = paths.path_to_predictions(
        conf, phase, epoch=epoch, scene=scene, additional_identifiers=additional_identifiers
    )
    clean = {k: v for k, v in pred_dict.items() if v is not None}
    np.savez(path + ".npz", **clean)
    return path + ".npz"


def table_columns(rows: List[Dict]) -> List[str]:
    """Union of the rows' keys in first-seen order, ``Scene`` first."""
    cols: List[str] = []
    for row in rows:
        cols += [k for k in row if k not in cols]
    if "Scene" in cols:
        cols.remove("Scene")
        cols.insert(0, "Scene")
    return cols


def _is_missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _round(v, decimals: int = 3):
    if isinstance(v, (float, np.floating)):
        return round(float(v), decimals)
    if isinstance(v, np.integer):
        return int(v)
    return v


def _parse_cell(text: str):
    if text in ("", "NULL"):
        return None
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def format_table(rows: List[Dict], decimals: int = 3) -> str:
    """Fixed-width text rendering of a result table (stdout logging)."""
    cols = table_columns(rows)
    cells = [cols] + [
        ["NaN" if _is_missing(r.get(c)) else str(_round(r.get(c), decimals)) for c in cols]
        for r in rows
    ]
    widths = [max(len(line[j]) for line in cells) for j in range(len(cols))]
    return "\n".join(
        "  ".join(v.rjust(w) for v, w in zip(line, widths)) for line in cells
    )


def write_results(conf, rows: List[Dict], file_name: str = "Results",
                  additional_identifiers=None, append: bool = False):
    """Result table, floats rounded to 3 decimals, with append-merge.

    Parity: reference general_utils.write_results (general_utils.py:61-77).
    Writes the reference's .xlsx artifact (gasfm.utils.xlsx) and a .csv
    twin. The CSV is the merge source for append mode: earlier rows are read
    back and the new ones appended after them.
    """
    from gasfm.utils.xlsx import write_xlsx

    exp_path = paths.path_to_exp(conf)
    file_name = "_".join([file_name] + list(additional_identifiers or []))
    path = os.path.join(exp_path, f"{file_name}.csv")
    rows = [{k: _round(v) for k, v in row.items()} for row in rows]
    if append and os.path.exists(path):
        with open(path, newline="") as f:
            prev = [{k: _parse_cell(v) for k, v in r.items()} for r in csv.DictReader(f)]
        rows = prev + rows
    cols = table_columns(rows)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        for row in rows:
            w.writerow(["NULL" if _is_missing(row.get(c)) else row.get(c) for c in cols])
    write_xlsx(os.path.join(exp_path, f"{file_name}.xlsx"), cols,
               [[row.get(c) for c in cols] for row in rows])
    return path


def log_code(conf):
    """Snapshot the package source into the experiment dir
    (parity: general_utils.log_code, general_utils.py:26-50)."""
    code_path = paths.path_to_code_logs(conf)
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(code_path, "gasfm")
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(pkg_root, dst, ignore=shutil.ignore_patterns("__pycache__", "*.so", "*.o"))
    with open(os.path.join(code_path, "exp.conf.json"), "w") as f:
        import json

        json.dump(conf.to_dict(), f, indent=2, default=str)


# ---------------------------------------------------------------------------
# TB tag scheme (parity: train.py:22-46 and train.py:272-369)
# ---------------------------------------------------------------------------


def tb_log_train_step(
    tb_writer, batch_idx: int, signal_name: str, signal_val, phase: Phases,
    additional_identifiers: Optional[List[str]] = None, scene: Optional[str] = None,
):
    additional_identifiers = list(additional_identifiers or [])
    if phase == Phases.TRAINING:
        main_tag = f"{phase.name}-all-scenes" if scene is None else f"{phase.name}-per-scene"
    else:
        assert phase in (Phases.FINE_TUNE, Phases.SHORT_OPTIMIZATION, Phases.OPTIMIZATION)
        assert scene is not None
        main_tag = f"{phase.name}-train"
    tag = [main_tag] + additional_identifiers
    if scene is not None:
        tag.append("".join(scene.split()))
    tag += ["batch", signal_name]
    tb_writer.add_scalar("/".join(tag), signal_val, global_step=batch_idx + 1)


def eval_metric_columns(conf, include_post_ba_metrics: bool) -> List[str]:
    """The per-epoch metric battery logged to TB (parity: train.py:280-340)."""
    depth_head = conf.get_bool("model.depth_head.enabled", default=False)
    view_head = conf.get_bool("model.view_head.enabled", default=False)
    scenepoint_head = conf.get_bool("model.scenepoint_head.enabled", default=False)
    explicit = view_head and scenepoint_head
    calc_backproj = conf.get_bool("eval.calc_reprojerr_with_gtposes_for_depth_pred", default=False)

    cols: List[str] = []
    if calc_backproj:
        cols += [
            "repro_backproj_rnd_gt_2view",
            "repro_backproj_depth_norm_mean_rnd_gt_2view",
            "repro_backproj_depth_norm_min_rnd_gt_2view",
            "repro_backproj_depth_norm_max_rnd_gt_2view",
        ]
        cols += [f"repro_backproj_depth_norm_q{q:02d}_rnd_gt_2view" for q in [10, 25, 50, 75, 90]]
    if depth_head:
        for prefix in ("depth_pred_norm", "depth_gt_norm"):
            cols += [f"{prefix}_mean", f"{prefix}_min", f"{prefix}_max"]
            cols += [f"{prefix}_q{q:02d}" for q in [10, 25, 50, 75, 90]]
        cols += ["depth_pred_err_mean"]
    if explicit:
        cols += ["our_repro", "triangulated_repro"]
        if conf.get_bool("dataset.calibrated"):
            cols += [
                "t_err_mean", "t_err_med", "R_err_mean", "R_err_med",
                "cam_centers_std", "cam_centers_gt_std",
            ]
        if include_post_ba_metrics:
            cols += ["repro_ba"]
            if conf.get_bool("dataset.calibrated"):
                cols += ["t_err_ba_mean", "t_err_ba_med", "R_err_ba_mean", "R_err_ba_med"]
        cols += [
            "fraction_views_neg_depth_for_any_point",
            "fraction_points_neg_depth_in_any_view",
            "total_fraction_points_neg_depth",
            "point_depth_mean", "point_depth_min", "point_depth_max",
        ]
    return cols


def tb_log_eval_step(
    conf, tb_writer, epoch: int, validation_errors: List[Dict],
    phase: Phases = Phases.VALIDATION, additional_identifiers=None, scene=None,
    include_post_ba_metrics: bool = False,
):
    from gasfm.train.loop import aggregate_val_metric

    additional_identifiers = list(additional_identifiers or [])
    for metric in eval_metric_columns(conf, include_post_ba_metrics):
        if phase == Phases.VALIDATION:
            main_tag = f"{phase.name}-scene-avg" if scene is None else f"{phase.name}-per-scene"
        elif phase == Phases.TRAINING:
            main_tag = f"{phase.name}-eval-scene-avg" if scene is None else f"{phase.name}-eval-per-scene"
        else:
            assert phase in (Phases.FINE_TUNE, Phases.SHORT_OPTIMIZATION, Phases.OPTIMIZATION)
            assert scene is not None
            main_tag = f"{phase.name}-eval"
        tag = [main_tag] + additional_identifiers
        if scene is not None:
            tag.append("".join(scene.split()))
        tag += ["epoch", metric]
        try:
            val = aggregate_val_metric(validation_errors, metric_column=metric, scene=scene)
        except KeyError:
            continue
        tb_writer.add_scalar("/".join(tag), val, global_step=epoch + 1)
