"""Config system tests (HOCON parsing, overrides, schema validation)."""

import os

import pytest

from gasfm.config import (
    ConfigFactory,
    ConfigMissingError,
    confs_dir,
    detect_schema_discrepancies,
    load_ref_schema,
    merge_external_params,
)

SAMPLE = """
random_seed = 0
dataset {
  use_gt = false
  calibrated = true
  scene = "AlcatrazCourtyard"
  test_set = [
    "A"
    "B"
  ]
}
model {
  type = "graph_attn_sfm.GraphAttnSfMNet"
  n_heads = 4
  depth_head {
    enabled = false
  }
}
train {
  lr = 0.0001
  outlier_injection_rate = null
}
# comment
loss.func = "ESFMLoss"  // dotted key
"""


def test_parse_types():
    conf = ConfigFactory.parse_string(SAMPLE)
    assert conf.get_int("random_seed") == 0
    assert conf.get_bool("dataset.use_gt") is False
    assert conf.get_bool("dataset.calibrated") is True
    assert conf.get_string("dataset.scene") == "AlcatrazCourtyard"
    assert conf.get_list("dataset.test_set") == ["A", "B"]
    assert conf.get_int("model.n_heads") == 4
    assert conf.get_bool("model.depth_head.enabled") is False
    assert conf.get_float("train.lr") == pytest.approx(1e-4)
    assert conf.get_float("train.outlier_injection_rate", default=None) is None
    assert conf.get_string("loss.func") == "ESFMLoss"


def test_missing_and_defaults():
    conf = ConfigFactory.parse_string(SAMPLE)
    with pytest.raises(ConfigMissingError):
        conf.get_int("nope.nothing")
    assert conf.get_int("nope.nothing", default=7) == 7
    assert conf.get_bool("model.view_head.enabled", default=False) is False


def test_external_param_merge():
    conf = ConfigFactory.parse_string(SAMPLE)
    merge_external_params(conf, ["train.lr=0.01", "model.n_heads=8", 'dataset.scene="X"'])
    assert conf.get_float("train.lr") == pytest.approx(0.01)
    assert conf.get_int("model.n_heads") == 8
    assert conf.get_string("dataset.scene") == "X"


def test_put_and_copy_independence():
    conf = ConfigFactory.parse_string(SAMPLE)
    clone = conf.copy()
    clone.put("train.lr", 0.5)
    assert conf.get_float("train.lr") == pytest.approx(1e-4)
    assert clone.get_float("train.lr") == pytest.approx(0.5)


def test_schema_check_accepts_known_and_rejects_unknown():
    ref = load_ref_schema()
    conf = ConfigFactory.parse_string(SAMPLE)
    assert detect_schema_discrepancies(conf, ref) == []
    conf.put("model.bogus_key", 1)
    assert detect_schema_discrepancies(conf, ref) == ["model.bogus_key"]


def test_shipped_confs_parse_and_validate():
    ref = load_ref_schema()
    for root, _, files in os.walk(confs_dir()):
        for f in files:
            if not f.endswith(".conf") or f == "ref.conf":
                continue
            conf = ConfigFactory.parse_file(os.path.join(root, f))
            assert detect_schema_discrepancies(conf, ref) == [], f
