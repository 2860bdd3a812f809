"""The port's own copies of the reference package's jax-free modules:
`config.SLAMConfig` (same fields, defaults, types, properties and methods)
and `utils.metrics.ate_rmse` (same numbers on seeded trajectories, within
1e-12: both are float64 numpy on the same inputs)."""

import dataclasses

import numpy as np
import pytest

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import port_config

from octree_slam_tpu.config import SLAMConfig as JaxConfig
from octree_slam_tpu.utils.metrics import ate_rmse as jax_ate_rmse
from octree_slam_tpu_torch import SLAMConfig
from octree_slam_tpu_torch.utils.metrics import ate_rmse

CONFIGS = [
    {},
    {"width": 64, "height": 48, "pyramid_depth": 2, "pyramid_iters": (6, 6)},
    {"width": 1920, "height": 1080, "track_finest_level": 1,
     "fuse_level": 1, "max_depth": 10},
    {"width": 483, "height": 645, "relocalize": False},
    {"reloc_candidates": 0},
]


def test_same_fields_defaults_and_types():
    port = {f.name: f for f in dataclasses.fields(SLAMConfig)}
    ref = {f.name: f for f in dataclasses.fields(JaxConfig)}
    assert list(port) == list(ref)
    for name, f in ref.items():
        assert port[name].default == f.default, name
        assert port[name].type == f.type, name
    assert SLAMConfig() == port_config(JaxConfig())
    with pytest.raises(dataclasses.FrozenInstanceError):
        SLAMConfig().width = 1


@pytest.mark.parametrize("change", CONFIGS)
def test_same_derived_values(change):
    j = JaxConfig(**change)
    t = SLAMConfig(**change)
    assert port_config(j) == t
    assert t.recovery_enabled == j.recovery_enabled
    assert t.resolution == j.resolution
    assert t.num_pixels == j.num_pixels
    for level in range(5):
        assert t.level_shape(level) == j.level_shape(level)


@pytest.mark.parametrize("align", [False, True])
def test_ate_rmse_matches(align):
    rng = np.random.default_rng(11)
    n = 30
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, :3, 3] = np.cumsum(rng.normal(0, 0.05, (n, 3)), axis=0)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.01, (n, 3))
    theta = 0.1
    R = np.array([[np.cos(theta), -np.sin(theta), 0.0],
                  [np.sin(theta), np.cos(theta), 0.0], [0.0, 0.0, 1.0]])
    est[:, :3, 3] = est[:, :3, 3] @ R.T + [0.2, -0.1, 0.05]
    a = ate_rmse(est.astype(np.float32), gt.astype(np.float32), align=align)
    b = jax_ate_rmse(est.astype(np.float32), gt.astype(np.float32),
                     align=align)
    assert isinstance(a, float)
    assert a == pytest.approx(b, rel=1e-12, abs=1e-12)
    assert (a < 0.05) == align


def test_default_config_and_stage_stats():
    """config.DEFAULT_CONFIG is SLAMConfig() in both packages; the port's
    span report keeps what the reference's StageStats reports: per stage,
    by sorted name, the count and the mean milliseconds (each span inside
    a StageStats block of the same name, so never above it)."""
    import time

    from octree_slam_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT
    from octree_slam_tpu.utils.timing import StageStats as JaxStageStats
    from octree_slam_tpu_torch.config import DEFAULT_CONFIG
    from octree_slam_tpu_torch.utils import spans
    assert DEFAULT_CONFIG == SLAMConfig() == port_config(JAX_DEFAULT)
    ref = JaxStageStats()
    spans.start()
    with spans.frame(0):
        for _ in range(2):
            with ref.time("fuse"), spans.span("fuse"):
                time.sleep(0.002)
        for _ in range(2):
            with ref.time("track"), spans.span("track"):
                pass
    report = spans.stop().report()
    assert list(report) == ["app.frame"] + list(ref.report()) == [
        "app.frame", "fuse", "track"]
    assert {k: report[k]["count"] for k in ("fuse", "track")} == ref.count
    for k in ("fuse", "track"):
        assert report[k]["mean_ms"] <= ref.mean_ms(k)
    assert report["fuse"]["mean_ms"] >= 2.0
    assert "render" not in report and ref.mean_ms("render") == 0.0
