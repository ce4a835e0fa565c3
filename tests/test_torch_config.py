"""The port's config tree, YAML reader, build_rig, build_imu_params and time
helpers against the JAX package's, on the CPU in float64.

No test reads a file outside the repository: the YAML cases write their own
file in the layout of the stock EuRoC configuration (the `%YAML:1.0`
directive, the camera blocks, the IMU, ceres, detection and publishing
options), with the JAX package's `distributed` and `posegraph` extension
blocks. Tolerances: the parsed trees field by field exactly; the rig's T_SC,
intrinsics, specs and overlaps to 1e-12; the IMU parameters exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis_tpu.config import build_imu_params as jbuild_imu_params
from okvis_tpu.config import build_rig as jbuild_rig
from okvis_tpu.config import read_config as jread_config
from okvis_tpu.config.parameters import VioParameters as JVioParameters
from okvis_tpu.utils import time as jtime
from okvis_tpu_torch.config import VioParameters, build_imu_params, build_rig, read_config
from okvis_tpu_torch.utils import time as ttime

torch.set_num_threads(2)

EUROC_YAML = """%YAML:1.0
cameras:
     - {T_SC:
        [ 0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
          0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
         -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
          0.0, 0.0, 0.0, 1.0],
        image_dimension: [752, 480],
        distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05],
        distortion_type: radialtangential,
        focal_length: [458.654880721, 457.296696463],
        principal_point: [367.215803962, 248.37534061]}
     - {T_SC:
        [ 0.0125552670891, -0.999755099723, 0.0182237714554, -0.0198435579556,
          0.999598781151, 0.0130119051815, 0.0251588363115, 0.0453689425024,
         -0.0253898008918, 0.0179005838253, 0.999517347078, 0.00786212447038,
          0.0, 0.0, 0.0, 1.0],
        image_dimension: [752, 480],
        distortion_coefficients: [-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05],
        distortion_type: radialtangential,
        focal_length: [457.587426604, 456.13442556],
        principal_point: [379.99944652, 255.238185386]}

camera_params:
    camera_rate: 20
    sigma_absolute_translation: 0.0
    sigma_absolute_orientation: 0.0
    sigma_c_relative_translation: 0.0
    sigma_c_relative_orientation: 0.0
    timestamp_tolerance: 0.005

imu_params:
    a_max: 176.0
    g_max: 7.8
    sigma_g_c: 12.0e-4
    sigma_a_c: 8.0e-3
    sigma_bg: 0.03
    sigma_ba: 0.1
    sigma_gw_c: 4.0e-6
    sigma_aw_c: 4.0e-5
    tau: 3600.0
    g: 9.81007
    a0: [ 0.0, 0.0, 0.0 ]
    imu_rate: 200
    T_BS:
        [1.0000, 0.0000, 0.0000, 0.0000,
         0.0000, 1.0000, 0.0000, 0.0000,
         0.0000, 0.0000, 1.0000, 0.0000,
         0.0000, 0.0000, 0.0000, 1.0000]

numKeyframes: 5
numImuFrames: 3

ceres_options:
    minIterations: 3
    maxIterations: 10
    timeLimit: 0.035

detection_options:
    threshold: 40.0
    octaves: 0
    maxNoKeypoints: 400

output_options:
    display_matches: true
    display_overhead: false

publishing_options:
    publish_rate: 200
    publishLandmarks: true
    landmarkQualityThreshold: 1.0e-2
    maximumLandmarkQuality: 0.05
    maxPathLength: 20
    publishImuPropagatedState: "false"
    trackedBodyFrame: B
    velocitiesFrame: Wc

imageDelay: 0.0
"""

EXTENSIONS = """
distributed:
    devices: 4

posegraph:
    enabled: "true"
    scoreThreshold: 0.3
    minGap: 12
    minInliers: 25
    nodeCapacity: 128
    edgeCapacity: 256
    cullRedundant: true
"""


@pytest.fixture(params=["euroc", "extensions"])
def yaml_path(request, tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text(EUROC_YAML + (EXTENSIONS if request.param == "extensions" else ""))
    return str(path)


def _plain(tree):
    """dataclasses.asdict with numpy arrays as lists (exact comparison)."""
    def conv(x):
        if isinstance(x, np.ndarray):
            return ("array", x.dtype.str, x.shape, x.tolist())
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return x
    return conv(dataclasses.asdict(tree))


def test_defaults_equal_jax():
    assert _plain(VioParameters()) == _plain(JVioParameters())


def test_read_config_equals_jax(yaml_path):
    got, want = read_config(yaml_path), jread_config(yaml_path)
    assert _plain(got) == _plain(want)
    assert len(got.cameras) == 2 and got.cameras[0].image_dimension == (752, 480)
    assert got.publishing.publish_imu_propagated_state is False
    assert got.cameras[1].dist_type_short == want.cameras[1].dist_type_short == "radtan"


def test_read_config_extension_blocks(tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text(EUROC_YAML + EXTENSIONS)
    p = read_config(str(path))
    assert p.optimization.distributed_devices == 4
    assert p.posegraph.enabled and p.posegraph.min_gap == 12 and p.posegraph.cull_redundant


@pytest.mark.parametrize("source", ["euroc", "extensions", "built_in_code"])
def test_write_config_round_trips_through_both_readers(tmp_path, source):
    """config.yaml_writer.write_config of a tree read from the stock layout,
    or built in code with the synthetic rig's cameras: read_config of either
    package gives the tree back exactly."""
    from okvis_tpu_torch.cameras.ncamera import NCameraSystem
    from okvis_tpu_torch.config.yaml_writer import cameras_from_rig, write_config
    from okvis_tpu_torch.datasets.synthetic import euroc_stereo_rig

    if source == "built_in_code":
        p = VioParameters()
        specs, T_SC, intr = euroc_stereo_rig(device="cpu")
        p.cameras = cameras_from_rig(NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intr))
        p.posegraph.enabled, p.posegraph.min_gap, p.optimization.max_num_keypoints = True, 2, 400
    else:
        src = tmp_path / "stock.yaml"
        src.write_text(EUROC_YAML + (EXTENSIONS if source == "extensions" else ""))
        p = read_config(str(src))
    path = str(tmp_path / "written.yaml")
    write_config(p, path)
    assert _plain(read_config(path)) == _plain(p)
    assert _plain(jread_config(path)) == _plain(p)


@pytest.mark.parametrize("compute_overlaps", [True, False])
def test_build_rig_equals_jax(yaml_path, compute_overlaps):
    got = build_rig(read_config(yaml_path), compute_overlaps=compute_overlaps, device="cpu")
    want = jbuild_rig(jread_config(yaml_path), compute_overlaps=compute_overlaps)
    assert got.specs == tuple(type(got.specs[0])(s.width, s.height, s.dist_type) for s in want.specs)
    assert got.T_SC.r.dtype == torch.float64 and got.T_SC.r.device.type == "cpu"
    np.testing.assert_allclose(got.T_SC.r.numpy(), np.asarray(want.T_SC.r), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.T_SC.q.numpy(), np.asarray(want.T_SC.q), rtol=0, atol=1e-12)
    for a, b in zip(got.intrinsics, want.intrinsics):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)
    if compute_overlaps:
        np.testing.assert_array_equal(got.overlaps, want.overlaps)
        assert got.has_overlap(0, 1) and got.has_overlap(1, 0)
        for row_a, row_b in zip(got.overlap_mats, want.overlap_mats):
            for a, b in zip(row_a, row_b):
                np.testing.assert_array_equal(a, b)
    else:
        assert got.overlaps is None and want.overlaps is None


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_build_imu_params_equals_jax(yaml_path, dtype):
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    got = build_imu_params(read_config(yaml_path), device="cpu", dtype=dtype)
    want = jbuild_imu_params(jread_config(yaml_path), dtype=jdtype)
    assert got._fields == want._fields and got.rate == want.rate == 200
    for name, a, b in zip(got._fields, got, want):
        if name == "rate":
            continue
        assert a.dtype == dtype and a.shape == np.asarray(b).shape, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("sec", [0.0, 1.5, 2.5e-9, 1403636579.763555580, -0.25])
def test_time_round_trips_equal_jax(sec):
    assert ttime.ns_from_sec(sec) == jtime.ns_from_sec(sec)
    assert type(ttime.ns_from_sec(sec)) is type(jtime.ns_from_sec(sec))
    assert ttime.duration_from_sec(sec) == jtime.duration_from_sec(sec)
    ns = int(ttime.ns_from_sec(sec))
    assert ttime.sec_from_ns(ns) == jtime.sec_from_ns(ns)
    arr = np.asarray([ns, ns + 1, 1403636579763555580], np.int64)
    np.testing.assert_array_equal(ttime.sec_from_ns(arr), jtime.sec_from_ns(arr))
    assert ttime.NSEC_PER_SEC == jtime.NSEC_PER_SEC
