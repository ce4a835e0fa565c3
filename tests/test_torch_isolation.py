"""okvis_tpu_torch stands alone: it imports neither JAX nor okvis_tpu, and
importing it loads neither PyYAML nor PIL (the card machine has neither;
only read_config and PoseViewer.save import them, when called); its entry
points refuse to fall back to the CPU when no card is present, and its
kernel library refuses to load without nvcc."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import okvis_tpu_torch
from okvis_tpu_torch.ops import cuda_lib

REPO = Path(__file__).resolve().parents[1]
PKG = Path(okvis_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "okvis_tpu")
NOT_AT_IMPORT = ("yaml", "PIL")  # imported inside the functions that need them


def _is_forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_every_module_loads_no_jax_okvis_tpu_yaml_or_pil():
    code = (
        "import importlib, pkgutil, sys\n"
        "import okvis_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'okvis_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(len(names))\n"
        "print(' '.join(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120, check=True).stdout.splitlines()
    assert int(out[0]) >= 66  # every module of the eight slices was imported
    loaded = out[1].split()
    for name in ("frontend.frontend", "imu.preintegration", "imu.ode", "factors.imu_factor",
                 "factors.reprojection", "factors.priors", "kinematics.local_parameterization",
                 "solver.structure", "solver.assemble", "solver.optimize", "estimator.marginalization",
                 "estimator.estimator", "utils.ids", "utils.timing", "utils.syncstats", "utils.capture",
                 "linalg", "convert", "frontend.ransac", "frontend.keyframe", "frontend.fivepoint",
                 "frontend.kernels", "kinematics.np_se3", "eval.ate", "utils.time", "config.parameters",
                 "config.yaml_reader", "pipeline.queues", "pipeline.synchronizer", "pipeline.threaded_vio",
                 "pipeline.visualizer", "pipeline.pose_viewer", "posegraph.graph", "posegraph.optimize",
                 "posegraph.place_recognition", "posegraph.loop_closure", "posegraph.manager", "datasets.png",
                 "datasets.euroc", "native", "apps.run_euroc", "apps.euroc_sweep", "config.yaml_writer"):
        assert f"okvis_tpu_torch.{name}" in loaded, name
    bad = [m for m in loaded if _is_forbidden(m) or m.split(".")[0] in NOT_AT_IMPORT]
    assert not bad, bad


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(REPO).as_posix() for p in PKG.rglob("*.py")] + ["chip_smoke.py"]))
def test_no_source_imports_jax_or_okvis_tpu(path):
    """Also covers imports inside functions, which a plain import misses."""
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_is_forbidden(n) for n in names), (path, names)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _rig_from_numpy(device=None):
    from okvis_tpu_torch.convert import rig_from_numpy

    return rig_from_numpy([(752, 480, "radtan")], np.zeros((1, 3)), np.asarray([[0, 0, 0, 1.0]]),
                          [np.asarray([461.4, 460.2, 363.0, 248.1, -0.28, 0.07, 2e-4, 1.8e-5])], device=device)


def _frame_arrays(K=4):
    return (np.zeros((K, 2)), np.zeros(K), np.ones(K, bool), np.zeros((K, 16), np.uint32), np.zeros(K, np.int64))


def _entry_points():
    from okvis_tpu_torch import kinematics, resolve_device
    from okvis_tpu_torch.cameras import pinhole
    from okvis_tpu_torch.convert import (
        estimator_from_numpy, estimator_to_numpy, frame_from_numpy, imu_params_from_numpy, multiframe_from_numpy,
        problem_from_numpy, problem_to_numpy)
    from okvis_tpu_torch.frontend.frontend import Frontend
    from okvis_tpu_torch.estimator import Estimator
    from okvis_tpu_torch.datasets.synthetic import build_ba_problem, euroc_stereo_rig
    from okvis_tpu_torch.imu import ImuParams
    from okvis_tpu_torch.solver import WindowConfig, empty_problem
    from okvis_tpu_torch.config import VioParameters, build_imu_params, build_rig
    from okvis_tpu_torch.pipeline import ThreadedVio
    from okvis_tpu_torch.apps.run_euroc import run as run_euroc

    tiny = WindowConfig(num_states=2, max_landmarks=4, max_observations=8, max_imu_links=1)
    return {
        "resolve_device": resolve_device,
        "euroc_stereo_rig": euroc_stereo_rig,
        "rig_from_numpy": _rig_from_numpy,
        "se3_identity": kinematics.identity,
        "intrinsics_vector": lambda: pinhole.intrinsics_vector(1.0, 1.0, 0.0, 0.0),
        "imu_params_euroc": ImuParams.euroc,
        "imu_params_from_numpy": lambda: imu_params_from_numpy(
            ImuParams.euroc(device="cpu")._replace(a0=np.zeros(3))._asdict()),
        "empty_problem": lambda: empty_problem(tiny),
        "problem_from_numpy": lambda: problem_from_numpy(problem_to_numpy(empty_problem(tiny, device="cpu"))),
        "build_ba_problem": lambda: build_ba_problem(num_frames=2, frame_stride=4, n_landmarks=8, duration=0.1),
        "estimator": lambda: Estimator(_rig_from_numpy("cpu"), ImuParams.euroc(device="cpu")),
        "frontend": lambda: Frontend(_rig_from_numpy()),
        "frame_from_numpy": lambda: frame_from_numpy(*_frame_arrays()),
        "multiframe_from_numpy": lambda: multiframe_from_numpy(
            dict(id=1, timestamp=0.0, frames=[dict(zip(("uv", "score", "mask", "descriptors", "landmark_ids"),
                                                       _frame_arrays()))])),
        "threaded_vio": lambda: ThreadedVio(VioParameters()),
        "run_euroc": lambda: run_euroc(VioParameters(), str(REPO)),
        "threaded_vio_with_a_cpu_rig": lambda: ThreadedVio(VioParameters(), rig=_rig_from_numpy("cpu")),
        "build_rig": lambda: build_rig(VioParameters()),
        "build_imu_params": lambda: build_imu_params(VioParameters()),
        "estimator_from_numpy": lambda: estimator_from_numpy(
            estimator_to_numpy(Estimator(_rig_from_numpy("cpu"), ImuParams.euroc(device="cpu"), cfg=tiny,
                                         device="cpu")),
            _rig_from_numpy("cpu"), ImuParams.euroc(device="cpu"), tiny),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_point_without_device_raises_without_cuda(no_cuda, name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_entry_point_runs_on_cpu_when_asked(no_cuda):
    from okvis_tpu_torch.datasets.synthetic import euroc_stereo_rig
    from okvis_tpu_torch.frontend.frontend import Frontend

    specs, T_SC, intr = euroc_stereo_rig(device="cpu")
    assert T_SC.r.device.type == "cpu" and intr[0].dtype == torch.float64
    from okvis_tpu_torch.cameras.ncamera import NCameraSystem

    Frontend(NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intr))
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


def test_kernel_library_refuses_to_load_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(cuda_lib, "DEFAULT_CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_lib, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_lib.load_library()
    assert not (tmp_path / "build").exists()


def test_cached_kernel_library_keeps_its_build_log(monkeypatch, tmp_path):
    """A library found already built comes with the nvcc output of the build
    that made it: chip_smoke.py reads registers and spills from it."""
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_lib, "build_log", "")
    digest = cuda_lib._digest(sorted(cuda_lib.SRC_DIR.glob("*.cu")))
    lib = tmp_path / f"libokvis_tpu_torch_{digest}.so"
    lib.write_bytes(b"")
    lib.with_suffix(".log").write_text("ptxas info    : Used 87 registers")
    assert cuda_lib.build_library() == lib
    assert cuda_lib.build_log == "ptxas info    : Used 87 registers"


def test_cuda_wrappers_refuse_cpu_tensors():
    from okvis_tpu_torch.ops.hamming import hamming_matrix
    from okvis_tpu_torch.ops.hamming_cuda import hamming_matrix_cuda

    d = torch.zeros((4, 16), dtype=torch.int32)
    before = hamming_matrix_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        hamming_matrix_cuda(d, d)
    assert hamming_matrix_cuda.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        hamming_matrix(d.to("meta"), d.to("meta"))


@pytest.mark.parametrize("name,replaces", [
    ("harris_nms.cu", "okvis_tpu/ops/detection_pallas.py::harris_suppressed_pallas"),
    ("hamming.cu", "okvis_tpu/ops/hamming_pallas.py::hamming_matrix_pallas"),
])
def test_kernel_sources_name_the_tpu_kernel_they_replace(name, replaces):
    head = (PKG / "csrc" / name).read_text().split("#include")[0]
    assert f"Replaces the TPU kernel {replaces}" in " ".join(head.split()).replace("// ", "")
    assert "What bounds it on the H100" in head and "Design:" in head


def test_association_round_runs_on_cpu_without_a_card(no_cuda):
    """A whole association round on CPU tensors (the plain Hamming version)
    never asks for the card."""
    from okvis_tpu_torch.cameras.pinhole import CameraSpec
    from okvis_tpu_torch.datasets.synthetic import association_scene, euroc_stereo_rig
    from okvis_tpu_torch.cameras.ncamera import NCameraSystem
    from okvis_tpu_torch.frontend.kernels import associate_multicam
    from okvis_tpu_torch.kinematics import SE3

    specs, T_SC, intr = euroc_stereo_rig(device="cpu")
    d = association_scene(NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intr), P=1, K=16)
    t = lambda x: torch.from_numpy(np.asarray(x).view(np.int32) if np.asarray(x).dtype == np.uint32  # noqa: E731
                                   else np.asarray(x))
    order = ("desc_a", "sel3d", "hp", "free2", "uv_a", "std_a", "T_WS_b", "sb_b", "T_WC_a", "desc_b", "free_b",
             "uv_b", "std_b", "sel_prev", "pts_prev", "T_SC")
    args = [SE3(r=t(d[k][0]), q=t(d[k][1])) if k.startswith("T_") else t(d[k]) for k in order]
    out = associate_multicam(CameraSpec(*d["spec"]), torch.rand((2, 64, 3), dtype=torch.float64), t(d["intr"]),
                             *args, 40.0, 9.0, stereo_pairs=((0, 1),))
    assert out[0].shape == (1, 2, 16) and out[0].device.type == "cpu"
