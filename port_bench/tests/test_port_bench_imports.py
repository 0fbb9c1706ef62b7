"""The import check compares each module's top-level name whole, and the
reference, the inputs and the yardstick import nothing of the program,
JAX or the JAX package."""

import ast
import subprocess
import sys

from conftest import ROOT


def test_top_level_names_compared_whole():
    sys.path.insert(0, str(ROOT / "port_bench"))
    from port_bench.run import loaded_forbidden

    assert loaded_forbidden({"segs_slam_tpu_torch": 1,
                             "segs_slam_tpu_torch.ops.rasterizer": 1,
                             "jaxtyping": 1, "flax_like": 1}) == []
    assert loaded_forbidden({"segs_slam_tpu.models": 1, "jax.numpy": 1,
                             "jaxlib": 1, "flax": 1}) == [
        "flax", "jax", "jaxlib", "segs_slam_tpu"]


def _imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "scene.py", "work.py"):
        found = _imports(ROOT / "port_bench" / name)
        assert not found & {"segs_slam_tpu_torch", "segs_slam_tpu", "jax",
                            "jaxlib", "flax"}, (name, found)


def test_harness_never_names_jax():
    for path in (ROOT / "port_bench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        found = _imports(path)
        assert not found & {"segs_slam_tpu", "jax", "jaxlib", "flax"}, path


def test_a_cpu_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import torch\n"
        "from conftest import tiny_cell\n"
        "from port_bench import bench\n"
        "from port_bench.run import loaded_forbidden\n"
        "cfg, tr, lim = tiny_cell('tum_rgbd.render')\n"
        "bench.run_cell('tum_rgbd.render', 1, 0.2, False,"
        " torch.device('cpu'), cfg=cfg, traffic=tr, limits=lim,"
        " log=lambda *a, **k: None)\n"
        "assert loaded_forbidden() == [], loaded_forbidden()\n"
        % (str(ROOT), str(ROOT / "port_bench" / "tests")))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    res = subprocess.run(
        [sys.executable, str(ROOT / "port_bench" / "run.py"), "--workload",
         "tum_rgbd.render", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT / "build")})
    import torch

    if torch.cuda.is_available():
        return
    assert res.returncode != 0 and "{" not in res.stdout
