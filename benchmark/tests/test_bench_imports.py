"""The import check: JAX and the JAX package nowhere in the benchmark, the
port nowhere in its reference, names compared as whole top-level words."""

import os

from benchmark import importcheck


def test_benchmark_passes():
    assert importcheck.faults() == []


def _tree(tmp_path, files):
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    return str(tmp_path)


def test_finds_jax_and_the_jax_package(tmp_path):
    root = _tree(tmp_path, {
        "a.py": "import jax.numpy as jnp\n",
        "b.py": "from raytracing_gpu_tpu.engine import render\n",
        "c.py": "import raytracing_gpu_tpu_torch\nimport jaxtyping\n",
        "d.py": "from flax import linen\n"})
    assert sorted(importcheck.faults(root)) == [
        ("a.py", "jax"), ("b.py", "raytracing_gpu_tpu"), ("d.py", "flax")]


def test_finds_the_port_in_the_reference(tmp_path):
    root = _tree(tmp_path, {
        os.path.join("reference", "x.py"):
            "def f():\n    from raytracing_gpu_tpu_torch.ops import build\n",
        "y.py": "from raytracing_gpu_tpu_torch.ops import build\n"})
    assert importcheck.faults(root) == [
        (os.path.join("reference", "x.py"), "raytracing_gpu_tpu_torch")]


def test_loaded_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "raytracing_gpu_tpu_torch_x",
                        types.ModuleType("raytracing_gpu_tpu_torch_x"))
    assert "raytracing_gpu_tpu_torch_x" not in importcheck.loaded()
    monkeypatch.setitem(sys.modules, "jaxlib.xla",
                        types.ModuleType("jaxlib.xla"))
    assert "jaxlib" in importcheck.loaded()
