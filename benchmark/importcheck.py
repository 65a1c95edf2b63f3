"""The import check: no module of the benchmark imports JAX or the JAX
package, and no module of the reference imports the port.

Names are compared by their top-level part (before the first dot) as a
whole word, because the port's package name begins with the JAX
package's.  `imports_of` reads a module's import statements without
running it; `loaded` reads what a process has loaded.
"""

from __future__ import annotations

import ast
import os
import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "raytracing_gpu_tpu"})
PORT = "raytracing_gpu_tpu_torch"
HERE = os.path.dirname(os.path.abspath(__file__))


def imports_of(path: str) -> set:
    """Top-level names of the absolute imports in a Python file."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            names.add(node.module.split(".")[0])
    return names


def faults(root: str = HERE) -> list:
    """(file, name) of every forbidden import under `root`: JAX or the
    JAX package anywhere, the port under `reference/`."""
    out = []
    ref = os.path.join(root, "reference") + os.sep
    for d, _, files in os.walk(root):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            bad = set(FORBIDDEN)
            if path.startswith(ref):
                bad.add(PORT)
            out += [(os.path.relpath(path, root), n)
                    for n in sorted(imports_of(path) & bad)]
    return out


def loaded() -> list:
    """Forbidden top-level names among the process's loaded modules."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
