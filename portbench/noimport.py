"""The import checks: what a run may not load and what the reference may not
import, compared by whole top-level module names (the part before the first
dot), since the port's own name begins with the JAX package's."""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, List

FORBIDDEN_IN_RUN = ("jax", "jaxlib", "flax", "mlx_video_tpu")
FORBIDDEN_IN_REFERENCE = FORBIDDEN_IN_RUN + ("mlx_video_tpu_torch",)


def loaded(forbidden: Iterable[str] = FORBIDDEN_IN_RUN, modules=None) -> List[str]:
    """The modules of ``sys.modules`` (or ``modules``) whose top-level name is
    one of ``forbidden``."""
    names = set(forbidden)
    return sorted(m for m in (sys.modules if modules is None else modules) if m.split(".")[0] in names)


def imported_by(path: Path) -> List[str]:
    """Top-level names of every module a Python file imports, anywhere in
    it (absolute imports; a relative one names no top-level package)."""
    out = set()
    for node in ast.walk(ast.parse(Path(path).read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return sorted(out)


def reference_violations(reference_dir: Path) -> List[str]:
    """``file: module`` for every import of a forbidden package in the plain
    reference's files."""
    bad = []
    for path in sorted(Path(reference_dir).glob("*.py")):
        bad += [f"{path.name}: {m}" for m in imported_by(path) if m in FORBIDDEN_IN_REFERENCE]
    return bad
