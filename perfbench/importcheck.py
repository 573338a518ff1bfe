"""Static check of every Python file under ``perfbench/``: the modules it
imports, by top-level name compared whole.

* No file imports ``jax``, ``jaxlib``, ``flax`` or the JAX package
  ``pyxu_tpu`` (``pyxu_tpu_torch``, the port, is another name).
* Only ``configs/`` imports the port (and the tests, which plant faults
  in it): the references, the work counts, the metrics and the harness
  measure it without using it.

    python3 perfbench/importcheck.py      # exit 1 and the offenders
"""

from __future__ import annotations

import ast
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent
BLOCKED = {"jax", "jaxlib", "flax", "pyxu_tpu"}
PORT = "pyxu_tpu_torch"
PORT_ALLOWED = ("configs", "tests")


def imported(source: str) -> set:
    """Top-level names of the modules ``source`` imports, also through
    ``importlib.import_module("...")`` and ``__import__("...")`` with a
    literal name."""
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and node.args:
            f = node.func
            fname = f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", None)
            arg = node.args[0]
            if fname in ("import_module", "__import__") and \
                    isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                 str):
                names.add(arg.value.split(".")[0])
    return names


def offenders(root=ROOT) -> list:
    """``[(relative path, name)]`` of every import the rules forbid."""
    out = []
    for path in sorted(pathlib.Path(root).rglob("*.py")):
        rel = path.relative_to(root)
        names = imported(path.read_text())
        for n in sorted(names & BLOCKED):
            out.append((str(rel), n))
        if PORT in names and rel.parts[0] not in PORT_ALLOWED:
            out.append((str(rel), PORT))
    return out


if __name__ == "__main__":
    bad = offenders()
    for rel, name in bad:
        print(f"{rel}: imports {name}", file=sys.stderr)
    sys.exit(1 if bad else 0)
