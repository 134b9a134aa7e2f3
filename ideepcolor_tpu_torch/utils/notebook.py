"""Run a notebook's code cells without Jupyter: in order, in one namespace.

The ``.ipynb`` is read as JSON (no ``nbformat``); IPython's line magics and
shell escapes (``%...``, ``!...``) are dropped; ``assign`` replaces the
right-hand side of top-level assignments by name (``{"DEVICE": "cpu"}``
turns ``DEVICE = "cuda"`` into ``DEVICE = 'cpu'``), so one notebook runs on
the card or the CPU. A failing cell raises with its index in the
traceback's file name.
"""

from __future__ import annotations

import json
import re


def code_cells(path: str) -> list[str]:
    """The code cells' sources, magics and shell escapes dropped."""
    with open(path) as f:
        nb = json.load(f)
    cells = []
    for cell in nb["cells"]:
        if cell["cell_type"] != "code":
            continue
        src = cell["source"]
        src = "".join(src) if isinstance(src, list) else src
        cells.append("\n".join(line for line in src.splitlines()
                               if not line.lstrip().startswith(("%", "!"))))
    return cells


def run_cells(path: str, assign: dict | None = None,
              namespace: dict | None = None):
    """Execute the code cells of ``path`` in order in ``namespace`` (a new
    one by default), yielding ``(index, namespace)`` after each."""
    ns = {"__name__": "__main__"} if namespace is None else namespace
    for i, src in enumerate(code_cells(path)):
        for name, value in (assign or {}).items():
            src = re.sub(rf"(?m)^{re.escape(name)}\s*=.*$",
                         f"{name} = {value!r}", src)
        exec(compile(src, f"{path}[cell {i}]", "exec"), ns)
        yield i, ns

