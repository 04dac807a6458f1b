"""A configuration's family module: ``servebench/reference/<name>.py``, named
by the configuration file's ``"reference"`` key.

It is the one place a layer kind is described, and exports

* ``layer_shapes(cfg, kind)``: one layer's leaves (without the repeats
  dim), in the served program's layout;
* ``layer_flops(cfg, kind, s)``: a layer's products and conv over ``s``
  positions, as arithmetic over those leaves (attention's and the scan's
  algorithmic counts are ``harness/work.py``'s, one count for every
  family);
* ``combined(cfg, trees, tokens, *, block_rows, prec)``: the ensemble's
  plain answer (``harness/check.py`` says what it returns).

The module imports nothing of the program, of JAX or of ``harness``.  It
is loaded by import path, so a test can register a module of its own
under ``reference.<name>`` in ``sys.modules``.
"""
from __future__ import annotations

import importlib
from types import ModuleType

FUNCTIONS = ("layer_shapes", "layer_flops", "combined")


def module(cfg: dict) -> ModuleType:
    """The family module of ``cfg``; raises ``ValueError`` where the
    configuration names none, the module is missing, or it lacks one of
    ``FUNCTIONS``."""
    name = cfg.get("reference")
    if not isinstance(name, str) or not name:
        raise ValueError(f"configuration {cfg.get('name')!r} names no "
                         f"\"reference\" module")
    path = "reference." + name
    try:
        mod = importlib.import_module(path)
    except ModuleNotFoundError as e:
        if e.name not in (path, "reference"):
            raise
        raise ValueError(f"configuration {cfg.get('name')!r}: no module "
                         f"servebench/reference/{name}.py") from None
    missing = [f for f in FUNCTIONS if not callable(getattr(mod, f, None))]
    if missing:
        raise ValueError(f"reference module {name!r} lacks {missing}")
    return mod
