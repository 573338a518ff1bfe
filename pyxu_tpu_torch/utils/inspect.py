"""Introspection helpers (counterpart of ``pyxu_tpu/utils/inspect.py``)."""

from __future__ import annotations

import importlib
import inspect
import types

__all__ = ["parse_params", "import_module"]


def parse_params(func, *args, **kwargs) -> dict:
    """(key, value) params as seen in the body of ``func`` when called via
    ``func(*args, **kwargs)``."""
    sig = inspect.Signature.from_callable(func)
    f_args = sig.bind(*args, **kwargs)
    f_args.apply_defaults()
    return dict(f_args.arguments)


def import_module(name: str, fail_on_error: bool = True) -> types.ModuleType:
    """Load a module dynamically; None when absent and
    ``fail_on_error=False``."""
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError:
        if fail_on_error:
            raise
        return None
