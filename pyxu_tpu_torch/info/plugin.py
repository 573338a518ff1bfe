"""Entry-point plugin discovery (counterpart of
``pyxu_tpu/info/plugin.py``).

Third-party wheels contribute operators, solvers, stop criteria and math
routines to the port's namespaces through Python entry points, in these
groups:

    ``pyxu_tpu_torch.operator``   -> injected into :mod:`pyxu_tpu_torch.operator`
    ``pyxu_tpu_torch.opt.solver`` -> injected into :mod:`pyxu_tpu_torch.opt.solver`
    ``pyxu_tpu_torch.opt.stop``   -> injected into :mod:`pyxu_tpu_torch.opt.stop`
    ``pyxu_tpu_torch.math``       -> injected into :mod:`pyxu_tpu_torch.math`

A plugin wheel declares, e.g. in its ``pyproject.toml``::

    [project.entry-points."pyxu_tpu_torch.operator"]
    MyRadon = "my_pkg.ops:MyRadon"

Names prefixed with ``_`` *override* an existing symbol of the same
(unprefixed) name; overriding without the prefix is refused with a
warning, so a plugin cannot silently shadow the core API.
"""

from __future__ import annotations

import importlib
import importlib.metadata
import warnings as _w

from pyxu_tpu_torch.info.warnings import BackendWarning

__all__ = ["discover_plugins", "load_plugins", "PLUGIN_GROUPS"]

PLUGIN_GROUPS = (
    "pyxu_tpu_torch.operator",
    "pyxu_tpu_torch.opt.solver",
    "pyxu_tpu_torch.opt.stop",
    "pyxu_tpu_torch.math",
)


def discover_plugins(group: str = None) -> dict:
    """Map ``group -> {name: entry_point}`` for installed plugin wheels
    (nothing is imported yet)."""
    groups = PLUGIN_GROUPS if group is None else (group,)
    eps = importlib.metadata.entry_points()
    return {g: {ep.name: ep for ep in eps.select(group=g)} for g in groups}


def load_plugins(group: str = None) -> dict:
    """Import every discovered plugin and inject its symbols into the
    target module.  Returns ``{qualified_name: object}`` of everything
    loaded.  A plugin that fails to load warns (BackendWarning) instead of
    raising, so one broken plugin cannot take down the package."""
    loaded = {}
    for g, eps in discover_plugins(group).items():
        if not eps:
            continue
        mod = importlib.import_module(g)
        for name, ep in eps.items():
            try:
                obj = ep.load()
            except Exception as e:  # noqa: BLE001 - isolation by design
                _w.warn(f"plugin {g}:{name} failed to load: {e!r}",
                        BackendWarning, stacklevel=2)
                continue
            target = name
            if name.startswith("_"):
                target = name[1:]  # explicit-override convention
            elif hasattr(mod, name):
                _w.warn(
                    f"plugin {g}:{name} shadows an existing symbol; "
                    f"rename it or use the '_' override prefix — skipped",
                    BackendWarning, stacklevel=2)
                continue
            setattr(mod, target, obj)
            loaded[f"{g}.{target}"] = obj
    return loaded
