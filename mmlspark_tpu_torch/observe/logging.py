"""Namespaced logger factory (the port of `mmlspark_tpu/observe/logging.py`).

Every logger is `<root>.<suffix>`, made through one factory, so the whole
package is silenceable/redirectable from a single knob:
`get_logger("serve")` -> logger "mmlspark_tpu_torch.serve", with the root
level driven by the MMLSPARK_TPU_LOG_LEVEL variable of the
mmlspark_tpu_torch.config registry.
"""

from __future__ import annotations

import logging

LOG_ROOT = "mmlspark_tpu_torch"
_configured = False


def _configure_root() -> None:
    global _configured
    if _configured:
        return
    from mmlspark_tpu_torch import config
    root = logging.getLogger(LOG_ROOT)
    level = config.LOG_LEVEL.current()
    if level is not None:
        # the user asked the framework to manage its own output: set the
        # level and attach a handler so records print without propagating
        # twice through an application root
        root.setLevel(getattr(logging, level.upper(), logging.WARNING))
        if not any(isinstance(h, logging.StreamHandler)
                   for h in root.handlers):
            handler = logging.StreamHandler()
            handler.setFormatter(logging.Formatter(
                "%(asctime)s %(name)s %(levelname)s: %(message)s"))
            root.addHandler(handler)
            root.propagate = False
    # otherwise: normal library behavior — no handlers, propagation on,
    # the application's logging config decides what shows
    _configured = True


def get_logger(suffix: str = "") -> logging.Logger:
    """The canonical logger for a subsystem: one per package, named under
    the framework root (`get_logger("train")` ->
    "mmlspark_tpu_torch.train")."""
    _configure_root()
    name = f"{LOG_ROOT}.{suffix}" if suffix else LOG_ROOT
    return logging.getLogger(name)
