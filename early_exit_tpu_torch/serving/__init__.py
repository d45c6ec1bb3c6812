"""Serving entry points, imported on first use: `ExportedRecognizer`
(`serving/export.py`), which runs a bundle with no model code, loads no
model module through this package.
"""

import importlib

_WHERE = {"StreamingRecognizer": "streaming", "StreamPool": "streaming",
          "ExportedRecognizer": "export"}
__all__ = sorted(_WHERE)


def __getattr__(name):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_WHERE[name]}"), name)
