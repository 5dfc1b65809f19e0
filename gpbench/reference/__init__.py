"""The plain reference: the GP (``gp.py``) over a kernel found by name
(``kernels/<kernel>.py``), and the system that makes the data
(``systems/<system>.py``).  It imports nothing of the program."""

from __future__ import annotations

import importlib
from types import ModuleType


def system(config: dict) -> ModuleType:
    """The configuration's system, ``gpbench/reference/systems/<system>.py``."""
    return importlib.import_module(
        f"gpbench.reference.systems.{config['system']}")
