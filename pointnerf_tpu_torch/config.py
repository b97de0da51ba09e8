"""The port's configuration: `pointnerf_tpu.config` reused as it is.

That module imports only dataclasses, json and typing, so `Options` and the
presets are shared by both packages without pulling in JAX.
"""

from __future__ import annotations

import os

# pointnerf_tpu/__init__.py creates a JAX compile-cache directory on import
# unless this variable is already set; the port runs no JAX, so it asks for
# none (a JAX process that set it first keeps its own value).
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "")

from pointnerf_tpu.config import (  # noqa: E402
    PRESETS, Options, nerf_synth_preset)

__all__ = ["Options", "PRESETS", "nerf_synth_preset"]
