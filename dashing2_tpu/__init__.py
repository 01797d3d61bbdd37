"""dashing2_tpu: a GPU-accelerated genomic sketching + comparison framework.

A ground-up rebuild of the capabilities of dnbaker/dashing2 in JAX:
XLA/Pallas device kernels for k-mer hashing, sketch register updates, and
tiled all-pairs register comparisons; jax.sharding meshes for multi-device
scaling; a host layer for FASTX/BED/BigWig ingest and the reference's
on-disk formats.

64-bit integer semantics are required throughout (k-mer codes, hash values),
so importing this package enables jax x64 mode. Hot device kernels
nevertheless operate on u32 limb pairs.
"""

import os as _os

import jax

jax.config.update("jax_enable_x64", True)


def compile_cache_dir():
    """Where the persistent XLA compilation cache lives, or None for no
    cache. JAX_COMPILATION_CACHE_DIR wins (JAX reads it itself); else a
    fixed directory inside the checkout, so that every process run from
    it -- on any machine it is copied to -- finds the same entries. None
    when JAX_PLATFORMS names only the CPU (the tests) or
    DASHING2_TPU_NO_COMPILE_CACHE is set."""
    if _os.environ.get("DASHING2_TPU_NO_COMPILE_CACHE"):
        return None
    env = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    plats = [p.strip() for p in
             _os.environ.get("JAX_PLATFORMS", "").lower().split(",")
             if p.strip()]
    if plats and all(p == "cpu" for p in plats):
        return None
    return _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), ".jax_cache")


_cc = compile_cache_dir()
if _cc is not None:
    try:
        if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            _os.makedirs(_cc, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", _cc)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    except OSError:
        pass  # read-only install: run without a persistent cache

from . import enums  # noqa: E402
from .enums import (  # noqa: E402
    DataType,
    SketchSpace,
    CountingType,
    KmerSketchResultType,
    OutputKind,
    OutputFormat,
    Measure,
)
from .config import Dashing2Options, Dashing2DistOptions  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "enums",
    "DataType",
    "SketchSpace",
    "CountingType",
    "KmerSketchResultType",
    "OutputKind",
    "OutputFormat",
    "Measure",
    "Dashing2Options",
    "Dashing2DistOptions",
    "__version__",
]
