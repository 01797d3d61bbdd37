"""RAM-or-disk array allocation (mm::vector equivalent).

Reference: /root/reference/src/mmvec.h:44-60 — containers hold data in
RAM until a size threshold (20 GiB default, overridable via
--sig-ram-limit / MEMSIGTHRESH, options.h:392-394) and transparently back
larger allocations with a file mmap. Here the big consumer is the (N, m)
signature matrix; numpy memmaps give the same spill behavior.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

DEFAULT_THRESHOLD = 20 << 30  # 20 GiB, mmvec.h:54


def alloc(shape, dtype, ram_limit: int = DEFAULT_THRESHOLD,
          fill=None) -> np.ndarray:
    """Allocate an array in RAM, or as a temp-file-backed memmap when it
    exceeds `ram_limit` bytes. The backing file is unlinked immediately
    (the mapping keeps it alive), so cleanup is automatic."""
    dtype = np.dtype(dtype)
    nbytes = int(np.prod(shape)) * dtype.itemsize
    if ram_limit <= 0 or nbytes <= ram_limit:
        out = np.empty(shape, dtype)
    else:
        fd, path = tempfile.mkstemp(prefix="d2_sigs_", suffix=".mm")
        try:
            os.ftruncate(fd, nbytes)
            out = np.memmap(path, dtype=dtype, mode="r+", shape=shape)
        finally:
            os.close(fd)
            os.unlink(path)
    if fill is not None:
        out[...] = fill
    return out
