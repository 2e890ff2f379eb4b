"""Ad-hoc device-buffer dump helpers — the reference's debug-macro surface.

The reference exposes console/MAT dump macros for arbitrary device buffers
(``PRINT_FROM_DEVICE``/``PRINT_FROM_DEVICE_INT``, Utilities.h:30-52;
``WRITE_MAT_FROM_DEVICE*``, Utilities.h:55-73) and for sparse operators
(``PRINT_SPARSE_CSR``, Utilities.h:90-102; printed 1-based via
``operator<<``, Utilities.cpp:222-240).  The equivalents here:

* Host side, a device buffer is just an array to fetch — ``print_from_device``
  and ``write_mat_from_device`` take any jax/numpy array (float or int; the
  reference's two dtype-specific macros collapse into one function).
* *Inside* ``jit`` — where the reference would printf from a kernel —
  ``print_in_jit`` stages the same dump through ``jax.debug.callback``, so a
  traced intermediate can be printed without breaking the compiled program.
* Sparse operators don't exist as stored matrices in this framework; the
  ``print_sparse``/``print_operator`` helpers reconstruct the reference's
  COO triplets from the product's stencil/resample fields (``sparse_dump``)
  and print them in ``operator<<``'s exact 1-based ``ii/jj/kk`` format.

Masked column-major packing (the layout of the reference's device vectors)
is available via ``pack=mask``.
"""

from __future__ import annotations

import sys

import numpy as np

from ..ops.grid import masked_select_colmajor
from . import sparse_dump
from .writers import save_vector_mat


def _fetch(arr, pack=None) -> np.ndarray:
    """Device -> host flat vector; optional masked colmajor packing (the
    reference's vector layout, SRPS.cu:160-168)."""
    a = np.asarray(arr)
    if pack is not None:
        a = masked_select_colmajor(a, np.asarray(pack))
    return a.reshape(-1)

def _fmt(v) -> str:
    if np.issubdtype(np.asarray(v).dtype, np.integer):
        return str(int(v))
    return f"{float(v):g}"


def print_from_device(arr, pack=None, stream=None) -> None:
    """``[v0 v1 ... ];`` console dump of any array — PRINT_FROM_DEVICE /
    PRINT_FROM_DEVICE_INT (Utilities.h:30-52; one function, dtype kept)."""
    stream = stream or sys.stdout
    vals = _fetch(arr, pack)
    stream.write("[" + " ".join(_fmt(v) for v in vals) + " ];\n")


def print_in_jit(arr, name: str = "") -> None:
    """In-``jit`` variant: call on a traced array inside a jitted function
    and the same ``[ ... ];`` line is emitted at run time via
    ``jax.debug.callback`` — the JAX analog of printing from device code."""
    import jax

    def _cb(a):
        if name:
            sys.stdout.write(name + " = ")
        print_from_device(a)

    jax.debug.callback(_cb, arr)


def write_mat_from_device(arr, filename: str, pack=None) -> None:
    """Dump any array as a MAT 7.3 column vector ``x`` —
    WRITE_MAT_FROM_DEVICE / _INT (Utilities.h:55-73; float32 via
    write_MAT_floats, Utilities.cpp:46-63, int32 via write_MAT_ints,
    Utilities.cpp:65-82)."""
    vals = _fetch(arr, pack)
    if np.issubdtype(vals.dtype, np.integer):
        vals = vals.astype(np.int32)
    else:
        vals = vals.astype(np.float32)
    save_vector_mat(filename, vals)


def print_sparse(ii, jj, kk, rows: int, cols: int, stream=None) -> None:
    """1-based ``ii/jj/kk`` triplet print, byte-matching the reference's
    ``operator<<(SparseCOO<float>)`` (Utilities.cpp:222-240)."""
    stream = stream or sys.stdout
    stream.write("ii = [" + " ".join(str(int(i) + 1) for i in ii) + "  ];\n")
    stream.write("jj = [" + " ".join(str(int(j) + 1) for j in jj) + "  ];\n")
    stream.write("kk = [" + " ".join(_fmt(v) for v in kk) + "  ];\n")
    stream.write(f"rows = {int(rows)}, cols = {int(cols)}\n")


def print_operator(which: str, prob, sf: int, stream=None) -> None:
    """PRINT_SPARSE_CSR analog (Utilities.h:90-102) for the framework's
    implicit operators: reconstruct ``Dx``/``Dy``/``D``/``KT`` COO triplets
    from the stencil/resample fields and print them 1-based."""
    mask = np.asarray(prob.mask)
    h, w = mask.shape
    which = which.lower()
    if which in ("dx", "dy"):
        dx, dy, npix = sparse_dump.gradient_coo(prob.gm, mask)
        tri = dx if which == "dx" else dy
        print_sparse(*tri, npix, npix, stream=stream)
    elif which == "d":
        print_sparse(*sparse_dump.downsample_coo(h, w, sf), stream=stream)
    elif which == "kt":
        print_sparse(*sparse_dump.kt_coo(mask, prob.masks, sf), stream=stream)
    else:
        raise ValueError(f"unknown operator {which!r} (Dx/Dy/D/KT)")
