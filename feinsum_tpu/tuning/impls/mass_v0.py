"""
Schedule space for the mass-matrix family ``e,ij,ej->ei`` and the
per-element matvec ``ij,ej->ei``.

Reference counterpart: ``tuning/impls/e_ij_ej_to_ei_no_prftch.py`` /
``ij_ej_to_ei_no_prftch.py``.  The space is the shared DG definition
(``make_dg_space``).
"""

from __future__ import annotations

from feinsum_tpu.tuning.impls._common import make_dg_space

transform = make_dg_space()


if __name__ == "__main__":
    import feinsum_tpu as f
    from feinsum_tpu.tuning import autotune

    ndof = 35
    einsum = f.einsum("e,ij,ej->ei",
                      f.array("jac", ("E",), "float32"),
                      f.array("M", (ndof, ndof), "float32"),
                      f.array("u", ("E", ndof), "float32"))
    autotune(einsum, __file__, stop_after=120)
