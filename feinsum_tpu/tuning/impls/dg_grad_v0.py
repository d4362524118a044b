"""
Schedule space for the DG gradient family ``xre,rij,ej->xei`` (and the
2-operand ``re,rij,ej->ei`` variants).

Reference counterpart: ``tuning/impls/xre_rij_ej_to_xei.py`` /
``re_rij_ej_to_ei*.py``.  The space is the shared DG definition
(``make_dg_space``); the hoisted schedule (``hoist``) computes the 3
r-dots once per element block and contracts them with the Jacobian on
chip.
"""

from __future__ import annotations

from feinsum_tpu.tuning.impls._common import make_dg_space

transform = make_dg_space()


if __name__ == "__main__":
    import feinsum_tpu as f
    from feinsum_tpu.tuning import autotune

    ndof = 35
    einsum = f.einsum("xre,rij,ej->xei",
                      f.array("J", (3, 3, "E"), "float32"),
                      f.array("D", (3, ndof, ndof), "float32"),
                      f.array("u", ("E", ndof), "float32"))
    autotune(einsum, __file__, stop_after=300)
