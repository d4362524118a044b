"""
Schedule space for the DG divergence family ``xre,rij,xej->ei`` /
``es,sij,ej->ei`` (batched or single-output).

Reference counterpart: ``tuning/impls/xre_rij_xej_to_ei*.py`` /
``batched_xre_rij_xej_to_ei.py`` (split element axis, hoist the
Jacobian-contraction into LOCAL memory, prefetch the reference matrix).
Here the same decisions are descriptor knobs over ONE shared space
definition (``make_dg_space``), so every DG family searches the full
block/warps/jfold/prereduce/hoist vocabulary; structurally inapplicable
knobs gate themselves off.
"""

from __future__ import annotations

from feinsum_tpu.tuning.impls._common import make_dg_space

transform = make_dg_space()


if __name__ == "__main__":
    import feinsum_tpu as f
    from feinsum_tpu.tuning import autotune

    ndof = 35
    einsum = f.batched_einsum(
        "es,sij,ej->ei",
        [[f.array(j, ("E", 3), "float32"),
          f.array("R", (3, ndof, ndof), "float32"),
          f.array(u, ("E", ndof), "float32")]
         for j, u in [("Jx", "ux"), ("Jy", "uy"), ("Jz", "uz")]])
    autotune(einsum, __file__, stop_after=300)
