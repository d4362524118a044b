"""
Schedule space for 3-D curl / cross-product batched einsums — b=3 output
rows, each contracting a rotated pairing of geometry and dof operands
(e.g. ``(curl u)_x = Σ_r J_y·D_r·u_z − J_z·D_r·u_y`` expressed as two
batched-einsum rows per component).

Reference counterpart: ``tuning/impls/re_rji_ej_to_ei_3d_cross_product_v0.py``
(which needs accumulator init/assign-id surgery on the loopy kernel,
``:12-40``).  Here multi-row accumulation is native to the emitter (every
batch row lowers inside one fused kernel and rows sharing operands CSE).
The space is the shared DG definition (``make_dg_space``); curl is the
family where ``prereduce`` gates ON (its D(r,i,j) has r private; the
built-in schedule pre-reduces it in XLA once per launch).  The file exists so curl-class facts carry their own
transform_id in the archive.
"""

from __future__ import annotations

from feinsum_tpu.tuning.impls._common import make_dg_space

transform = make_dg_space()


if __name__ == "__main__":
    import feinsum_tpu as f
    from feinsum_tpu.tuning import autotune

    ndof = 35
    # (curl u) component rows: J_a (E,) per-element geometry factor,
    # D (3, ndof, ndof) reference derivatives, u_b (E, ndof) dofs
    einsum = f.batched_einsum(
        "e,rij,ej->ei",
        [[f.array(j, ("E",), "float32"),
          f.array("D", (3, ndof, ndof), "float32"),
          f.array(u, ("E", ndof), "float32")]
         for j, u in [("Jy", "uz"), ("Jz", "ux"), ("Jx", "uy")]])
    autotune(einsum, __file__, stop_after=300)
