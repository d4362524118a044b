"""
Schedule space for the DG face-mass / lift family ``ifj,fe,fej->ei``.

Reference counterpart: ``tuning/impls/ifj_fe_fej_to_ei*.py`` (gather-heavy,
per-face unroll).  The tiny face axis ``f`` unrolls inside the kernel
automatically (it is a small axis in the lowering); the space is the shared
DG definition (``make_dg_space``).
"""

from __future__ import annotations

from feinsum_tpu.tuning.impls._common import make_dg_space

transform = make_dg_space()


if __name__ == "__main__":
    import feinsum_tpu as f
    from feinsum_tpu.tuning import autotune

    einsum = f.einsum("ifj,fe,fej->ei",
                      f.array("L", (35, 4, 15), "float32"),
                      f.array("F", (4, "E"), "float32"),
                      f.array("uf", (4, "E", 15), "float32"))
    autotune(einsum, __file__, stop_after=300)
