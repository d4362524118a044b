"""
3D DG Maxwell (source-free curl-curl system) — the curl-family flagship
(reference class: ``tuning/impls/re_rji_ej_to_ei_3d_cross_product_v0.py``;
the wave model covers the div/grad/face families, this one exercises the
cross-product structure as a physically-coupled operator chain).

Non-dimensionalized source-free Maxwell on E curved tetrahedral elements:

    dE/dt =  curl(H)        dH/dt = -curl(E)

with the DG curl on curved elements (chain rule through the metric
columns J_b[r, e] = d xi_r / d x_b):

    (curl F)_a[e, i] = eps_{abc} * sum_{r,j} J_b[e, r] D[r, i, j] F_c[e, j]

i.e. per component two div-class contractions ("es,sij,ej->ei") with
opposite signs — the model builds ONE batched einsum with six rows
(+y z, -z y, +z x, -x z, +x y, -y x) sharing D and the metric columns, so
a single fused kernel streams every operand once per step, and the +/-
pairing happens on the (tiny) outputs.

Like the wave model, every einsum goes through the transform archive
(``db_path``) with a sane Pallas default fallback, and state/geometry are
dof-major end to end.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import sql_utils
from ..codegen.program import build_executable, generate_program
from ..diagnostics import NoFactInDatabaseError
from ..make_einsum import array, batched_einsum
from .wave import _default_transform

# six rows of the cross product: (metric column, source component, sign);
# rows 2k/2k+1 are the +/- halves of curl component k (x, y, z)
_CURL_ROWS = (("Jy", "Fz"), ("Jz", "Fy"),
              ("Jz", "Fx"), ("Jx", "Fz"),
              ("Jx", "Fy"), ("Jy", "Fx"))


class MaxwellOperator3D:
    """DG Maxwell curl operator over ``n_elements`` curved elements with
    ``ndof`` volume dofs per field component."""

    def __init__(self, *, ndof: int = 35, dtype: str = "float32",
                 use_pallas: bool = True, block_long: int = 128,
                 db_path: Optional[str] = None, device=None) -> None:
        self.ndof = ndof
        self.dtype = np.dtype(dtype)
        d = dtype

        self.curl_einsum = batched_einsum(
            "es,sij,ej->ei",
            [[array(jb, ("E", 3), d),
              array("D", (3, ndof, ndof), d),
              array(fc, ("E", ndof), d)]
             for jb, fc in _CURL_ROWS])

        program = generate_program(self.curl_einsum)
        transform = None
        if db_path is not None:
            try:
                transform = sql_utils.retrieve(self.curl_einsum, device,
                                               db_path=db_path)
            except NoFactInDatabaseError:
                transform = None
        if transform is not None:
            program = transform(program)
        else:
            program = _default_transform(
                program, use_pallas=use_pallas, block_long=block_long)
        # dof-major state contract, as in the wave model: reset archive
        # storage-layout choices, keep the algebraic/backing choices
        from ..ops.layouts import dofmajor_layouts
        layouts, out_perm = dofmajor_layouts(self.curl_einsum)
        self._program = program.with_descriptor(
            arg_layouts=layouts, out_layout=out_perm,
            fold_long=1, preblock_args=())

    def make_step(self, n_elements: int, dt: float = 1e-3):
        """jittable ``step(state, geom) -> state`` advancing (E, H) one
        explicit-Euler step of the source-free Maxwell system."""
        fn = build_executable(self._program, long_dim_length=n_elements)

        def curl(field, geom):
            # field: (3, P, E) dof-major; rows come back (P, E) each
            rows = fn({"Jx": geom["Jx"], "Jy": geom["Jy"],
                       "Jz": geom["Jz"], "D": geom["D"],
                       "Fx": field[0], "Fy": field[1], "Fz": field[2]})
            import jax.numpy as jnp
            return jnp.stack([rows[0] - rows[1],
                              rows[2] - rows[3],
                              rows[4] - rows[5]])

        def step(state, geom):
            e, h = state["E"], state["H"]
            new_e = e + dt * curl(h, geom)
            new_h = h - dt * curl(e, geom)
            return {"E": new_e, "H": new_h}

        return step


def make_maxwell_state(n_elements: int, *, ndof: int = 35,
                       dtype: str = "float32", seed: int = 0) -> tuple:
    """(state, geometry) pytrees with random data in the model's dof-major
    layouts: E/H (3, P, Elems), metric columns (3, Elems), D (3, P, P)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)

    def arr(*shape):
        return jnp.asarray(rng.random(shape), dtype=dtype)

    state = {"E": arr(3, ndof, n_elements), "H": arr(3, ndof, n_elements)}
    geom = {"Jx": arr(3, n_elements), "Jy": arr(3, n_elements),
            "Jz": arr(3, n_elements), "D": arr(3, ndof, ndof)}
    return state, geom
