"""
The 3D DG wave operator — the framework's flagship workload (reference:
``examples/dg_wave_grad.py``, ``dg_wave_div.py``, ``dg_wave_face_mass.py``,
``wave_3d_p4_auto.py``).

First-order acoustic wave system on E curved tetrahedral elements with P
volume dofs and F faces x Pf face dofs:

    dv/dt = grad(u):   v'[x,e,i] += dt * sum_{r,j} J[x,r,e] D[r,i,j] u[e,j]
    du/dt = div(v):    u'[e,i]   += dt * sum_{x,r,j} J[x,r,e] D[r,i,j] v[x,e,j]
                              + face lift: sum_{f,j} L[e,f,j] flux[f,e,j]
    flux from the state:         flux[f,e,j] = sum_i R[f,j,i] u[e,i]

(the face flux is COMPUTED from the state each step via the face-restriction
einsum R — a physically-coupled operator chain, not a fixed geometry array;
the random geometry stands in for mesh connectivity as in the reference's
random-input examples)

Every einsum runs through the transform-database machinery: programs are
built once, the archive is consulted for the best schedule on this device
(falling back to sane defaults), and the whole step jits into fused Pallas
kernels (or XLA programs, with ``use_pallas=False``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import sql_utils
from ..codegen.program import (
    EinsumProgram,
    build_executable,
    generate_program,
    generate_program_with_opt_einsum_schedule,
)
from ..diagnostics import NoFactInDatabaseError
from ..make_einsum import array, batched_einsum, einsum


def _default_transform(program: EinsumProgram, *, use_pallas: bool,
                       block_long: int) -> EinsumProgram:
    if use_pallas:
        from ..tuning.impls._common import default_pallas_program
        return default_pallas_program(program, block_long=block_long)
    return generate_program_with_opt_einsum_schedule(program.einsum)


class WaveOperator3D:
    """DG wave operator over ``n_elements`` elements at polynomial order
    giving ``ndof`` volume dofs and ``(nfaces, nfacedof)`` face dofs."""

    def __init__(self, *, ndof: int = 35, nfacedof: int = 15,
                 nfaces: int = 4, dtype: str = "float32",
                 use_pallas: bool = True, block_long: int = 128,
                 db_path: Optional[str] = None, device=None) -> None:
        self.ndof = ndof
        self.nfacedof = nfacedof
        self.nfaces = nfaces
        self.dtype = np.dtype(dtype)
        d = dtype

        self.grad_einsum = einsum(
            "xre,rij,ej->xei",
            array("J", (3, 3, "E"), d),
            array("D", (3, ndof, ndof), d),
            array("u", ("E", ndof), d))
        self.div_einsum = batched_einsum(
            "es,sij,ej->ei",
            [[array(f"J{x}", ("E", 3), d), array("D", (3, ndof, ndof), d),
              array(f"v{x}", ("E", ndof), d)] for x in "xyz"])
        self.face_einsum = einsum(
            "ifj,fe,fej->ei",
            array("L", (ndof, nfaces, nfacedof), d),
            array("Fj", (nfaces, "E"), d),
            array("flux", (nfaces, "E", nfacedof), d))
        # face restriction: volume dofs -> per-face face dofs (couples the
        # lift to the state; the matvec-per-element einsum family)
        self.restrict_einsum = einsum(
            "fji,ei->fej",
            array("R", (nfaces, nfacedof, ndof), d),
            array("u", ("E", ndof), d))

        from ..ops.layouts import dofmajor_layouts

        self._programs = {}
        for name, e in [("grad", self.grad_einsum),
                        ("div", self.div_einsum),
                        ("face", self.face_einsum),
                        ("restrict", self.restrict_einsum)]:
            program = generate_program(e)
            transform = None
            if db_path is not None:
                try:
                    transform = sql_utils.retrieve(e, device, db_path=db_path)
                except NoFactInDatabaseError:
                    transform = None
            if transform is not None:
                program = transform(program)
            else:
                program = _default_transform(
                    program, use_pallas=use_pallas, block_long=block_long)
            # the model keeps its state and geometry dof-major end to end
            # (zero transposes per step), so pin the data layouts regardless
            # of what schedule the archive chose — including resetting the
            # archive's storage-layout choices (fold_long / preblock_args
            # describe how *that schedule* wants arrays stored in HBM; the
            # model's state contract is plain dof-major).  The algebraic
            # schedule, backend, block size, and dot precision carry over.
            layouts, out_perm = dofmajor_layouts(e)
            program = program.with_descriptor(arg_layouts=layouts,
                                              out_layout=out_perm,
                                              fold_long=1,
                                              preblock_args=())
            self._programs[name] = program

    def executables(self, n_elements: int) -> dict:
        return {name: build_executable(p, long_dim_length=n_elements)
                for name, p in self._programs.items()}

    def make_step(self, n_elements: int, dt: float = 1e-3):
        """jittable ``step(state, geometry) -> state`` advancing (u, v) one
        explicit-Euler step of the wave system."""

        fns = self.executables(n_elements)

        def step(state, geom):
            # state is dof-major: u (P, E), v (3, P, E); geometry arrays are
            # pre-permuted by make_wave_state to match the programs' layouts
            u, v = state["u"], state["v"]
            grad_u, = fns["grad"]({"J": geom["J"], "D": geom["D"], "u": u})
            vx, vy, vz = fns["div"]({
                "Jx": geom["Jx"], "Jy": geom["Jy"], "Jz": geom["Jz"],
                "D": geom["D"],
                "vx": v[0], "vy": v[1], "vz": v[2]})
            div_v = vx + vy + vz                      # (P, E)
            # flux from the state: restrict u to the faces (stored (F,Pf,E),
            # exactly the layout the face program streams)
            flux, = fns["restrict"]({"R": geom["Rface"], "u": u})
            lift, = fns["face"]({"L": geom["L"], "Fj": geom["Fj"],
                                 "flux": flux})
            new_v = v + dt * grad_u                   # grad out: (x, P, E)
            new_u = u + dt * (div_v + lift)
            return {"u": new_u, "v": new_v}

        return step

    def layouts(self) -> dict:
        """arg name -> stored-axis permutation, across all programs."""
        out = {}
        for p in self._programs.values():
            out.update(p.descriptor.arg_layouts_map)
        return out


def make_wave_state(n_elements: int, *, ndof: int = 35, nfacedof: int = 15,
                    nfaces: int = 4, dtype: str = "float32", seed: int = 0
                    ) -> tuple:
    """(state, geometry) pytrees with random data (the reference examples
    likewise run on random inputs), in the model's dof-major storage
    layouts: u (P, E), v (3, P, E), per-component Jacobians (3, E); the face
    flux is not stored — it is computed from u each step via the
    face-restriction matrix ``Rface`` (F, Pf, P)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)

    def arr(*shape):
        return jnp.asarray(rng.random(shape), dtype=dtype)

    state = {"u": arr(ndof, n_elements),
             "v": arr(3, ndof, n_elements)}
    geom = {"J": arr(3, 3, n_elements),
            "Jx": arr(3, n_elements),
            "Jy": arr(3, n_elements),
            "Jz": arr(3, n_elements),
            "D": arr(3, ndof, ndof),
            "L": arr(nfaces, ndof, nfacedof),
            "Fj": arr(nfaces, n_elements),
            "Rface": arr(nfaces, nfacedof, ndof)}
    return state, geom
