"""The product's core promise: a transform tuned against a reference einsum
replays onto a *differently-named* user computation (reference:
doc/compiler_writer_tutorial.rst + test_loopy_utils.py:145-173) — including
a user function that computes a SUM of einsums (``2*div(u) - lift(flux)``),
where ``insn_match`` selects the instruction to transform (reference parity:
the loopy ``insn_match`` filter, loopy_utils/__init__.py:233-254)."""
import jax.numpy as jnp
import numpy as np

import feinsum_tpu as f

f.enable_persistent_compilation_cache()
from feinsum_tpu.matching import (
    get_a_matched_einsum,
    get_matched_einsums,
    match_fn_to_einsum,
)

# the archived reference einsum (canonical names irrelevant): the DG
# divergence class, es,sij,ej->ei
ref = f.einsum("es,sij,ej->ei",
               f.array("Jac", ("E", 3), "float32"),
               f.array("Dmat", (3, 35, 35), "float32"),
               f.array("dofs", ("E", 35), "float32"))


# the user's computation, as they wrote it: a full DG right-hand side —
# divergence volume term plus face-mass lift, with a literal scalar factor
def user_rhs(geo_jac, diff_mat, u_dofs, lift_mat, face_jac, flux):
    vol = jnp.einsum("np,pdq,nq->nd", geo_jac, diff_mat, u_dofs)
    surf = jnp.einsum("dfq,fn,fnq->nd", lift_mat, face_jac, flux)
    return 2.0 * vol - surf


E = 8192
example = [jnp.ones((E, 3), jnp.float32),
           jnp.ones((3, 35, 35), jnp.float32),
           jnp.ones((E, 35), jnp.float32),
           jnp.ones((35, 4, 15), jnp.float32),
           jnp.ones((4, E), jnp.float32),
           jnp.ones((4, E, 15), jnp.float32)]

# enumerate the einsum instructions inside the composite function
for einsum_k, name_map_k, info in get_matched_einsums(user_rhs, example):
    print(f"insn {info.flat_index}: {einsum_k.get_subscripts():24s}"
          f" reads {info.arg_names}")

# select the gradient instruction and match it against the archive's einsum
matched, name_map = get_a_matched_einsum(
    user_rhs, example, insn_match=lambda i: "diff_mat" in i.arg_names)
print("matched:", matched.get_subscripts())
print("isomorphic to ref:",
      f.canonicalize_einsum(matched) == f.canonicalize_einsum(ref))
print("name map ref->user:",
      match_fn_to_einsum(user_rhs, example, ref,
                         insn_match=lambda i: "diff_mat" in i.arg_names))

# apply the best-known schedule for this einsum class to the user's program
program = f.generate_program_with_opt_einsum_schedule(matched).with_descriptor(
    backend="pallas", block_long=2048)
fn = f.build_executable(program, long_dim_length=E)
out = fn({"geo_jac": example[0], "diff_mat": example[1],
          "u_dofs": example[2]})
print("output:", out[0].shape, np.asarray(out[0]).mean())


# the substitution-rule seam (reference codegen/loopy.py:94-95,156-168): an
# operand that is an arbitrary EXPRESSION — here an affine-rescaled jacobian
# 2*J + 1 — still matches; the expression becomes an opaque operand expr0
# whose name_map entry lists the inputs feeding it
def user_rhs_expr(geo_jac, diff_mat, u_dofs):
    return jnp.einsum("np,pdq,nq->nd", 2.0 * geo_jac + 1.0,
                      diff_mat, u_dofs)


matched_e, nm_e = get_a_matched_einsum(user_rhs_expr, example[:3])
print("expression-operand match:", matched_e.get_subscripts(),
      "| expr operand inputs:", nm_e["expr0"])
print("still isomorphic to ref:",
      f.canonicalize_einsum(matched_e) == f.canonicalize_einsum(ref))
