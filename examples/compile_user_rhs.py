"""One-call consumer flow: a DG right-hand side written as plain
``jnp.einsum`` calls — componentwise divergence (three einsums, one
negated) plus a face lift, with an affine-rescaled jacobian (an operand
*expression*) and a traced ``dt`` scalar factor — compiled against the
transform archive in one call.

The componentwise div instructions group into a single b=3 batched plan
(hitting the archive's batched-div champion); the ``2*J + 1`` expression
becomes an opaque operand evaluated from the traced jaxpr (the reference's
substitution-rule seam, codegen/loopy.py:94-95)."""
import jax
import jax.numpy as jnp
import numpy as np

import feinsum_tpu as f

f.enable_persistent_compilation_cache()

E, ndof, nf, nfdof = 100_000, 35, 4, 15
rng = np.random.default_rng(0)


def rand(*shape):
    return jnp.asarray(rng.random(shape, np.float32))


Jx, Jy, Jz = rand(E, 3), rand(E, 3), rand(E, 3)
R = rand(3, ndof, ndof)
ux, uy, uz = rand(E, ndof), rand(E, ndof), rand(E, ndof)
L, Fj, flux = rand(ndof, nf, nfdof), rand(nf, E), rand(nf, E, nfdof)


def user_rhs(dt, Jx, Jy, Jz, R, ux, uy, uz, L, Fj, flux):
    # componentwise divergence; the z-jacobian arrives affine-rescaled
    div = (jnp.einsum("es,sij,ej->ei", Jx, R, ux)
           + jnp.einsum("es,sij,ej->ei", Jy, R, uy)
           - jnp.einsum("es,sij,ej->ei", 2.0 * Jz + 1.0, R, uz))
    lift = jnp.einsum("ifj,fe,fej->ei", L, Fj, flux)
    # the traced time-step factor is captured as InsnInfo.scale_vars and
    # re-applied per instruction at call time
    return dt * (div - 0.5 * lift)


args = [jnp.float32(0.125), Jx, Jy, Jz, R, ux, uy, uz, L, Fj, flux]
rhs = f.compile_fn_with_archive(user_rhs, args,
                                long_dim_length=1000)

for infos, einsum, program in rhs.plans:
    print(f"plan: {einsum.get_subscripts():24s} b={einsum.b}"
          f" insns={[i.flat_index for i in infos]}"
          f" scales={[i.scale for i in infos]}"
          f" -> {program.descriptor.backend}"
          f" (block={program.descriptor.block_long})")

out = rhs(*args)
ref = user_rhs(*args)
err = float(jnp.max(jnp.abs(out - ref)) / jnp.max(jnp.abs(ref)))
print(f"output {out.shape}, max rel err vs plain jnp: {err:.2e}")


# --- epilogue seam: einsums inside a larger kernel ---------------------
# The reference's match_t_unit_to_einsum matches the einsum INSIDE a
# kernel and leaves the other statements intact.  Here the RHS is wrapped
# in a slope-limiter-style nonlinearity and paired with a scalar energy
# diagnostic: the einsums still run through their archived schedules, and
# the tanh/sqrt epilogues replay around the archive-computed values.
def user_rhs_limited(dt, Jx, Jy, Jz, R, ux, uy, uz, L, Fj, flux):
    r = user_rhs(dt, Jx, Jy, Jz, R, ux, uy, uz, L, Fj, flux)
    energy = jnp.sqrt(jnp.einsum("ej,ej->", ux, ux))
    return jnp.tanh(r), energy


rhs_lim = f.compile_fn_with_archive(user_rhs_limited, args,
                                    long_dim_length=1000)
lim, en = rhs_lim(*args)
lim_ref, en_ref = user_rhs_limited(*args)
err = float(jnp.max(jnp.abs(lim - lim_ref)) / jnp.max(jnp.abs(lim_ref)))
print(f"limited output {lim.shape}, max rel err: {err:.2e};"
      f" energy rel err: {abs(float(en - en_ref)) / float(en_ref):.2e}")
