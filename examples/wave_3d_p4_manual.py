"""Hand-write GPU schedules for the P4 wave operator and race the archive.

Reference counterpart: ``examples/wave_3d_p4_manual.py`` (606 lines of
hand-rolled loopy verbs — ``split_iname``/``tag_inames``/``add_prefetch``
with hand-picked tile sizes for div/grad/face-mass).  Here a schedule is
*data*: a :class:`~feinsum_tpu.ScheduleDescriptor` interpreted by the
Pallas/XLA emitters.  This walkthrough builds each descriptor from first
principles (each knob annotated with the reason for it), validates against
numpy, and — on a GPU — times the manual schedule against the archive's
champion for the same einsum.

Run on the CPU (validates only):   python examples/wave_3d_p4_manual.py
Run on the GPU (also measures):    the same command on the card.
"""
import numpy as np

import feinsum_tpu as f
from feinsum_tpu.tuning.impls._common import fused_pallas_program

NDOF = 35          # P4 tetrahedral element
NFACEDOF = 15


# {{{ the P4 wave-operator einsum classes (same classes bench.py times)

def make_div():
    # weak divergence: 3 rows sharing the resident R (3, 35, 35)
    return f.batched_einsum(
        "es,sij,ej->ei",
        [[f.array(jn, ("E", 3), "float32"),
          f.array("R", (3, NDOF, NDOF), "float32"),
          f.array(un, ("E", NDOF), "float32")]
         for jn, un in [("Jx", "ux"), ("Jy", "uy"), ("Jz", "uz")]])


def make_grad():
    return f.einsum("xre,rij,ej->xei",
                    f.array("J", (3, 3, "E"), "float32"),
                    f.array("D", (3, NDOF, NDOF), "float32"),
                    f.array("u", ("E", NDOF), "float32"))


def make_face_mass():
    return f.einsum("ifj,fe,fej->ei",
                    f.array("L", (NDOF, 4, NFACEDOF), "float32"),
                    f.array("Fj", (4, "E"), "float32"),
                    f.array("flux", (4, "E", NFACEDOF), "float32"))

# }}}


# {{{ the hand-written schedules

def transform_div(program):
    """Manual div schedule.  Reasoning, knob by knob:

    * ``dofmajor`` — store the long axis trailing, so one element block is
      a contiguous run of every dof row (coalesced loads).
    * ``jfold`` — outer-product-first: tmp[e,s,j] = J[e,s]*u[e,j] first,
      then one contraction against the resident R, accumulated over s in
      the dot's f32 accumulator.
    * ``precision_3x`` — f32 dots as the 3-pass TF32 split on the tensor
      cores (about 2^-21 relative); IEEE fp32 dots run on the CUDA cores
      and compile to long FMA sequences.
    * ``block_long=128`` — elements per program: a (128 x 64) f32 tile per
      operand keeps the dots' shared-memory staging well inside a block's
      227 KB (the guard inside checks).
    """
    return fused_pallas_program(
        program, block_long=128, hoist=False, dofmajor=True, jfold=True,
        precision_3x=True)


def transform_grad(program):
    """Manual grad schedule: the opt_einsum (hoisted) schedule computes
    tmp[r] = D[r] @ u once per r and contracts it with the Jacobian on
    chip — the 4.14x flop cut of the reference's hoist, with the
    (3, E, 35) intermediate never written to HBM."""
    return fused_pallas_program(
        program, block_long=128, hoist=True, dofmajor=True,
        precision_3x=True)


def transform_face_mass(program):
    """Manual face-mass schedule: plain fused single-step contraction —
    the resident L (35, 4, 15) contracts against the streamed flux, one
    dot per face.  ``hoist=False`` keeps the trivial schedule: opt_einsum's
    pairwise path would build a (4, E, 35) intermediate."""
    return fused_pallas_program(
        program, block_long=128, hoist=False, dofmajor=True,
        precision_3x=True)

# }}}


def main():
    import jax

    on_gpu = jax.devices()[0].platform == "gpu"
    rows = []
    for name, einsum, tr in (("div", make_div(), transform_div),
                             ("grad", make_grad(), transform_grad),
                             ("face_mass", make_face_mass(),
                              transform_face_mass)):
        # 1. correctness first, always (tiny length, numpy oracle)
        f.validate_batched_einsum_transform(einsum, tr,
                                            long_dim_length=1024)
        print(f"{name}: manual schedule validates against numpy")
        if not on_gpu:
            continue

        # 2. time the manual schedule (median of back-to-back launches)
        manual = f.timeit(einsum, transform=tr, long_dim_length=1_000_000)

        # 3. the archive's champion for the same (canonicalized) einsum
        try:
            best = f.retrieve(einsum, device=jax.devices()[0])
            champ = f.timeit(einsum, transform=best,
                             long_dim_length=1_000_000)
        except f.NoFactInDatabaseError:
            champ = None
        rows.append((name, manual, champ))

    for name, manual, champ in rows:
        beat = (" (manual BEATS the DB!)" if champ and manual < champ
                else "")
        print(f"{name}: manual {manual * 1e6:.0f} us vs archive champion "
              f"{champ * 1e6:.0f} us{beat}" if champ else
              f"{name}: manual {manual * 1e6:.0f} us (no archive row)")


if __name__ == "__main__":
    main()
