"""
TTGT (Transpose-Transpose-GEMM-Transpose) schedule space for dense
2-operand tensor contractions.

Reference counterpart: ``tuning/impls/ttgt.py`` (tuned tile params for three
transpose kernels + a GEMM).  Here the GEMM and its tiling belong to XLA;
the schedule choices that remain are the operand/output *layout
permutations* (which axes land on the GEMM's contiguous dims — the "TT" and
the final "T") plus the contraction path and precision.
"""

from __future__ import annotations

import itertools

from feinsum_tpu.codegen.descriptor import ScheduleDescriptor
from feinsum_tpu.contraction_schedule import get_trivial_contraction_schedule
from feinsum_tpu.diagnostics import InvalidParameterError
from feinsum_tpu.tuning import IntParameter, einsum_arg, transform_param

_PRECISIONS = ("default", "highest", "bf16_3x")


def _n_perms(ndim: int) -> int:
    out = 1
    for k in range(2, ndim + 1):
        out *= k
    return out


def _perm(ndim: int, idx: int):
    perms = list(itertools.permutations(range(ndim)))
    return perms[idx % len(perms)]


def _natural_out_perm(e, pos_a, pos_b, pa, pb):
    """Permutation putting the output in GEMM-natural order for the chosen
    operand layouts — lhs free axes (in stored order) then rhs free axes —
    so XLA writes the contraction result once, with NO output transpose.
    On expansion-heavy high-rank outputs the transpose IS the pathology
    (TCCG #35 measured ~5% of the bandwidth roofline; the natural layout
    removes it), and a random walk over rank! permutations cannot find
    this point."""
    a_idx = [e.in_idx_sets[pos_a][p] for p in pa]
    b_idx = [e.in_idx_sets[pos_b][p] for p in pb]
    out_set = set(e.out_idx_set)
    natural = ([ix for ix in a_idx if ix in out_set]
               + [ix for ix in b_idx if ix in out_set
                  and ix not in a_idx])
    return tuple(e.out_idx_set.index(ix) for ix in natural)


def _canon_rank(e, slot):
    """Rank of the operand at CANONICAL position *slot* — the param spaces
    must be sized against the same positions the transform applies perms
    to, or a user-ordered rank-asymmetric einsum gets an aliased/truncated
    space (autotune canonicalizes first and never sees the difference)."""
    from feinsum_tpu.canonicalization import canonical_operand_positions
    if e.n <= slot:
        return 1
    return len(e.in_idx_sets[canonical_operand_positions(e)[slot]])


@transform_param("perm_a", lambda e: IntParameter(
    0, _n_perms(_canon_rank(e, 0)) - 1))
@transform_param("perm_b", lambda e: IntParameter(
    0, _n_perms(_canon_rank(e, 1)) - 1))
@transform_param("perm_out", lambda e: IntParameter(
    0, _n_perms(len(e.out_idx_set)) - 1))
@transform_param("precision_idx",
                 lambda e: IntParameter(0, len(_PRECISIONS) - 1))
@transform_param("natural_out", lambda e: IntParameter(0, 1))
def transform(program, perm_a, perm_b, perm_out, precision_idx,
              natural_out=0):
    from feinsum_tpu.canonicalization import canonical_operand_positions

    e = program.einsum
    if e.n != 2 or e.b != 1 or e.all_size_params:
        raise InvalidParameterError(
            "ttgt_v0 expects a dense 2-operand single-row contraction")
    # operand names MUST come from the program being transformed, not from
    # an @einsum_arg of the einsum the params were bound against: on the
    # archive-replay path that einsum is the CANONICAL one (names arg_0,
    # arg_1), which broke replay onto user-named programs (bench r2:
    # KeyError 'arg_0').  The permutations are archived relative to
    # CANONICAL operand positions (autotune canonicalizes first), so they
    # must be routed onto the user's positions through sigma_j — applying
    # perm_a to user position 0 silently retunes the wrong operand whenever
    # canonical order differs (e.g. TCCG #02/#35, sigma_j = (1, 0)).
    pos_a, pos_b = canonical_operand_positions(e)
    pa = _perm(len(e.in_idx_sets[pos_a]), perm_a)
    pb = _perm(len(e.in_idx_sets[pos_b]), perm_b)
    layouts = (
        (e.args[0][pos_a].name, pa),
        (e.args[0][pos_b].name, pb),
    )
    if natural_out:
        out_perm = _natural_out_perm(e, pos_a, pos_b, pa, pb)
    else:
        out_perm = _perm(len(e.out_idx_set), perm_out)
    return program.copy(
        schedule=get_trivial_contraction_schedule(e),
        descriptor=ScheduleDescriptor(
            backend="xla",
            precision=_PRECISIONS[precision_idx],
            arg_layouts=layouts,
            out_layout=out_perm))


if __name__ == "__main__":
    import feinsum_tpu as f
    from feinsum_tpu.tuning import autotune

    einsum = f.get_tccg_benchmark(3, dtype="float32")
    autotune(einsum, __file__, stop_after=300, long_dim_length=100)
