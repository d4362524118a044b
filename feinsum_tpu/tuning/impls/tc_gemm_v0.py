"""
First-party TC-as-GEMM schedule space for dense 2-operand tensor
contractions (the COGENT-class shapes, reference ``tuning/impls/cogent.py``
/ ``ttgt.py``).

The schedule choice is the *storage rank*: operands and output are stored
**fused to GEMM-natural 2D** (``descriptor.pre_layouts`` /
``pre_out_layout`` — host-side storage contracts, the same vocabulary as
the DG suite's dof-major layouts) and contracted (M,K)x(N,K)->(M,N)
directly:

- ``backend_pallas=False``: one XLA dot at the chosen precision;
- ``backend_pallas=True``: the library's own streaming Pallas kernel
  (mass/matvec family: resident (N,K) factor loaded whole by every
  program, grid over M).
"""

from __future__ import annotations

from feinsum_tpu.diagnostics import InvalidParameterError
from feinsum_tpu.tuning import BoolParameter, IntParameter, transform_param

_PRECISIONS = ("highest", "bf16_3x", "default")


def _gemm_split(e, swap):
    """(lhs_arg, rhs_arg, lhs_idx, rhs_idx, M_idx, N_idx, K_idx) for a pure
    (no batch index) 2-operand contraction, operand order optionally
    swapped.  Raises InvalidParameterError when the einsum is not of this
    shape (the tuner scores the point inf and other spaces cover it).

    ``swap`` is interpreted relative to CANONICAL operand positions: the
    archive stores params tuned on the canonical einsum, but replay applies
    the transform to the user-ordered program (see
    :func:`feinsum_tpu.canonicalization.canonical_operand_positions`) —
    e.g. TCCG #02 canonicalizes with operands exchanged, which flipped the
    resident/streamed roles on replay before this mapping."""
    from feinsum_tpu.canonicalization import canonical_operand_positions
    from feinsum_tpu.einsum import SizeParam

    if e.n != 2 or e.b != 1:
        raise InvalidParameterError(
            "tc_gemm_v0 expects a 2-operand single-row contraction")
    if any(isinstance(ln, SizeParam)
           for ln in e.index_to_dim_length.values()):
        raise InvalidParameterError(
            "tc_gemm_v0 expects a dense (fully concrete) contraction")
    lhs_pos, rhs_pos = canonical_operand_positions(e)
    if swap:
        lhs_pos, rhs_pos = rhs_pos, lhs_pos
    lhs, rhs = e.args[0][lhs_pos], e.args[0][rhs_pos]
    lhs_idx, rhs_idx = e.in_idx_sets[lhs_pos], e.in_idx_sets[rhs_pos]
    out_set = set(e.out_idx_set)
    k_idx = [ix for ix in lhs_idx if ix not in out_set]
    if not k_idx:
        raise InvalidParameterError("tc_gemm_v0: no contracted index")
    if set(k_idx) - set(rhs_idx):
        raise InvalidParameterError(
            "tc_gemm_v0: contracted index missing from the other operand")
    m_idx = [ix for ix in lhs_idx if ix in out_set]
    n_idx = [ix for ix in rhs_idx if ix in out_set]
    if set(m_idx) & set(n_idx):
        raise InvalidParameterError(
            "tc_gemm_v0: batch indices (shared free axes) are not a GEMM")
    if set(m_idx) | set(n_idx) != out_set:
        raise InvalidParameterError("tc_gemm_v0: output index unaccounted")
    if [ix for ix in rhs_idx if ix not in out_set and ix not in k_idx]:
        raise InvalidParameterError(
            "tc_gemm_v0: rhs has a privately-contracted index")
    return lhs, rhs, lhs_idx, rhs_idx, m_idx, n_idx, k_idx


@transform_param("log2_block", lambda e: IntParameter(4, 10))
@transform_param("backend_pallas", lambda e: BoolParameter())
@transform_param("precision_idx",
                 lambda e: IntParameter(0, len(_PRECISIONS) - 1))
@transform_param("swap", lambda e: BoolParameter())
@transform_param("dofmajor", lambda e: BoolParameter())
@transform_param("fold", lambda e: BoolParameter())
def transform(program, log2_block, blkc128=0, *, backend_pallas,
              precision_idx, swap, dofmajor=False, fold=False, vmem_idx=2):
    """``blkc128`` and ``vmem_idx`` are archived-row knobs: accepted so
    old rows replay, without effect on the kernel."""
    import numpy as np

    import feinsum_tpu as f
    from feinsum_tpu.codegen.program import generate_program
    from feinsum_tpu.tuning.impls._common import (
        fused_pallas_program,
        resolve_block,
    )

    e = program.einsum
    lhs, rhs, lhs_idx, rhs_idx, m_idx, n_idx, k_idx = _gemm_split(e, swap)
    lengths = {ix: int(ln) for ix, ln in e.index_to_dim_length.items()}
    m_len = int(np.prod([lengths[ix] for ix in m_idx], dtype=np.int64))
    n_len = int(np.prod([lengths[ix] for ix in n_idx], dtype=np.int64))
    k_len = int(np.prod([lengths[ix] for ix in k_idx], dtype=np.int64))

    # the rewritten 2D program: "ej,ij->ei" with e=M (streamed, SizeParam
    # bound to m_len via bind_lengths), i=N (lanes), j=K (contracted).
    # Operand names carry over so the measurement plumbing feeds the same
    # (fused-stored) arrays.
    e2d = f.einsum("ej,ij->ei",
                   f.array(lhs.name, ("E_tc", k_len), lhs.dtype.name),
                   f.array(rhs.name, (n_len, k_len), rhs.dtype.name))
    p2 = generate_program(e2d)

    # host-side fused-storage contracts (nested = groups of source axes)
    pre_layouts = (
        (lhs.name, (tuple(lhs_idx.index(ix) for ix in m_idx),
                    tuple(lhs_idx.index(ix) for ix in k_idx))),
        (rhs.name, (tuple(rhs_idx.index(ix) for ix in n_idx),
                    tuple(rhs_idx.index(ix) for ix in k_idx))),
    )
    pre_out = (tuple(e.out_idx_set.index(ix) for ix in m_idx),
               tuple(e.out_idx_set.index(ix) for ix in n_idx))

    precision = _PRECISIONS[precision_idx]
    if backend_pallas:
        p2 = fused_pallas_program(
            p2, block_long=resolve_block(log2_block, blkc128), hoist=False,
            dofmajor=dofmajor, fold=fold,
            precision=precision)
        if precision == "default":
            raise InvalidParameterError(
                "pallas route has no 1-pass mode (duplicate of highest)")
    else:
        if dofmajor or fold:
            raise InvalidParameterError(
                "dofmajor/fold are pallas-route knobs (xla duplicates)")
        p2 = p2.with_descriptor(backend="xla", precision=precision)
    return p2.with_descriptor(
        pre_layouts=pre_layouts, pre_out_layout=pre_out,
        bind_lengths=(("e", m_len),))


if __name__ == "__main__":
    import feinsum_tpu as f
    from feinsum_tpu.tuning import autotune

    einsum = f.get_tccg_benchmark(35, dtype="float32")
    autotune(einsum, __file__, stop_after=300, long_dim_length=100)
