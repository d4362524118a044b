"""
Multi-step contraction schedules for a batched einsum.

A :class:`ContractionSchedule` decomposes each row's einsum into a sequence of
steps, each with its own subscripts and operand list (original operands or
earlier intermediates).  The trivial schedule has one step; the opt_einsum
schedule follows the optimal contraction path with parametric dims treated as
very long (reference: ``feinsum/contraction_schedule.py:62-178``).

The schedule doubles as the *algebraic hoist* mechanism: the 4.14x flop
cut of the reference's ``hoist_invariant_multiplicative_terms_in_sum_
reduction`` falls out of choosing a multi-step schedule, and the Pallas
emitter fuses all steps in one kernel (no HBM round-trip for
intermediates).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

from .einsum import BatchedEinsum, SizeParam

FALLBACK_LONG_DIM_LENGTH = 1_000_000


@dataclass(frozen=True)
class EinsumOperand:
    """Reference to the *i*-th original operand position of the einsum."""

    position: int


@dataclass(frozen=True)
class IntermediateResult:
    """Reference to the result of an earlier schedule step, by name."""

    name: str


ArgumentT = Union[EinsumOperand, IntermediateResult]


@dataclass(frozen=True)
class ContractionSchedule:
    """Per-step: a subscript string (explicit ``->``), a result name, and the
    argument references consumed by that step.  The final step's result name
    is the einsum output."""

    subscripts: tuple
    result_names: tuple
    arguments: tuple

    def __post_init__(self) -> None:
        assert len(self.subscripts) == len(self.result_names) == len(
            self.arguments)
        for subs, args in zip(self.subscripts, self.arguments):
            n_in = len(subs.split("->")[0].split(","))
            assert n_in == len(args), (
                f"step '{subs}' expects {n_in} args, got {len(args)}")

    @property
    def nsteps(self) -> int:
        return len(self.subscripts)


def get_trivial_contraction_schedule(einsum: BatchedEinsum
                                     ) -> ContractionSchedule:
    """Single-step schedule computing the whole contraction at once."""
    subs = ",".join("".join(s) for s in einsum.in_idx_sets)
    out = "".join(einsum.out_idx_set)
    return ContractionSchedule(
        subscripts=(f"{subs}->{out}",),
        result_names=("_fe_out",),
        arguments=(tuple(EinsumOperand(i) for i in range(einsum.n)),),
    )


def get_opt_einsum_contraction_schedule(
        einsum: BatchedEinsum, *,
        long_dim_length: int = FALLBACK_LONG_DIM_LENGTH,
        **opt_einsum_kwargs) -> ContractionSchedule:
    """Schedule following :func:`opt_einsum.contract_path` with
    ``optimize="optimal"`` by default; parametric dims are treated as
    *long_dim_length*-long while costing the path."""
    import opt_einsum

    opt_einsum_kwargs.setdefault("optimize", "optimal")
    opt_einsum_kwargs.setdefault("use_blas", False)

    shapes = []
    for idx_set in einsum.in_idx_sets:
        shapes.append(tuple(
            long_dim_length if isinstance(einsum.index_to_dim_length[ix],
                                          SizeParam)
            else int(einsum.index_to_dim_length[ix])
            for ix in idx_set))
    subs = (",".join("".join(s) for s in einsum.in_idx_sets)
            + "->" + "".join(einsum.out_idx_set))
    _, path_info = opt_einsum.contract_path(
        subs, *shapes, shapes=True, **opt_einsum_kwargs)

    # current operand stack mirrors opt_einsum's contraction bookkeeping
    operands: list = [EinsumOperand(i) for i in range(einsum.n)]
    subscripts: list = []
    result_names: list = []
    arguments: list = []
    n_steps = len(path_info.contraction_list)
    for k, (inds, _idx_rm, einsum_str, _remaining, _blas) in enumerate(
            path_info.contraction_list):
        step_args = tuple(operands[i] for i in inds)
        for i in sorted(inds, reverse=True):
            operands.pop(i)
        name = "_fe_out" if k == n_steps - 1 else f"_fe_tmp_{k}"
        operands.append(IntermediateResult(name))
        subscripts.append(einsum_str)
        result_names.append(name)
        arguments.append(step_args)
    return ContractionSchedule(tuple(subscripts), tuple(result_names),
                               tuple(arguments))
