"""
Schedule space for dense 2-operand tensor contractions (the TCCG suite):
XLA backend with tunable contraction order and matmul precision.

Reference counterpart: ``tuning/impls/cogent*.py`` / ``ttgt.py``.  XLA
already performs COGENT-style tiling (cuBLAS or its own GEMM emitters) and
TTGT-style transposes for arbitrary dot_generals; the remaining schedule
choices are the contraction path and the precision/pass-count trade-off.
"""

from __future__ import annotations

from feinsum_tpu.codegen.descriptor import ScheduleDescriptor
from feinsum_tpu.contraction_schedule import (
    get_opt_einsum_contraction_schedule,
    get_trivial_contraction_schedule,
)
from feinsum_tpu.diagnostics import InvalidParameterError
from feinsum_tpu.tuning import BoolParameter, IntParameter, einsum_arg, transform_param

_PRECISIONS = ("default", "highest", "bf16_3x")


def _is_tensor_contraction(einsum) -> bool:
    # 2 operands, everything dense and concrete (cogent.py:21-42 analog)
    return einsum.n == 2 and einsum.b == 1 and not einsum.all_size_params


@transform_param("use_opt_path", lambda e: BoolParameter())
@transform_param("precision_idx",
                 lambda e: IntParameter(0, len(_PRECISIONS) - 1))
@einsum_arg("is_tc", _is_tensor_contraction)
def transform(program, is_tc, use_opt_path, precision_idx):
    if not is_tc:
        raise InvalidParameterError(
            "tc_xla_v0 expects a dense 2-operand single-row contraction")
    e = program.einsum
    schedule = (get_opt_einsum_contraction_schedule(e) if use_opt_path
                else get_trivial_contraction_schedule(e))
    return program.copy(
        schedule=schedule,
        descriptor=ScheduleDescriptor(
            backend="xla", precision=_PRECISIONS[precision_idx]))


if __name__ == "__main__":
    import feinsum_tpu as f
    from feinsum_tpu.tuning import autotune

    einsum = f.get_tccg_benchmark(12, dtype="float32")
    autotune(einsum, __file__, stop_after=120, long_dim_length=100)
