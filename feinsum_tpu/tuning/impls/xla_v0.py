"""
Schedule space lowering any batched einsum through the XLA backend:
contraction path x matmul precision.  The general-purpose fallback space —
in particular the fp64 path (XLA's native double arithmetic; the Pallas
kernel is f32-only), mirroring the reference's fp64-centric archive rows
(its ``tuning/impls`` all target fp64 on the TITAN V).
"""

from __future__ import annotations

from feinsum_tpu.codegen.descriptor import ScheduleDescriptor
from feinsum_tpu.contraction_schedule import (
    get_opt_einsum_contraction_schedule,
    get_trivial_contraction_schedule,
)
from feinsum_tpu.tuning import BoolParameter, IntParameter, transform_param

# "default" and "highest" both resolve to Precision.HIGHEST for >=32-bit
# dtypes (codegen/program.py _precision) — the duplication is kept on
# purpose: the two differ for sub-32-bit dtypes (bf16 inputs run the native
# 1-pass path under "default"), and archived precision_idx values would
# silently change meaning if the tuple were reordered or shrunk.
_PRECISIONS = ("default", "highest", "bf16_3x")


@transform_param("use_opt_path", lambda e: BoolParameter())
@transform_param("precision_idx",
                 lambda e: IntParameter(0, len(_PRECISIONS) - 1))
@transform_param("log2_chunk", lambda e: IntParameter(0, 17))
def transform(program, use_opt_path, precision_idx, log2_chunk=0):
    e = program.einsum
    schedule = (get_opt_einsum_contraction_schedule(e) if use_opt_path
                else get_trivial_contraction_schedule(e))
    # log2_chunk > 0: lax.map the schedule over 2^log2_chunk-element chunks
    # of the long axis — bounds XLA's f64-emulation temp footprint (the
    # unchunked f64 div @ E=1M materializes ~29 GB of f32-pair temps and
    # runs at ~6 GOp/s); build_executable rejects invalid combinations
    return program.copy(
        schedule=schedule,
        descriptor=ScheduleDescriptor(
            backend="xla", precision=_PRECISIONS[precision_idx],
            xla_block_long=(1 << log2_chunk) if log2_chunk else None))


if __name__ == "__main__":
    import feinsum_tpu as f
    from feinsum_tpu.tuning import autotune

    ndof = 35
    einsum = f.batched_einsum(
        "es,sij,ej->ei",
        [[f.array(j, ("E", 3), "float64"),
          f.array("R", (3, ndof, ndof), "float64"),
          f.array(u, ("E", ndof), "float64")]
         for j, u in [("Jx", "ux"), ("Jy", "uy"), ("Jz", "uz")]])
    autotune(einsum, __file__, stop_after=120, long_dim_length=200_000)
