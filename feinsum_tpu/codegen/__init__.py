"""
Lowering: (BatchedEinsum, ContractionSchedule, ScheduleDescriptor) -> compiled
JAX executable.

This replaces the reference's loopy codegen
(``feinsum/codegen/loopy.py:113-339``).  Where the reference emits a loopy
kernel and *then* mutates it with imperative transform scripts, here the
schedule descriptor is pure data interpreted by two backends:

* ``xla``   — each schedule step becomes a ``jnp.einsum``; XLA fuses and
              tiles.  Always available; the CI/CPU oracle path.
* ``pallas`` — a fused kernel gridded over the parametric (long) axis with all
              schedule steps computed per block on chip, compiled through
              Triton on a GPU (``pallas_emitter``).
"""

from .descriptor import ScheduleDescriptor
from .program import (
    EinsumProgram,
    build_executable,
    enable_persistent_compilation_cache,
    generate_program,
    generate_program_with_opt_einsum_schedule,
)

__all__ = (
    "EinsumProgram",
    "ScheduleDescriptor",
    "build_executable",
    "enable_persistent_compilation_cache",
    "generate_program",
    "generate_program_with_opt_einsum_schedule",
)
