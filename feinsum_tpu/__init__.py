"""
feinsum_tpu — a batched-einsum transform-database library for NVIDIA GPUs.

Rebuild of kaushikcfd/feinsum's capabilities on an idiomatic JAX/Pallas/XLA
stack: an immutable :class:`BatchedEinsum` IR with parametric axes, canonical-
form hashing (first-party C++ graph canonicalizer) for database lookup,
schedule descriptors as *data* interpreted by a Pallas emitter (compiled
through Triton), an empirical validate→time→record autotuning loop persisted
to sqlite, and roofline-relative reporting against the device's peak-flop /
HBM-bandwidth table.
"""

from .algebraic import (
    extract_multiplicative_terms_in_sum_reduction_as_subst,
    hoist_cses,
    hoist_cses_in_fn,
    hoist_cses_in_jaxpr,
    hoist_invariant_multiplicative_terms_in_sum_reduction,
)
from .canonicalization import (
    canonical_operand_positions,
    canonicalize_einsum,
    get_substitution_mapping_between_isomorphic_batched_einsums,
    visualize,
)
from .cl_utils import FakeCLDevice, FakeDevice
from .codegen import (
    EinsumProgram,
    ScheduleDescriptor,
    build_executable,
    enable_persistent_compilation_cache,
    generate_program,
    generate_program_with_opt_einsum_schedule,
)
from .contraction_schedule import (
    ContractionSchedule,
    EinsumOperand,
    IntermediateResult,
    get_opt_einsum_contraction_schedule,
    get_trivial_contraction_schedule,
)
from .diagnostics import (
    EinsumMatchError,
    EinsumTunitMatchError,
    InvalidParameterError,
    NoDevicePeaksInfoError,
    NoFactInDatabaseError,
    TransformValidationError,
)
from .einsum import (
    Array,
    BatchedEinsum,
    EinsumAxisAccess,
    FreeAxis,
    SizeParam,
    SummationAxis,
)
from .apply import compile_fn_with_archive
from .make_einsum import array, batched_einsum, einsum
from .matching import (
    InsnInfo,
    abstract_long_axes,
    get_a_matched_einsum,
    get_call_ids,
    get_matched_einsums,
    identify_as_einsum,
    match_fn_to_einsum,
    match_t_unit_to_einsum,
)
from .measure import (
    apply_layouts,
    get_giga_op_map,
    get_footprint_gbytes,
    get_roofline_flop_rate,
    measure_giga_op_rate,
    stringify_comparison_vs_roofline,
    timeit,
    validate_batched_einsum_transform,
)
from .sql_utils import (
    DEFAULT_DB,
    apply_best_transform,
    get_timed_einsums_in_db,
    query,
    record_facts,
    record_into_db,
    retrieve,
)
from .tuning import (
    BoolParameter,
    IntParameter,
    ParametrizedTransform,
    TupleParameter,
    autotune,
    einsum_arg,
    transform_param,
)
from .ops.layouts import unpack_output
from .utils import IndexNameGenerator, get_tccg_benchmark

__version__ = "0.1.0"

__all__ = (
    "Array",
    "BatchedEinsum",
    "BoolParameter",
    "ContractionSchedule",
    "DEFAULT_DB",
    "EinsumAxisAccess",
    "EinsumMatchError",
    "EinsumOperand",
    "EinsumProgram",
    "EinsumTunitMatchError",
    "FakeCLDevice",
    "FakeDevice",
    "FreeAxis",
    "IndexNameGenerator",
    "IntParameter",
    "IntermediateResult",
    "InvalidParameterError",
    "NoDevicePeaksInfoError",
    "NoFactInDatabaseError",
    "ParametrizedTransform",
    "ScheduleDescriptor",
    "SizeParam",
    "SummationAxis",
    "TransformValidationError",
    "TupleParameter",
    "abstract_long_axes",
    "apply_layouts",
    "array",
    "autotune",
    "batched_einsum",
    "build_executable",
    "apply_best_transform",
    "compile_fn_with_archive",
    "canonical_operand_positions",
    "canonicalize_einsum",
    "visualize",
    "einsum",
    "einsum_arg",
    "enable_persistent_compilation_cache",
    "extract_multiplicative_terms_in_sum_reduction_as_subst",
    "generate_program",
    "generate_program_with_opt_einsum_schedule",
    "get_a_matched_einsum",
    "get_matched_einsums",
    "InsnInfo",
    "get_call_ids",
    "get_footprint_gbytes",
    "get_giga_op_map",
    "get_opt_einsum_contraction_schedule",
    "get_roofline_flop_rate",
    "get_substitution_mapping_between_isomorphic_batched_einsums",
    "get_tccg_benchmark",
    "get_timed_einsums_in_db",
    "get_trivial_contraction_schedule",
    "hoist_cses",
    "hoist_cses_in_fn",
    "hoist_cses_in_jaxpr",
    "hoist_invariant_multiplicative_terms_in_sum_reduction",
    "identify_as_einsum",
    "match_fn_to_einsum",
    "match_t_unit_to_einsum",
    "measure_giga_op_rate",
    "query",
    "record_facts",
    "record_into_db",
    "retrieve",
    "stringify_comparison_vs_roofline",
    "timeit",
    "transform_param",
    "unpack_output",
    "validate_batched_einsum_transform",
)
