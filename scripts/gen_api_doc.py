"""Generate doc/api.md from the installed package's public surface
(reference counterpart: doc/api.rst, autodoc over the same module list).
Re-run after adding API names; tests/test_tutorials.py pins coverage."""
import inspect
import re

import jax

jax.config.update("jax_platforms", "cpu")

import feinsum_tpu as f  # noqa: E402

GROUPS = [
    ("Building batched einsums", [
        "array", "einsum", "einsum_arg", "batched_einsum", "make_einsum",
        "abstract_long_axes", "BatchedEinsum", "Array", "SizeParam",
        "EinsumAxisAccess", "FreeAxis", "SummationAxis",
        "IndexNameGenerator", "get_tccg_benchmark"]),
    ("Canonicalization", [
        "canonicalize_einsum", "canonical_operand_positions",
        "get_substitution_mapping_between_isomorphic_batched_einsums",
        "visualize"]),
    ("Programs, schedules and descriptors", [
        "generate_program", "generate_program_with_opt_einsum_schedule",
        "get_trivial_contraction_schedule",
        "get_opt_einsum_contraction_schedule", "build_executable",
        "EinsumProgram", "ContractionSchedule", "ScheduleDescriptor",
        "EinsumOperand", "IntermediateResult", "unpack_output",
        "apply_layouts"]),
    ("Measurement and validation", [
        "timeit", "measure_giga_op_rate", "validate_batched_einsum_transform",
        "stringify_comparison_vs_roofline", "get_roofline_flop_rate",
        "get_footprint_gbytes", "get_giga_op_map",
        "enable_persistent_compilation_cache"]),
    ("Transform archive (sqlite)", [
        "query", "retrieve", "record_facts", "record_into_db",
        "get_timed_einsums_in_db", "apply_best_transform", "DEFAULT_DB"]),
    ("Autotuning", [
        "autotune", "transform_param", "IntParameter", "BoolParameter",
        "TupleParameter", "ParametrizedTransform"]),
    ("Matching jitted functions / consumer path", [
        "match_fn_to_einsum", "match_t_unit_to_einsum",
        "get_a_matched_einsum", "get_matched_einsums", "identify_as_einsum",
        "get_call_ids", "compile_fn_with_archive", "InsnInfo"]),
    ("Algebraic transforms", [
        "hoist_cses", "hoist_cses_in_fn", "hoist_cses_in_jaxpr",
        "extract_multiplicative_terms_in_sum_reduction_as_subst",
        "hoist_invariant_multiplicative_terms_in_sum_reduction"]),
    ("Diagnostics", [
        "InvalidParameterError", "EinsumMatchError",
        "EinsumTunitMatchError", "NoDevicePeaksInfoError",
        "NoFactInDatabaseError", "TransformValidationError"]),
    ("Device shims", ["FakeDevice", "FakeCLDevice"]),
]

MODULES = [
    ("feinsum_tpu.einsum", "IR: BatchedEinsum / Array / access descriptors"),
    ("feinsum_tpu.make_einsum", "builder entry points"),
    ("feinsum_tpu.canonicalization",
     "colored-digraph canonical forms (first-party C++ McKay backend)"),
    ("feinsum_tpu.contraction_schedule", "schedule construction"),
    ("feinsum_tpu.codegen.descriptor", "schedules-as-data descriptors"),
    ("feinsum_tpu.codegen.program", "program build + executables"),
    ("feinsum_tpu.ops.pallas_emitter", "fused Pallas kernels (Triton)"),
    ("feinsum_tpu.ops.kernel_lowering", "in-kernel step lowering (Rep)"),
    ("feinsum_tpu.ops.layouts", "dof-major / fold / preblock contracts"),
    ("feinsum_tpu.matching", "jaxpr grammar matcher"),
    ("feinsum_tpu.apply", "compile_fn_with_archive consumer path"),
    ("feinsum_tpu.measure", "timing protocols, rooflines, validation"),
    ("feinsum_tpu.sql_utils", "transform DB"),
    ("feinsum_tpu.tuning", "autotune driver + parameter DSL"),
    ("feinsum_tpu.parallel", "multi-card DP/TP/EP/PP over jax.sharding"),
    ("feinsum_tpu.algebraic", "jaxpr CSE / hoisting"),
    ("feinsum_tpu.diagnostics", "exception taxonomy"),
    ("feinsum_tpu.utils", "TCCG benchmark table and helpers"),
    ("feinsum_tpu.models", "DG wave / Maxwell model operators"),
]


def first_line(obj) -> str:
    doc = inspect.getdoc(obj) or ""
    line = doc.split("\n\n")[0].replace("\n", " ").strip()
    line = re.sub(r":(class|func|mod|attr):`~?([^`]*)`", r"`\2`", line)
    return line


def main():
    out = ["# feinsum_tpu API reference", "",
           "The public surface (`import feinsum_tpu as f`).  Generated by"
           " `scripts/gen_api_doc.py`; regenerate after API changes.",
           "", "Reference counterpart: `doc/api.rst` (the reference exposes"
           " 28 names; this package is a strict superset).", ""]
    documented = set()
    for title, names in GROUPS:
        out += [f"## {title}", ""]
        for n in names:
            obj = getattr(f, n)
            documented.add(n)
            if inspect.isclass(obj) or callable(obj):
                try:
                    sig = str(inspect.signature(obj))
                except (ValueError, TypeError):
                    sig = ""
                if len(sig) > 62:
                    sig = "(...)"
                out.append(f"- **`{n}{sig}`** — {first_line(obj)}")
            else:
                out.append(f"- **`{n}`** — `{obj!r}`")
        out.append("")
    out += ["## Module map", ""]
    for mod, desc in MODULES:
        out.append(f"- `{mod}` — {desc}")
    out += ["",
            "Submodule namespaces (`f.measure`, `f.tuning`, `f.sql_utils`,"
            " `f.matching`, `f.apply`, `f.algebraic`, `f.canonicalization`,"
            " `f.codegen`, `f.ops`, `f.utils`, `f.diagnostics`,"
            " `f.cl_utils`, `f.contraction_schedule`,"
            " `f.data`) are also importable directly.", ""]
    with open("doc/api.md", "w") as fh:
        fh.write("\n".join(out))
    public = {n for n in dir(f) if not n.startswith("_")}
    missing = public - documented - {
        "measure", "tuning", "sql_utils", "matching", "apply", "algebraic",
        "canonicalization", "codegen", "ops", "utils", "diagnostics",
        "cl_utils", "contraction_schedule", "data", "einsum",
        "make_einsum"}
    print(f"doc/api.md written; {len(documented)} names documented;"
          f" missing: {sorted(missing) or 'none'}")


if __name__ == "__main__":
    main()
