"""
EinsumProgram: the transformable kernel object.

The reference's transform target is a ``loopy.TranslationUnit``; ours is an
immutable (einsum, schedule, descriptor) triple.  A ``TransformT`` maps a
program to a program (usually only touching the descriptor/schedule);
``build_executable`` interprets the result into a jitted callable.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np

from ..contraction_schedule import (
    ContractionSchedule,
    EinsumOperand,
    IntermediateResult,
    get_trivial_contraction_schedule,
    get_opt_einsum_contraction_schedule,
)
from ..einsum import BatchedEinsum, SizeParam
from .descriptor import ScheduleDescriptor


@dataclass(frozen=True)
class EinsumProgram:
    """An executable description of a batched einsum: what to compute
    (einsum), in which algebraic steps (schedule), and how to map it onto the
    device (descriptor)."""

    einsum: BatchedEinsum
    schedule: ContractionSchedule
    descriptor: ScheduleDescriptor

    def copy(self, **changes) -> "EinsumProgram":
        return replace(self, **changes)

    def with_descriptor(self, **changes) -> "EinsumProgram":
        return replace(self, descriptor=self.descriptor.copy(**changes))


def generate_program(einsum: BatchedEinsum,
                     schedule: Optional[ContractionSchedule] = None,
                     descriptor: Optional[ScheduleDescriptor] = None
                     ) -> EinsumProgram:
    """Default program: trivial schedule, XLA backend (parity:
    ``generate_loopy``, reference codegen/loopy.py:113)."""
    return EinsumProgram(
        einsum=einsum,
        schedule=schedule or get_trivial_contraction_schedule(einsum),
        descriptor=descriptor or ScheduleDescriptor(),
    )


def generate_program_with_opt_einsum_schedule(
        einsum: BatchedEinsum, *,
        descriptor: Optional[ScheduleDescriptor] = None,
        **opt_einsum_kwargs) -> EinsumProgram:
    """Program with the opt_einsum optimal contraction path (parity:
    ``generate_loopy_with_opt_einsum_schedule``, reference
    codegen/loopy.py:328)."""
    return EinsumProgram(
        einsum=einsum,
        schedule=get_opt_einsum_contraction_schedule(
            einsum, **opt_einsum_kwargs),
        descriptor=descriptor or ScheduleDescriptor(),
    )


TransformT = Callable[[EinsumProgram], EinsumProgram]


def get_index_lengths(einsum: BatchedEinsum, long_dim_length: int) -> dict:
    """Concrete index -> length map with SizeParams bound to
    *long_dim_length*."""
    return {
        ix: long_dim_length if isinstance(ln, SizeParam) else int(ln)
        for ix, ln in einsum.index_to_dim_length.items()}


def output_dtype(einsum: BatchedEinsum, row: int) -> np.dtype:
    """dtype of batch-row *row*'s output: numpy promotion of its operands."""
    return np.result_type(*[arg.dtype for arg in einsum.args[row]])


_SPLIT_PRESETS = {"bf16_3x": "BF16_BF16_F32_X3",
                  "tf32_3x": "TF32_TF32_F32_X3"}


def _precision(name: str, eff_itemsize: int = 4):
    """Map a descriptor precision name to a jax dot precision.  "default" on
    >=32-bit floats resolves to HIGHEST (IEEE f32 / f64) — the same safe
    default as the Pallas emitter — because a plain f32 dot may run as
    single-pass TF32 on the GPU and fail the validation oracle.
    "fastest" keeps the single-pass path.  "bf16_3x" / "tf32_3x" name the
    3-pass split algorithms explicitly (XLA's CPU backend has none and runs
    them at HIGHEST)."""
    import jax
    lowered = (name or "default").lower()
    if lowered == "default":
        return (jax.lax.Precision.HIGHEST if eff_itemsize >= 4 else None)
    if lowered in ("none", "fastest"):
        return None
    if lowered in ("high", "highest"):
        return getattr(jax.lax.Precision, lowered.upper())
    if lowered in _SPLIT_PRESETS:
        if jax.default_backend() == "cpu":
            return jax.lax.Precision.HIGHEST
        return getattr(jax.lax.DotAlgorithmPreset, _SPLIT_PRESETS[lowered])
    return name  # dot-algorithm preset string, passed through


def default_compilation_cache_dir() -> str:
    """``<checkout>/.jax_cache``: a fixed path inside the checkout (the
    path is part of the cache key, so it must not move between runs)."""
    import os
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_persistent_compilation_cache(directory: Optional[str] = None
                                        ) -> None:
    """Persist compiled executables across processes so a DB-hit replay after
    the first-ever compile is a cache lookup (the reference's "<10 ms
    hit→codegen" budget, SURVEY.md §7.6; jit-level caching handles repeats
    within a process).  Where ``JAX_COMPILATION_CACHE_DIR`` is set JAX
    already caches there and no other directory is set; otherwise the
    cache goes to *directory* or :func:`default_compilation_cache_dir`."""
    import os

    import jax
    if directory is None:
        if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            return
        directory = default_compilation_cache_dir()
    os.makedirs(directory, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", directory)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def ensure_x64_if_needed(einsum: BatchedEinsum) -> None:
    """Enable jax x64 mode when the einsum uses 64-bit dtypes (JAX defaults
    to 32-bit otherwise and would silently truncate)."""
    import jax
    if any(dt.itemsize >= 8 for dt in einsum.arg_to_dtype.values()):
        if not jax.config.read("jax_enable_x64"):
            jax.config.update("jax_enable_x64", True)


def _xla_row_fn(program: EinsumProgram, row: int, arrays_by_name: dict):
    """Evaluate one batch row's schedule with jnp.einsum per step."""
    import jax.numpy as jnp

    e = program.einsum
    desc = program.descriptor
    eff_itemsize = (jnp.dtype(desc.compute_dtype).itemsize
                    if desc.compute_dtype is not None
                    else max(dt.itemsize for dt in e.arg_to_dtype.values()))
    prec = _precision(desc.precision, eff_itemsize)
    accum = (jnp.dtype(desc.accum_dtype).type
             if desc.accum_dtype is not None else None)

    env: dict = {}
    result = None
    for subs, name, step_args in zip(program.schedule.subscripts,
                                     program.schedule.result_names,
                                     program.schedule.arguments):
        ins = []
        for a in step_args:
            if isinstance(a, EinsumOperand):
                arr = arrays_by_name[e.args[row][a.position].name]
                if desc.compute_dtype is not None:
                    arr = arr.astype(desc.compute_dtype)
                ins.append(arr)
            else:
                assert isinstance(a, IntermediateResult)
                ins.append(env[a.name])
        kwargs = {}
        if prec is not None:
            kwargs["precision"] = prec
        if accum is not None:
            kwargs["preferred_element_type"] = accum
        env[name] = jnp.einsum(subs, *ins, **kwargs)
        result = env[name]
    result = result.astype(output_dtype(e, row))
    if desc.out_layout is not None:
        result = jnp.transpose(result, tuple(int(p) for p in
                                             desc.out_layout))
    fold = getattr(desc, "fold_long", 1) or 1
    if fold > 1:
        from ..ops.layouts import fold_axis_of
        out_idx = (tuple(e.out_idx_set[p] for p in desc.out_layout)
                   if desc.out_layout is not None else tuple(e.out_idx_set))
        if out_idx and out_idx[-1] == fold_axis_of(program):
            result = jnp.reshape(
                result, result.shape[:-1] + (fold, result.shape[-1] // fold))
    return result


def _logical_arrays(program: EinsumProgram, arrays_by_name: dict) -> dict:
    """Undo descriptor-mandated argument layouts (fold + permutation) to
    recover logical axes."""
    import jax.numpy as jnp

    desc = program.descriptor
    out = dict(arrays_by_name)
    if (getattr(desc, "fold_long", 1) or 1) > 1:
        from ..ops.layouts import fold_axis_of, stored_arg_layouts
        fold_ix = fold_axis_of(program)
        for name, idx in stored_arg_layouts(program).items():
            if fold_ix in idx:
                arr = out[name]
                out[name] = jnp.reshape(
                    arr, arr.shape[:-2] + (arr.shape[-2] * arr.shape[-1],))
    layouts = desc.arg_layouts_map
    for name, perm in layouts.items():
        inv = np.argsort(perm)
        out[name] = jnp.transpose(out[name], tuple(int(i) for i in inv))
    return out


@functools.lru_cache(maxsize=512)
def _build_executable_cached(program: EinsumProgram, lengths_key: tuple):
    import jax

    kron = tuple(getattr(program.descriptor, "kron_args", ()) or ())
    expand = tuple(getattr(program.descriptor, "lane_pack_expand", ()) or ())
    g = getattr(program.descriptor, "lane_pack", 1) or 1
    if (kron or expand) and g > 1:
        # lane-pack contract: resident operands arrive in their LOGICAL
        # shape and are kron-expanded to block-diagonal form in-graph (tiny,
        # once per launch; XLA feeds the result to the kernel as raw blocks).
        # The 0/1 lane-expansion matrices (descriptor.lane_pack_expand) are
        # synthesized here too — callers never pass them.
        inner = _build_executable_cached(
            program.with_descriptor(kron_args=(), lane_pack_expand=()),
            lengths_key)
        import jax.numpy as jnp

        def outer(arrays_by_name: dict):
            arrays = dict(arrays_by_name)
            for entry in kron:
                name, perm = (entry if isinstance(entry, tuple)
                              else (entry, None))
                a = arrays[name]
                if perm is not None:
                    a = jnp.transpose(a, tuple(int(p) for p in perm))
                if a.ndim == 1:     # vecmat variant: x -> kron(I, x[:,None])
                    a = a.reshape(-1, 1)
                eye = jnp.eye(g, dtype=a.dtype)
                if a.ndim == 2:
                    arrays[name] = jnp.kron(eye, a)
                else:
                    # batched kron over the last two axes: T[..m] =
                    # kron(I_g, R[..m]) for DG residents (s/r/f, i, j)
                    lead = a.shape[:-2]
                    di, dj = a.shape[-2:]
                    t = jnp.einsum("ab,...ij->...aibj", eye, a)
                    arrays[name] = t.reshape(lead + (g * di, g * dj))
            for entry in expand:
                if entry[1] == "P":
                    name, _kind, gg, d, dt = entry
                    p = jnp.einsum("af,k->afk",
                                   jnp.eye(gg, dtype=dt),
                                   jnp.ones((d,), dtype=dt))
                    arrays[name] = p.reshape(gg, gg * d)
                else:
                    name, _kind, gg, s, d, dt = entry
                    a4 = jnp.einsum("af,ut,k->taufk",
                                    jnp.eye(gg, dtype=dt),
                                    jnp.eye(s, dtype=dt),
                                    jnp.ones((d,), dtype=dt))
                    arrays[name] = a4.reshape(s, gg * s, gg * d)
            return inner(arrays)

        return jax.jit(outer)

    if program.descriptor.backend == "pallas":
        from ..ops.pallas_emitter import build_pallas_executable
        return build_pallas_executable(program, dict(lengths_key))

    if getattr(program.descriptor, "preblock_args", ()):
        from ..diagnostics import InvalidParameterError
        raise InvalidParameterError(
            "preblock_args requires the pallas backend")

    blk = getattr(program.descriptor, "xla_block_long", None)
    if blk:
        return jax.jit(_xla_chunked_fn(program, dict(lengths_key), int(blk)))

    def fn(arrays_by_name: dict):
        logical = _logical_arrays(program, arrays_by_name)
        return tuple(_xla_row_fn(program, r, logical)
                     for r in range(program.einsum.b))

    return jax.jit(fn)


def _xla_chunked_fn(program: EinsumProgram, index_to_length: dict,
                    blk: int):
    """The XLA schedule lax.map-ed over long-axis chunks of *blk* elements
    (descriptor.xla_block_long).  Sequential chunks bound the intermediate
    footprint; see the descriptor field's docstring."""
    import jax
    import jax.numpy as jnp

    from ..diagnostics import InvalidParameterError

    e = program.einsum
    desc = program.descriptor
    # guard on parametric index LETTERS (two letters can share one
    # SizeParam, which all_size_params would count once)
    long_letters = [ix for ix, ln in e.index_to_dim_length.items()
                    if isinstance(ln, SizeParam)]
    if len(long_letters) != 1:
        raise InvalidParameterError(
            "xla_block_long needs exactly one parametric long axis")
    if (getattr(desc, "fold_long", 1) or 1) > 1 or desc.pre_layouts:
        raise InvalidParameterError(
            "xla_block_long composes with neither fold_long nor pre_layouts")
    (letter,) = long_letters
    if letter not in e.out_idx_set:
        raise InvalidParameterError(
            "xla_block_long needs the long axis in the output")
    length = int(index_to_length[letter])
    # ceil-chunk: zero-pad the tail chunk instead of hunting for a divisor
    # (a divisor search degenerates to blk=1 for prime lengths — ~1M
    # sequential lax.map steps).  The long axis is a batch axis (it must
    # appear in the output), so zero rows in the pad region produce junk
    # rows that the final slice discards; archived chunk params stay
    # meaningful at ANY long_dim_length.
    blk = min(blk, length)
    nc = -(-length // blk)
    pad = nc * blk - length
    # long-axis position per operand (positions are identical across batch
    # rows: rows share in_idx_sets)
    arg_axis = {}
    for r in range(e.b):
        for j, idx_set in enumerate(e.in_idx_sets):
            if letter in idx_set:
                arg_axis[e.args[r][j].name] = idx_set.index(letter)
    out_letters = (tuple(e.out_idx_set[p] for p in desc.out_layout)
                   if desc.out_layout is not None else tuple(e.out_idx_set))
    p_out = out_letters.index(letter)

    def fn(arrays_by_name: dict):
        logical = _logical_arrays(program, arrays_by_name)
        chunked, captured = {}, {}
        for name, arr in logical.items():
            k = arg_axis.get(name)
            if k is None:
                captured[name] = arr
                continue
            if pad:
                widths = [(0, 0)] * arr.ndim
                widths[k] = (0, pad)
                arr = jnp.pad(arr, widths)
            shape = arr.shape
            arr = jnp.reshape(arr, shape[:k] + (nc, blk) + shape[k + 1:])
            chunked[name] = jnp.moveaxis(arr, k, 0)

        def body(ch):
            return tuple(_xla_row_fn(program, r, {**captured, **ch})
                         for r in range(e.b))

        outs = jax.lax.map(body, chunked)
        merged = []
        for o in outs:       # (nc, ..., blk @ p_out+1, ...) after stacking
            o = jnp.moveaxis(o, 0, p_out)
            o = jnp.reshape(
                o, o.shape[:p_out] + (nc * blk,) + o.shape[p_out + 2:])
            if pad:
                o = jax.lax.slice_in_dim(o, 0, length, axis=p_out)
            merged.append(o)
        return tuple(merged)

    return fn


def build_executable(program: EinsumProgram, *,
                     long_dim_length: int = 100_000,
                     index_to_length: Optional[dict] = None):
    """Compile *program* into ``fn(arrays_by_name: dict) -> tuple`` returning
    the b row outputs.  Executables are cached on (program, lengths)."""
    ensure_x64_if_needed(program.einsum)
    if index_to_length is None:
        index_to_length = get_index_lengths(program.einsum, long_dim_length)
    else:
        index_to_length = dict(index_to_length)
    # axes of a rewritten program whose lengths are fixed by the original
    # einsum (descriptor.bind_lengths) override the caller's long_dim_length
    for ix, ln in program.descriptor.bind_lengths:
        index_to_length[ix] = int(ln)
    # row-concatenation rewrites stretch the long axis: b rows end-to-end
    rc = getattr(program.descriptor, "rowcat", 1) or 1
    if rc > 1:
        for ix, ln in program.einsum.index_to_dim_length.items():
            if isinstance(ln, SizeParam):
                index_to_length[ix] *= rc
    # lane-pack rewrites scale the long axis: g elements per packed row
    g = getattr(program.descriptor, "lane_pack", 1) or 1
    if g > 1:
        from ..diagnostics import InvalidParameterError
        for ix, ln in program.einsum.index_to_dim_length.items():
            if isinstance(ln, SizeParam):
                if index_to_length[ix] % g:
                    raise InvalidParameterError(
                        f"lane_pack={g} requires the long axis length"
                        f" ({index_to_length[ix]}) divisible by it")
                index_to_length[ix] //= g
    lengths_key = tuple(sorted(index_to_length.items()))
    return _build_executable_cached(program, lengths_key)
