"""
Empirical measurement & validation harness (parity: ``feinsum/measure.py``).

* random input generation (dtype-aware) and device placement;
* validation of a transformed program against the ``numpy.einsum`` oracle at a
  small long-dim length with dtype-dependent tolerances
  (reference measure.py:111-194);
* wall-clock timing with warmup + batched rounds until >=10 rounds and >=2 s
  (reference measure.py:197-275), fenced with ``block_until_ready``; on a
  GPU, the median of back-to-back launches each ending in
  ``block_until_ready`` (:func:`timeit_on_device`);
* flop polynomials per dtype from the contraction schedule (reference
  counts via loopy's polyhedral op map, measure.py:278-331; ours evaluates
  the same closed form: per step, |domain| * ((n_terms-1) muls + 1 add when
  contracted), complex-weighted mul=6/add=2), kept as integer coefficients
  of powers of the long axis;
* roofline = flops / max(sum_dtype flops_d/peak_d, bytes/BW) from the device
  tables (reference measure.py:388-418).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from .codegen.program import (
    EinsumProgram,
    TransformT,
    build_executable,
    ensure_x64_if_needed,
    generate_program,
    get_index_lengths,
    output_dtype,
)
from .contraction_schedule import (
    ContractionSchedule,
    EinsumOperand,
    get_opt_einsum_contraction_schedule,
)
from .data.device_info import (
    DEV_TO_PEAK_BW,
    DEV_TO_PEAK_GFLOPS,
    L2_BYTES,
    get_device_key,
)
from .diagnostics import (
    NoDevicePeaksInfoError,
    TimingBelowFloorError,
    TransformValidationError,
)
from .einsum import BatchedEinsum, SizeParam

N_WARMUP_ROUNDS = 5
N_MIN_TIMING_ROUNDS = 10
MIN_TIMING_SECS = 2.0

DTYPE_TO_RTOL = {
    np.dtype("float16"): 1e-2,
    np.dtype("float32"): 2e-5,
    # f64 at the 1e-12 north star (BASELINE.json "bitwise-tolerant"): f64
    # runs through XLA's native double arithmetic.  The reference used
    # 1e-10 (measure.py:57-63); we tighten 100x.
    np.dtype("float64"): 1e-12,
    np.dtype("complex64"): 2e-5,
    np.dtype("complex128"): 1e-12,
}


# {{{ inputs

def generate_input_arrays(einsum: BatchedEinsum, *, long_dim_length: int,
                          seed: int = 0, as_numpy: bool = False) -> dict:
    """Random inputs for every distinct operand, on the default device.
    Layout permutations mandated by a descriptor are applied by the caller
    (see :func:`_apply_layouts`)."""
    lengths = get_index_lengths(einsum, long_dim_length)
    rng = np.random.default_rng(seed)
    out = {}
    arg_to_idx = {}
    for args_row in einsum.args:
        for arg, idx_set in zip(args_row, einsum.in_idx_sets):
            arg_to_idx[arg.name] = idx_set
    for name in einsum.arg_to_shape:
        shape = tuple(lengths[ix] for ix in arg_to_idx[name])
        dtype = einsum.arg_to_dtype[name]
        if dtype.kind == "c":
            base = (rng.random(shape) + 1j * rng.random(shape))
        elif dtype.kind in "iu":
            base = rng.integers(0, 8, size=shape)
        else:
            base = rng.random(shape)
        out[name] = np.asarray(base, dtype=dtype)
    if as_numpy:
        return out
    import jax
    if any(v.dtype in (np.float64, np.complex128) for v in out.values()):
        # device_put silently downcasts f64 -> f32 while x64 is off; an
        # executable build enables it as a side effect (program.py:132),
        # but a caller generating inputs FIRST must not get f32 "f64"
        if not jax.config.read("jax_enable_x64"):
            jax.config.update("jax_enable_x64", True)
    return {k: jax.device_put(v) for k, v in out.items()}


def apply_layouts(program: EinsumProgram, arrays: dict) -> dict:
    """Pack logical (einsum-shaped) *arrays* into *program*'s declared HBM
    storage contract — the calling convention of
    :func:`~feinsum_tpu.build_executable`'s result when the descriptor
    carries layout knobs (dofmajor/fold/preblock/lane_pack/rowcat/
    pre_layouts).  Inverse on the output side:
    :func:`feinsum_tpu.unpack_output`.  Public consumer-path API: the
    reference's transforms rewrite the kernel in place so its calling
    convention never changes (codegen/loopy.py); ours trade that for
    measured HBM-layout wins, so replaying an archived champion by hand
    (retrieve -> transform -> build_executable) needs this pair —
    :func:`~feinsum_tpu.compile_fn_with_archive` applies them for you."""
    from .ops.layouts import apply_nested_layout, fold_arrays, preblock_arrays

    out = dict(arrays)
    # row-concatenation contract first: the rows' streamed operands stack
    # end-to-end along the (leading) long axis (descriptor.rowcat_args)
    for new_name, olds in (getattr(program.descriptor, "rowcat_args", ())
                           or ()):
        stack = [out.pop(n) for n in olds]
        if isinstance(stack[0], np.ndarray):
            out[new_name] = np.concatenate(stack, axis=0)
        else:
            import jax.numpy as jnp
            out[new_name] = jnp.concatenate(stack, axis=0)
    # lane-pack contract first: g consecutive elements of the long axis
    # share one packed dof row, (lead..., E, rest...) ->
    # (lead..., E/g, g*prod(rest)) — a free reshape of the row-major buffer
    # (descriptor.lane_pack; entries may be (name, n_lead), plain names
    # mean n_lead 0)
    g = getattr(program.descriptor, "lane_pack", 1) or 1
    for entry in getattr(program.descriptor, "lane_pack_args", ()) or ():
        name, n_lead = (entry if isinstance(entry, tuple) else (entry, 0))
        arr = out[name]
        if arr.shape[n_lead] % g:
            from .diagnostics import InvalidParameterError
            raise InvalidParameterError(
                f"lane_pack={g} requires {name}'s long axis"
                f" ({arr.shape[n_lead]}) divisible by it")
        out[name] = arr.reshape(
            arr.shape[:n_lead] + (arr.shape[n_lead] // g, -1))
    # pre_layouts: logical (user) axes -> the rewritten program's stored
    # grouping (e.g. rank-4 TC operand -> GEMM-natural 2D), applied first
    for name, nested in dict(program.descriptor.pre_layouts).items():
        out[name] = apply_nested_layout(out[name], nested)
    layouts = program.descriptor.arg_layouts_map
    for name, perm in layouts.items():
        out[name] = out[name].transpose(tuple(int(p) for p in perm))
    return preblock_arrays(program, fold_arrays(program, out))


# internal alias (pre-export name; all in-tree callers use it)
_apply_layouts = apply_layouts

# }}}


# {{{ flop counting

_COMPLEX_WEIGHTS = {"mul": 6, "add": 2}
_REAL_WEIGHTS = {"mul": 1, "add": 1}


def _length_poly(length) -> dict:
    """An axis length as a polynomial {power of the long axis: coeff}."""
    if isinstance(length, SizeParam):
        return {1: 1}
    return {0: int(length)}


def _poly_mul(a: dict, b: dict) -> dict:
    out: dict = {}
    for pa, ca in a.items():
        for pb, cb in b.items():
            out[pa + pb] = out.get(pa + pb, 0) + ca * cb
    return out


def get_giga_op_map(einsum: BatchedEinsum,
                    schedule: Optional[ContractionSchedule] = None) -> dict:
    """dtype-name -> flop count over all b rows of *schedule* (default: the
    opt_einsum schedule, matching the reference's convention of counting
    against the optimal path), as a polynomial in the long axis length:
    ``{power: integer coefficient}`` of flops (evaluate with
    :func:`evaluate_giga_op_map`, which scales to 1e9)."""
    if schedule is None:
        schedule = get_opt_einsum_contraction_schedule(einsum)
    lengths = einsum.index_to_dim_length
    totals: dict = {}
    for row in range(einsum.b):
        # dtype of each step's result for this row
        env_dtype: dict = {}
        for subs, name, step_args in zip(schedule.subscripts,
                                         schedule.result_names,
                                         schedule.arguments):
            in_specs, out_spec = subs.replace(" ", "").split("->")
            in_specs = in_specs.split(",")
            dts = []
            for a in step_args:
                if isinstance(a, EinsumOperand):
                    dts.append(einsum.args[row][a.position].dtype)
                else:
                    dts.append(env_dtype[a.name])
            dt = np.result_type(*dts)
            env_dtype[name] = dt

            all_idx = set("".join(in_specs))
            contracted = all_idx - set(out_spec)
            domain = {0: 1}
            for ix in sorted(all_idx):
                domain = _poly_mul(domain, _length_poly(lengths[ix]))
            w = _COMPLEX_WEIGHTS if dt.kind == "c" else _REAL_WEIGHTS
            n_terms = len(step_args)
            per_point = ((n_terms - 1) * w["mul"]
                         + (w["add"] if contracted else 0))
            if per_point:
                poly = totals.setdefault(dt.name, {})
                for p, c in domain.items():
                    poly[p] = poly.get(p, 0) + c * per_point
    return totals


def evaluate_giga_op_map(giga_op_map: dict, long_dim_length: int) -> dict:
    """GOps per dtype with every long axis == long_dim_length."""
    return {k: sum(c * long_dim_length ** p for p, c in poly.items()) * 1e-9
            for k, poly in giga_op_map.items()}


def get_footprint_gbytes(einsum: BatchedEinsum, *, long_dim_length: int
                         ) -> float:
    """Ideal HBM traffic: every distinct operand read once + outputs written
    once (the fused Pallas model materializes no intermediates)."""
    lengths = get_index_lengths(einsum, long_dim_length)
    arg_to_idx = {}
    for args_row in einsum.args:
        for arg, idx_set in zip(args_row, einsum.in_idx_sets):
            arg_to_idx[arg.name] = idx_set
    nbytes = 0
    for name in einsum.all_args:
        size = 1
        for ix in arg_to_idx[name]:
            size *= lengths[ix]
        nbytes += size * einsum.arg_to_dtype[name].itemsize
    return nbytes * 1e-9 + get_write_gbytes(
        einsum, long_dim_length=long_dim_length)


def get_write_gbytes(einsum: BatchedEinsum, *,
                     long_dim_length: int) -> float:
    """Output bytes only (written once)."""
    lengths = get_index_lengths(einsum, long_dim_length)
    out_size = 1
    for ix in einsum.out_idx_set:
        out_size *= lengths[ix]
    return sum(out_size * output_dtype(einsum, row).itemsize
               for row in range(einsum.b)) * 1e-9

# }}}


# {{{ validation

def _numpy_oracle(einsum: BatchedEinsum, np_arrays: dict) -> list:
    subs = (",".join("".join(s) for s in einsum.in_idx_sets)
            + "->" + "".join(einsum.out_idx_set))
    outs = []
    for row in einsum.args:
        ins = [np_arrays[arg.name] for arg in row]
        outs.append(np.einsum(subs, *ins, optimize="optimal"))
    return outs


def validate_batched_einsum_transform(
        einsum: BatchedEinsum, transform: Optional[TransformT], *,
        long_dim_length: int = 100, seed: int = 0,
        rtol: Optional[float] = None) -> None:
    """Run the transformed program and compare against numpy.einsum; raises
    :class:`TransformValidationError` on mismatch (parity: reference
    measure.py:111-194)."""
    ensure_x64_if_needed(einsum)
    program = generate_program(einsum)
    if transform is not None:
        program = transform(program)
        if not isinstance(program, EinsumProgram):
            raise TypeError("transform must return an EinsumProgram")

    fold = getattr(program.descriptor, "fold_long", 1) or 1
    lane_g = getattr(program.descriptor, "lane_pack", 1) or 1
    div = fold * lane_g
    if div > 1 and long_dim_length % div:
        # folded / lane-packed layouts require the long axis divisible
        long_dim_length += div - long_dim_length % div

    np_arrays = generate_input_arrays(einsum, long_dim_length=long_dim_length,
                                      seed=seed, as_numpy=True)
    expected = _numpy_oracle(einsum, np_arrays)

    import jax
    dev_arrays = {k: jax.device_put(v)
                  for k, v in _apply_layouts(program, np_arrays).items()}
    fn = build_executable(program, long_dim_length=long_dim_length)
    results = fn(dev_arrays)
    rc = getattr(program.descriptor, "rowcat", 1) or 1
    if rc > 1:
        # rowcat rewrites deliver ONE output: the rows concatenated along
        # the (leading) long output axis — concatenate the oracle the same
        from .einsum import SizeParam as _SP
        (el,) = [ix for ix, ln in einsum.index_to_dim_length.items()
                 if isinstance(ln, _SP)]
        p_long = list(einsum.out_idx_set).index(el)
        expected = [np.concatenate(expected, axis=p_long)]
    if len(results) != (1 if rc > 1 else einsum.b):
        raise TransformValidationError(
            f"expected {einsum.b} outputs, got {len(results)}")
    out_layout = program.descriptor.out_layout
    fold = getattr(program.descriptor, "fold_long", 1) or 1
    pre_out = program.descriptor.pre_out_layout
    for r, (got, ref) in enumerate(zip(results, expected)):
        got = np.asarray(got)
        if pre_out is not None:
            # rewritten-program outputs are grouped (e.g. GEMM-natural 2D)
            from .ops.layouts import apply_nested_layout
            ref = apply_nested_layout(ref, pre_out)
        if lane_g > 1:
            # lane-packed outputs are delivered (lead..., E/g, g*d_out)
            # (the long axis is second-to-last logically; 1D vecmat
            # outputs pack (E,) -> (E/g, g))
            if ref.ndim == 1:
                ref = np.reshape(ref, (ref.shape[0] // lane_g, -1))
            else:
                ref = np.reshape(
                    ref, ref.shape[:-2] + (ref.shape[-2] // lane_g, -1))
        if out_layout is not None:
            # outputs are delivered in the descriptor's stored layout
            ref = np.transpose(ref, tuple(int(p) for p in out_layout))
        if fold > 1 and got.ndim == ref.ndim + 1:
            # stored-folded output: trailing (E,) delivered as (f, E/f)
            ref = np.reshape(ref, ref.shape[:-1] + (fold, -1))
        dt = output_dtype(einsum, r)
        tol = rtol if rtol is not None else DTYPE_TO_RTOL.get(
            np.dtype(dt), 1e-2)
        scale = float(np.max(np.abs(ref))) or 1.0
        if got.shape != ref.shape:
            raise TransformValidationError(
                f"row {r}: shape {got.shape} != expected {ref.shape}")
        if not np.allclose(got.astype(np.float64) if got.dtype.kind != "c"
                           else got,
                           ref, rtol=tol, atol=tol * scale):
            err = float(np.max(np.abs(got - ref)))
            raise TransformValidationError(
                f"row {r}: max abs error {err:.3e} exceeds tolerance"
                f" rtol={tol} (scale {scale:.3e})")

# }}}


# {{{ timing

def _median_launch_seconds(fn, arrays: dict, *, n_launches: int = 20,
                           n_warmup: int = 3) -> float:
    """Median host-clock seconds of *n_launches* back-to-back launches of
    *fn*, each ending in ``block_until_ready`` (after *n_warmup* untimed
    launches, the first of which compiles)."""
    import jax

    for _ in range(n_warmup):
        jax.block_until_ready(fn(arrays))
    times = []
    for _ in range(n_launches):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(arrays))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _bytes_floor_seconds(arrays: dict, outs, device=None) -> float:
    """The physics floor: (input + output logical bytes) / the device's
    peak HBM bandwidth.  No launch that streams its operands can beat it.
    Raises :class:`NoDevicePeaksInfoError` for a device not in the table."""
    key = get_device_key(device)
    if key not in DEV_TO_PEAK_BW:
        raise NoDevicePeaksInfoError(
            f"No peak bandwidth recorded for device '{key}'. Known:"
            f" {sorted(DEV_TO_PEAK_BW)}")
    if not isinstance(outs, (tuple, list)):
        outs = (outs,)
    nbytes = sum(int(v.size) * v.dtype.itemsize for v in arrays.values())
    nbytes += sum(int(o.size) * o.dtype.itemsize for o in outs)
    return nbytes / (DEV_TO_PEAK_BW[key] * 1e9)


def timeit_on_device(fn, arrays: dict, *, n_launches: int = 20) -> float:
    """Seconds per launch of *fn* on the current accelerator: the median
    host-clock time of back-to-back launches, each ending in
    ``block_until_ready``.  A median below the bandwidth floor (logical
    bytes / peak HBM bandwidth) cannot be a real measurement and raises
    :class:`TimingBelowFloorError`."""
    import jax

    dt = _median_launch_seconds(fn, arrays, n_launches=n_launches)
    outs = jax.block_until_ready(fn(arrays))
    floor = _bytes_floor_seconds(arrays, outs)
    if dt < floor:
        raise TimingBelowFloorError(
            f"median launch {dt * 1e6:.1f} us is below the"
            f" {floor * 1e6:.1f} us bandwidth floor")
    return dt


def _timeit_in_graph(fn, arrays: dict, *, min_work_seconds: float = 0.6,
                     max_iters: int = 200_000) -> float:
    """Per-iteration seconds of ``fn`` measured with the whole loop inside one
    jit: every iteration's inputs pass through an ``optimization_barrier``
    tied to the running accumulator, so the call is loop-carried (no
    hoisting/CSE); the fence is a scalar reduction (never download the
    outputs); fixed host costs cancel via a (k2 iters) - (k1 iters)
    difference, with k2 grown adaptively until the on-device work dominates.
    Every iteration is one dependency chain, so consecutive calls cannot
    overlap — a conservative per-call cost, used by the consumer path's
    plan shootout."""
    import jax
    import jax.numpy as jnp

    names = sorted(arrays)

    # small working sets stay in the 50 MB L2 across the chained
    # iterations, and the loop would measure L2 — not HBM — bandwidth.
    # Rotate among stacked copies of every input so each iteration's reads
    # must come from HBM (concrete-shape einsums like the TCCG suite hit
    # this; the parametric DG suite at E=1M never does).
    ws_bytes = sum(int(a.size) * a.dtype.itemsize for a in arrays.values())
    n_copies = 1
    if ws_bytes < L2_BYTES:
        n_copies = min(64, -(-2 * L2_BYTES // max(ws_bytes, 1)))

    if n_copies > 1:
        stacked = {name: jnp.stack([arr] * n_copies)
                   for name, arr in arrays.items()}
    else:
        stacked = arrays

    def _select(arrs, i):
        if n_copies == 1:
            return arrs
        return {name: jax.lax.dynamic_index_in_dim(
                    stk, i % n_copies, 0, keepdims=False)
                for name, stk in arrs.items()}

    def body(i, carry):
        arrs, acc = carry
        # route the inputs through a barrier together with the accumulator:
        # the barrier's outputs are data-dependent on acc, so the iteration
        # cannot be hoisted out of the loop — and no input bytes move
        gated = jax.lax.optimization_barrier(
            tuple(arrs[n] for n in names) + (acc,))
        arrs_g = dict(zip(names, gated[:-1]))
        acc = gated[-1]   # keep the accumulator update downstream of the
        # barrier too, so the whole iteration is one dependency chain
        outs = fn(_select(arrs_g, i))
        # the output barrier forces every output to fully materialize:
        # without it, XLA sinks the one-element probe slice THROUGH a
        # plain-HLO dot and the whole iteration shrinks to a vector dot
        # (observed on TCCG GEMMs via the XLA backend — 61 PFlop/s
        # "measurements"; Pallas calls are opaque and were never affected)
        outs = jax.lax.optimization_barrier(tuple(outs))
        # one element of the output feeds the accumulator: the call cannot be
        # dead-code-eliminated, and reading 4 bytes adds no HBM traffic
        probe = outs[0].ravel()[0].astype(jnp.float32)
        acc = acc * 0.5 + probe
        return arrs, acc

    @jax.jit
    def run(arrs, k):
        # dynamic trip count: one compilation serves every k
        arrs, acc = jax.lax.fori_loop(0, k, body, (arrs, jnp.float32(0)),
                                      unroll=False)
        outs = jax.lax.optimization_barrier(
            tuple(fn(_select(arrs, jnp.int32(0)))))
        return acc + outs[0].ravel()[0].astype(jnp.float32)

    def timed(k, reps=3):
        vals = []
        for _i in range(reps):
            t0 = time.perf_counter()
            _ = float(run(stacked, k))
            vals.append(time.perf_counter() - t0)
        return sorted(vals)[len(vals) // 2]

    _ = float(run(stacked, 1))   # warm / compile
    k1 = 8
    t1 = timed(k1)
    k2 = 64
    while k2 < max_iters:
        t2 = timed(k2, reps=1)
        if t2 - t1 > min_work_seconds:
            break
        per_iter = max((t2 - t1) / (k2 - k1), 1e-7)
        k2 = min(max_iters,
                 max(2 * k2, k1 + int(min_work_seconds / per_iter)))
    t2 = timed(k2)
    return max((t2 - t1) / (k2 - k1), 1e-9)


def timeit(einsum: BatchedEinsum, *,
           transform: Optional[TransformT] = None,
           long_dim_length: int = 100_000,
           validate: bool = True,
           validation_long_dim_length: int = 100,
           min_rounds: int = N_MIN_TIMING_ROUNDS,
           min_seconds: float = MIN_TIMING_SECS,
           method: str = "auto",
           device=None) -> float:
    """Seconds per launch of the (transformed) einsum program: validate
    first, then time.  ``method="host"`` follows the reference protocol
    (5 warmups, batches of 5 until >= *min_rounds* rounds and >=
    *min_seconds*; reference measure.py:35-37, 197-275); ``"in_graph"`` chains
    iterations inside one jit (see :func:`_timeit_in_graph`); ``"device"``
    is :func:`timeit_on_device`.  ``"auto"`` picks device on a GPU and host
    otherwise.

    ``device`` is accepted for reference call-shape parity (the reference's
    timeit takes a ``cl_ctx``); execution always happens on the ambient JAX
    backend, so here it only names the device for roofline/archive keys in
    wrappers (:func:`stringify_comparison_vs_roofline`) and is otherwise
    ignored."""
    del device  # naming-only (see docstring); execution is ambient-JAX
    import jax

    if validate:
        validate_batched_einsum_transform(
            einsum, transform, long_dim_length=validation_long_dim_length)

    program = generate_program(einsum)
    if transform is not None:
        program = transform(program)
    arrays = generate_input_arrays(einsum, long_dim_length=long_dim_length)
    arrays = _apply_layouts(program, arrays)
    fn = build_executable(program, long_dim_length=long_dim_length)

    if method == "auto":
        method = ("device" if jax.devices()[0].platform == "gpu"
                  else "host")
    if method == "device":
        return timeit_on_device(fn, arrays)
    if method == "in_graph":
        return _timeit_in_graph(fn, arrays)

    for _ in range(N_WARMUP_ROUNDS):
        out = fn(arrays)
    jax.block_until_ready(out)

    n_rounds = 0
    elapsed = 0.0
    while n_rounds < min_rounds or elapsed < min_seconds:
        t0 = time.perf_counter()
        for _ in range(5):
            out = fn(arrays)
        jax.block_until_ready(out)
        elapsed += time.perf_counter() - t0
        n_rounds += 5
    return elapsed / n_rounds


def measure_giga_op_rate(einsum: BatchedEinsum, *,
                         transform: Optional[TransformT] = None,
                         long_dim_length: int = 100_000,
                         **timeit_kwargs) -> dict:
    """dtype-name -> achieved GOp/s (parity: reference measure.py:357-385);
    the special key ``"total"`` sums all dtypes.  Extra kwargs (including
    the naming-only ``device``) forward to :func:`timeit`."""
    runtime = timeit(einsum, transform=transform,
                     long_dim_length=long_dim_length, **timeit_kwargs)
    gops = evaluate_giga_op_map(get_giga_op_map(einsum), long_dim_length)
    rates = {k: v / runtime for k, v in gops.items()}
    rates["total"] = sum(v for k, v in rates.items())
    return rates

# }}}


# {{{ roofline

def get_roofline_flop_rate(einsum: BatchedEinsum, device_name: str, *,
                           long_dim_length: int = 100_000) -> float:
    """Roofline GOp/s: total flops / max(compute time, memory time) using the
    static device peaks (parity: reference measure.py:388-418).  Raises
    :class:`NoDevicePeaksInfoError` for a device or dtype not in the
    tables."""
    key = get_device_key(device_name)
    if key not in DEV_TO_PEAK_GFLOPS or key not in DEV_TO_PEAK_BW:
        raise NoDevicePeaksInfoError(
            f"No peak flops/bandwidth info for device '{key}'. Known:"
            f" {sorted(DEV_TO_PEAK_GFLOPS)}")
    gops = evaluate_giga_op_map(get_giga_op_map(einsum), long_dim_length)
    total_gops = sum(gops.values())
    t_compute = 0.0
    for dtype_name, g in gops.items():
        peaks = DEV_TO_PEAK_GFLOPS[key]
        if dtype_name not in peaks:
            raise NoDevicePeaksInfoError(
                f"No {dtype_name} peak recorded for '{key}'.")
        t_compute += g / peaks[dtype_name]
    t_mem = get_footprint_gbytes(
        einsum, long_dim_length=long_dim_length) / DEV_TO_PEAK_BW[key]
    return total_gops / max(t_compute, t_mem)


def stringify_comparison_vs_roofline(
        einsum: BatchedEinsum, *, device_name: Optional[str] = None,
        device=None,
        transform: Optional[TransformT] = None,
        long_dim_length: int = 100_000,
        **timeit_kwargs) -> str:
    """Measured-vs-roofline comparison table (parity: reference
    measure.py:484-525).  ``device`` accepts anything with a ``.name`` /
    ``.device_kind`` (e.g. :class:`~feinsum_tpu.FakeDevice`), mirroring the
    reference's ``cl_device`` argument; ``device_name`` takes a plain
    roofline-table key string."""
    if device_name is None and device is not None:
        device_name = get_device_key(device)
    if device_name is None:
        import jax
        device_name = get_device_key(jax.devices()[0])
    measured = measure_giga_op_rate(
        einsum, transform=transform, long_dim_length=long_dim_length,
        **timeit_kwargs)
    roofline = get_roofline_flop_rate(
        einsum, device_name, long_dim_length=long_dim_length)
    total = measured["total"]
    rows = [("dtype", "measured GOps/s", "roofline GOps/s", "% roofline"),
            ("total", f"{total:.1f}", f"{roofline:.1f}",
             f"{100.0 * total / roofline:.1f}%")]
    for k, v in sorted(measured.items()):
        if k != "total":
            rows.append((k, f"{v:.1f}", "-", "-"))
    widths = [max(len(r[i]) for r in rows) for i in range(4)]
    lines = [" | ".join(c.ljust(w) for c, w in zip(r, widths)) for r in rows]
    lines.insert(1, "-+-".join("-" * w for w in widths))
    return "\n".join(lines)

# }}}


# {{{ profiling

def profile_program(program: EinsumProgram, *, long_dim_length: int = 100_000,
                    trace_dir: Optional[str] = None,
                    n_iters: int = 10) -> str:
    """Capture a jax profiler trace of the compiled program (viewable in
    TensorBoard/Perfetto) into *trace_dir* (default: a fresh temporary
    directory); returns the trace directory.  The reference has no tracer
    (SURVEY.md §5)."""
    import tempfile

    import jax

    if trace_dir is None:
        trace_dir = tempfile.mkdtemp(prefix="feinsum_trace_")
    arrays = _apply_layouts(program, generate_input_arrays(
        program.einsum, long_dim_length=long_dim_length))
    fn = build_executable(program, long_dim_length=long_dim_length)
    out = fn(arrays)
    jax.block_until_ready(out)
    with jax.profiler.trace(trace_dir):
        for _ in range(n_iters):
            out = fn(arrays)
        jax.block_until_ready(out)
    return trace_dir

# }}}


# {{{ device calibration

def calibrate_device_peaks(*, sizes=(4096,), dtype="float32",
                           n_iters: int = 20) -> dict:
    """Measure achievable matmul GFLOP/s and HBM copy bandwidth on the
    current default device (used to sanity-check/update the static tables)."""
    import jax
    import jax.numpy as jnp

    results = {}
    for size in sizes:
        a = jnp.ones((size, size), dtype=dtype)
        b = jnp.ones((size, size), dtype=dtype)
        f = jax.jit(lambda a, b: a @ b)
        f(a, b).block_until_ready()
        t0 = time.perf_counter()
        out = None
        for _ in range(n_iters):
            out = f(a, b)
        out.block_until_ready()
        dt = (time.perf_counter() - t0) / n_iters
        results[f"matmul_{dtype}_{size}"] = 2 * size**3 / dt / 1e9

    n = 64 * 1024 * 1024 // 4
    x = jnp.ones((n,), dtype="float32")
    g = jax.jit(lambda x: x * 2.0 + 1.0)
    g(x).block_until_ready()
    t0 = time.perf_counter()
    for _ in range(n_iters):
        y = g(x)
    y.block_until_ready()
    dt = (time.perf_counter() - t0) / n_iters
    results["stream_GBps"] = 2 * x.nbytes / dt / 1e9
    return results

# }}}
