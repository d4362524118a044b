"""
Multi-chip execution of batched-einsum programs over a ``jax.sharding.Mesh``.

The reference is single-device (SURVEY.md §2.4); this layer is the
extension: the parametric element axis is embarrassingly parallel (every
archived einsum's contractions are element-local), so

* :func:`sharded_einsum_executable` shards the long axis across a mesh axis
  with ``shard_map`` — pure data parallelism, no collectives;
* :func:`reduction_sharded_executable` additionally splits one *contracted*
  axis across a second mesh axis and ``psum``s partial results — the
  tensor-parallel pattern, used when a single card's HBM bandwidth is the
  bottleneck and operands are sharded at rest.

Each shard runs the same fused Pallas/XLA kernel built by
``build_executable``; XLA inserts the collectives (NCCL over NVLink).  The
cards of a host are joined all to all, so meshes follow the algorithm,
not a torus.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..codegen.program import (
    EinsumProgram,
    build_executable,
    get_index_lengths,
)
from ..einsum import SizeParam


def _long_axis(program: EinsumProgram) -> str:
    e = program.einsum
    params = [ix for ix, ln in e.index_to_dim_length.items()
              if isinstance(ln, SizeParam)]
    if program.descriptor.grid_index is not None:
        return program.descriptor.grid_index
    if not params:
        raise ValueError("no parametric axis to shard over")
    out_params = [ix for ix in e.out_idx_set if ix in params]
    return (out_params or params)[0]


def _specs_for(program: EinsumProgram, shard_axis: str, mesh_axis: str,
               extra: Optional[dict] = None):
    """P-specs for inputs (dict) and outputs (tuple) of the executable:
    arrays carrying *shard_axis* are sharded on *mesh_axis* along it; *extra*
    maps an additional index letter to a mesh axis."""
    from jax.sharding import PartitionSpec as P

    e = program.einsum
    extra = extra or {}
    layouts = program.descriptor.arg_layouts_map

    def spec_of(idx_set, name=None):
        if name is not None and name in layouts:
            idx_set = tuple(idx_set[p] for p in layouts[name])
        return P(*[
            mesh_axis if ix == shard_axis else extra.get(ix)
            for ix in idx_set])

    arg_idx = {}
    for row in e.args:
        for arg, idx_set in zip(row, e.in_idx_sets):
            arg_idx[arg.name] = idx_set
    in_specs = {name: spec_of(idx_set, name)
                for name, idx_set in arg_idx.items()}
    out_idx = tuple(e.out_idx_set)
    if program.descriptor.out_layout is not None:
        # outputs are delivered in the descriptor's stored layout
        out_idx = tuple(out_idx[p] for p in program.descriptor.out_layout)
    out_spec = spec_of(out_idx)
    return in_specs, tuple(out_spec for _ in range(e.b))


def sharded_einsum_executable(program: EinsumProgram, mesh, *,
                              mesh_axis: str = "data",
                              long_dim_length: int = 100_000,
                              shard_axis: Optional[str] = None):
    """``fn(arrays_by_name) -> tuple``: the program's long axis sharded over
    ``mesh.shape[mesh_axis]`` devices; each device runs the single-chip fused
    kernel on its slab."""
    import jax
    from jax import shard_map

    shard_axis = shard_axis or _long_axis(program)
    n_shards = mesh.shape[mesh_axis]
    if long_dim_length % n_shards:
        raise ValueError(
            f"long axis ({long_dim_length}) must divide over"
            f" {n_shards} shards")
    lengths = get_index_lengths(program.einsum, long_dim_length)
    local_lengths = dict(lengths)
    local_lengths[shard_axis] = lengths[shard_axis] // n_shards
    local_fn = build_executable(program, index_to_length=local_lengths)

    in_specs, out_specs = _specs_for(program, shard_axis, mesh_axis)

    sharded = shard_map(
        lambda arrs: local_fn(arrs),
        mesh=mesh,
        in_specs=(in_specs,),
        out_specs=out_specs,
        check_vma=False)
    return jax.jit(sharded)


def reduction_sharded_executable(program: EinsumProgram, mesh, *,
                                 data_axis: str = "data",
                                 model_axis: str = "model",
                                 reduction_index: Optional[str] = None,
                                 long_dim_length: int = 100_000,
                                 shard_axis: Optional[str] = None):
    """2D-sharded executable: long axis over *data_axis* (pure DP) and one
    contracted index over *model_axis* (TP) with a ``psum`` over partial
    contractions."""
    import jax
    from jax import shard_map

    e = program.einsum
    shard_axis = shard_axis or _long_axis(program)
    if reduction_index is None:
        # largest contracted axis
        candidates = [(ix, e.index_to_dim_length[ix])
                      for ix in e.sum_indices
                      if not isinstance(e.index_to_dim_length[ix], SizeParam)]
        if not candidates:
            raise ValueError("no concrete contracted axis to shard")
        reduction_index = max(candidates, key=lambda kv: int(kv[1]))[0]

    n_data = mesh.shape[data_axis]
    n_model = mesh.shape[model_axis]
    lengths = get_index_lengths(e, long_dim_length)
    if lengths[shard_axis] % n_data:
        raise ValueError("long axis must divide over the data mesh axis")
    if lengths[reduction_index] % n_model:
        raise ValueError(
            f"reduction axis {reduction_index} (={lengths[reduction_index]})"
            f" must divide over {n_model} model shards")
    local_lengths = dict(lengths)
    local_lengths[shard_axis] = lengths[shard_axis] // n_data
    local_lengths[reduction_index] = lengths[reduction_index] // n_model
    local_fn = build_executable(program, index_to_length=local_lengths)

    in_specs, out_specs = _specs_for(
        program, shard_axis, data_axis, extra={reduction_index: model_axis})

    def shard_fn(arrs):
        partial = local_fn(arrs)
        return tuple(
            jax.lax.psum(p, axis_name=model_axis) for p in partial)

    sharded = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(in_specs,),
        out_specs=out_specs,
        check_vma=False)
    return jax.jit(sharded)


def row_sharded_executable(program: EinsumProgram, mesh, *,
                           mesh_axis: str = "rows",
                           long_dim_length: int = 100_000):
    """Shard the **batch rows** over ``mesh.shape[mesh_axis]`` devices — the
    expert-parallel pattern for batched einsums: rows are independent
    einsums sharing one subscript, so each device evaluates its row slab
    with the single-chip fused kernel and no collectives at all (operands
    appearing in every row, e.g. the reference matrix ``D``, are
    replicated; per-row operands arrive STACKED on a leading row axis).

    Returns ``fn(stacked_arrays, shared_arrays) -> (b, *out_shape)`` where
    ``stacked_arrays[name]`` has shape ``(b, *operand_shape)`` for each
    per-row operand position (name = position-0 row's operand name).
    Complements :func:`sharded_einsum_executable` (DP over elements) and
    :func:`reduction_sharded_executable` (TP over a contracted axis)."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    e = program.einsum
    b, n = e.b, mesh.shape[mesh_axis]
    if b % n:
        raise ValueError(f"b={b} rows must divide over {n} shards")
    b_local = b // n

    # operand positions whose array differs between rows get stacked;
    # positions with one shared array (same name in every row) replicate
    shared_pos = [j for j in range(e.n)
                  if len({e.args[i][j].name for i in range(b)}) == 1]
    stack_pos = [j for j in range(e.n) if j not in shared_pos]
    stack_names = {j: e.args[0][j].name for j in stack_pos}

    # the local program: b_local rows, positional arg names (every shard
    # runs the same executable on its slab of the stacked operands)
    local_args = tuple(
        tuple(e.args[0][j].copy(name=(e.args[0][j].name if j in shared_pos
                                      else f"_row{i}_{e.args[0][j].name}"))
              for j in range(e.n))
        for i in range(b_local))
    from ..einsum import BatchedEinsum
    local_e = BatchedEinsum(e.out_idx_set, e.in_idx_sets, local_args)
    # renamed per-row args inherit their position's storage layout
    new_layouts = []
    renamed = {stack_names[j] for j in stack_pos}
    for name, perm in program.descriptor.arg_layouts:
        if name in renamed:
            new_layouts.extend((f"_row{i}_{name}", perm)
                               for i in range(b_local))
        elif name in {a.name for row in local_args for a in row}:
            new_layouts.append((name, perm))
    local_prog = program.copy(einsum=local_e).with_descriptor(
        arg_layouts=tuple(new_layouts))
    lengths = get_index_lengths(e, long_dim_length)
    local_fn = build_executable(local_prog, index_to_length=lengths)

    in_specs = (
        {stack_names[j]: P(mesh_axis,
                           *[None for _ in e.in_idx_sets[j]])
         for j in stack_pos},
        {e.args[0][j].name: P(*[None for _ in e.in_idx_sets[j]])
         for j in shared_pos},
    )
    out_spec = P(mesh_axis, *[None for _ in e.out_idx_set])

    def shard_fn(stacked, shared):
        # ONE call: local_prog is a b_local-row batched einsum expecting
        # every local row's operands together (so rows still share DMA in
        # the fused kernel)
        arrs = dict(shared)
        for i in range(b_local):
            for j in stack_pos:
                arrs[f"_row{i}_{stack_names[j]}"] = stacked[stack_names[j]][i]
        return jnp.stack(local_fn(arrs))

    sharded = shard_map(shard_fn, mesh=mesh,
                        in_specs=in_specs, out_specs=out_spec,
                        check_vma=False)
    return jax.jit(sharded)


def make_mesh(shape: dict):
    """Mesh from {'data': n, 'model': m} over the available devices."""
    import jax
    from jax.sharding import Mesh

    names = tuple(shape)
    dims = tuple(shape[n] for n in names)
    n_dev = int(np.prod(dims))
    devices = np.array(jax.devices()[:n_dev]).reshape(dims)
    return Mesh(devices, names)


def pipeline_stage_executable(stage_fns, mesh, *, stage_axis: str = "stage",
                              n_microbatches: int,
                              carry_shape_dtype):
    """GPipe-style pipeline parallelism (PP) over *stage_axis*: device ``s``
    of the stage ring owns ``stage_fns[s]`` and microbatches flow through
    the ring via ``ppermute`` (neighbor hops on the mesh), with the
    standard ``S - 1``-tick fill/drain bubble.

    ``stage_fns[s] (microbatch_inputs, carry) -> carry`` must all return
    the ``carry_shape_dtype``-shaped activation (a
    ``jax.ShapeDtypeStruct``).  *Inputs* to the returned function form a
    pytree whose leaves carry a leading ``n_microbatches`` axis; every
    stage receives the current microbatch's slice (replicated inputs — PP
    shards COMPUTE, an outer DP/TP mesh shards data; compose via a 2-axis
    mesh and the other executables in this module).

    Returns ``fn(inputs) -> (n_microbatches, *carry_shape)`` — the final
    stage's activations, replicated across the ring.

    This is the multi-chip analog of the reference's multi-kernel operator
    chains (SURVEY §2.4 stretch): each schedule stage (e.g. wave RHS =
    div -> mass+axpy) lives on its own device group and the element
    stream is microbatched through them."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    n_stages = mesh.shape[stage_axis]
    if len(stage_fns) != n_stages:
        raise ValueError(
            f"{len(stage_fns)} stage fns for a {n_stages}-stage mesh axis")
    perm = [(i, i + 1) for i in range(n_stages - 1)]
    n_ticks = n_microbatches + n_stages - 1
    carry0 = jnp.zeros(carry_shape_dtype.shape, carry_shape_dtype.dtype)

    def ring(inputs):
        s = jax.lax.axis_index(stage_axis)
        is_last = s == n_stages - 1
        outs0 = jnp.zeros((n_microbatches,) + carry0.shape, carry0.dtype)
        # the loop carries become device-varying after the first ppermute;
        # mark the unvarying zero inits so fori_loop's carry types match
        init = jax.tree_util.tree_map(
            lambda a: jax.lax.pcast(a, (stage_axis,), to="varying"),
            (carry0, outs0))

        def tick(t, state):
            carry, outs = state
            m = t - s
            valid = (m >= 0) & (m < n_microbatches)
            m_c = jnp.clip(m, 0, n_microbatches - 1)
            chunk = jax.tree_util.tree_map(
                lambda a: jax.lax.dynamic_index_in_dim(a, m_c, 0,
                                                       keepdims=False),
                inputs)
            new = jax.lax.switch(s, list(stage_fns), chunk, carry)
            new = jnp.where(valid, new, jnp.zeros_like(new))
            outs = jax.lax.dynamic_update_index_in_dim(
                outs, jnp.where(valid & is_last, new, outs[m_c]), m_c, 0)
            # hand the activation to the next stage (ring hop);
            # stage 0 receives zeros, which it never reads
            carry = jax.lax.ppermute(new, stage_axis, perm) \
                if perm else new
            return carry, outs

        _, outs = jax.lax.fori_loop(0, n_ticks, tick, init)
        # only the last stage holds real outputs; psum replicates them
        outs = jnp.where(is_last, outs, jnp.zeros_like(outs))
        return jax.lax.psum(outs, stage_axis)

    def fn(inputs):
        sharded = shard_map(
            ring, mesh=mesh,
            in_specs=(jax.tree_util.tree_map(lambda _: P(), inputs),),
            out_specs=P())
        return sharded(inputs)

    return jax.jit(fn)
