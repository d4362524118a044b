"""
Storage layouts of streamed operands, and their inverses.

``dofmajor_layouts`` computes the argument and output permutations that
rotate every parametric (long) axis to the back, so that one block of
elements is a contiguous run of every dof row; ``fold_long`` and
``preblock_args`` are further storage contracts kept for archived schedules
(see :class:`~feinsum_tpu.codegen.descriptor.ScheduleDescriptor`).
"""

from __future__ import annotations

from ..diagnostics import InvalidParameterError
from ..einsum import BatchedEinsum, SizeParam


def dofmajor_layouts(einsum: BatchedEinsum):
    """(arg_layouts, out_layout) rotating long axes to the trailing (lane)
    position for every operand/output that carries one."""
    arg_idx = {}
    for row in einsum.args:
        for arg, idx_set in zip(row, einsum.in_idx_sets):
            arg_idx[arg.name] = idx_set
    long_letters = {ix for ix, ln in einsum.index_to_dim_length.items()
                    if isinstance(ln, SizeParam)}

    def rotate(idx_set):
        perm = [i for i, ix in enumerate(idx_set) if ix not in long_letters]
        perm += [i for i, ix in enumerate(idx_set) if ix in long_letters]
        return tuple(perm)

    layouts = []
    for name, idx_set in arg_idx.items():
        if (set(idx_set) & long_letters) and idx_set \
                and idx_set[-1] not in long_letters:
            layouts.append((name, rotate(idx_set)))
        elif not (set(idx_set) & long_letters) and len(idx_set) > 2:
            # resident (non-streamed) operands: keep the two largest axes
            # trailing so they stay tensor dims in the kernel and tiny axes
            # unroll
            # (e.g. the face-lift matrix (i,f,j) -> (f,i,j))
            sizes = {ix: int(einsum.index_to_dim_length[ix])
                     for ix in idx_set}
            biggest = sorted(range(len(idx_set)),
                             key=lambda p: sizes[idx_set[p]])[-2:]
            big_sorted = sorted(biggest)      # keep relative order
            perm = tuple([p for p in range(len(idx_set))
                          if p not in biggest] + big_sorted)
            if perm != tuple(range(len(idx_set))):
                layouts.append((name, perm))
    out = tuple(einsum.out_idx_set)
    out_perm = None
    if out and out[-1] not in long_letters and (set(out) & long_letters):
        out_perm = rotate(out)
    return tuple(layouts), out_perm


def apply_nested_layout(arr, nested):
    """Apply a grouped storage layout: *nested* is a tuple of tuples of
    source-axis positions; the stored array is ``arr.transpose(flat_perm)``
    reshaped to one (merged) axis per group.  Works on numpy and jax arrays.

    This is the host-side half of ``descriptor.pre_layouts`` — the
    fused-storage contract that keeps high-rank small-dim tensors in
    GEMM-natural 2D form."""
    flat = tuple(int(p) for g in nested for p in g)
    if sorted(flat) != list(range(arr.ndim)):
        raise ValueError(
            f"nested layout {nested!r} is not a grouping of {arr.ndim} axes")
    arr = arr.transpose(flat)
    shape = []
    k = 0
    for g in nested:
        n = 1
        for _ in g:
            n *= arr.shape[k]
            k += 1
        shape.append(n)
    return arr.reshape(tuple(shape))


# {{{ folded long axis (descriptor.fold_long)

def fold_axis_of(program):
    """The long axis letter that ``descriptor.fold_long`` folds, or ``None``
    when folding is off.  Folding targets the grid axis; it must be the
    descriptor's ``grid_index`` or the unique parametric axis."""
    desc = program.descriptor
    f = getattr(desc, "fold_long", 1) or 1
    if f <= 1:
        return None
    if desc.grid_index is not None:
        return desc.grid_index
    params = [ix for ix, ln in program.einsum.index_to_dim_length.items()
              if isinstance(ln, SizeParam)]
    if len(params) != 1:
        raise InvalidParameterError(
            "fold_long requires grid_index or exactly one parametric axis,"
            f" found {params}")
    return params[0]


def stored_arg_layouts(program) -> dict:
    """arg name -> stored (post arg_layouts permutation) index letters."""
    e = program.einsum
    layouts = program.descriptor.arg_layouts_map
    out = {}
    for row in e.args:
        for arg, idx_set in zip(row, e.in_idx_sets):
            perm = layouts.get(arg.name)
            out[arg.name] = (tuple(idx_set[p] for p in perm)
                             if perm is not None else tuple(idx_set))
    return out


def check_foldable(program) -> str:
    """Validate that fold_long can apply; returns the folded axis letter.
    Every operand and output carrying the axis must store it trailing
    (dof-major), so the fold is a free view of the buffer."""
    fold_ix = fold_axis_of(program)
    assert fold_ix is not None
    for name, stored in stored_arg_layouts(program).items():
        if fold_ix in stored and stored[-1] != fold_ix:
            raise InvalidParameterError(
                f"fold_long requires the long axis {fold_ix!r} stored"
                f" trailing on {name!r} (stored layout {stored}); use"
                " dof-major arg_layouts")
    e = program.einsum
    out_idx = (tuple(e.out_idx_set[p] for p in program.descriptor.out_layout)
               if program.descriptor.out_layout is not None
               else tuple(e.out_idx_set))
    if fold_ix in out_idx and out_idx[-1] != fold_ix:
        raise InvalidParameterError(
            f"fold_long requires the long axis {fold_ix!r} stored trailing"
            f" on the output (stored layout {out_idx})")
    return fold_ix


def preblock_names(program) -> tuple:
    pb = getattr(program.descriptor, "preblock_args", ()) or ()
    return tuple(pb)


def preblock_small_args(einsum, *, max_rows: int = 16) -> tuple:
    """Arg names the ``preblock`` knob applies to: they carry the (unique)
    long axis and their non-long dims multiply to <= *max_rows* rows that
    are not a multiple of 8 (DG Jacobians (3,E)/(3,3,E), mass jacobians
    (E,), face flux factors (4,E)); big operands (u (35,E)) never
    qualify."""
    long_letters = {ix for ix, ln in einsum.index_to_dim_length.items()
                    if isinstance(ln, SizeParam)}
    names = []
    for row in einsum.args:
        for arg, idx_set in zip(row, einsum.in_idx_sets):
            if arg.name in names or not (set(idx_set) & long_letters):
                continue
            rows = 1
            for ix in idx_set:
                if ix not in long_letters:
                    rows *= int(einsum.index_to_dim_length[ix])
            if rows <= max_rows and rows % 8:
                names.append(arg.name)
    return tuple(names)


PREBLOCK_F = 8


def preblock_geometry(block_long: int, length: int, fold: int = 1):
    """(B, blk_c, nb) for pre-blocked storage of a long axis of *length*:
    B = elements per block, blk_c = lanes per block, nb = number of blocks.
    Must agree between the host packer and the emitter's unpacking."""
    if fold > 1:
        c_len = length // fold
        blk_c = min(max(block_long // fold, 1), c_len)
        return blk_c * fold, blk_c, -(-c_len // blk_c)
    if block_long % PREBLOCK_F:
        raise InvalidParameterError(
            f"preblock_args requires block_long ({block_long}) divisible"
            f" by {PREBLOCK_F}")
    B = min(block_long, -(-length // PREBLOCK_F) * PREBLOCK_F)
    return B, B // PREBLOCK_F, -(-length // B)


def preblock_arrays(program, arrays: dict) -> dict:
    """Repack the descriptor's ``preblock_args`` into pre-blocked
    storage.  Arrays must already be permuted (arg_layouts) and folded
    (fold_arrays); the long/c axis is trailing.  Zero-pads the tail so the
    final block is exact (zero factors keep contracted-grid sums exact)."""
    import numpy as np

    names = preblock_names(program)
    if not names:
        return arrays
    check_preblockable(program)
    desc = program.descriptor
    fold = getattr(desc, "fold_long", 1) or 1
    out = dict(arrays)
    for name in names:
        arr = out[name]
        length = arr.shape[-1] * (fold if fold > 1 else 1)
        B, blk_c, nb = preblock_geometry(desc.block_long, length, fold)
        if isinstance(arr, np.ndarray):
            xp = np
        else:
            import jax.numpy as xp
        c_stored = arr.shape[-1]
        pad = nb * blk_c - c_stored if fold > 1 else nb * B - c_stored
        if pad:
            widths = [(0, 0)] * (arr.ndim - 1) + [(0, pad)]
            arr = xp.pad(arr, widths)
        if fold > 1:
            # (*lead, f, c) -> (*lead, f, nb, blk_c) -> (nb, *lead, f, blk_c)
            arr = arr.reshape(arr.shape[:-1] + (nb, blk_c))
            arr = xp.moveaxis(arr, -2, 0)
        else:
            # (*lead, L) -> (*lead, nb, 8, blk_c) -> (nb, *lead, 8, blk_c)
            arr = arr.reshape(arr.shape[:-1] + (nb, PREBLOCK_F, blk_c))
            arr = xp.moveaxis(arr, -3, 0)
        out[name] = arr
    return out


def check_preblockable(program) -> str:
    """Validate descriptor.preblock_args; returns the long axis letter.
    Each named arg must exist and store the long axis trailing."""
    from .pallas_emitter import _pick_grid_index
    from ..codegen.program import get_index_lengths

    e = program.einsum
    lengths = get_index_lengths(e, 100_000)
    grid_ix = _pick_grid_index(program, lengths)
    if grid_ix is None:
        raise InvalidParameterError(
            "preblock_args requires a long (grid) axis")
    stored = stored_arg_layouts(program)
    for name in preblock_names(program):
        if name not in stored:
            raise InvalidParameterError(
                f"preblock_args names unknown arg {name!r}")
        if grid_ix not in stored[name] or stored[name][-1] != grid_ix:
            raise InvalidParameterError(
                f"preblock_args requires the long axis {grid_ix!r} stored"
                f" trailing on {name!r} (stored layout {stored[name]})")
    return grid_ix


def fold_arrays(program, arrays: dict) -> dict:
    """Reshape every stored-trailing-long operand (..., E) -> (..., f, E/f).
    Arrays must already be in their arg_layouts permutation."""
    fold_ix = fold_axis_of(program)
    if fold_ix is None:
        return arrays
    check_foldable(program)
    f = program.descriptor.fold_long
    stored = stored_arg_layouts(program)
    out = dict(arrays)
    for name, idx in stored.items():
        if fold_ix in idx:
            arr = out[name]
            length = arr.shape[-1]
            if length % f:
                raise InvalidParameterError(
                    f"fold_long={f} requires the long axis length ({length})"
                    " to be divisible by it")
            out[name] = arr.reshape(arr.shape[:-1] + (f, length // f))
    return out

# }}}


def unpack_output(program, arr, logical_shape):
    """Invert the descriptor's output storage contract: stored row output
    ``arr`` -> the logical einsum output of shape *logical_shape*.

    The forward chain (see measure.validate_batched_einsum_transform) is
    pre_out_layout -> lane_pack -> out_layout -> fold_long -> dd pairs;
    this applies the inverses in reverse order.  Works on numpy and jax
    arrays (reshapes/transposes only)."""
    import numpy as np

    desc = program.descriptor
    if isinstance(arr, np.ndarray):
        xp = np
    else:
        import jax.numpy as xp
    if getattr(desc, "dd_pairs", False):
        arr = arr[0].astype("float64") + arr[1].astype("float64")
    fold = getattr(desc, "fold_long", 1) or 1
    lane_g = getattr(desc, "lane_pack", 1) or 1
    # how many axes the stored (post-contract, pre-fold) output has
    n_stored = len(logical_shape)
    if desc.pre_out_layout is not None:
        n_stored = len(desc.pre_out_layout)
    elif lane_g > 1:
        # packed outputs keep the logical rank (long axis second-to-last,
        # packed dof axis last), except the 1D vecmat variant which stores
        # (E/g, g)
        n_stored = max(len(logical_shape), 2)
    if fold > 1 and arr.ndim == n_stored + 1:
        arr = xp.reshape(arr, arr.shape[:-2] + (-1,))
    if desc.out_layout is not None:
        inv = np.argsort(desc.out_layout)
        arr = xp.transpose(arr, tuple(int(i) for i in inv))
    if lane_g > 1:
        # (lead..., E/g, g*d) -> (lead..., E, d): split the packed lanes
        # and merge g into the adjacent long axis (both free views of the
        # row-major buffer)
        arr = xp.reshape(arr, arr.shape[:-2] + (arr.shape[-2] * lane_g,
                                                arr.shape[-1] // lane_g))
        if arr.shape[-1] == 1 and len(logical_shape) == 1:
            arr = xp.reshape(arr, (-1,))
    if desc.pre_out_layout is not None:
        nested = desc.pre_out_layout
        flat = [int(p) for g_ in nested for p in g_]
        split = []
        for g_ in nested:
            split.extend(int(logical_shape[p]) for p in g_)
        arr = xp.reshape(arr, tuple(split))
        arr = xp.transpose(arr, tuple(int(i)
                                      for i in np.argsort(flat)))
    if tuple(arr.shape) != tuple(logical_shape):
        raise ValueError(
            f"unpack_output: inverted stored shape {tuple(arr.shape)} does"
            f" not match the logical output {tuple(logical_shape)}")
    return arr
