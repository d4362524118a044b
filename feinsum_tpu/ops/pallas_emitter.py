"""
Pallas emitter: lower an :class:`EinsumProgram` to one fused GPU kernel,
compiled through Triton.

Design (after the reference's DG recipes, SURVEY.md §81):

* The parametric "long" axis (DG element axis; reference Def. S in
  doc/design.rst) is cut into blocks of ``block_long`` elements, one
  program per block on a 1-D parallel grid — the reference's split of the
  element axis across work-groups.  Programs are independent: nothing is
  carried from one block to the next.
* Operands without the long axis (the small reference matrices) are loaded
  whole by every program — the reference's LOCAL-memory prefetch of ``D``
  (e.g. tuning/impls/xre_rij_xej_to_ei_v4.py steps 4-6).
* ALL schedule steps are evaluated inside the kernel on the current block:
  multi-step (hoisted) schedules never materialize intermediates in HBM —
  where the reference writes GLOBAL temporaries (codegen/loopy.py:263-273),
  we hold them on chip.  This is the main HBM-traffic win over XLA, which
  writes every step's intermediate to HBM.
* Small axes are padded in-kernel to the next power of two (at least 16)
  by masked loads whose padding is 0; nothing is padded in HBM.
* If the long axis is *contracted*, each program writes its block's
  partial result and XLA sums the partials.
* Steps lower to 2D ``dot``s with f32 accumulation, broadcasts and sums
  (see :mod:`~feinsum_tpu.ops.kernel_lowering`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..diagnostics import InvalidParameterError
from ..einsum import SizeParam
from .kernel_lowering import padded_length


def interpret_mode(desc) -> bool:
    """Whether Pallas runs in the interpreter: when the descriptor asks for
    it or the default backend is the CPU.  On a GPU the kernel is compiled
    through Triton; any other platform has no route."""
    import jax

    if desc.interpret:
        return True
    platform = jax.devices()[0].platform
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise RuntimeError(f"the pallas backend has no route for {platform!r}")


def _pick_grid_index(program, index_to_length) -> Optional[str]:
    """The axis to grid over: descriptor override, else the unique SizeParam
    axis, else the longest axis; None if nothing is long enough to block."""
    desc = program.descriptor
    e = program.einsum
    if desc.grid_index is not None:
        return desc.grid_index
    params = [ix for ix, ln in e.index_to_dim_length.items()
              if isinstance(ln, SizeParam)]
    if len(params) == 1:
        return params[0]
    if len(params) > 1:
        # prefer a parametric *output* axis (independent blocks)
        out_params = [ix for ix in e.out_idx_set if ix in params]
        return (out_params or params)[0]
    # fully concrete einsum: grid over the longest free axis if it's big
    candidates = sorted(e.out_idx_set,
                        key=lambda ix: -index_to_length[ix])
    if candidates and index_to_length[candidates[0]] >= 2 * 1024:
        return candidates[0]
    return None


def _arg_index_sets(einsum) -> dict:
    out = {}
    for row in einsum.args:
        for arg, idx_set in zip(row, einsum.in_idx_sets):
            out[arg.name] = idx_set
    return out


def block_tile(block_long: int, length: int) -> int:
    """In-kernel element-block extent: ``block_long`` capped by the axis
    length, rounded up to a power of two (at least 16)."""
    return padded_length(min(int(block_long), int(length)))


def estimate_block_smem_bytes(einsum, block_long: int,
                              index_to_length: dict) -> int:
    """On-chip bytes one program stages for its largest ``dot``: the
    largest streamed (element-block x padded dof) tile plus the largest
    resident tile, both f32-or-wider as stored.  Triton stages both
    operands of a ``dot`` in shared memory, so this is what must fit the
    card's per-block limit (the analog of the reference impls'
    shared-memory guards, e.g. cogent.py:16-18)."""
    params = [ix for ix, ln in einsum.index_to_dim_length.items()
              if isinstance(ln, SizeParam)]
    grid_ix = params[0] if params else None
    streamed, resident = 0, 0
    for name, idx_set in _arg_index_sets(einsum).items():
        itemsize = einsum.arg_to_dtype[name].itemsize
        others = [padded_length(int(index_to_length[ix]))
                  for ix in idx_set if ix != grid_ix]
        widest = max(others, default=1)
        if grid_ix in idx_set:
            streamed = max(streamed, block_tile(
                block_long, index_to_length[grid_ix]) * widest * itemsize)
        else:
            second = sorted(others)[-2] if len(others) >= 2 else 1
            resident = max(resident, widest * second * itemsize)
    return streamed + resident


def _dot_precision(desc, eff_dtype, interpret: bool):
    """In-kernel ``dot`` precision.  f32 defaults to ``"bf16_3x"``, the
    3-pass split-bf16 product on the tensor cores (about 2^-16 relative
    per product; it meets the 1e-5*max|ref| f32 oracle on the DG classes,
    measured on the card); ``"tf32_3x"`` is the 3-pass TF32 split (about
    2^-21); ``"highest"`` is IEEE fp32 on the CUDA cores, which Triton
    unrolls into FMA sequences that compile and run slowly for the
    multi-dot DG classes; ``"fastest"`` is single-pass TF32.  The CPU
    interpreter has no split algorithms and runs them at HIGHEST."""
    import jax

    presets = {"tf32_3x": jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3,
               "bf16_3x": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3}
    name = (desc.precision or "default").lower()
    if np.dtype(eff_dtype).itemsize < 4:
        return None
    if name == "default":
        name = "bf16_3x"
    if name in presets:
        return jax.lax.Precision.HIGHEST if interpret else presets[name]
    if name == "highest":
        return jax.lax.Precision.HIGHEST
    if name == "fastest":
        return None
    raise InvalidParameterError(
        f"precision {desc.precision!r} has no pallas lowering")


def _unpreblock(arr, block_long: int, length: int, fold: int):
    """Invert :func:`~feinsum_tpu.ops.layouts.preblock_arrays` for one
    array: (nb, *lead, f, blk_c) -> (*lead, f * c) (folded) or
    (nb, *lead, 8, blk_c) -> (*lead, length)."""
    import jax.numpy as jnp

    from .layouts import preblock_geometry

    B, blk_c, nb = preblock_geometry(block_long, length, fold)
    if fold > 1:
        arr = jnp.moveaxis(arr, 0, -2)                  # (*lead, f, nb, c)
        arr = arr.reshape(arr.shape[:-2] + (nb * blk_c,))
        return arr[..., :length // fold].reshape(arr.shape[:-2] + (-1,))
    arr = jnp.moveaxis(arr, 0, -3)                      # (*lead, nb, 8, c)
    arr = arr.reshape(arr.shape[:-3] + (nb * B,))
    return arr[..., :length]


def build_pallas_executable(program, index_to_length: dict):
    """Compile *program* with the Pallas backend; returns
    ``fn(arrays_by_name) -> tuple`` like the XLA backend."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plt

    from ..codegen.program import output_dtype
    from ..contraction_schedule import EinsumOperand, IntermediateResult
    from .kernel_lowering import default_big, lower_step, rep_from_loader
    from .layouts import (check_foldable, check_preblockable,
                          preblock_names)

    e = program.einsum
    desc = program.descriptor
    lengths = dict(index_to_length)

    if isinstance(desc.grid_index, tuple):
        raise InvalidParameterError(
            "multi-axis grids have no pallas lowering; use the xla backend")
    for dt in e.arg_to_dtype.values():
        if dt.kind == "c" or dt.itemsize > 4:
            raise InvalidParameterError(
                f"{dt} einsums run through the xla backend")

    if not desc.multiple_results_in_one_kernel and e.b > 1:
        # one pallas_call per batch row: rows lose operand-load sharing and
        # cross-row CSE but each kernel is smaller
        subfns = []
        for row in range(e.b):
            sub_e = e.copy(args=(e.args[row],))
            row_names = sub_e.all_args
            sub_desc = desc.copy(
                multiple_results_in_one_kernel=True,
                arg_layouts=tuple((n, p) for n, p in desc.arg_layouts
                                  if n in row_names),
                preblock_args=tuple(n for n in desc.preblock_args
                                    if n in row_names))
            subfns.append(build_pallas_executable(
                program.copy(einsum=sub_e, descriptor=sub_desc),
                index_to_length))

        def split_fn(arrays_by_name: dict):
            outs = []
            for sf in subfns:
                outs.extend(sf(arrays_by_name))
            return tuple(outs)

        return jax.jit(split_fn)

    grid_ix = _pick_grid_index(program, lengths)
    arg_idx = _arg_index_sets(e)
    layouts = desc.arg_layouts_map

    # fold_long stores the long axis (f, E/f) trailing: a free reshape of
    # the dof-major buffer, undone around the kernel
    fold = desc.fold_long or 1
    if fold > 1:
        fold_ix = check_foldable(program)
        if grid_ix is None or fold_ix != grid_ix:
            raise InvalidParameterError(
                f"fold_long targets axis {fold_ix!r} but the grid is over"
                f" {grid_ix!r}")
        if lengths[grid_ix] % fold:
            raise InvalidParameterError(
                f"fold_long={fold} requires the long axis"
                f" ({lengths[grid_ix]}) to be divisible by it")

    pb_names = set(preblock_names(program))
    if pb_names:
        check_preblockable(program)

    # stored subscript per arg after layout permutation
    stored_idx = {}
    for name, idx_set in arg_idx.items():
        perm = layouts.get(name)
        stored_idx[name] = (tuple(idx_set[p] for p in perm)
                            if perm is not None else tuple(idx_set))

    if grid_ix is None:
        be, n_blocks, long_len = None, 1, None
    else:
        long_len = int(lengths[grid_ix])
        be = block_tile(desc.block_long, long_len)
        n_blocks = -(-long_len // be)
    mask_e = grid_ix is not None and long_len % be != 0
    long_is_contracted = (grid_ix is not None
                          and grid_ix not in e.out_idx_set)

    padded = {ix: padded_length(int(ln)) for ix, ln in lengths.items()}
    if grid_ix is not None:
        padded[grid_ix] = be

    arg_names = sorted(e.all_args)
    out_dtypes = [output_dtype(e, r) for r in range(e.b)]
    # outputs may be stored in a permuted layout (e.g. dof-major (35, E));
    # callers receive the stored layout
    if desc.out_layout is not None:
        out_idx = tuple(e.out_idx_set[p] for p in desc.out_layout)
    else:
        out_idx = tuple(e.out_idx_set)
    out_full = tuple(int(lengths[ix]) for ix in out_idx)
    lead = (n_blocks,) if long_is_contracted else ()
    out_shapes = [jax.ShapeDtypeStruct(lead + out_full, dt)
                  for dt in out_dtypes]

    n_rows = e.b
    schedule = program.schedule
    accum = jnp.dtype(desc.accum_dtype) if desc.accum_dtype else None
    compute_dtype = (jnp.dtype(desc.compute_dtype)
                     if desc.compute_dtype else None)

    # {{{ resident-only steps (hoist_resident_steps): a step none of whose
    # inputs carries the grid axis (transitively) is evaluated ONCE per
    # launch in XLA and fed to the kernel as a raw resident operand instead
    # of being recomputed by every program

    _steps = list(zip(schedule.subscripts, schedule.result_names,
                      schedule.arguments))
    host_step_set: set = set()
    if desc.hoist_resident_steps and grid_ix is not None:
        _carries: dict = {}
        for subs, name, step_args in _steps:
            carried = False
            for a in step_args:
                if isinstance(a, EinsumOperand):
                    if grid_ix in e.in_idx_sets[a.position]:
                        carried = True
                elif _carries[a.name]:
                    carried = True
            _carries[name] = carried
            if not carried:
                host_step_set.add(name)
        host_step_set.discard(schedule.result_names[-1])
    kernel_steps = [s for s in _steps if s[1] not in host_step_set]
    host_steps = [s for s in _steps if s[1] in host_step_set]

    # per-row plan: which kernel input serves each host result (rows whose
    # host steps read identical operands share one)
    host_slot_of = [dict() for _ in range(n_rows)]   # row -> name -> skey
    host_slots: dict = {}                            # skey -> (letters, slot)
    for row in range(n_rows):
        _env_key: dict = {}
        for subs, name, step_args in host_steps:
            out_sub = subs.replace(" ", "").split("->")[1]
            fkeys = []
            for a in step_args:
                if isinstance(a, EinsumOperand):
                    fkeys.append(("arg", e.args[row][a.position].name))
                else:
                    fkeys.append(_env_key[a.name])
            skey = (subs, tuple(fkeys))
            _env_key[name] = skey
            host_slot_of[row][name] = skey
            if skey not in host_slots:
                host_slots[skey] = (tuple(out_sub),
                                    f"_host{len(host_slots)}")
    host_input_names = [slot for _, slot in host_slots.values()]
    for letters, slot in host_slots.values():
        stored_idx[slot] = letters

    def compute_host_arrays(arrays_by_name) -> list:
        """Evaluate the hoisted steps in XLA at HIGHEST precision."""
        vals: dict = {}
        for row in range(n_rows):
            env: dict = {}      # name -> (letters, value)
            for subs, name, step_args in host_steps:
                ins_sub, out_sub = subs.replace(" ", "").split("->")
                ops = []
                for a, s_ in zip(step_args, ins_sub.split(",")):
                    if isinstance(a, EinsumOperand):
                        arg = e.args[row][a.position]
                        arr = arrays_by_name[arg.name]
                        perm = layouts.get(arg.name)
                        if perm is not None:
                            arr = jnp.transpose(arr,
                                                tuple(np.argsort(perm)))
                        ops.append(arr)
                    else:
                        letters, val = env[a.name]
                        if tuple(s_) != letters:
                            val = jnp.transpose(
                                val, [letters.index(c) for c in s_])
                        ops.append(val)
                skey = host_slot_of[row][name]
                slot = host_slots[skey][1]
                if slot in vals:
                    env[name] = (host_slots[skey][0], vals[slot])
                    continue
                val = jnp.einsum(f"{ins_sub}->{out_sub}", *ops,
                                 precision=jax.lax.Precision.HIGHEST)
                env[name] = (host_slots[skey][0], val)
                vals[slot] = val
        return [vals[slot] for slot in host_input_names]

    # }}}

    interpret = interpret_mode(desc)
    eff_dtype = compute_dtype or max(
        (dt for dt in e.arg_to_dtype.values()), key=lambda d: d.itemsize)
    dot_precision = _dot_precision(desc, eff_dtype, interpret)

    # in-kernel axis lengths: the grid axis shrinks to one block
    lengths_kernel = {ix: int(ln) for ix, ln in lengths.items()}
    if grid_ix is not None:
        lengths_kernel[grid_ix] = be

    all_input_names = list(arg_names) + host_input_names

    def kernel(*refs):
        in_refs = dict(zip(all_input_names, refs[:len(all_input_names)]))
        out_refs = refs[len(all_input_names):]
        e_idx = (pl.program_id(0) * be + jnp.arange(be, dtype=jnp.int32)
                 if grid_ix is not None else None)

        def index(letters, big, combo):
            """(indexer, mask) of one tile: big axes become broadcast index
            vectors (masked past their logical length), small axes the
            unrolled values in *combo*."""
            idx, masks = [], []
            for l in letters:
                if l not in big:
                    idx.append(combo[l])
                    continue
                if l == grid_ix:
                    vec = e_idx
                    m = (e_idx < long_len) if mask_e else None
                else:
                    vec = jnp.arange(padded[l], dtype=jnp.int32)
                    m = (vec < lengths[l]) if padded[l] != lengths[l] \
                        else None
                if len(big) == 2:
                    pos = big.index(l)
                    vec = vec[:, None] if pos == 0 else vec[None, :]
                    if m is not None:
                        m = m[:, None] if pos == 0 else m[None, :]
                idx.append(vec)
                if m is not None:
                    masks.append(m)
            mask = None
            for m in masks:
                mask = m if mask is None else mask & m
            return tuple(idx), mask

        def loader(name):
            ref = in_refs[name]
            letters = stored_idx[name]

            def load_piece(big, combo):
                idx, mask = index(letters, big, combo)
                view = ref.at[idx] if idx else ref
                if mask is None:
                    val = plt.load(view)
                else:
                    val = plt.load(view, mask=mask, other=0)
                if compute_dtype is not None:
                    val = val.astype(compute_dtype)
                return val
            return load_piece

        rep_cache: dict = {}
        step_cache: dict = {}

        def raw_rep(name):
            if name not in rep_cache:
                letters = stored_idx[name]
                rep_cache[name] = rep_from_loader(
                    letters, default_big(letters, grid_ix), lengths_kernel,
                    loader(name))
            return rep_cache[name]

        for row in range(n_rows):
            env, env_key = {}, {}
            res = None
            for subs, name, step_args in kernel_steps:
                ins_sub, out_sub = subs.replace(" ", "").split("->")
                factors, factor_keys = [], []
                for a, s in zip(step_args, ins_sub.split(",")):
                    if isinstance(a, EinsumOperand):
                        arg = e.args[row][a.position]
                        use_letters = e.in_idx_sets[a.position]
                        rep = raw_rep(arg.name)
                        # step letters may differ from einsum letters
                        trans = dict(zip(use_letters, s))
                        if any(trans[l] != l for l in use_letters):
                            rep = rep.rename(trans)
                        factors.append(rep)
                        factor_keys.append(("arg", arg.name, s))
                    else:
                        assert isinstance(a, IntermediateResult)
                        if a.name not in env and \
                                a.name in host_slot_of[row]:
                            letters, slot = host_slots[
                                host_slot_of[row][a.name]]
                            env[a.name] = raw_rep(slot)
                            env_key[a.name] = ("host", slot)
                        factors.append(env[a.name])
                        factor_keys.append(env_key[a.name])
                # cross-row CSE (the hoist_cses analog, reference
                # cse.py:307): identical steps over identical operands
                # compute once per block
                skey = (subs, tuple(factor_keys))
                if skey not in step_cache:
                    step_cache[skey] = lower_step(
                        factors, tuple(out_sub), grid_ix, lengths_kernel,
                        padded, accum_dtype=accum, big_order_pref=out_idx,
                        dot_precision=dot_precision)
                env[name] = step_cache[skey]
                env_key[name] = skey
                res = env[name]

            ref = out_refs[row]
            for key, val in res.data.items():
                combo = dict(zip(res.small, key))
                big = tuple(l for l in out_idx if l in res.big)
                if len(res.big) == 2 and tuple(res.big) != big:
                    val = val.swapaxes(0, 1)
                idx, mask = index(out_idx, big, combo)
                if long_is_contracted:
                    idx = (pl.program_id(0),) + idx
                plt.store(ref.at[idx], val.astype(out_dtypes[row]),
                          mask=mask)

    call = pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        out_shape=tuple(out_shapes),
        interpret=interpret,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=desc.num_warps,
                                           num_stages=desc.num_stages),
        name=f"feinsum_{'_'.join(out_idx) or 'scalar'}",
    )

    def to_kernel_layout(name, arr):
        """Undo the pre-blocked / folded storage contracts (a copy and a
        free view respectively) so the kernel sees (..., E)."""
        if name in pb_names:
            return _unpreblock(arr, desc.block_long, long_len, fold)
        if fold > 1 and grid_ix in stored_idx[name]:
            return arr.reshape(arr.shape[:-2] + (-1,))
        return arr

    def fn(arrays_by_name: dict):
        host_arrays = (compute_host_arrays(arrays_by_name)
                       if host_steps else [])
        outs = call(*[to_kernel_layout(name, arrays_by_name[name])
                      for name in arg_names], *host_arrays)
        if long_is_contracted:
            outs = tuple(jnp.sum(o, axis=0, dtype=o.dtype) for o in outs)
        if fold > 1 and grid_ix in out_idx:
            outs = tuple(o.reshape(o.shape[:-1] + (fold, -1)) for o in outs)
        return tuple(outs)

    return jax.jit(fn)
