"""Shared helpers for the schedule-space library."""

from __future__ import annotations

from feinsum_tpu.codegen.program import get_index_lengths
from feinsum_tpu.contraction_schedule import (
    get_opt_einsum_contraction_schedule,
    get_trivial_contraction_schedule,
)
from feinsum_tpu.diagnostics import InvalidParameterError
from feinsum_tpu.einsum import SizeParam


def has_resident_private_indices(einsum) -> bool:
    """True iff some resident (no-long-axis) operand carries indices private
    to it (reducible ahead of the main contraction — the prereduce knob's
    applicability condition; see :func:`prereduce_resident_private`)."""
    e = einsum
    for p in range(e.n):
        sub = e.in_idx_sets[p]
        if any(isinstance(e.index_to_dim_length[ix], SizeParam)
               for ix in sub):
            continue
        elsewhere = set(e.out_idx_set)
        for q in range(e.n):
            if q != p:
                elsewhere |= set(e.in_idx_sets[q])
        if any(ix not in elsewhere for ix in sub):
            return True
    return False


def jfold_applicable(einsum) -> bool:
    """jfold needs >= 2 streamed operands (to form the outer product) and
    >= 1 resident operand (to contract against)."""
    e = einsum
    n_long = sum(
        1 for s in e.in_idx_sets
        if any(isinstance(e.index_to_dim_length[ix], SizeParam) for ix in s))
    return 2 <= n_long < e.n


def long_axis_of(einsum) -> str:
    params = [ix for ix, ln in einsum.index_to_dim_length.items()
              if isinstance(ln, SizeParam)]
    if len(params) != 1:
        raise InvalidParameterError(
            f"schedule space expects exactly one parametric axis, found"
            f" {params}")
    return params[0]


def guard_smem(einsum, block_long: int, *,
               long_dim_length: int = 100_000) -> None:
    """Reject blocks whose largest ``dot`` stages more shared memory than
    one thread block may use (the analog of the reference impls'
    shared-memory guards, e.g. cogent.py:16-18): such a point would fail
    to compile, so it is refused host-side instead."""
    from feinsum_tpu.data.device_info import SMEM_BYTES_PER_BLOCK
    from feinsum_tpu.ops.pallas_emitter import estimate_block_smem_bytes
    lengths = get_index_lengths(einsum, long_dim_length)
    need = estimate_block_smem_bytes(einsum, block_long, lengths)
    if need > SMEM_BYTES_PER_BLOCK:
        raise InvalidParameterError(
            f"block_long={block_long} stages ~{need >> 10} KiB of shared"
            f" memory (> {SMEM_BYTES_PER_BLOCK >> 10} KiB per block)")


def prereduce_resident_private(einsum, schedule):
    """Prefix *schedule* with steps reducing each resident (no-long-axis)
    operand over indices private to it (appearing in no other operand nor
    the output), and rewrite later steps to consume the reduced
    intermediates.  E.g. curl's D (r,i,j) with r private becomes
    'rij->ij', turning the per-element contraction into a plain mass shape
    (one dot instead of an unrolled sum of three)."""
    from feinsum_tpu.contraction_schedule import (
        ContractionSchedule, EinsumOperand, IntermediateResult)
    from feinsum_tpu.einsum import SizeParam

    e = einsum
    pre_subs, pre_names, pre_args = [], [], []
    replace = {}
    for p in range(e.n):
        sub = e.in_idx_sets[p]
        if any(isinstance(e.index_to_dim_length[ix], SizeParam)
               for ix in sub):
            continue
        elsewhere = set(e.out_idx_set)
        for q in range(e.n):
            if q != p:
                elsewhere |= set(e.in_idx_sets[q])
        private = [ix for ix in sub if ix not in elsewhere]
        if private:
            reduced = "".join(ix for ix in sub if ix not in private)
            name = f"_fe_pre_{p}"
            pre_subs.append(f"{''.join(sub)}->{reduced}")
            pre_names.append(name)
            pre_args.append((EinsumOperand(p),))
            replace[p] = (name, reduced)
    if not replace:
        return schedule
    new_subs, new_args = [], []
    for subs_, args_ in zip(schedule.subscripts, schedule.arguments):
        ins, out = subs_.split("->")
        ins = ins.split(",")
        ins2, args2 = [], []
        for s_, a_ in zip(ins, args_):
            if isinstance(a_, EinsumOperand) and a_.position in replace:
                name, reduced = replace[a_.position]
                ins2.append(reduced)
                args2.append(IntermediateResult(name))
            else:
                ins2.append(s_)
                args2.append(a_)
        new_subs.append(f"{','.join(ins2)}->{out}")
        new_args.append(tuple(args2))
    return ContractionSchedule(
        subscripts=tuple(pre_subs) + tuple(new_subs),
        result_names=tuple(pre_names) + schedule.result_names,
        arguments=tuple(pre_args) + tuple(new_args))


def resolve_block(log2_block: int, blkc128: int = 0) -> int:
    """Block size from the space params: ``2**log2_block``.  Archived rows
    may carry ``blkc128 > 0``, a block of ``1024 * blkc128`` elements."""
    return 1024 * int(blkc128) if blkc128 else 2 ** int(log2_block)


def fused_pallas_program(program, *, block_long: int, hoist: bool,
                         dofmajor: bool = False, fold: bool = False,
                         preblock: bool = False, precision_3x: bool = False,
                         jfold: bool = False, prereduce: bool = False,
                         split_rows: bool = False, accum_f32: bool = False,
                         host_hoist: bool = True, keep_schedule: bool = False,
                         num_warps: int = 4, num_stages: int = 2,
                         **desc) -> object:
    """The core schedule of the DG family: (optionally) multi-step hoisted
    contraction, fully fused in one kernel, gridded over the long axis;
    *dofmajor* rotates long axes to the trailing (contiguous) position;
    *fold* additionally stores the long axis as (8, E/8) (a free view)."""
    e = program.einsum
    guard_smem(e, block_long)
    if keep_schedule:
        # the program carries a rewrite-built schedule (lane_pack DG
        # variant); the schedule-selection knobs were rejected upstream
        schedule = program.schedule
    elif jfold:
        # outer-product-first schedule: multiply the streamed operands into
        # one intermediate (e.g. div's tmp[e,s,j] = J[e,s]*u[e,j]), then a
        # single contraction against the resident matrix.  Resident
        # operands are first reduced over indices private to them
        # (curl's Sum_r D_rij -> a plain mass-matrix shape) so no step ever
        # materializes a resident-x-streamed outer product — the trap that
        # opt_einsum's literal pairwise path falls into on the curl class
        # (it picks 'rij,e->ije', a (ndof,ndof,E) intermediate).
        from feinsum_tpu.algebraic import (
            extract_multiplicative_terms_in_sum_reduction_as_subst,
        )
        from feinsum_tpu.codegen.program import generate_program

        long_pos = [i for i, s_ in enumerate(e.in_idx_sets)
                    if any(isinstance(e.index_to_dim_length[ix], SizeParam)
                           for ix in s_)]
        if len(long_pos) < 2 or len(long_pos) >= e.n:
            raise InvalidParameterError(
                "jfold needs >=2 streamed operands and >=1 resident operand")
        schedule = prereduce_resident_private(
            e, extract_multiplicative_terms_in_sum_reduction_as_subst(
                generate_program(e), long_pos).schedule)
    elif hoist:
        schedule = get_opt_einsum_contraction_schedule(e)
    else:
        schedule = get_trivial_contraction_schedule(e)
    if prereduce and not jfold and not keep_schedule:
        # resident-private pre-reduction on the plain schedules too (the
        # curl class: 'rij->ij' turns 3 unrolled r-dots into one mass dot)
        reduced = prereduce_resident_private(e, schedule)
        if reduced is schedule:
            raise InvalidParameterError(
                "prereduce: no resident operand has private contracted"
                " indices")
        schedule = reduced
    if dofmajor and "arg_layouts" not in desc:
        from feinsum_tpu.ops.layouts import dofmajor_layouts
        layouts, out_perm = dofmajor_layouts(e)
        desc["arg_layouts"] = layouts
        desc["out_layout"] = out_perm
    if fold:
        if not dofmajor:
            raise InvalidParameterError(
                "fold requires dofmajor (the long axis must be stored"
                " trailing)")
        desc["fold_long"] = 8
    if preblock:
        from feinsum_tpu.ops.layouts import preblock_small_args
        if not dofmajor:
            raise InvalidParameterError(
                "preblock requires dofmajor (the long axis must be stored"
                " trailing)")
        names = preblock_small_args(e)
        if not names:
            raise InvalidParameterError(
                "no argument qualifies for preblock (all streamed operands"
                " have >= 16 or 8-divisible rows)")
        desc["preblock_args"] = names
    if precision_3x:
        desc["precision"] = "tf32_3x"
    if split_rows:
        if program.einsum.b <= 1:
            raise InvalidParameterError(
                "split_rows needs a multi-row batched einsum")
        desc["multiple_results_in_one_kernel"] = False
    if accum_f32:
        if all(dt.itemsize >= 4
               for dt in program.einsum.arg_to_dtype.values()):
            raise InvalidParameterError(
                "accum_f32 only applies to sub-32-bit input dtypes")
        desc["accum_dtype"] = "float32"
    if not host_hoist:
        desc["hoist_resident_steps"] = False
    return program.copy(schedule=schedule).with_descriptor(
        backend="pallas", block_long=block_long, num_warps=num_warps,
        num_stages=num_stages, **desc)


def default_pallas_program(program, *, block_long: int = 128):
    """The built-in Pallas schedule for the DG family, used where the
    archive has no fact: dof-major storage, the default (3-pass split) dot
    precision, and the opt_einsum schedule — or, when a resident operand
    carries indices private to it (curl's D over r), the jfold schedule
    that pre-reduces them in XLA (opt_einsum would pick a
    resident x streamed outer product there)."""
    e = program.einsum
    jfold = has_resident_private_indices(e) and jfold_applicable(e)
    return fused_pallas_program(program, block_long=block_long,
                                hoist=not jfold, jfold=jfold, dofmajor=True)


def make_dg_space(*, log2_block_max: int = 10):
    """ONE definition site for the DG-family schedule space: every family
    module does ``transform = make_dg_space()`` so each knob that wins on
    one family is searchable on all of them; knobs whose applicability
    depends on einsum structure gate themselves (``IntParameter(0, 0)`` =
    pinned off) so the tuner never wastes samples.

    Archive compatibility: knobs of earlier spaces (``blkc128``,
    ``parallel_grid``, ``vmem_idx``, ``mfold``) are still accepted so
    archived rows replay; they no longer change the kernel, and the search
    does not draw them."""
    from feinsum_tpu.tuning import (
        BoolParameter, IntParameter, transform_param)

    def gate(cond):
        return BoolParameter() if cond else IntParameter(0, 0)

    @transform_param("log2_block", lambda e: IntParameter(4, log2_block_max))
    @transform_param("log2_warps", lambda e: IntParameter(2, 3))
    @transform_param("num_stages", lambda e: IntParameter(1, 3))
    @transform_param("dofmajor", lambda e: BoolParameter())
    @transform_param("fold", lambda e: BoolParameter())
    @transform_param("preblock", lambda e: BoolParameter())
    @transform_param("precision_3x", lambda e: BoolParameter())
    @transform_param("hoist", lambda e: BoolParameter())
    @transform_param("jfold", lambda e: gate(jfold_applicable(e)))
    @transform_param("prereduce", lambda e: gate(
        has_resident_private_indices(e)))
    @transform_param("lane_pack_g", lambda e: (
        IntParameter(0, 5) if lane_packable(e)
        or lane_pack_dg_applicable(e) else IntParameter(0, 0)))
    @transform_param("rowcat", lambda e: gate(rowcat_applicable(e)))
    @transform_param("split_rows", lambda e: gate(e.b > 1))
    @transform_param("accum_f32", lambda e: gate(
        any(dt.itemsize < 4 for dt in e.arg_to_dtype.values())))
    @transform_param("host_hoist", lambda e: BoolParameter())
    def transform(program, log2_block, blkc128=0, *, dofmajor,
                  log2_warps=2, num_stages=2, hoist=False, fold=False,
                  preblock=False, precision_3x=False, jfold=False,
                  mfold=False, prereduce=False, lane_pack_g=0,
                  rowcat=False, split_rows=False, accum_f32=False,
                  host_hoist=True, parallel_grid=True, vmem_idx=None):
        del mfold, parallel_grid, vmem_idx     # archived-row knobs
        extras = {}
        if rowcat:
            if split_rows:
                raise InvalidParameterError(
                    "rowcat merges rows; split_rows contradicts it")
            # lane_pack composes with rowcat: rowcat rewrites first (rows
            # concatenated along the long axis), then the packing rewrite
            # applies to the merged single-row program — exactly
            # apply_layouts' storage-contract order; the extras dicts merge
            # (disjoint keys)
            program, ex = rewrite_rowcat(program)
            extras.update(ex)
        keep_schedule = False
        if lane_pack_g:
            if lane_packable(program.einsum):
                program, ex = rewrite_lane_pack(program,
                                                2 ** int(lane_pack_g))
                extras.update(ex)
            else:
                # DG variant fixes its own 3-step schedule; the
                # schedule-shape knobs would silently duplicate configs
                if hoist or jfold or prereduce:
                    raise InvalidParameterError(
                        "lane_pack (DG variant) fixes its own schedule;"
                        " hoist/jfold/prereduce do not compose")
                program, ex = rewrite_lane_pack_dg(
                    program, 2 ** int(lane_pack_g))
                extras.update(ex)
                keep_schedule = True
        p2 = fused_pallas_program(
            program, block_long=resolve_block(log2_block, blkc128),
            hoist=bool(hoist), dofmajor=dofmajor, fold=fold,
            preblock=preblock, precision_3x=precision_3x, jfold=bool(jfold),
            prereduce=bool(prereduce), split_rows=bool(split_rows),
            accum_f32=bool(accum_f32), host_hoist=bool(host_hoist),
            keep_schedule=keep_schedule, num_warps=2 ** int(log2_warps),
            num_stages=int(num_stages))
        if extras:
            p2 = p2.with_descriptor(**extras)
        return p2

    return transform


def lane_packable(einsum):
    """Shape check for the lane-pack rewrite (descriptor.lane_pack): a
    single-row 2-operand matvec-class einsum — streamed operand (e, j) with
    the long axis LEADING, resident 2D operand over {i, j} (both concrete),
    output exactly (e, i).  Returns ``(el, i_letter, j_letter, streamed_name,
    resident_name, resident_idx)`` or ``None``."""
    e = einsum
    if e.b != 1 or e.n != 2:
        return None
    long_letters = [ix for ix, ln in e.index_to_dim_length.items()
                    if isinstance(ln, SizeParam)]
    if len(long_letters) != 1:
        return None
    el = long_letters[0]
    streamed = [p for p, s in enumerate(e.in_idx_sets) if el in s]
    if len(streamed) != 1:
        return None
    sp = streamed[0]
    rp = 1 - sp
    s_idx, r_idx = e.in_idx_sets[sp], e.in_idx_sets[rp]
    if len(s_idx) != 2 or s_idx[0] != el:
        return None
    j = s_idx[1]
    if tuple(e.out_idx_set) == (el,) and tuple(r_idx) == (j,):
        # vecmat variant (ej,j->e): the packed resident becomes
        # kron(I_g, x[:,None]) (g*d, g) and the output packs to (E/g, g)
        return (el, None, j, e.args[0][sp].name, e.args[0][rp].name, (j,))
    if len(e.out_idx_set) != 2 or e.out_idx_set[0] != el:
        return None
    i = e.out_idx_set[1]
    if set(r_idx) != {i, j} or i == j:
        return None
    return (el, i, j, e.args[0][sp].name, e.args[0][rp].name, tuple(r_idx))


def rewrite_lane_pack(program, g: int):
    """Rewrite a matvec-class program for ``lane_pack=g`` (the small-dof
    element-packing answer to the reference's ``n_e_per_wg``,
    tuning/impls/xre_rij_xej_to_ei_v4.py:41-114): the einsum becomes the
    SAME class with d -> g*d and E -> E/g; streamed/output arrays are stored
    packed (free reshapes of the row-major buffers) and the resident matrix
    is kron(I_g, D) (block-diagonal, built in-graph once per launch).  The
    kernel then contracts dense (B, g*d)x(g*d, g*d) tiles.

    Returns ``(rewritten_program, descriptor_extras)``; raises
    :class:`InvalidParameterError` when the shape does not qualify or g
    breaks the storage contract's alignment ((g*d) % 8 == 0)."""
    import feinsum_tpu as f

    e = program.einsum
    info = lane_packable(e)
    if info is None:
        raise InvalidParameterError(
            "lane_pack applies only to matvec-class einsums"
            " (streamed (e,j) x resident (i,j) -> (e,i))")
    el, i, j, s_name, r_name, r_idx = info
    if i is None:
        # vecmat variant: the group axis becomes the (new) output dof axis
        i = next(c for c in "abcdefghijklmnopqrstuvwxyz"
                 if c not in (el, j) and c not in e.arg_to_shape)
        di = 1
        r_idx = (j, i)
    else:
        di = int(e.index_to_dim_length[i])
    dj = int(e.index_to_dim_length[j])
    if (g * di) % 8 or (g * dj) % 8:
        raise InvalidParameterError(
            f"lane_pack={g}: packed dims ({g}*{di}, {g}*{dj}) must be"
            f" 8-aligned")
    if g * max(di, dj) > 4096:
        raise InvalidParameterError(
            f"lane_pack={g}: packed dim {g * max(di, dj)} exceeds the 4096"
            f" resident cap")
    dt = e.arg_to_dtype[s_name].name
    rdt = e.arg_to_dtype[r_name].name
    sizes = {i: g * di, j: g * dj}
    e2 = f.einsum(
        f"{el}{j},{''.join(r_idx)}->{el}{i}",
        f.array(s_name, (f"N{el}_", g * dj), dt),
        f.array(r_name, tuple(sizes[ix] for ix in r_idx), rdt))
    extras = dict(lane_pack=int(g), lane_pack_args=(s_name,),
                  kron_args=(r_name,))
    return program.copy(einsum=e2,
                        schedule=get_trivial_contraction_schedule(e2)), extras


def lane_pack_dg_applicable(einsum):
    """Structure check for the DG-family lane-pack rewrite
    (:func:`rewrite_lane_pack_dg`) — the small-ndof element-packing answer
    to the reference's ``n_e_per_wg`` on 3-operand classes with a second
    streamed "scale" factor (reference tuning/impls/
    xre_rij_xej_to_ei_v4.py:41-114, batched_re_rij_ej_to_ei_v2.py:24-50).

    Requires (same structure in every batch row):

      * one RESIDENT operand (no long axis) carrying the output dof ``i``,
        the contracted dof ``j``, and optional concrete axes ``m`` (div's
        s, grad/curl's r, face's f);
      * one MAIN streamed operand ``(lam_u..., el, j)`` with ``lam_u`` a
        subset of the resident's ``m`` (face's flux (f,e,j));
      * one SCALE streamed operand, either ``(el, s)`` with ``s`` in ``m``
        (div's J) or ``(lam_j..., el)`` (mass/curl (e,), grad (x,r,e),
        face (f,e));
      * output ``(chi..., el, i)`` with ``chi`` a subset of ``lam_j``
        (grad's x).

    Returns a structure dict or ``None``."""
    e = einsum
    if e.n != 3:
        return None
    long_letters = [ix for ix, ln in e.index_to_dim_length.items()
                    if isinstance(ln, SizeParam)]
    if len(long_letters) != 1:
        return None
    el = long_letters[0]
    out = tuple(e.out_idx_set)
    if len(out) < 2 or out[-2] != el or out[-1] == el:
        return None
    i = out[-1]
    chi = out[:-2]
    if el in chi or i in chi:
        return None
    residents = [p for p, s in enumerate(e.in_idx_sets) if el not in s]
    if len(residents) != 1:
        return None
    rp = residents[0]
    rho = tuple(e.in_idx_sets[rp])
    if i not in rho:
        return None
    streamed = [p for p in range(3) if p != rp]

    def classify(up, jp):
        s = tuple(e.in_idx_sets[up])
        if not (len(s) >= 2 and s[-2] == el and s[-1] in rho and s[-1] != i
                and s[-1] not in out and set(s[:-2]) <= set(rho) - {i}):
            return None
        j, lam_u = s[-1], s[:-2]
        js = tuple(e.in_idx_sets[jp])
        m = tuple(c for c in rho if c not in (i, j))
        if len(js) == 2 and js[0] == el and js[1] in m:
            variant, s_ax, lam_j = "A", js[1], ()
        elif js[-1] == el and el not in js[:-1]:
            variant, s_ax, lam_j = "B", None, js[:-1]
            if not set(lam_j) <= set(m) | set(chi):
                return None
            if i in lam_j or j in lam_j:
                return None
        else:
            return None
        if not set(chi) <= set(lam_j):
            return None
        # every non-dof axis must be concrete (the long axis is el alone)
        for c in set(rho) | set(lam_j) | {i, j}:
            if c != el and isinstance(e.index_to_dim_length[c], SizeParam):
                return None
        return dict(el=el, i=i, j=j, chi=chi, rp=rp, up=up, jp=jp, rho=rho,
                    m=m, lam_u=lam_u, lam_j=lam_j, variant=variant,
                    s_ax=s_ax)

    # div's J (e,s) and u (e,j) both fit the "main streamed" pattern (the
    # roles are algebraically symmetric); prefer the assignment with the
    # larger contracted dof (denser kron dots, 8-alignment at smaller g)
    cands = [c for c in (classify(streamed[0], streamed[1]),
                         classify(streamed[1], streamed[0])) if c]
    if not cands:
        return None
    return max(cands, key=lambda c: int(e.index_to_dim_length[c["j"]]))


def rewrite_lane_pack_dg(program, g: int):
    """Rewrite a DG-class program (see :func:`lane_pack_dg_applicable`) for
    ``lane_pack=g``: g consecutive elements share one packed dof row.

    Packed computation (all contracts free row-major reshapes host-side,
    all residents computed in-graph once per launch):

      * main streamed ``u -> (lam_u..., E/g, g*dj)``; resident
        ``R -> T[m] = kron(I_g, R[m])`` (block-diagonal, in-graph);
      * scale streamed packed to lanes and re-broadcast across each
        element's ``di`` output lanes by ONE dot against a synthesized 0/1
        expansion matrix (descriptor.lane_pack_expand) — no lane reshape,
        no strided lane slicing;
      * 3-step schedule: ``V = u' @ T`` (per-m dots),
        ``W = J' @ EXP``, then the elementwise product summed over the
        shared concrete axes.

    Returns ``(rewritten_program, descriptor_extras)``."""
    import feinsum_tpu as f

    e = program.einsum
    info = lane_pack_dg_applicable(e)
    if info is None:
        raise InvalidParameterError(
            "lane_pack (DG variant) applies only to 3-operand classes with"
            " one resident, one (.., e, j) streamed and one scale streamed"
            " operand")
    el, i, j = info["el"], info["i"], info["j"]
    di = int(e.index_to_dim_length[i])
    dj = int(e.index_to_dim_length[j])
    if (g * di) % 8 or (g * dj) % 8:
        raise InvalidParameterError(
            f"lane_pack={g}: packed dims ({g}*{di}, {g}*{dj}) must be"
            f" 8-aligned")
    if g * max(di, dj) > 4096:
        raise InvalidParameterError(
            f"lane_pack={g}: packed dim {g * max(di, dj)} exceeds the 4096"
            f" resident cap")
    used = set(e.index_to_dim_length) | set("".join(e.arg_to_shape))
    fresh = (c for c in "abcdefghijklmnopqrstuvwxyz" if c not in used)
    exp_name = "_lp_exp0"
    long_name = f"N{el}_"

    m, lam_u, lam_j = info["m"], info["lam_u"], info["lam_j"]
    chi, rho = info["chi"], info["rho"]
    sizes = {c: int(e.index_to_dim_length[c])
             for c in set(rho) | set(lam_j) if c != el}
    sizes[i] = g * di
    sizes[j] = g * dj

    # the packed SCALE lanes keep the same 8-alignment as the dof dims
    s_lanes = g * (int(e.index_to_dim_length[info["s_ax"]])
                   if info["variant"] == "A" else 1)
    if s_lanes % 8:
        raise InvalidParameterError(
            f"lane_pack={g}: packed scale lanes ({s_lanes}) must be"
            f" 8-aligned")

    jdt = e.args[0][info["jp"]].dtype.name
    if info["variant"] == "A":
        s_ax = info["s_ax"]
        s_len = int(e.index_to_dim_length[s_ax])
        pk = next(fresh)                       # packed-J lane axis (g*s)
        sizes[pk] = g * s_len
        j_sub = el + pk
        exp_sub = s_ax + pk + i
        exp_shape = (s_len, g * s_len, g * di)
        expand = ((exp_name, "A", g, s_len, di, jdt),)
        n_lead_j = 0
        w_sub = s_ax + el + i
    else:
        pk = next(fresh)                       # group axis (g)
        sizes[pk] = g
        j_sub = "".join(lam_j) + el + pk
        exp_sub = pk + i
        exp_shape = (g, g * di)
        expand = ((exp_name, "P", g, di, jdt),)
        n_lead_j = len(lam_j)
        w_sub = "".join(lam_j) + el + i

    t_sub = "".join(m) + i + j
    u_sub = "".join(lam_u) + el + j
    v_sub = "".join(m) + el + i
    out_sub = "".join(chi) + el + i
    subs = f"{j_sub},{exp_sub},{t_sub},{u_sub}->{out_sub}"

    def shp(sub):
        return tuple(long_name if c == el else sizes[c] for c in sub)

    rows = []
    for r in range(e.b):
        jarr = e.args[r][info["jp"]]
        rarr = e.args[r][info["rp"]]
        uarr = e.args[r][info["up"]]
        rows.append([f.array(jarr.name, shp(j_sub), jarr.dtype.name),
                     f.array(exp_name, exp_shape, jdt),
                     f.array(rarr.name, shp(t_sub), rarr.dtype.name),
                     f.array(uarr.name, shp(u_sub), uarr.dtype.name)])
    e2 = f.batched_einsum(subs, rows)

    from feinsum_tpu.contraction_schedule import (
        ContractionSchedule, EinsumOperand, IntermediateResult)
    schedule = ContractionSchedule(
        subscripts=(f"{u_sub},{t_sub}->{v_sub}",
                    f"{j_sub},{exp_sub}->{w_sub}",
                    f"{v_sub},{w_sub}->{out_sub}"),
        result_names=("_lp_v", "_lp_w", "_fe_out"),
        arguments=((EinsumOperand(3), EinsumOperand(2)),
                   (EinsumOperand(0), EinsumOperand(1)),
                   (IntermediateResult("_lp_v"),
                    IntermediateResult("_lp_w"))))

    # kron perm: resident logical axes -> (m..., i, j)
    perm = tuple(rho.index(c) for c in m + (i, j))
    pack_args = {(e.args[r][info["jp"]].name, n_lead_j) for r in range(e.b)}
    pack_args |= {(e.args[r][info["up"]].name, len(lam_u))
                  for r in range(e.b)}
    kron_args = {(e.args[r][info["rp"]].name, perm) for r in range(e.b)}
    extras = dict(lane_pack=int(g),
                  lane_pack_args=tuple(sorted(pack_args)),
                  kron_args=tuple(sorted(kron_args)),
                  lane_pack_expand=expand)
    return program.copy(einsum=e2, schedule=schedule), extras


def rowcat_applicable(einsum) -> bool:
    """rowcat merges batch rows that share EVERY resident operand and
    stream DISTINCT per-row operands with the long axis LEADING (div/curl
    shapes: J (E,s), u (E,j)); the long axis must lead the output too."""
    e = einsum
    if e.b <= 1:
        return False
    long_letters = [ix for ix, ln in e.index_to_dim_length.items()
                    if isinstance(ln, SizeParam)]
    if len(long_letters) != 1:
        return False
    el = long_letters[0]
    if not e.out_idx_set or e.out_idx_set[0] != el:
        return False
    for p, idx in enumerate(e.in_idx_sets):
        names = [e.args[r][p].name for r in range(e.b)]
        dtypes = {e.args[r][p].dtype for r in range(e.b)}
        if len(dtypes) != 1:
            return False
        if el in idx:
            if idx[0] != el or len(set(names)) != e.b:
                return False
        else:
            if len(set(names)) != 1:
                return False
    return True


def rewrite_rowcat(program):
    """Rewrite a rowcat-applicable batched program into a SINGLE row over a
    b*E-long axis: streamed operands are stored stacked end-to-end
    (descriptor.rowcat_args; free for (b, E, ...) row-major buffers),
    residents pass through, and the one output is the b row outputs
    concatenated.  Traffic and dot work are identical; grid steps (and
    their fixed overhead — the small-ndof P1/P2 tax) drop b-fold.

    Returns ``(rewritten_program, descriptor_extras)``."""
    import feinsum_tpu as f

    e = program.einsum
    if not rowcat_applicable(e):
        raise InvalidParameterError(
            "rowcat needs a batched einsum whose rows share every resident"
            " operand and stream distinct long-leading operands")
    el = long_axis_of(e)
    taken = set(e.arg_to_shape)
    new_args, rowcat_args = [], []
    for p, idx in enumerate(e.in_idx_sets):
        arg0 = e.args[0][p]
        if el in idx:
            k = 0
            while f"cat{p}_{k}" in taken:
                k += 1
            name = f"cat{p}_{k}"
            taken.add(name)
            rowcat_args.append(
                (name, tuple(e.args[r][p].name for r in range(e.b))))
            shape = tuple(f"N{el}_" if ix == el else
                          int(e.index_to_dim_length[ix]) for ix in idx)
            new_args.append(f.array(name, shape, arg0.dtype.name))
        else:
            new_args.append(f.array(
                arg0.name,
                tuple(int(e.index_to_dim_length[ix]) for ix in idx),
                arg0.dtype.name))
    subs = (",".join("".join(s) for s in e.in_idx_sets)
            + "->" + "".join(e.out_idx_set))
    e2 = f.einsum(subs, *new_args)
    extras = dict(rowcat=int(e.b), rowcat_args=tuple(rowcat_args))
    return program.copy(einsum=e2,
                        schedule=get_trivial_contraction_schedule(e2)), extras
