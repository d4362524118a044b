"""
In-kernel lowering of schedule steps to the primitives Pallas lowers
through Triton.

Triton tensors are at most a few dimensions, have power-of-two extents, and
cannot be sliced once loaded; its matrix product is a 2D ``dot`` whose
operands are at least 16 along every dimension.  So each step of a
contraction schedule is lowered with every tensor-in-flight represented as
a :class:`Rep`:

  * ``big``  — at most two axes kept as tensor dimensions: the long (grid)
               axis ``e`` and one dof axis, each padded to a power of two
               (the padding holds zeros);
  * ``small``— all other (tiny, static) axes unrolled into a dict of tiles.

A step then becomes, per combination of unrolled indices:
  * a 2D ``dot`` over one chosen contraction axis ``k`` when the factor
    pieces split into an (e,k) side and a (k,n) side,
  * otherwise broadcast-products and axis-sums (e.g. reductions over the
    long axis, or tiny contracted axes folded into unrolled sums).

Raw operands carry a ``source`` that reloads them from memory with a
different split of big and small axes; a schedule that would re-split a
computed tile is refused.  This is the analog of the reference's
loop-nest transforms: the grid is ``split_iname(e)``; ``big`` axes are the
vectorized inames; ``small`` axes are ``unr``-tagged unrolled inames
(cf. tuning/impls/xre_rij_xej_to_ei_v4.py steps 0-9).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, Optional

from ..diagnostics import InvalidParameterError

MAX_UNROLL_COMBOS = 1024
MIN_TILE = 16


def padded_length(n: int) -> int:
    """In-kernel extent of an axis of length *n*: the next power of two,
    and at least :data:`MIN_TILE` (Triton's smallest ``dot`` operand)."""
    p = MIN_TILE
    while p < n:
        p *= 2
    return p


@dataclass
class Rep:
    """A tensor-in-flight: ``data[key]`` has dims ``big`` (order meaningful),
    keyed by the values of the ``small`` axes.  ``source(big)`` reloads a
    raw operand with the given big axes (``None`` for computed values)."""

    small: tuple
    big: tuple
    data: dict
    source: Optional[Callable] = None

    def rename(self, mapping: dict) -> "Rep":
        source = None
        if self.source is not None:
            inv = {v: k for k, v in mapping.items()}
            base = self.source

            def source(big):
                return base(tuple(inv[l] for l in big)).rename(mapping)
        return Rep(tuple(mapping[l] for l in self.small),
                   tuple(mapping[l] for l in self.big),
                   self.data, source)

    def get(self, combo: dict):
        return self.data[tuple(combo[l] for l in self.small)]


def default_big(letters, e_letter) -> tuple:
    """The long axis and the last other axis stay tensor dims (at most two
    in all); everything else unrolls."""
    letters = tuple(letters)
    big_set = set()
    if e_letter in letters:
        big_set.add(e_letter)
    for l in reversed([l for l in letters if l != e_letter]):
        if len(big_set) >= 2:
            break
        big_set.add(l)
    return tuple(l for l in letters if l in big_set)


def rep_from_loader(letters, big, lengths, load_piece) -> Rep:
    """Rep of a raw operand with stored axes *letters*: ``load_piece(big,
    combo)`` loads one tile (dims = *big* in stored order) for the small
    axes' values in *combo*."""
    letters = tuple(letters)
    if len(set(letters)) != len(letters):
        raise InvalidParameterError(
            f"repeated index within one operand ({letters}) is not supported"
            " by the pallas backend")
    big = tuple(l for l in letters if l in set(big))
    small = tuple(l for l in letters if l not in big)
    combos = 1
    for l in small:
        combos *= lengths[l]
    if combos > MAX_UNROLL_COMBOS:
        raise InvalidParameterError(
            f"unrolling {small} needs {combos} slices (> {MAX_UNROLL_COMBOS})")
    data = {key: load_piece(big, dict(zip(small, key)))
            for key in itertools.product(*[range(lengths[l]) for l in small])}

    def source(new_big):
        return rep_from_loader(letters, new_big, lengths, load_piece)
    return Rep(small, big, data, source)


def _bcast_to(piece_axes, piece, target_axes):
    """Broadcastable view of *piece* (dims = piece_axes) against a target
    axis order (len<=2)."""
    if piece_axes == tuple(target_axes):
        return piece
    if len(piece_axes) == 2:
        assert set(piece_axes) == set(target_axes)
        return piece.swapaxes(0, 1)
    if len(piece_axes) == 0:
        return piece
    (ax,) = piece_axes
    pos = target_axes.index(ax)
    if len(target_axes) == 1:
        return piece
    return piece[:, None] if pos == 0 else piece[None, :]


def _product(pieces, target_axes):
    """Elementwise product of (axes, array) pieces broadcast to target_axes
    (None -> scalar product)."""
    out = None
    for axes, arr in pieces:
        arr = _bcast_to(axes, arr, target_axes or ())
        out = arr if out is None else out * arr
    return out


def lower_step(factor_reps, out_letters, e_letter, lengths, padded, *,
               accum_dtype=None, big_order_pref=None,
               dot_precision=None) -> Rep:
    """Compute one schedule step from factor Reps; returns the result Rep.
    *lengths* are the axes' logical lengths (unroll ranges), *padded* their
    in-kernel tensor extents."""
    import jax.numpy as jnp

    out_letters = tuple(out_letters)
    all_letters = []
    for rep in factor_reps:
        for l in rep.small + rep.big:
            if l not in all_letters:
                all_letters.append(l)
    contracted = [l for l in all_letters if l not in out_letters]
    e_present = e_letter is not None and any(
        e_letter in r.big for r in factor_reps)
    e_in_out = e_present and e_letter in out_letters
    e_contracted = e_present and not e_in_out

    def is_big_somewhere(l):
        return any(l in r.big for r in factor_reps)

    # dof axis of the output: the *largest* eligible axis (picking a tiny
    # trailing axis would unroll a big one — e.g. 'ej,es->ejs' must keep j=35
    # vectorized and unroll s=3, not the reverse).  Prefer axes that are big
    # in every factor carrying them; otherwise the straggler factors get
    # promoted below.
    n_loose = [l for l in out_letters
               if l != e_letter and is_big_somewhere(l)]
    n_strict = [l for l in n_loose
                if all(l in r.big for r in factor_reps
                       if l in r.small + r.big)]
    pool = n_strict or n_loose
    n_ax = max(pool, key=lambda l: lengths[l]) if pool else None
    if n_ax is not None and n_ax not in n_strict:
        factor_reps = [_promote(r, n_ax, keep=e_letter)
                       if n_ax in r.small else r for r in factor_reps]

    # contraction axis fed to the dot: must be a big axis in every factor
    # that carries it — if it's an unrolled axis anywhere, the whole
    # contraction over it unrolls into a sum instead
    k_candidates = [
        l for l in contracted
        if l != e_letter and is_big_somewhere(l)
        and all(l in r.big for r in factor_reps if l in r.small + r.big)]
    k_ax = (max(k_candidates, key=lambda l: lengths[l])
            if k_candidates else None)

    keep = {l for l in (e_letter if e_present else None, n_ax, k_ax)
            if l is not None}
    unroll = [l for l in all_letters if l not in keep]
    combos = 1
    for l in unroll:
        combos *= lengths[l]
    if combos > MAX_UNROLL_COMBOS:
        raise InvalidParameterError(
            f"step unroll over {unroll} needs {combos} combos")

    reps = []
    for rep in factor_reps:
        drop = [l for l in rep.big if l in unroll]
        if drop:
            # unroll a tensor dim: reload the raw operand with it small
            if rep.source is None:
                raise InvalidParameterError(
                    f"cannot unroll {drop} of a computed intermediate")
            rep = rep.source(tuple(l for l in rep.big if l not in drop))
        reps.append(rep)

    out_small = tuple(l for l in out_letters if l in unroll)
    sum_small = [l for l in contracted if l in unroll]

    result_letters = {l for l in (e_letter if e_in_out else None, n_ax)
                      if l is not None}
    # orientation: honor the caller's preferred order (the output's stored
    # layout) when it covers the result; otherwise inherit the orientation of
    # the factors so no transposes are introduced
    if (big_order_pref is not None and len(result_letters) == 2
            and set(big_order_pref) >= result_letters):
        result_big = tuple(sorted(result_letters,
                                  key=list(big_order_pref).index))
    elif len(result_letters) == 2:
        src = next((tuple(r.big) for r in reps
                    if set(r.big) == result_letters), None)
        result_big = src if src is not None else tuple(
            l for l in (e_letter if e_in_out else None, n_ax)
            if l is not None)
    else:
        result_big = tuple(result_letters)

    result = {}
    for out_key in itertools.product(*[range(lengths[l]) for l in out_small]):
        out_combo = dict(zip(out_small, out_key))
        acc = None
        for sum_key in itertools.product(
                *[range(lengths[l]) for l in sum_small]):
            combo = {**out_combo, **dict(zip(sum_small, sum_key))}
            pieces = [(r.big, r.get(combo)) for r in reps]
            val = _contract_pieces(
                pieces, e_letter if e_present else None, e_contracted,
                k_ax, n_ax, result_big, accum_dtype, dot_precision)
            acc = val if acc is None else acc + val
        # materialize to the full tile shape so downstream consumers and
        # stores see exact shapes
        if result_big:
            full = tuple(padded[l] for l in result_big)
            if acc.shape != full:
                acc = jnp.broadcast_to(acc, full)
        result[out_key] = acc
    return Rep(out_small, result_big, result)


def _promote(rep: Rep, letter, keep=None) -> Rep:
    """Turn the unrolled axis *letter* of a raw operand into a tensor dim
    (used when another factor needs the axis vectorized) by reloading it;
    with two tensor dims already, the one that is not *keep* becomes
    unrolled.  A computed tile cannot be re-split (Triton cannot stack or
    slice loaded values): such a schedule is refused."""
    if rep.source is None:
        raise InvalidParameterError(
            f"cannot vectorize {letter} of a computed intermediate")
    big = rep.big if len(rep.big) < 2 else tuple(
        l for l in rep.big if l == keep)
    return rep.source(big + (letter,))


def _contract_pieces(pieces, e, e_contracted, k, n, result_big, accum_dtype,
                     dot_precision):
    """Contract factor pieces (each dims subset of {e,k,n}) over k (a dot
    when possible) and over e when e is contracted (a sum)."""
    import jax
    import jax.numpy as jnp

    dot_kwargs = {"preferred_element_type": accum_dtype or jnp.float32}
    if dot_precision is not None:
        dot_kwargs["precision"] = dot_precision

    def do_dot(lhs, rhs, dims):
        return jax.lax.dot_general(lhs, rhs, dims, **dot_kwargs)

    post = [(axes, arr) for axes, arr in pieces if k is None or k not in axes]
    kgroup = [(axes, arr) for axes, arr in pieces
              if k is not None and k in axes]

    if kgroup:
        aside = [(a, x) for a, x in kgroup if e is not None and e in a]
        bside = [(a, x) for a, x in kgroup if n is not None and n in a]
        konly = [(a, x) for a, x in kgroup if a == (k,)]
        assert len(aside) + len(bside) + len(konly) == len(kgroup), (
            "unclassifiable k-group piece (axes beyond {e,k,n}?)")
        # build each side in the storage order of its first 2D piece;
        # dot_general contracts along whichever positions k landed in
        a_axes = next((a for a, _ in aside if len(a) == 2), (e, k))
        b_axes = next((a for a, _ in bside if len(a) == 2),
                      (k, n) if n else (k,))
        if aside and (bside or konly):
            A = _product(aside, a_axes)
            B = _product(bside + konly, b_axes)
            if n is not None:
                cka, ckb = a_axes.index(k), b_axes.index(k)
                if result_big == (n, e):
                    core = do_dot(B, A, (((ckb,), (cka,)), ((), ())))
                    core_axes = (n, e)
                else:
                    core = do_dot(A, B, (((cka,), (ckb,)), ((), ())))
                    core_axes = (e, n)
            else:
                Bb = _bcast_to(b_axes, B, a_axes)
                core = jnp.sum(A * Bb, axis=a_axes.index(k))
                core_axes = tuple(l for l in a_axes if l != k)
        elif aside:
            core = jnp.sum(_product(aside + konly, a_axes),
                           axis=a_axes.index(k))
            core_axes = tuple(l for l in a_axes if l != k)
        else:
            prod = _product(bside + konly, b_axes)
            core = jnp.sum(prod, axis=b_axes.index(k))
            core_axes = tuple(l for l in b_axes if l != k)
    else:
        core = None
        core_axes = ()

    # fold in the k-free pieces, in the result's own orientation (or, when e
    # is contracted, in the orientation of the post pieces — the reduction
    # over e happens below)
    if e_contracted:
        src = next((a for a, _ in post if len(a) == 2), None)
        target = src if src is not None else tuple(
            l for l in (e, n) if l is not None)
    else:
        target = tuple(l for l in result_big if l in (e, n))
    if post or core is None:
        p = _product(post, target) if post else None
        if core is None:
            core, core_axes = p, target if p is not None else ()
        elif p is not None:
            core = _bcast_to(core_axes, core, target) * p
            core_axes = target
    # reduce over e if it's contracted
    if e_contracted and core_axes and e in core_axes:
        core = jnp.sum(core, axis=core_axes.index(e))
        core_axes = tuple(l for l in core_axes if l != e)

    # normalize to result_big order
    if core_axes != result_big:
        if set(core_axes) == set(result_big):
            core = core.swapaxes(0, 1)
        else:
            # broadcast missing axes (pieces independent of an output axis)
            missing = [l for l in result_big if l not in core_axes]
            for l in missing:
                pos = result_big.index(l)
                core = jnp.expand_dims(core, pos)
            core_axes = result_big
    return core
