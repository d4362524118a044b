"""
Schedule descriptors: device schedules as *data*.

The reference records transforms as (impl-module id, parameter values) where
the impl replays imperative loopy verbs (split_iname/precompute/...,
SURVEY.md §2.2).  The equivalent here is a declarative descriptor
interpreted by the emitters; the tuning impls' job is to *produce* good
descriptors for their einsum family.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional


def _freeze_mapping(m) -> tuple:
    if isinstance(m, tuple):
        return m
    return tuple(sorted(m.items()))


@dataclass(frozen=True)
class ScheduleDescriptor:
    """How to lower a batched-einsum program onto the device.

    :attr backend: ``"xla"`` (jnp.einsum per step, XLA fusion) or ``"pallas"``
        (one fused kernel gridded over :attr:`grid_index`, compiled through
        Triton on a GPU and interpreted on the CPU).
    :attr grid_index: index letter the Pallas grid iterates over — normally
        the parametric "long" axis (DG element axis).  ``None`` = choose
        automatically (the unique SizeParam axis if any).
    :attr block_long: elements of the long axis processed per program
        (rounded up to a power of two in-kernel).
    :attr num_warps: Triton warps per program.
    :attr num_stages: Triton software-pipelining stages.
    :attr accum_dtype: accumulation dtype for contractions (e.g. "float32"
        for bf16 inputs); ``None`` = operand dtype.
    :attr compute_dtype: cast operands to this dtype before contracting;
        ``None`` = as-is.
    :attr arg_layouts: per-arg axis permutation applied to the HBM layout,
        as a tuple of ``(arg_name, perm_tuple)``.  The executable then
        expects the argument pre-transposed — layout choice is part of the
        schedule, like the reference's TTGT transposes.
    :attr precision: dot precision: "highest" (IEEE f32 for f32 data),
        "tf32_3x" / "bf16_3x" (3-pass split products on the tensor cores),
        "fastest" (single-pass), or an XLA dot-algorithm preset name (XLA
        backend).  "default" is "highest" on the XLA backend and "bf16_3x"
        in the Pallas kernel (see ops/pallas_emitter._dot_precision).
    :attr interpret: force Pallas interpret mode (the CPU always
        interprets).
    :attr multiple_results_in_one_kernel: evaluate all batch rows inside one
        pallas_call (shares operand loads between rows) vs one call per row.
    """

    backend: str = "xla"
    # host-side storage contract applied BEFORE everything else: per-arg
    # nested axis grouping ((name, ((2,0),(1,3))), ...) — the stored array is
    # transpose(flat_perm) reshaped to one axis per group, e.g. a high-rank
    # small-dim TC operand stored as a GEMM-natural 2D matrix.  Like
    # arg_layouts, it is part of the schedule's data-layout contract.
    pre_layouts: tuple = ()
    pre_out_layout: Optional[tuple] = None  # nested grouping for every output
    # explicit index->length bindings for axes of a REWRITTEN program whose
    # lengths are fixed by the original einsum (e.g. the flattened M axis of
    # a TC-as-GEMM rewrite) rather than by the caller's long_dim_length
    bind_lengths: tuple = ()
    grid_index: Optional[str] = None
    block_long: int = 256
    num_warps: int = 4
    num_stages: int = 2
    accum_dtype: Optional[str] = None
    compute_dtype: Optional[str] = None
    arg_layouts: tuple = ()
    out_layout: Optional[tuple] = None   # axis perm applied to every output
    # fold the trailing long axis E -> (fold_long, E/fold_long) in storage
    # (a free view of the dof-major buffer).  Requires dof-major storage
    # (the long axis trailing on every operand/output that carries it) and
    # E % fold_long == 0.
    fold_long: int = 1
    # store the named args pre-blocked: (nb, *small_axes, 8, blk_c) — block
    # g holds elements [g*B, (g+1)*B) laid out (8, blk_c) row-major (see
    # ops/layouts.preblock_arrays).  The pallas backend unpacks them to
    # dof-major before its kernel.
    preblock_args: tuple = ()
    precision: str = "default"
    # evaluate schedule steps whose inputs are all resident (no long-axis
    # operand, transitively) in XLA outside the kernel, once per launch,
    # and feed the result to the kernel as a resident operand instead of
    # recomputing it in every program.
    hoist_resident_steps: bool = True
    # lane-pack rewrite contract (the small-dof answer to the reference's
    # n_e_per_wg element packing, tuning/impls/xre_rij_xej_to_ei_v4.py:
    # 41-114): the program's einsum is REWRITTEN so g consecutive elements
    # share one dof axis — u (E, d) is stored (E/g, g*d) (a free reshape of
    # the row-major buffer), the resident matrix becomes the block-diagonal
    # kron(I_g, D) (computed in-graph, once per launch), and the output is
    # delivered packed (E/g, g*d_out).
    # ``lane_pack`` = g; ``lane_pack_args`` = streamed operand names stored
    # packed host-side; ``kron_args`` = resident names kron-expanded
    # in-graph.  SizeParam axis lengths are divided by g at build time.
    # ``lane_pack_args`` entries may be ``(name, n_lead)``: the long axis
    # sits after *n_lead* leading axes and packing reshapes
    # (lead..., E, rest...) -> (lead..., E/g, g*prod(rest)).
    # ``kron_args`` entries may be ``(name, perm)``: the resident is
    # transposed by *perm* first, then kron-expanded over its LAST TWO axes
    # batched over the leading ones (T[m] = kron(I_g, R[m])).
    # ``lane_pack_expand`` synthesizes the 0/1 lane-expansion matrices the
    # packed scale factor contracts against: entries ``(name, "P", g, d,
    # dtype)`` make P[a, f*d+k] = (a==f) of shape (g, g*d); ``(name, "A", g,
    # s, d, dtype)`` make A[t, a*s+u, f*d+k] = (a==f)(u==t) of shape
    # (s, g*s, g*d).
    lane_pack: int = 1
    lane_pack_args: tuple = ()
    kron_args: tuple = ()
    lane_pack_expand: tuple = ()
    # row-concatenation rewrite (batched einsums whose rows share every
    # resident operand): the b rows' streamed operands are stored stacked
    # along the long axis ((b, E, ...) -> (b*E, ...), free for row-major
    # buffers via rowcat_args name groups) and the program becomes a
    # SINGLE row over a b*E-long axis.  The single output is the b row
    # outputs concatenated along the long axis.  SizeParam lengths are
    # multiplied by b at build time.
    rowcat: int = 1
    rowcat_args: tuple = ()   # ((stacked_name, (row0_name, row1_name...)),)
    # XLA route only: split the long (SizeParam) axis into chunks of this
    # many elements and lax.map the whole schedule over them sequentially,
    # bounding the intermediate footprint.  None = one launch over the
    # full axis.
    xla_block_long: Optional[int] = None
    interpret: Optional[bool] = None
    multiple_results_in_one_kernel: bool = True
    flags: tuple = field(default_factory=tuple)

    def __post_init__(self):
        object.__setattr__(self, "arg_layouts",
                           _freeze_mapping(self.arg_layouts))
        object.__setattr__(self, "pre_layouts",
                           _freeze_mapping(self.pre_layouts))
        object.__setattr__(self, "bind_lengths",
                           _freeze_mapping(self.bind_lengths))
        object.__setattr__(self, "rowcat_args",
                           _freeze_mapping(self.rowcat_args))
        object.__setattr__(self, "flags", _freeze_mapping(self.flags))
        if self.backend not in ("xla", "pallas"):
            raise ValueError(f"unknown backend {self.backend!r}")

    def copy(self, **changes) -> "ScheduleDescriptor":
        return replace(self, **changes)

    @property
    def arg_layouts_map(self) -> dict:
        return dict(self.arg_layouts)

    @property
    def flags_map(self) -> dict:
        return dict(self.flags)
