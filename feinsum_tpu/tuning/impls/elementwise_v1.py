"""
Schedule space for bandwidth-bound kernels over one long axis: block size,
warps, and the dof-major layout knob (the long axis stored trailing, so
each element block is a contiguous run of every dof row).  Archived rows'
``blkc128`` / ``flatten`` / ``parallel_grid`` / ``vmem_idx`` knobs are
accepted so they replay, but no longer change the kernel.
"""

from __future__ import annotations

from feinsum_tpu.tuning import BoolParameter, IntParameter, transform_param
from feinsum_tpu.tuning.impls._common import fused_pallas_program


@transform_param("log2_block", lambda e: IntParameter(4, 10))
@transform_param("log2_warps", lambda e: IntParameter(2, 3))
@transform_param("dofmajor", lambda e: BoolParameter())
@transform_param("fold", lambda e: BoolParameter())
def transform(program, log2_block, blkc128=0, *, dofmajor, log2_warps=2,
              fold=False, flatten=False, parallel_grid=True, vmem_idx=None):
    from feinsum_tpu.tuning.impls._common import resolve_block
    del flatten, parallel_grid, vmem_idx     # archived-row knobs
    return fused_pallas_program(
        program, block_long=resolve_block(log2_block, blkc128), hoist=False,
        dofmajor=dofmajor, fold=fold, num_warps=2 ** int(log2_warps))


if __name__ == "__main__":
    import feinsum_tpu as f
    from feinsum_tpu.tuning import autotune

    einsum = f.einsum("ij,ij->ij",
                      f.array("A", ("E", 35), "float32"),
                      f.array("B", ("E", 35), "float32"))
    autotune(einsum, __file__, stop_after=300, long_dim_length=1_000_000)
