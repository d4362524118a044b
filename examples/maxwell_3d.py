"""Source-free 3D DG Maxwell stepped with archive-driven curl kernels
(the cross-product einsum family; reference class
``re_rji_ej_to_ei_3d_cross_product_v0``).

Runs on the GPU, and on the CPU with Pallas in interpret mode:

    python examples/maxwell_3d.py
"""

import numpy as np

import jax

from feinsum_tpu.models import MaxwellOperator3D, make_maxwell_state


def main():
    on_gpu = jax.devices()[0].platform == "gpu"
    # interpret-mode Pallas on the CPU is an emulator: keep the demo tiny
    n_elements, ndof, dt = (65536, 35, 1e-3) if on_gpu else (256, 10, 1e-3)
    op = MaxwellOperator3D(ndof=ndof, db_path=None)   # built-in schedule
    step = jax.jit(op.make_step(n_elements, dt=dt))
    state, geom = make_maxwell_state(n_elements, ndof=ndof)

    for i in range(5):
        state = step(state, geom)
    jax.block_until_ready(state)
    e = np.asarray(state["E"])
    print(f"5 Maxwell steps on {n_elements} elements x {ndof} dofs:"
          f" |E| rms = {float(np.sqrt((e ** 2).mean())):.6f}")


if __name__ == "__main__":
    main()
