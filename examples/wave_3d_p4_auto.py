"""Full 3D wave operator at P4 with DB-driven schedules (reference:
examples/wave_3d_p4_auto.py): every einsum in the step consults the transform
archive for the best recorded schedule on this device."""
import sys
import time

import jax

from feinsum_tpu import sql_utils
from feinsum_tpu.models import WaveOperator3D, make_wave_state

# the streaming regime on the GPU; pass a small count on the CPU, where
# Pallas runs in its interpreter
N_ELEMENTS = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000

if __name__ == "__main__":
    op = WaveOperator3D(ndof=35, nfacedof=15, dtype="float32",
                        db_path=sql_utils.DEFAULT_DB)
    step = jax.jit(op.make_step(N_ELEMENTS))
    state, geom = make_wave_state(N_ELEMENTS)

    # time k chained steps inside one jit (robust against async dispatch)
    @jax.jit
    def run(state, geom, k):
        st = jax.lax.fori_loop(0, k, lambda _, s: step(s, geom), state,
                               unroll=False)
        return st["u"].ravel()[0]

    _ = float(run(state, geom, 1))          # compile
    t1 = time.perf_counter()
    _ = float(run(state, geom, 4))
    t1 = time.perf_counter() - t1
    t2 = time.perf_counter()
    _ = float(run(state, geom, 104))
    t2 = time.perf_counter() - t2
    dt = (t2 - t1) / 100
    print(f"wave step: {dt * 1e3:.2f} ms/step at E={N_ELEMENTS}"
          f" ({N_ELEMENTS * op.ndof / dt / 1e9:.1f} Gdof/s)")
