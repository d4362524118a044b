"""Scale the DG wave divergence operator across a device mesh.

The reference is single-device (SURVEY.md SS2.4: intra-kernel work-groups
only; no distributed layer exists to port).  This example shows the
extension: the archived single-card kernel runs unchanged on each
device's slab of elements while ``jax.sharding`` + ``shard_map`` place
the data and XLA inserts the collectives (NCCL over NVLink on GPUs).

Three layouts on one 8-device mesh (runs on the CPU with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``; the same code
drives the cards of a GPU host):

* pure data parallelism — elements sharded over all 8 devices, zero
  collectives (every DG contraction is element-local);
* data x tensor parallelism (4x2) — the derivative operator's contracted
  dof axis additionally split over the model axis, partial contractions
  ``psum``-ed;
* row/expert parallelism — the 3 batched rows (x/y/z components) placed
  on different devices.

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
         python examples/multichip_dg_operator.py
"""
import os

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")

import jax

# The 8-device mesh is virtual CPU devices unless JAX_PLATFORMS names the
# GPU (a host with 8 cards).
if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np

import feinsum_tpu as f
from feinsum_tpu.codegen.program import generate_program
from feinsum_tpu.parallel import (
    make_mesh,
    reduction_sharded_executable,
    row_sharded_executable,
    sharded_einsum_executable,
)

E, NDOF = 4096, 16

div = f.batched_einsum(
    "es,sij,ej->ei",
    [[f.array(jn, ("E", 3), "float32"),
      f.array("R", (3, NDOF, NDOF), "float32"),
      f.array(un, ("E", NDOF), "float32")]
     for jn, un in [("Jx", "ux"), ("Jy", "uy"), ("Jz", "uz")]])
program = generate_program(div)

rng = np.random.default_rng(0)
arrays = {"R": rng.standard_normal((3, NDOF, NDOF), np.float32)}
for n in ("Jx", "Jy", "Jz"):
    arrays[n] = rng.standard_normal((E, 3), np.float32)
for n in ("ux", "uy", "uz"):
    arrays[n] = rng.standard_normal((E, NDOF), np.float32)
arrays = {k: jax.numpy.asarray(v) for k, v in arrays.items()}

oracle = [np.einsum("es,sij,ej->ei", arrays[j], arrays["R"], arrays[u])
          for j, u in [("Jx", "ux"), ("Jy", "uy"), ("Jz", "uz")]]


def check(outs, label):
    for got, ref in zip(outs, oracle):
        np.testing.assert_allclose(np.asarray(got), ref,
                                   rtol=2e-4, atol=2e-4)
    print(f"  {label}: OK on {len(jax.devices())} devices")


# 1. pure DP: elements sharded 8 ways, no collectives
mesh = make_mesh({"data": 8})
fn_dp = sharded_einsum_executable(program, mesh, long_dim_length=E)
check(fn_dp(arrays), "data-parallel (8-way element shard)")

# 2. DP x TP (4x2): contracted dof axis split; psum across devices
mesh2 = make_mesh({"data": 4, "model": 2})
fn_tp = reduction_sharded_executable(program, mesh2, long_dim_length=E)
check(fn_tp(arrays), "data x tensor parallel (4x2, psum over dof)")

# 3. row/EP: the x/y/z component rows on different devices (per-row
# operands arrive stacked on a leading row axis; shared R replicates)
mesh3 = make_mesh({"rows": 3})   # one device per component row
fn_ep = row_sharded_executable(program, mesh3, long_dim_length=E)
stacked = {
    "Jx": jax.numpy.stack([arrays["Jx"], arrays["Jy"], arrays["Jz"]]),
    "ux": jax.numpy.stack([arrays["ux"], arrays["uy"], arrays["uz"]])}
check(list(fn_ep(stacked, {"R": arrays["R"]})),
      "row-parallel (3 component rows as experts)")

print("multichip DG operator: all layouts match the numpy oracle")
