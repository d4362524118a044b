"""DG wave-operator divergence (batched, b=3): validate + time + roofline
(reference: examples/dg_wave_div.py)."""
import feinsum_tpu as f

NDIM = 3
NDOF = 35  # P4

einsum = f.batched_einsum(
    "es,sij,ej->ei",
    [[f.array(jn, ("E", NDIM), "float32"),
      f.array("R", (NDIM, NDOF, NDOF), "float32"),
      f.array(un, ("E", NDOF), "float32")]
     for jn, un in [("Jx", "ux"), ("Jy", "uy"), ("Jz", "uz")]])


def variant_1(program):
    return f.generate_program_with_opt_einsum_schedule(
        program.einsum).with_descriptor(backend="pallas", block_long=128)


if __name__ == "__main__":
    # run on the GPU (the roofline needs the card's table row); E = 1M
    # elements is the streaming regime, far past the 50 MB L2
    print(f.stringify_comparison_vs_roofline(
        einsum, transform=variant_1, long_dim_length=1_000_000))
