"""DG face-mass / lift operator einsum (reference:
examples/dg_wave_face_mass.py)."""
import feinsum_tpu as f

NVOLDOF = 35
NFACEDOF = 15
NFACES = 4

einsum = f.einsum("ifj,fe,fej->ei",
                  f.array("L", (NVOLDOF, NFACES, NFACEDOF), "float32"),
                  f.array("Fj", (NFACES, "E"), "float32"),
                  f.array("flux", (NFACES, "E", NFACEDOF), "float32"))


def variant_1(program):
    return f.generate_program_with_opt_einsum_schedule(
        program.einsum).with_descriptor(backend="pallas", block_long=128)


if __name__ == "__main__":
    # run on the GPU (the roofline needs the card's table row)
    print(f.stringify_comparison_vs_roofline(
        einsum, transform=variant_1, long_dim_length=1_000_000))
