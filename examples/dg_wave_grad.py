"""DG wave-operator gradient einsum: validate + time + roofline
(reference: examples/dg_wave_grad.py)."""
import feinsum_tpu as f

NDIM = 3
NDOF = 20  # P3

einsum = f.einsum("xre,rij,ej->xei",
                  f.array("J", (NDIM, NDIM, "E"), "float32"),
                  f.array("D", (NDIM, NDOF, NDOF), "float32"),
                  f.array("u", ("E", NDOF), "float32"))


def variant_0(program):
    """XLA backend with the hoisted (opt_einsum) schedule at HIGHEST
    precision (IEEE f32 dots)."""
    return f.generate_program_with_opt_einsum_schedule(
        program.einsum).with_descriptor(precision="highest")


def variant_1(program):
    """Fused Pallas kernel: one program per 128-element block, all
    contraction steps on chip."""
    return f.generate_program_with_opt_einsum_schedule(
        program.einsum).with_descriptor(backend="pallas", block_long=128)


if __name__ == "__main__":
    # run on the GPU (the roofline needs the card's table row)
    for name, variant in [("xla-hoisted", variant_0),
                          ("pallas-fused", variant_1)]:
        print(f"==== {name} ====")
        print(f.stringify_comparison_vs_roofline(
            einsum, transform=variant, long_dim_length=1_000_000))
