"""The Pallas kernel emitter (Triton on the GPU) and its storage layouts."""
