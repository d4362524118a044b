"""
Static per-device peak tables for roofline modeling
(parity: reference ``feinsum/data/device_info.py:5-26``).

Keys are :func:`sanitize_device_name` of the device kind JAX reports.  The
NVIDIA H100 row is the card this system runs on; the TITAN V, GTX 1650 and
H200 NVL rows mirror the reference's table so its archived facts remain
interpretable.  A device not in the tables is an error wherever a peak is
needed, never a default.
"""

from __future__ import annotations

# peak GFLOP/s by dtype
DEV_TO_PEAK_GFLOPS = {
    # NVIDIA H100 SXM5 data sheet, dense rates.  float64 67 TF is the
    # tensor-core (DMMA) rate, 34 TF outside them; float32 67 TF is the
    # CUDA-core rate (IEEE fp32), tfloat32 495 TF the tensor cores' TF32.
    "NVIDIA_H100_80GB_HBM3": {
        "float64": 67_000.0,
        "float32": 67_000.0,
        "tfloat32": 495_000.0,
        "bfloat16": 989_000.0,
        "float16": 989_000.0,
        "complex64": 67_000.0,
        "complex128": 67_000.0,
    },
    # --- reference GPUs (from the reference's table) ---
    "NVIDIA_TITAN_V": {
        "float32": 12_288.0,
        "float64": 6_144.0,
        "complex64": 12_288.0,
        "complex128": 6_144.0,
    },
    "NVIDIA_GEFORCE_GTX_1650": {
        "float32": 3_916.8,
        "float64": 122.4,
    },
    "NVIDIA_H200_NVL": {
        "float32": 67_000.0,
        "float64": 34_000.0,
    },
}

# peak HBM bandwidth, GB/s
DEV_TO_PEAK_BW = {
    "NVIDIA_H100_80GB_HBM3": 3_350.0,     # H100 SXM5 data sheet
    "NVIDIA_TITAN_V": 652.8,
    "NVIDIA_GEFORCE_GTX_1650": 192.0,
    "NVIDIA_H200_NVL": 4_800.0,
}

# Hopper per-block limits (H100 data sheet / Hopper tuning guide): the
# shared memory one thread block may use, and the L2 cache size.  Schedule
# spaces guard on the first; timing loops size their input rotation from
# the second.
SMEM_BYTES_PER_BLOCK = 227 * 1024
L2_BYTES = 50 * 1024 * 1024


def sanitize_device_name(name: str) -> str:
    """'NVIDIA H100 80GB HBM3' -> 'NVIDIA_H100_80GB_HBM3' (reference
    sql_utils.py:122-132)."""
    return name.strip().replace(" ", "_").replace("-", "_")


def get_device_key(device=None) -> str:
    """Roofline-table key for *device* (a jax Device, a str, or anything with
    ``.device_kind``/``.name``); defaults to jax's first device."""
    if device is None:
        import jax
        device = jax.devices()[0]
    if isinstance(device, str):
        return sanitize_device_name(device)
    kind = getattr(device, "device_kind", None) or getattr(device, "name", "")
    return sanitize_device_name(str(kind))
