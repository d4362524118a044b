"""What the GPU bring-up added around the kernel, tested on the CPU: the
device table and its unknown-device errors, the host-clock timer, the
compile-cache placement, explicit split precisions, native fp64 through
XLA, the timing-protocol tag, stored-layout sharding, and chip_smoke.py's
phases at a tiny size (Pallas in interpret mode)."""

import importlib
import os
import sys
import time

import numpy as np
import pytest

import feinsum_tpu as f
from feinsum_tpu.diagnostics import (NoDevicePeaksInfoError,
                                     TimingBelowFloorError)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def chip_smoke():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    return importlib.import_module("chip_smoke")


# {{{ device table

def test_h100_row():
    from feinsum_tpu.data.device_info import (
        DEV_TO_PEAK_BW, DEV_TO_PEAK_GFLOPS, L2_BYTES, SMEM_BYTES_PER_BLOCK,
        get_device_key)
    key = get_device_key(f.FakeDevice("NVIDIA H100 80GB HBM3"))
    assert key == "NVIDIA_H100_80GB_HBM3"
    peaks = DEV_TO_PEAK_GFLOPS[key]
    assert (peaks["float64"], peaks["float32"], peaks["tfloat32"],
            peaks["bfloat16"]) == (67_000.0, 67_000.0, 495_000.0, 989_000.0)
    assert DEV_TO_PEAK_BW[key] == 3_350.0
    assert SMEM_BYTES_PER_BLOCK == 227 * 1024
    assert L2_BYTES == 50 * 1024 * 1024


def test_h100_roofline_is_bandwidth_bound_for_dg_grad():
    e = chip_smoke().dg_classes(35)["grad"]
    roof = f.get_roofline_flop_rate(e, "NVIDIA H100 80GB HBM3",
                                    long_dim_length=1_000_000)
    from feinsum_tpu.measure import evaluate_giga_op_map
    gops = sum(evaluate_giga_op_map(f.get_giga_op_map(e),
                                    1_000_000).values())
    gbytes = f.get_footprint_gbytes(e, long_dim_length=1_000_000)
    assert roof == pytest.approx(gops / (gbytes / 3350.0))


@pytest.mark.parametrize("device", ["NVIDIA A100-SXM4-80GB", "cpu", "bogus"])
def test_unknown_device_raises_everywhere(device):
    from feinsum_tpu.measure import _bytes_floor_seconds
    e = chip_smoke().dg_classes(4)["mass"]
    with pytest.raises(NoDevicePeaksInfoError):
        f.get_roofline_flop_rate(e, device)
    with pytest.raises(NoDevicePeaksInfoError):
        _bytes_floor_seconds({"a": np.zeros(4, np.float32)}, (), device)

# }}}


# {{{ host-clock timer

def test_median_launch_seconds_blocks_and_takes_the_median():
    from feinsum_tpu.measure import _median_launch_seconds
    calls = []

    def fn(arrays):
        calls.append(1)
        time.sleep(0.002 if len(calls) % 2 else 0.004)
        return np.zeros(1)

    dt = _median_launch_seconds(fn, {}, n_launches=5, n_warmup=2)
    assert len(calls) == 7
    assert 0.0015 < dt < 0.05


def test_timer_below_the_bandwidth_floor_raises(monkeypatch):
    from feinsum_tpu import measure
    monkeypatch.setattr(measure, "_median_launch_seconds",
                        lambda fn, arrays, n_launches: 1e-9)
    monkeypatch.setattr(measure, "_bytes_floor_seconds",
                        lambda arrays, outs: 1e-6)
    with pytest.raises(TimingBelowFloorError):
        measure.timeit_on_device(lambda a: np.zeros(1), {})
    monkeypatch.setattr(measure, "_median_launch_seconds",
                        lambda fn, arrays, n_launches: 2e-6)
    assert measure.timeit_on_device(lambda a: np.zeros(1), {}) == 2e-6


def test_bytes_floor_counts_inputs_and_outputs():
    from feinsum_tpu.measure import _bytes_floor_seconds
    arrays = {"a": np.zeros((1000, 35), np.float32)}
    outs = (np.zeros((1000, 35), np.float64),)
    got = _bytes_floor_seconds(arrays, outs, "NVIDIA H100 80GB HBM3")
    assert got == pytest.approx((1000 * 35 * 12) / 3350e9)

# }}}


# {{{ compile cache and precisions

@pytest.fixture
def restore_cache_dir():
    import jax
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_defaults_inside_the_checkout(monkeypatch,
                                                    restore_cache_dir):
    import jax
    from feinsum_tpu.codegen.program import default_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    f.enable_persistent_compilation_cache()
    assert default_compilation_cache_dir() == os.path.join(ROOT,
                                                           ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == os.path.join(
        ROOT, ".jax_cache")


def test_compile_cache_follows_the_environment(monkeypatch, tmp_path,
                                               restore_cache_dir):
    import jax
    jax.config.update("jax_compilation_cache_dir", "unchanged")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    f.enable_persistent_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == "unchanged"


@pytest.mark.parametrize("name,expected", [
    ("bf16_3x", "HIGHEST"), ("tf32_3x", "HIGHEST"), ("default", "HIGHEST"),
    ("highest", "HIGHEST")])
def test_xla_split_precisions_are_explicit(name, expected):
    """On the CPU the split algorithms run at HIGHEST; nothing maps to the
    single-pass Precision.HIGH any more."""
    from feinsum_tpu.codegen.program import _precision
    assert _precision(name).name == expected


def test_xla_split_precisions_name_the_preset_on_gpu(monkeypatch):
    import jax
    from feinsum_tpu.codegen.program import _precision
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert _precision("bf16_3x") == jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
    assert _precision("tf32_3x") == jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3


@pytest.mark.parametrize("name", ["div", "grad", "face", "mass", "curl"])
def test_fp64_through_xla_meets_1e_12(name):
    cs = chip_smoke()
    e = cs.dg_classes(35, "float64")[name]
    err = cs.run_and_compare(e, cs.xla_program(e), 300, rtol=1e-12,
                             atol_frac=1e-12)
    assert err < 1e-12

# }}}


def test_compiler_version_names_the_timing_protocol():
    from feinsum_tpu import sql_utils
    v = sql_utils.dump_compiler_version()
    assert v.endswith("-timing-proto4")
    assert sql_utils._protocol_of(v) == 4
    assert sql_utils._protocol_of("jax-x") == 0


def test_sharded_dofmajor_program_shards_the_stored_layout():
    """An out_layout program's outputs are sharded along the long axis of
    their STORED layout."""
    import jax
    from feinsum_tpu.measure import _numpy_oracle, generate_input_arrays
    from feinsum_tpu.parallel import make_mesh, sharded_einsum_executable
    e = chip_smoke().dg_classes(10)["grad"]
    prog = f.generate_program_with_opt_einsum_schedule(e)
    from feinsum_tpu.ops.layouts import dofmajor_layouts
    layouts, out_perm = dofmajor_layouts(e)
    prog = prog.with_descriptor(arg_layouts=layouts, out_layout=out_perm)
    raw = generate_input_arrays(e, long_dim_length=64, as_numpy=True)
    fn = sharded_einsum_executable(prog, make_mesh({"data": 4}),
                                   long_dim_length=64)
    (out,) = fn({k: jax.device_put(v)
                 for k, v in f.apply_layouts(prog, raw).items()})
    (ref,) = _numpy_oracle(e, raw)
    got = f.unpack_output(prog, np.asarray(out), ref.shape)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


# {{{ chip_smoke.py phases, rehearsed at a tiny size

def test_chip_smoke_refuses_the_cpu(capsys):
    cs = chip_smoke()
    with pytest.raises(SystemExit, match="needs a GPU"):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_kernel_phase(capsys):
    chip_smoke().phase_kernels(200, extra_ndofs=(4,))
    out = capsys.readouterr().out
    assert out.count("phase 2 kernel") == 7


def test_chip_smoke_fp64_phase(capsys):
    chip_smoke().phase_fp64(100)
    assert capsys.readouterr().out.count("phase 3 fp64") == 5


def test_chip_smoke_wave_phase(capsys):
    chip_smoke().phase_wave(128, steps=2)
    assert "kernel vs XLA" in capsys.readouterr().out


def test_chip_smoke_consumer_phase(capsys):
    chip_smoke().phase_consumer(128)
    out = capsys.readouterr().out
    assert "backends ['xla']" in out      # the shipped archive misses


def test_chip_smoke_archive_phase(tmp_path, capsys):
    chip_smoke().phase_archive(128, 256, out_dir=str(tmp_path))
    assert "hit replayed" in capsys.readouterr().out


def test_chip_smoke_timing_phase():
    times = chip_smoke().phase_timing(128, "cpu rehearsal", n_launches=2)
    assert set(times) == {"div", "grad", "face", "mass", "curl",
                          "wave_step"}
    assert all(t["kernel"] > 0 and t["xla"] > 0 for t in times.values())


def test_chip_smoke_tccg_phase(capsys):
    times = chip_smoke().phase_tccg(
        "cpu rehearsal", f.FakeDevice("NVIDIA H100 80GB HBM3"), ids=(2,),
        n_launches=2)
    assert times["tccg_02"] > 0
    assert "% of the data-sheet roofline" in capsys.readouterr().out


def test_chip_smoke_sharded_phase(capsys):
    chip_smoke().phase_sharded(4 * 128)
    assert capsys.readouterr().out.count("matches one card") == 2

# }}}
