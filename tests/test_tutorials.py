"""Execute the tutorials' python code blocks (the reference runs its
tutorial doctests in CI, SURVEY §4 — same contract here: docs that drift
from the API fail the suite).

Blocks run sequentially per file in one shared namespace.  Expensive
constants are substituted down (tuning budget, long-dim length, archive
path → tmp) — substitutions are textual and listed per file so a doc
rewrite that invalidates them fails loudly rather than silently skipping.
"""

import os
import re

import pytest

DOC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "doc")


def blocks_of(path):
    text = open(path).read()
    return re.findall(r"```python\n(.*?)```", text, flags=re.S)


def run_blocks(path, substitutions, preamble=""):
    ns: dict = {}
    if preamble:
        exec(preamble, ns)
    for i, block in enumerate(blocks_of(path)):
        for old, new in substitutions:
            if old in block:
                block = block.replace(old, new)
        try:
            exec(block, ns)
        except Exception as ex:  # noqa: BLE001
            raise AssertionError(
                f"{os.path.basename(path)} block {i} failed:"
                f" {type(ex).__name__}: {ex}\n--- block ---\n{block}")
    return ns


def test_perf_engg_tutorial(tmp_path):
    db = str(tmp_path / "my_archive.sqlite").replace("\\", "/")
    ns = run_blocks(
        os.path.join(DOC, "perf_engg_tutorial.md"),
        substitutions=[
            ("stop_after=600", "stop_after=1"),
            ("long_dim_length=1_000_000", "long_dim_length=20_000"),
            ("E = 1_000_000", "E = 20_000"),
            ('"my_archive.sqlite"', f'"{db}"'),
        ])
    assert "out_rows" in ns and len(ns["out_rows"]) == 3
    # the autotune block really recorded facts the consume block replayed
    import feinsum_tpu.sql_utils as sql_utils
    assert sql_utils.query(ns["einsum"], db_path=db)


def test_compiler_writer_tutorial(tmp_path):
    scratch = str(tmp_path / "tutorial_scratch.sqlite")
    preamble = (
        "import jax.numpy as jnp\n"
        "import numpy as np\n"
        "import feinsum_tpu as f\n"
        "rng = np.random.default_rng(0)\n"
        "example_args = (jnp.asarray(rng.random((3, 3, 512), np.float32)),\n"
        "                jnp.asarray(rng.random((3, 35, 35), np.float32)),\n"
        "                jnp.asarray(rng.random((512, 35), np.float32)))\n"
        "archived_einsum = f.einsum('xre,rij,ej->xei',\n"
        "    f.array('J', (3, 3, 'E'), 'float32'),\n"
        "    f.array('D', (3, 35, 35), 'float32'),\n"
        "    f.array('u', ('E', 35), 'float32'))\n")
    ns = run_blocks(
        os.path.join(DOC, "compiler_writer_tutorial.md"),
        substitutions=[
            # the record block would re-time on this device against the
            # SHIPPED archive; point it at a scratch file instead
            ('db_path="my_archive.sqlite"',
             f'db_path="{scratch}", long_dim_length=2000'),
        ],
        preamble=preamble)
    # the matched einsum found the shipped archive's facts
    assert ns["best"].total_giga_op_rate > 0
    assert ns["subst"]


def test_design_doc_claims_match_code():
    """doc/design.md references real symbols; a rename must update docs."""
    import feinsum_tpu.measure as m
    text = open(os.path.join(DOC, "design.md")).read()
    for sym in re.findall(r"`measure\.(\w+)`", text):
        assert hasattr(m, sym), f"design.md references measure.{sym}"


def test_examples_compile():
    """Every examples/*.py parses and compiles (full runs are GPU-scale;
    the wave/maxwell model paths are exercised by the model tests)."""
    import py_compile
    ex_dir = os.path.join(os.path.dirname(DOC), "examples")
    files = [f for f in os.listdir(ex_dir) if f.endswith(".py")]
    assert len(files) >= 7
    for name in files:
        py_compile.compile(os.path.join(ex_dir, name), doraise=True)


def test_manual_walkthrough_schedules_validate():
    """examples/wave_3d_p4_manual.py (reference wave_3d_p4_manual.py): the
    three hand-written P4 schedules must validate against numpy — the
    example is a real walkthrough, not prose."""
    import importlib
    import sys

    ex_dir = os.path.join(os.path.dirname(DOC), "examples")
    sys.path.insert(0, ex_dir)
    try:
        m = importlib.import_module("wave_3d_p4_manual")
    finally:
        sys.path.remove(ex_dir)
    import feinsum_tpu as f
    for einsum, tr in ((m.make_div(), m.transform_div),
                       (m.make_grad(), m.transform_grad),
                       (m.make_face_mass(), m.transform_face_mass)):
        f.validate_batched_einsum_transform(einsum, tr,
                                            long_dim_length=1024)


def test_api_doc_covers_public_surface():
    """doc/api.md (reference doc/api.rst) must mention every public name;
    regenerate with scripts/gen_api_doc.py after API changes."""
    import inspect

    import feinsum_tpu as f
    text = open(os.path.join(DOC, "api.md")).read()
    for name in dir(f):
        # lazily-imported submodules (e.g. `native` after the first
        # canonicalize) appear in dir() depending on test order; the
        # module map section documents modules by curated list instead
        if name.startswith("_") or inspect.ismodule(getattr(f, name)):
            continue
        assert f"`{name}" in text or f".{name}`" in text, (
            f"doc/api.md is missing {name}; re-run"
            " scripts/gen_api_doc.py")
