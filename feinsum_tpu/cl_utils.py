"""
Device shims (parity: reference ``feinsum/cl_utils.py``): anything with a
``.name``/``.device_kind`` works as a device for archive queries, so the DB
can be consulted without the hardware (reference ``FakeCLDevice``, used in
doc/compiler_writer_tutorial.rst)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, runtime_checkable


@runtime_checkable
class DeviceT(Protocol):
    name: str


@dataclass(frozen=True)
class FakeDevice:
    """Query the transform archive for a device you don't have, e.g.
    ``FakeDevice("NVIDIA H100 80GB HBM3")``."""

    name: str

    @property
    def device_kind(self) -> str:
        return self.name


# reference-compatible alias
FakeCLDevice = FakeDevice
