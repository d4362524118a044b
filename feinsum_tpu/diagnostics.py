"""Exception taxonomy (parity: ``feinsum/diagnostics.py:33-65``)."""

from __future__ import annotations


class FeinsumTPUError(Exception):
    """Base class for all feinsum_tpu errors."""


class EinsumMatchError(FeinsumTPUError):
    """Raised when a user program cannot be matched against the batched-einsum
    grammar (analog of the reference's ``EinsumTunitMatchError``)."""


# Reference-compatible alias
EinsumTunitMatchError = EinsumMatchError


class InvalidParameterError(FeinsumTPUError):
    """Raised by a transform when a tuning point lies in the declared parameter
    space but is illegal for the target hardware (e.g. exceeds the shared
    memory of a block)."""


class NoDevicePeaksInfoError(FeinsumTPUError):
    """Raised when the roofline tables have no entry for a device."""


class TransformValidationError(FeinsumTPUError):
    """Raised when a transformed kernel's output mismatches the reference
    einsum evaluation."""


class NoFactInDatabaseError(FeinsumTPUError):
    """Raised when the transform archive contains no fact for a query."""


class TimingBelowFloorError(FeinsumTPUError):
    """Raised when a measured launch time is below the bandwidth floor of
    the bytes it must move — a broken measurement, never a result."""
