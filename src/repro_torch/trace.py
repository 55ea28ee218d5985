"""Spans on the profiler's clock: named ranges at the port's layer
boundaries (the serving tier's admission and batch step, the ivf search's
stages), recorded only while a ``torch.profiler`` records.

While a profiler records, ``span(name)`` is a record-function range
``rt.<name>``: it lands in the same trace as the kernels it launches, on
the same clock, so each idle gap of the card can be put down to what the
port's host code was doing.  The range is PyTorch's fast one
(``RecordFunctionFast``, a ``cpu_op`` event in the trace): on an H100
host ``torch.profiler.record_function`` costs ~12 µs a range while a
profiler records, which slowed a traced serving window by a fifth with one
range per admitted request; the fast one costs ~1.5 µs.  Otherwise
``span`` returns one shared null context and no torch call is made.
Nothing switches it on but the profiler itself.
"""
from __future__ import annotations

import contextlib

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

#: every span's name in the trace starts with this
PREFIX = "rt."

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager naming ``rt.<name>`` in a running profiler's
    trace, or a shared no-op one when no profiler records."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _RecordFunctionFast(PREFIX + name)
