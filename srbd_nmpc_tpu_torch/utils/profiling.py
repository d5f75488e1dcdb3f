"""Named spans of a solve on the profiler's timeline (counterpart of
``srbd_nmpc_tpu/utils/profiling.annotate``).

``span(name)`` is a PyTorch ``RecordFunction`` range named ``srbd::<name>``
while a profiler records (``torch.autograd._profiler_enabled()``): a
``torch.profiler.profile`` holds it among its host events, on the clock of
its CUDA kernel records, and under ``torch.autograd.profiler.emit_nvtx()``
it is an NVTX range for Nsight Systems. With no profiler it is one check
and a shared no-op context: no name is built, nothing is allocated, the
device is never read.

The range is the operator scope's (``_RecordFunctionFast``), the one every
aten operation records in, and not ``record_function``'s user scope: for
each user-scope range the CUDA profiler also writes a device-side event
that spans the kernels launched inside it (``gpu_user_annotation``), which
a reader of the device's busy time would take for a kernel.
"""

from __future__ import annotations

import contextlib
from typing import Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

# what ``span`` returns while no profiler records
NO_SPAN = contextlib.nullcontext()


def span(name: str, width: Optional[int] = None):
    """The range ``srbd::<name>``, or ``srbd::<name>[<width>]`` where the
    span launches ``width`` lanes; ``NO_SPAN`` with no profiler."""
    if not _profiler_enabled():
        return NO_SPAN
    return _RecordFunctionFast(
        f"srbd::{name}" if width is None else f"srbd::{name}[{width}]")
