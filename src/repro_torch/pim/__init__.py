"""repro_torch.pim — the UPMEM-host-API-shaped session façade on one GPU
(DESIGN.md §9), the PyTorch counterpart of ``repro.pim``.

Allocate banks with :func:`session` (on ``cuda:0``, or ``device="cpu"``
when asked), launch with ``run``/``submit``/``map``, inspect
``telemetry``/``stats()``, release with ``close()``.
``repro_torch.runtime`` stays the internal layer underneath.  The QoS
surface (DESIGN.md §13) is re-exported here: :class:`RequestOptions`
rides on ``run``/``submit``/``map``, and :class:`QueueFull` /
:class:`DeadlineExpired` are the shed / expired outcomes a request's
``result()`` can raise.

:class:`DecodeEngine` is the LLM decode serving tier built on the session
(session-resident weights, one tenant per decode stream).  It lives in
:mod:`repro_torch.pim.decode` and is imported lazily here, pulling the
model stack only when decode serving is used.
"""
from repro_torch.runtime.qos import DeadlineExpired, QueueFull, RequestOptions
from repro_torch.runtime.resident import ResidentHandle

from .session import PimSession, registry, session

__all__ = ["DeadlineExpired", "DecodeEngine", "PimSession", "QueueFull",
           "RequestOptions", "ResidentHandle", "StepRecord", "registry",
           "session"]


def __getattr__(name: str):
    if name in ("DecodeEngine", "StepRecord"):
        from . import decode
        return getattr(decode, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
