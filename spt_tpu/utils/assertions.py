"""Invariant checks: host-side verify/check + device-side checkify.

Mirrors render_assert.h (/root/reference/libs/render/src/render_assert.h:
15-44): ``verify`` is an always-on invariant check that reports the source
location and raises; ``check`` compiles out when SPT_RELEASE is set
(the RENDER_RELEASE analog).  For traced device code, ``checked_fn`` wraps a
function with jax.experimental.checkify so NaN/OOB/div-by-zero surface as
errors instead of silent garbage — the device-side race/corruption detector
(SURVEY.md §5).
"""

from __future__ import annotations

import inspect
import os


class VerifyError(AssertionError):
    pass


def _location(depth: int = 2) -> str:
    frame = inspect.stack()[depth]
    return f"{frame.filename}:{frame.lineno} in {frame.function}"


def verify(condition: bool, message: str = "verification failed") -> None:
    """Always-on invariant check (render_assert.h:15-25)."""
    if not condition:
        raise VerifyError(f"{message} [{_location()}]")


_RELEASE = bool(int(os.environ.get("SPT_RELEASE", "0")))


def check(condition: bool, message: str = "check failed") -> None:
    """Debug-only invariant check; disabled when SPT_RELEASE=1
    (render_assert.h:28-44)."""
    if _RELEASE:
        return
    if not condition:
        raise VerifyError(f"{message} [{_location()}]")


def checked_fn(fn, errors=None):
    """Wrap a jittable function with checkify (NaN / div / OOB checks).

    Returns g(*args) -> value, raising on the first detected error.  Use in
    tests and debugging sessions; production paths call ``fn`` directly.
    """
    from jax.experimental import checkify

    if errors is None:
        errors = checkify.float_checks | checkify.index_checks
    wrapped = checkify.checkify(fn, errors=errors)

    def g(*args, **kwargs):
        err, out = wrapped(*args, **kwargs)
        err.throw()
        return out

    return g
