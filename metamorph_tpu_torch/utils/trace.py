"""Spans of the port's phases on the host clock, off by default.

    from metamorph_tpu_torch.utils import trace
    trace.enable()
    with trace.span("serve.admit", bucket=512, uids=[7, 9]):
        ...
    spans = trace.drain()      # plain data; the buffer is cleared

A span records its name, `t0`/`t1` from `time.perf_counter_ns()`, its
`id`, the `parent` id of the span that was open around it on the same
thread (its cause; None at the top), the `thread` and its attrs: plain
host values, so that recording never waits for the device.

`perf_counter_ns` is the clock a device trace can be put on (a marker
kernel launched at a noted host time gives the offset), so each span can
be laid against the device's operations and idle gaps without a
conversion.

The recorder is module-level, because the phases it times sit in plain
functions (`train/train_step.accum_train_step`) with no object to carry
one. Off, `span()` returns one shared no-op object after a flag check.
On, at most `_CAP` spans are kept until `drain()`: a process left tracing
cannot grow without bound, and the spans it dropped are counted. The
buffer, the ids and the drop count change under one lock; each thread
keeps its own stack of open spans.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List

_CAP = 200_000            # spans kept between two drains
_on = False
_spans: List[Dict] = []
_dropped = 0
_ids = itertools.count()
_lock = threading.Lock()
_local = threading.local()


class _NoSpan:
    """What `span()` returns when nothing is recorded."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP = _NoSpan()


class _Span:
    __slots__ = ("rec", "stack")

    def __init__(self, rec: Dict, stack: List[int]):
        self.rec, self.stack = rec, stack

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.rec["t1"] = time.perf_counter_ns()
        self.stack.pop()
        return False

    def set(self, **attrs) -> None:
        """Attrs known only inside the span (what a phase found)."""
        self.rec["attrs"].update(attrs)


def enable() -> None:
    """Start recording (again)."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until `drain()`."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(name: str, **attrs):
    """A context manager timing one phase; a no-op while tracing is off.
    Nest spans to give a phase its cause."""
    global _dropped
    if not _on:
        return _NOOP
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    with _lock:
        if len(_spans) >= _CAP:
            _dropped += 1
            return _NOOP
        rec = dict(name=name, id=next(_ids),
                   parent=stack[-1] if stack else None,
                   thread=threading.get_ident(), t0=0, t1=None, attrs=attrs)
        _spans.append(rec)
    stack.append(rec["id"])
    rec["t0"] = time.perf_counter_ns()
    return _Span(rec, stack)


def dropped() -> int:
    """Spans not recorded since the last `drain()` because `_CAP` was
    reached."""
    return _dropped


def drain() -> List[Dict]:
    """The recorded spans in the order they opened, as plain data, and
    clears them and the drop count. A span still open has `t1` None."""
    global _spans, _dropped
    with _lock:
        out, _spans, _dropped = _spans, [], 0
    return out
