"""Progress/tracing event system (re-derived from K/Event.java:25-110 and
K/Listener.java).

Listeners receive typed events at every block stage; ``InfoPrinter`` in the
app layer renders them.  Timestamps are nanoseconds (time.monotonic_ns).

Inside a block's entropy stage the device glue reports finer spans to the
same listeners (the port's own event types, past kanzi's): ``GLUE_WAIT``
(asking for ops/glue.py's lock), ``GLUE_HOLD`` (holding it), ``COPY_IN``
and ``COPY_OUT`` (one copy to or from the card, sized in bytes) and
``CARD_WAIT`` (the host waiting on the card's stream before a fetch).
``encode_block``/``decode_block`` (io/stream.py) open a ``block_context``
on their thread; ``span`` reports to it, and costs no event, clock read or
sync on a thread without listeners.
"""

from __future__ import annotations

import contextlib
import enum
import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Protocol


class EventType(enum.Enum):
    COMPRESSION_START = 0
    DECOMPRESSION_START = 1
    BEFORE_TRANSFORM = 2
    AFTER_TRANSFORM = 3
    BEFORE_ENTROPY = 4
    AFTER_ENTROPY = 5
    COMPRESSION_END = 6
    DECOMPRESSION_END = 7
    AFTER_HEADER_DECODING = 8
    BLOCK_INFO = 9
    BEFORE_GLUE_WAIT = 10
    AFTER_GLUE_WAIT = 11
    BEFORE_GLUE_HOLD = 12
    AFTER_GLUE_HOLD = 13
    BEFORE_COPY_IN = 14
    AFTER_COPY_IN = 15
    BEFORE_CARD_WAIT = 16
    AFTER_CARD_WAIT = 17
    BEFORE_COPY_OUT = 18
    AFTER_COPY_OUT = 19


@dataclass
class HeaderInfo:
    """Stream-header payload for AFTER_HEADER_DECODING (K/Event.java HeaderInfo)."""
    bs_version: int = 0
    checksum_size: int = 0
    block_size: int = 0
    entropy: str = ""
    transform: str = ""
    original_size: int = -1


@dataclass
class Event:
    type: EventType
    block_id: int
    size: int = 0
    hash_value: Optional[int] = None
    time_ns: int = field(default_factory=time.monotonic_ns)
    msg: Optional[str] = None
    offset: int = -1
    skip_flags: int = 0
    header: Optional[HeaderInfo] = None

    def __str__(self) -> str:
        if self.msg is not None:
            return self.msg
        s = f"{{ \"type\":\"{self.type.name}\", \"id\":{self.block_id}, \"size\":{self.size}"
        if self.hash_value is not None:
            s += f", \"hash\":{self.hash_value:08X}"
        if self.offset >= 0:
            s += f", \"offset\":{self.offset}, \"skipFlags\":{self.skip_flags:08b}"
        return s + " }"


class Listener(Protocol):
    def process_event(self, evt: Event) -> None: ...


def notify(listeners, evt: Event) -> None:
    for lst in listeners or ():
        try:
            lst.process_event(evt)
        except Exception:
            pass  # listeners must never break the pipeline


_block = threading.local()   # .ctx: (listeners, block id) of this thread's block


class block_context:
    """The block this thread encodes or decodes, for ``span``: its listeners
    and id, from entry to exit (nested contexts restore the outer one)."""

    def __init__(self, listeners, block_id: int) -> None:
        self.ctx = (listeners, block_id) if listeners else None

    def __enter__(self) -> None:
        self.outer = getattr(_block, "ctx", None)
        _block.ctx = self.ctx

    def __exit__(self, *exc) -> None:
        _block.ctx = self.outer


def traced() -> bool:
    """Whether this thread's block has listeners."""
    return getattr(_block, "ctx", None) is not None


class _Span:
    __slots__ = ("listeners", "block_id", "kind", "size")

    def __init__(self, ctx, kind: str, size: int) -> None:
        self.listeners, self.block_id = ctx
        self.kind = kind
        self.size = size

    def __enter__(self) -> None:
        notify(self.listeners, Event(EventType["BEFORE_" + self.kind], self.block_id,
                                     self.size))

    def __exit__(self, *exc) -> None:
        notify(self.listeners, Event(EventType["AFTER_" + self.kind], self.block_id,
                                     self.size))


_UNTRACED = contextlib.nullcontext()


def span(kind: str, size: int = 0):
    """A context manager that reports BEFORE_<kind> and AFTER_<kind> (kind
    ``GLUE_WAIT``, ``GLUE_HOLD``, ``COPY_IN``, ``CARD_WAIT`` or ``COPY_OUT``)
    with ``size`` to this thread's block's listeners; nothing without them."""
    ctx = getattr(_block, "ctx", None)
    return _UNTRACED if ctx is None else _Span(ctx, kind, size)
