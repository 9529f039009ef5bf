"""Progress/tracing event system (re-derived from K/Event.java:25-110 and
K/Listener.java).

Listeners receive typed events at every block stage; ``InfoPrinter`` in the
app layer renders them.  Timestamps are nanoseconds (time.monotonic_ns).
"""

from __future__ import annotations

import enum
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
