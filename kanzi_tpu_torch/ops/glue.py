"""What the entropy stages' host glue shares (ops/ans_block.py,
ops/huffman_block.py): one lock around a block's glue, and a block's wire
written under it as one packed segment."""

from __future__ import annotations

import contextlib
import threading

from ..core.bits import BitWriter
from ..core.events import span

# The glue is Python and numpy under the GIL.  When the stream's pool threads
# interleave it, every numpy call hands the GIL to another thread, which
# doubled its CPU time at 8 threads; run one block's glue at a time, while
# the other threads' native work (transforms, the host's C++ coders) goes on
# beside it.
GLUE_LOCK = threading.Lock()


@contextlib.contextmanager
def glue_lock():
    """Hold GLUE_LOCK for the block; its listeners get the wait for it as a
    GLUE_WAIT span and the hold as a GLUE_HOLD span, closed before the
    release."""
    with span("GLUE_WAIT"):
        GLUE_LOCK.acquire()
    try:
        with span("GLUE_HOLD"):
            yield
    finally:
        GLUE_LOCK.release()


def write_locked(bw: BitWriter, write):
    """``write(wire)`` into a fresh BitWriter under glue_lock(), the wire
    packed there too, so that the caller's writer does not pack its small
    header segments outside the lock; then the packed wire appended to
    ``bw`` as one segment.  Returns what ``write`` returned."""
    with glue_lock():
        wire = BitWriter()
        res = write(wire)
        arr, nbits = wire.getvalue_packed()
    bw.write_bytes(arr, nbits=nbits)
    return res
