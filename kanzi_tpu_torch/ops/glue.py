"""What the entropy stages' host glue shares (ops/ans_block.py,
ops/huffman_block.py): one lock around a block's glue, and header parsing
from a window of the reader."""

from __future__ import annotations

import contextlib
import threading

from ..core.bits import BitReader
from ..core.events import span

HEADER_WINDOW = 1024   # an ANS0 chunk header is < 530 bytes, a Huffman one < 300

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


def read_windowed(br: BitReader, parse, *args):
    """``parse(sub, *args)`` on a reader over the next HEADER_WINDOW bytes of
    ``br`` only, then advance ``br`` past what it read.  BitReader.read_bits_vec
    copies its whole buffer on every call, which made a block's per-chunk
    header parse quadratic; a header that runs past the window raises
    EOFError, as a truncated stream does."""
    pos = br.read_count
    skip = pos & 7
    nbits = min(br.remaining + skip, HEADER_WINDOW * 8)
    sub = BitReader(br._data[pos >> 3:(pos >> 3) + HEADER_WINDOW], nbits=nbits,
                    bitpos=skip)
    res = parse(sub, *args)
    br.seek(pos + sub.read_count - skip)
    return res
