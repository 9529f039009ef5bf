"""The control and the planted faults that show ``correct`` can fail.

Each is a context manager that patches the program in memory for one
run of the harness (``lib/harness.run_cell``); none is on the
benchmark's path.  ``portbench/control.py`` runs them on the card at the
cells' own sizes, ``tests/test_portbench_faults.py`` on the CPU at small
ones.

control
    The guarantee broken: kanzi's readers take the stream.  The writer
    XORs every block's entropy payload with 0x5A and the reader undoes
    it, so the port reads its own streams back exactly, as a port-only
    wire layout of the device stage would; only the reference sees it.
token
    A token altered where it is produced: one byte in the middle of
    every block's entropy payload flipped by the writer.
answer
    An answer altered where it is produced: one byte of every block the
    reader decodes flipped.
state
    A step that returns its state unchanged: the transform chain hands
    the entropy stage the block as it came in, flagged as transformed.
half
    Half of the batch left out: the writer drops every other block it
    commits (counted over streams, so one-block streams lose every other
    block too).

The exchange between chips is no fault of these one-chip cells.
"""

from __future__ import annotations

import contextlib

import numpy as np

MODES = ("control", "token", "answer", "state", "half")


def _payload_start(arr: np.ndarray) -> int:
    """Byte offset of the entropy payload in a packed block (its header:
    mode, the skip byte of chains over four stages, the length, the
    header checksum; no block hash in these configurations)."""
    mode = int(arr[0])
    skip = 1 if mode & 0x10 else 0
    return 1 + skip + ((mode >> 5) & 3) + 1 + 1


def _xor_payload(arr: np.ndarray, nbits: int, middle_only: bool = False) -> np.ndarray:
    out = arr.copy()
    lo = _payload_start(out)
    hi = nbits >> 3                        # whole bytes only
    if hi <= lo:
        return out
    if middle_only:
        out[lo + (hi - lo) // 2] ^= 0xFF
    else:
        out[lo:hi] ^= 0x5A
    return out


@contextlib.contextmanager
def planted(mode: str):
    from kanzi_tpu_torch.io import stream as S
    from kanzi_tpu_torch.transforms import factory as F
    saved = (S.encode_block, S.decode_block, F.Sequence.forward,
             S.CompressedOutputStream._commit)
    enc, dec = S.encode_block, S.decode_block
    try:
        if mode == "control":
            def encode_block(*a, **kw):
                arr, nbits = enc(*a, **kw)
                return _xor_payload(arr, nbits), nbits

            def decode_block(payload, nbits, *a, **kw):
                return dec(_xor_payload(payload, nbits), nbits, *a, **kw)
            S.encode_block, S.decode_block = encode_block, decode_block
        elif mode == "token":
            def encode_block(*a, **kw):
                arr, nbits = enc(*a, **kw)
                return _xor_payload(arr, nbits, middle_only=True), nbits
            S.encode_block = encode_block
        elif mode == "answer":
            def decode_block(*a, **kw):
                out = dec(*a, **kw).copy()
                if out.size:
                    out[out.size // 2] ^= 0xFF
                return out
            S.decode_block = decode_block
        elif mode == "state":
            fwd = F.Sequence.forward

            def forward(self, src):
                fwd(self, src)
                return np.asarray(src, dtype=np.uint8).copy()
            F.Sequence.forward = forward
        elif mode == "half":
            commit = S.CompressedOutputStream._commit
            seen = [0]

            def _commit(self, result):
                seen[0] += 1                  # counted over every stream
                if seen[0] % 2:
                    commit(self, result)
            S.CompressedOutputStream._commit = _commit
        else:
            raise ValueError(f"unknown mode {mode!r}; modes: {', '.join(MODES)}")
        yield
    finally:
        (S.encode_block, S.decode_block, F.Sequence.forward,
         S.CompressedOutputStream._commit) = saved
