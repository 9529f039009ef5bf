"""File compressor front end with the reference's level presets.

Level table re-derived from K/app/BlockCompressor.java:539-574 and default
block sizes from :142-158.  ``device`` is the streams' (io/stream.py): a
torch device for the device stages, or None for the host coders.
"""

from __future__ import annotations

import os

from ..io.stream import CompressedOutputStream

_MB = 1024 * 1024

# level -> (transform chain, entropy codec, default block size)
LEVELS = {
    0: ("NONE", "NONE", 4 * _MB),
    1: ("LZX", "NONE", 4 * _MB),
    2: ("DNA+LZ", "HUFFMAN", 4 * _MB),
    3: ("TEXT+UTF+PACK+MM+LZX", "HUFFMAN", 4 * _MB),
    4: ("TEXT+UTF+EXE+PACK+MM+ROLZ", "NONE", 4 * _MB),
    5: ("TEXT+UTF+BWT+RANK+ZRLT", "ANS0", 4 * _MB),
    6: ("TEXT+UTF+BWT+SRT+ZRLT", "FPAQ", 8 * _MB),
    7: ("LZP+TEXT+UTF+BWT+LZP", "CM", 16 * _MB),
    8: ("EXE+RLT+TEXT+UTF+DNA", "TPAQ", 16 * _MB),
    9: ("EXE+RLT+TEXT+UTF+DNA", "TPAQX", 32 * _MB),
}

_READ_CHUNK = 1024 * 1024


class BlockCompressor:
    def __init__(self, transform: str = "NONE", entropy: str = "NONE",
                 block_size: int = 4 * _MB, jobs: int = 1, checksum: int = 0,
                 skip_blocks: bool = False, verbosity: int = 1,
                 headerless: bool = False, *, device) -> None:
        self.device = device
        self.transform = transform
        self.entropy = entropy
        self.block_size = block_size
        self.jobs = jobs
        self.checksum = checksum
        self.skip_blocks = skip_blocks
        self.verbosity = verbosity
        self.headerless = headerless
        self.listeners: list = []

    def _ctx(self, file_size: int) -> dict:
        return {
            "transform": self.transform,
            "entropy": self.entropy,
            "blockSize": self.block_size,
            "jobs": self.jobs,
            "checksum": self.checksum,
            "skipBlocks": self.skip_blocks,
            "verbosity": self.verbosity,
            "fileSize": file_size,
            "headerless": self.headerless,
        }

    def compress_stream(self, src, dst, file_size: int = 0) -> tuple[int, int]:
        """Compress a binary stream; returns (bytes read, bytes written)."""
        cos = CompressedOutputStream(dst, self._ctx(file_size),
                                     device=self.device)
        for lst in self.listeners:
            cos.add_listener(lst)
        read = 0
        try:
            while True:
                chunk = src.read(_READ_CHUNK)
                if not chunk:
                    break
                read += len(chunk)
                cos.write(chunk)
        finally:
            cos.close()
        return read, cos.written

    def compress_file(self, in_path: str, out_path: str) -> tuple[int, int]:
        size = os.path.getsize(in_path)
        try:
            with open(in_path, "rb") as src, open(out_path, "wb") as dst:
                read, _ = self.compress_stream(src, dst, size)
            return read, os.path.getsize(out_path)
        except Exception:
            # clean up the partial output (BlockCompressor.java:836-842)
            if os.path.exists(out_path):
                try:
                    os.remove(out_path)
                except OSError:
                    pass
            raise

    def compress_bytes(self, data: bytes) -> bytes:
        import io as pyio
        dst = pyio.BytesIO()
        src = pyio.BytesIO(data)
        self.compress_stream(src, dst, len(data))
        return dst.getvalue()
