"""File decompressor front end (K/app/BlockDecompressor.java:62-792).

``device`` is the streams' (io/stream.py): a torch device for the device
stages, or None for the host coders."""

from __future__ import annotations

import os

from ..io.stream import CompressedInputStream


class BlockDecompressor:
    def __init__(self, jobs: int = 1, verbosity: int = 1,
                 from_block: int = 0, to_block: int = 0,
                 headerless_ctx: dict | None = None, *, device) -> None:
        self.device = device
        self.jobs = jobs
        self.verbosity = verbosity
        self.from_block = from_block
        self.to_block = to_block
        self.headerless_ctx = headerless_ctx
        self.listeners: list = []

    def _ctx(self) -> dict:
        ctx = dict(self.headerless_ctx or {})
        ctx["jobs"] = self.jobs
        ctx["verbosity"] = self.verbosity
        if self.from_block > 0:
            ctx["from"] = self.from_block
        if self.to_block > 0:
            ctx["to"] = self.to_block
        if self.headerless_ctx is not None:
            ctx["headerless"] = True
        return ctx

    def decompress_stream(self, src, dst) -> tuple[int, int]:
        cis = CompressedInputStream(src, self._ctx(), device=self.device)
        for lst in self.listeners:
            cis.add_listener(lst)
        written = 0
        while True:
            chunk = cis.read(1024 * 1024)
            if not chunk:
                break
            dst.write(chunk)
            written += len(chunk)
        cis.close()
        return 0, written

    def decompress_file(self, in_path: str, out_path: str) -> tuple[int, int]:
        read = os.path.getsize(in_path)
        try:
            with open(in_path, "rb") as src, open(out_path, "wb") as dst:
                _, written = self.decompress_stream(src, dst)
            return read, written
        except Exception:
            if os.path.exists(out_path):
                try:
                    os.remove(out_path)
                except OSError:
                    pass
            raise

    def decompress_bytes(self, data: bytes) -> bytes:
        import io as pyio
        dst = pyio.BytesIO()
        self.decompress_stream(pyio.BytesIO(data), dst)
        return dst.getvalue()
