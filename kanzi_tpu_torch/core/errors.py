"""Error codes and exception types (re-derived from K/Error.java:29-124 and
K/BitStreamException.java)."""

from __future__ import annotations


class Error:
    """Numeric process exit / error codes."""

    ERR_MISSING_PARAM = 1
    ERR_BLOCK_SIZE = 2
    ERR_INVALID_CODEC = 3
    ERR_CREATE_COMPRESSOR = 4
    ERR_CREATE_DECOMPRESSOR = 5
    ERR_OUTPUT_IS_DIR = 6
    ERR_OVERWRITE_FILE = 7
    ERR_CREATE_FILE = 8
    ERR_CREATE_BITSTREAM = 9
    ERR_OPEN_FILE = 10
    ERR_READ_FILE = 11
    ERR_WRITE_FILE = 12
    ERR_PROCESS_BLOCK = 13
    ERR_CREATE_CODEC = 14
    ERR_INVALID_FILE = 15
    ERR_STREAM_VERSION = 16
    ERR_CREATE_STREAM = 17
    ERR_INVALID_PARAM = 18
    ERR_CRC_CHECK = 19
    ERR_UNKNOWN = 127


class KanziError(Exception):
    """Base error carrying a numeric error code."""

    def __init__(self, message: str, code: int = Error.ERR_UNKNOWN) -> None:
        super().__init__(message)
        self.code = code


class BitStreamError(KanziError):
    """Bitstream-level failure (K/BitStreamException.java)."""

    UNDEFINED = 0
    INPUT_OUTPUT = 1
    END_OF_STREAM = 2
    INVALID_STREAM = 3
    STREAM_CLOSED = 4

    def __init__(self, message: str, error_type: int = UNDEFINED) -> None:
        super().__init__(message, Error.ERR_CREATE_BITSTREAM)
        self.error_type = error_type


class IOError_(KanziError):
    """Stream engine failure (K/io/KanziIOException.java)."""
