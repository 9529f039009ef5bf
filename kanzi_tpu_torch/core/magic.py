"""File-type magic numbers (re-derived from K/Magic.java:26-258)."""

from __future__ import annotations

NO_MAGIC = 0
JPG_MAGIC = 0xFFD8FFE0
GIF_MAGIC = 0x47494638
PDF_MAGIC = 0x25504446
ZIP_MAGIC = 0x504B0304
LZMA_MAGIC = 0x377ABCAF
PNG_MAGIC = 0x89504E47
ELF_MAGIC = 0x7F454C46
MAC_MAGIC32 = 0xFEEDFACE
MAC_CIGAM32 = 0xCEFAEDFE
MAC_MAGIC64 = 0xFEEDFACF
MAC_CIGAM64 = 0xCFFAEDFE
ZSTD_MAGIC = 0x28B52FFD
BROTLI_MAGIC = 0x81CFB2CE
RIFF_MAGIC = 0x52494646
CAB_MAGIC = 0x4D534346
FLAC_MAGIC = 0x664C6143
XZ_MAGIC = 0xFD377A58
RAR_MAGIC = 0x52617221
KNZ_MAGIC = 0x4B414E5A  # "KANZ"
BZIP2_MAGIC = 0x425A68
MP3_ID3_MAGIC = 0x494433
GZIP_MAGIC = 0x1F8B
BMP_MAGIC = 0x424D
WIN_MAGIC = 0x4D5A
PBM_MAGIC = 0x5034
PGM_MAGIC = 0x5035
PPM_MAGIC = 0x5036

_KEYS32 = frozenset([GIF_MAGIC, PDF_MAGIC, ZIP_MAGIC, LZMA_MAGIC, PNG_MAGIC,
                     ELF_MAGIC, MAC_MAGIC32, MAC_CIGAM32, MAC_MAGIC64, MAC_CIGAM64,
                     ZSTD_MAGIC, BROTLI_MAGIC, CAB_MAGIC, RIFF_MAGIC, FLAC_MAGIC,
                     XZ_MAGIC, KNZ_MAGIC, RAR_MAGIC])
_KEYS16 = frozenset([GZIP_MAGIC, BMP_MAGIC, WIN_MAGIC])

_COMPRESSED = frozenset([JPG_MAGIC, GIF_MAGIC, PNG_MAGIC, LZMA_MAGIC, ZSTD_MAGIC,
                         BROTLI_MAGIC, CAB_MAGIC, ZIP_MAGIC, GZIP_MAGIC, BZIP2_MAGIC,
                         FLAC_MAGIC, MP3_ID3_MAGIC, XZ_MAGIC, KNZ_MAGIC, RAR_MAGIC])
_MULTIMEDIA = frozenset([JPG_MAGIC, GIF_MAGIC, PNG_MAGIC, RIFF_MAGIC, FLAC_MAGIC,
                         MP3_ID3_MAGIC, BMP_MAGIC, PBM_MAGIC, PGM_MAGIC, PPM_MAGIC])
_EXECUTABLE = frozenset([ELF_MAGIC, WIN_MAGIC, MAC_MAGIC32, MAC_CIGAM32,
                         MAC_MAGIC64, MAC_CIGAM64])


def get_type(src, start: int = 0) -> int:
    """Identify a file-type magic number from the first 4 bytes."""
    data = bytes(src[start:start + 4])
    if len(data) < 4:
        return NO_MAGIC
    key = int.from_bytes(data, "big")
    if (key & ~0x0F) == JPG_MAGIC:
        return key
    if (key >> 8) in (BZIP2_MAGIC, MP3_ID3_MAGIC):
        return key >> 8
    if key in _KEYS32:
        return key
    key16 = key >> 16
    if key16 in _KEYS16:
        return key16
    if key16 in (PBM_MAGIC, PGM_MAGIC, PPM_MAGIC):
        if ((key >> 8) & 0xFF) in (0x07, 0x0A, 0x0D, 0x20):
            return key16
    return NO_MAGIC


def is_compressed(magic: int) -> bool:
    return magic in _COMPRESSED


def is_multimedia(magic: int) -> bool:
    return magic in _MULTIMEDIA


def is_executable(magic: int) -> bool:
    return magic in _EXECUTABLE
