"""kanzi_tpu_torch command line — compress/decompress with kanzi-compatible
flags, on an NVIDIA card by default.

Re-derived from K/app/Kanzi.java:36-1026, BlockCompressor.java:62-903,
BlockDecompressor.java:62-792 (flags, level presets, default block sizes).
``--device`` picks the streams' device: ``cuda`` (the default: the device
stages on the card, which must be there), ``cpu`` (their plain PyTorch
versions) or ``none`` (the host coders).  ``-y`` reads the header on the
host whatever the device.

    python -m kanzi_tpu_torch.app -c -i <file> -l 5 [--device cuda|cpu|none]
    python -m kanzi_tpu_torch.app -d -i <file>.knz [--device cuda|cpu|none]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ..core.errors import Error, KanziError
from ..utils.device import check_device
from .block_compressor import LEVELS, BlockCompressor
from .block_decompressor import BlockDecompressor


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="kanzi_tpu_torch",
        description="kanzi_tpu_torch — block compressor with CUDA device stages "
                    "(kanzi bitstream v7)")
    p.add_argument("-c", "--compress", action="store_true")
    p.add_argument("-d", "--decompress", action="store_true")
    p.add_argument("-y", "--info", action="store_true",
                   help="print stream header info without decompressing")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", default=None)
    p.add_argument("-b", "--block", default=None, help="block size (e.g. 4m, 1024k, auto)")
    p.add_argument("-t", "--transform", default=None, help="transform chain, e.g. BWT+RANK+ZRLT")
    p.add_argument("-e", "--entropy", default=None, help="entropy codec, e.g. ANS0")
    p.add_argument("-l", "--level", type=int, default=None, choices=range(10))
    p.add_argument("-j", "--jobs", type=int, default=0, help="0 = all cores (max 64)")
    p.add_argument("-v", "--verbose", type=int, default=1)
    p.add_argument("-x", "--checksum", nargs="?", const="32", default="0",
                   help="block checksum size (32 or 64)")
    p.add_argument("-x32", dest="checksum", action="store_const", const="32",
                   help="32-bit block checksums (same as -x)")
    p.add_argument("-x64", dest="checksum", action="store_const", const="64",
                   help="64-bit block checksums")
    p.add_argument("-f", "--force", "--overwrite", action="store_true",
                   help="overwrite output")
    p.add_argument("-s", "--skip", action="store_true", help="skip incompressible blocks")
    p.add_argument("--from", dest="from_block", type=int, default=0)
    p.add_argument("--to", dest="to_block", type=int, default=0)
    p.add_argument("--rm", action="store_true", help="remove input after success")
    p.add_argument("--skip-links", action="store_true",
                   help="do not follow symbolic links when recursing directories")
    p.add_argument("--skip-dot-files", action="store_true",
                   help="ignore dot files when recursing directories")
    p.add_argument("--no-file-reorder", action="store_true",
                   help="keep path order instead of (dir, size desc) order")
    p.add_argument("--device", choices=("cuda", "cpu", "none"), default="cuda",
                   help="cuda: device stages on the card (default); cpu: their "
                        "plain PyTorch versions; none: the host coders")
    args = p.parse_args(argv)

    if args.info:
        return _info(args)
    if args.compress == args.decompress:
        print("Exactly one of -c / -d is required", file=sys.stderr)
        return Error.ERR_MISSING_PARAM
    # the card is checked before any output is opened; no CPU fallback
    args.device = None if args.device == "none" else args.device
    if args.device is not None:
        try:
            check_device(args.device)
        except RuntimeError as e:
            print(f"Error: {e}", file=sys.stderr)
            return Error.ERR_INVALID_PARAM
    try:
        if args.compress:
            return _compress(args)
        return _decompress(args)
    except KanziError as e:
        print(f"Error: {e}", file=sys.stderr)
        return e.code
    except OSError as e:
        print(f"Error: {e}", file=sys.stderr)
        return Error.ERR_OPEN_FILE


def _parse_block_size(s: str, file_size: int, jobs: int) -> int:
    s = s.strip().lower()
    if s == "auto":
        if file_size <= 0:
            return 4 * 1024 * 1024
        bsz = (file_size + jobs - 1) // jobs
        return max(1024, (bsz + 63) & ~63)
    mult = 1
    if s[-1] in "kmg":
        mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}[s[-1]]
        s = s[:-1]
    return int(s) * mult


def _out_path(args, suffix: str, strip: str) -> str:
    if args.output:
        return args.output
    if args.decompress and args.input.endswith(strip):
        return args.input[:-len(strip)]
    return args.input + suffix


def _input_files(args) -> list[tuple[str, str | None]]:
    """Expand the -i argument: file, comma list, or directory (recursed).

    Mirrors K/app/BlockCompressor.java:256 + IOUtil enumeration with the
    --skip-links/--skip-dot-files/--no-file-reorder flags.
    """
    from ..io.ioutil import create_file_list, sort_files_by_path_and_size
    files: list = []
    basedirs: dict = {}
    for part in args.input.split(","):
        part = part.strip()
        if not part:
            continue
        if os.path.isdir(part):
            found = create_file_list(part, skip_links=args.skip_links,
                                     skip_dot_files=args.skip_dot_files)
            files.extend(found)
            for f in found:
                basedirs[str(f)] = part
        else:
            from pathlib import Path
            files.append(Path(part))
    if len(files) > 1:
        sort_files_by_path_and_size(files, not args.no_file_reorder)
    return [(str(f), basedirs.get(str(f))) for f in files]


def _check_dir_output(args, inputs) -> int:
    """Directory input + explicit output requires an existing directory
    (BlockCompressor.java:326-333); returns an error code or 0."""
    special = (args.output or "").upper() in ("", "NONE", "STDOUT")
    if special or not any(base for _, base in inputs):
        return 0
    if not os.path.isdir(args.output):
        print("Output must be an existing directory (or 'NONE')",
              file=sys.stderr)
        return Error.ERR_CREATE_FILE
    return 0


def _rel_out(path: str, base: str | None, out_dir: str, suffix: str) -> str:
    """Mirror the input's path relative to its source directory under the
    output directory (BlockCompressor.java:375-377).  Pure path computation:
    parents are created by the caller only after overwrite checks pass."""
    rel = os.path.relpath(path, base) if base else os.path.basename(path)
    return os.path.join(out_dir, rel + suffix) if suffix else \
        os.path.join(out_dir, rel)


def _compress(args) -> int:
    jobs = args.jobs if args.jobs > 0 else min(os.cpu_count() or 1, 64)
    level = args.level
    if level is None and args.transform is None and args.entropy is None:
        level = 3
    if level is not None:
        transform, entropy, default_block = LEVELS[level]
        if args.transform is not None or args.entropy is not None:
            print("Warning: -l overrides -t/-e", file=sys.stderr)
    else:
        transform = args.transform or "NONE"
        entropy = args.entropy or "NONE"
        default_block = 4 * 1024 * 1024
    inputs = _input_files(args)
    if not inputs:
        print("No input files found", file=sys.stderr)
        return Error.ERR_OPEN_FILE
    err = _check_dir_output(args, inputs)
    if err:
        return err
    multi = len(inputs) > 1
    dir_in = any(base for _, base in inputs)
    out_dir = args.output if args.output and (multi or dir_in) \
        and os.path.isdir(args.output) else None
    total_read = total_written = 0
    t0 = time.time()
    for path, base in inputs:
        file_size = os.path.getsize(path) if os.path.isfile(path) else 0
        block = _parse_block_size(args.block, file_size, jobs) if args.block else default_block
        if (args.output or "").upper() == "NONE":
            out = os.devnull                    # sink (Kanzi.java -o NONE)
        elif out_dir:
            out = _rel_out(path, base, out_dir, ".knz")
        elif multi or (dir_in and not args.output):
            out = path + ".knz"
        else:
            out = _out_path(args, ".knz", "")
        if out != os.devnull and os.path.exists(out) and not args.force:
            print(f"Output file {out} exists (use -f to overwrite)", file=sys.stderr)
            return Error.ERR_OVERWRITE_FILE
        if out != os.devnull:
            parent = os.path.dirname(out)
            if parent:
                os.makedirs(parent, exist_ok=True)
        bc = BlockCompressor(transform=transform, entropy=entropy, block_size=block,
                             jobs=jobs, checksum=int(args.checksum or 0),
                             skip_blocks=args.skip, verbosity=args.verbose,
                             device=args.device)
        tf = time.time()
        read, written = bc.compress_file(path, out)
        dtf = time.time() - tf
        total_read += read
        total_written += written
        if args.verbose > 0:
            ratio = written / read if read else 0
            print(f"Compressed {path}: {read} -> {written} bytes "
                  f"(ratio {ratio:.4f}) in {dtf*1000:.0f} ms "
                  f"[{read/max(dtf,1e-9)/1e6:.1f} MB/s] "
                  f"t={transform} e={entropy} b={block} j={jobs}")
        if args.rm:
            os.remove(path)
    if multi and args.verbose > 0:
        dt = time.time() - t0
        print(f"Total: {len(inputs)} files, {total_read} -> {total_written} bytes "
              f"in {dt*1000:.0f} ms")
    return 0


def _decompress(args) -> int:
    jobs = args.jobs if args.jobs > 0 else min(os.cpu_count() or 1, 64)
    inputs = _input_files(args)
    if not inputs:
        print("No input files found", file=sys.stderr)
        return Error.ERR_OPEN_FILE
    err = _check_dir_output(args, inputs)
    if err:
        return err
    multi = len(inputs) > 1
    dir_in = any(base for _, base in inputs)
    out_dir = args.output if args.output and (multi or dir_in) \
        and os.path.isdir(args.output) else None
    for path, base in inputs:
        if (args.output or "").upper() == "NONE":
            out = os.devnull                    # sink (Kanzi.java -o NONE)
        elif out_dir:
            rel = os.path.relpath(path, base) if base else os.path.basename(path)
            rel = rel[:-4] if rel.endswith(".knz") else rel + ".out"
            out = os.path.join(out_dir, rel)
        elif multi or (dir_in and not args.output):
            out = path[:-4] if path.endswith(".knz") else path + ".out"
        else:
            out = _out_path(args, ".out", ".knz")
        if out != os.devnull and os.path.exists(out) and not args.force:
            print(f"Output file {out} exists (use -f to overwrite)", file=sys.stderr)
            return Error.ERR_OVERWRITE_FILE
        if out != os.devnull:
            parent = os.path.dirname(out)
            if parent:
                os.makedirs(parent, exist_ok=True)
        bd = BlockDecompressor(jobs=jobs, verbosity=args.verbose,
                               from_block=args.from_block, to_block=args.to_block,
                               device=args.device)
        t0 = time.time()
        read, written = bd.decompress_file(path, out)
        dt = time.time() - t0
        if args.verbose > 0:
            print(f"Decompressed {path}: {read} -> {written} bytes in "
                  f"{dt*1000:.0f} ms [{written/max(dt,1e-9)/1e6:.1f} MB/s]")
        if args.rm:
            os.remove(path)
    return 0


def _info(args) -> int:
    """`-y`: decode the stream header only (BlockDecompressor.java:168-182)."""
    from ..io.stream import CompressedInputStream
    from .info_printer import InfoPrinter, Type
    with open(args.input, "rb") as f:
        cis = CompressedInputStream(f, {"jobs": 1, "from": 1, "to": 1},
                                    device=None)
    printer = InfoPrinter(Type.INFO, verbosity=args.verbose)
    from ..core.events import Event, EventType, HeaderInfo
    from ..entropy import factory as ef
    from ..transforms import factory as tf
    printer.process_event(Event(
        EventType.AFTER_HEADER_DECODING, 0, 0,
        header=HeaderInfo(cis.bs_version, cis.checksum, cis.block_size,
                          ef.get_name(cis.entropy_type),
                          tf.get_name(cis.transform_type),
                          cis.output_size or -1)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
