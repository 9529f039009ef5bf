"""The multi-process dry run of the mesh: each process one rank, feeding only
its own rows.

Counterpart of kanzi_tpu/parallel/multihost.py.  kanzi_tpu forms one mesh
over the devices of several processes with ``jax.distributed``; here each
process is one rank of a torch.distributed group (gloo on ``cpu``, NCCL on
``cuda``), initialised from the coordinator's address.  The ANS0 entropy
stage (level 5's stage 2, engine.make_pipeline_step) runs with each rank
feeding only its local rows; the per-chunk lengths ride the first gather,
the tables, states and payload prefixes the second, and rank 0 assembles
the exact ANSRangeEncoder wire, which must equal the host encoder's and
decode back.  Then the level-1 stage (engine.make_l1_step) the same way,
committed by rank 0 through the v7 writer and round-tripped.

Run one process for each rank:

    python -m kanzi_tpu_torch.parallel.multihost --process-id I \\
        --num-processes N --coordinator HOST:PORT --out FILE [--device cuda|cpu]

or through ``parallel/dryrun.py`` ``dryrun_multihost``, which spawns them.
Each process writes "OK pI: ..." or "FAIL pI: ..." to its ``--out`` file;
an OK line ends with the process's kernel launch counts (ops/launch.py),
"launches {name: count, ...}", the kernels it launched only.
"""

from __future__ import annotations

import argparse
import sys
import traceback
from datetime import timedelta


def worker_main(process_id: int, num_processes: int, coordinator: str,
                out_path: str | None, device: str,
                timeout_s: float = 300.0) -> None:
    import io

    import numpy as np
    import torch
    import torch.distributed as dist

    from ..core.bits import BitReader, BitWriter
    from ..entropy import ans as hans
    from ..io.stream import CompressedInputStream, CompressedOutputStream
    from ..ops import launch
    from ..ops.ans_block import encode_ans0_wire
    from ..utils.corpus import mixed_corpus
    from ..utils.device import check_device
    from .engine import _l1_batch_arrays, make_l1_step, make_mesh, make_pipeline_step
    from .engine import tokens_to_hints

    dev = check_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=timeout_s))
    result, detail = "FAIL", ""
    try:
        mesh = make_mesh(num_processes, device=dev)

        # every rank derives the same codec config and data from the seed
        # (the stream-header fields a deployment sends to all hosts)
        chunk = 16384
        nblocks = 2 * num_processes               # 2 chunks a rank
        data = mixed_corpus(nblocks * chunk, seed=42)
        chunks = data.reshape(nblocks, chunk)
        local = chunks[process_id * 2:(process_id + 1) * 2]
        freq, payload, lengths, states = make_pipeline_step(mesh, chunk)(local)
        if lengths.shape != (nblocks,):
            raise RuntimeError(f"lengths of shape {lengths.shape}")
        # the ordered commit needs the same lengths on every rank
        mine = torch.from_numpy(lengths.astype(np.int64)).to(mesh.comm_device)
        every = [torch.empty_like(mine) for _ in range(num_processes)]
        dist.all_gather(every, mine)
        if not all(torch.equal(e, mine) for e in every):
            raise RuntimeError("per-chunk lengths diverged across ranks")
        if process_id == 0:
            bw = BitWriter()
            encode_ans0_wire(data, bw, lambda _: (freq, payload, lengths, states), chunk)
            wire = bw.getvalue()
            hw = BitWriter()
            hans.ANSRangeEncoder(hw, 0, chunk_size=chunk).encode(data)
            if wire != hw.getvalue():
                raise RuntimeError(f"the wire differs from the host encoder's: "
                                   f"{len(wire)} B vs {len(hw.getvalue())} B")
            got = hans.ANSRangeDecoder(BitReader(wire), 0, chunk_size=chunk).decode(data.size)
            if not np.array_equal(got, data):
                raise RuntimeError("the wire does not decode to the input")
            detail = (f"{num_processes} ranks on {dev.type}; {data.size} B -> "
                      f"{len(wire)} B ANS0 wire, equal to the host encoder's, decoded")
        else:
            detail = "shard contributed; lengths equal on every rank"

        # phase 2: the level-1 stage (the LZX engine) across the ranks
        blk = 256 << 10
        l1_data = mixed_corpus(num_processes * blk, seed=43)
        blocks = [l1_data[i * blk:(i + 1) * blk] for i in range(num_processes)]
        live = list(range(num_processes))
        bufs, send, mdist, bucket, nb = _l1_batch_arrays(blocks, live, num_processes)
        rows = nb // num_processes
        own = slice(process_id * rows, (process_id + 1) * rows)
        pk, dist_, counts = make_l1_step(mesh, 4)(bufs[own], send[own], mdist[own])
        if process_id == 0:
            hints = tokens_to_hints(blocks, live, [(4, None)] * num_processes, pk, dist_,
                                    counts, bucket, nb, num_processes, 4)
            sink = io.BytesIO()
            cos = CompressedOutputStream(sink, {
                "entropy": "NONE", "transform": "LZX", "blockSize": blk,
                "jobs": 2, "fileSize": l1_data.size}, device=None)
            done = [0]

            def hint_fn(chs):
                base = done[0]
                done[0] += len(chs)
                return hints[base:base + len(chs)]

            cos._lz_hint_fn = hint_fn
            cos.write(l1_data.tobytes())
            cos.close()
            wire1 = sink.getvalue()
            with CompressedInputStream(io.BytesIO(wire1), {"jobs": 2}, device=None) as cis:
                if cis.read(-1) != l1_data.tobytes():
                    raise RuntimeError("the level-1 stream does not round-trip")
            detail += (f"; level-1 stage across the ranks: {l1_data.size} B -> "
                       f"{len(wire1)} B, round-trip ok")
        detail += f"; launches {({k: v for k, v in launch.launches.items() if v})}"
        result = "OK"
        dist.destroy_process_group()
    except Exception:
        detail = traceback.format_exc()
        raise
    finally:
        if out_path:
            with open(out_path, "w") as f:
                f.write(f"{result} p{process_id}: {detail}\n")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", required=True, help="HOST:PORT of rank 0")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="the process group's timeout, seconds")
    a = ap.parse_args()
    try:
        worker_main(a.process_id, a.num_processes, a.coordinator, a.out, a.device,
                    a.timeout)
    except Exception:
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
