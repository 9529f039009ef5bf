"""Launcher of the mesh's ranks, and the dry runs of the multi-GPU engine.

Counterpart of __graft_entry__.py's ``entry`` (:37), ``dryrun_multichip``
(:58) and ``dryrun_multihost`` (:288).  kanzi_tpu builds a virtual mesh of
XLA devices in one process; here every rank is a fresh Python process that
joins one torch.distributed group on a free localhost port: gloo on
``cpu``, NCCL on ``cuda`` (one rank a card: NCCL does not put two ranks of
one group on one GPU), or gloo on ``cuda`` with ``backend="gloo"``, which
stages the collectives through host memory and lets several ranks share a
card.

Every child writes its result and its log to files, never to a pipe: an
undrained pipe would block a chatty rank inside a collective and hang the
others.  Each child runs under a wall-clock timeout and its process group
under a timeout of its own, so a hang fails instead of running on.

    python -m kanzi_tpu_torch.parallel.dryrun [--ranks N] [--device cuda|cpu]
        [--size BYTES] [--block BYTES] [--jobs N]

runs ``entry``, ``dryrun_multichip`` (with its scaling line) and
``dryrun_multihost``.
"""

from __future__ import annotations

import argparse
import importlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from datetime import timedelta

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(pythonpath=()) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([ROOT, *pythonpath, env.get("PYTHONPATH", "")])
    # every rank is on this host: NCCL's and gloo's bootstraps ride the
    # loopback (a sealed machine may have no other interface up)
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    return env


def _run_processes(cmds: list, env: dict, timeout: float, tmp: str) -> list:
    """Start every command at once, each with its output to a log file in
    ``tmp``; wait at most ``timeout`` seconds for all of them, killing them
    all past it.  Returns each process's (exit code, log tail)."""
    logs = [open(os.path.join(tmp, f"rank{i}.log"), "wb") for i in range(len(cmds))]
    procs = []
    try:
        for cmd, lg in zip(cmds, logs):
            procs.append(subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=lg,
                                          stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for i, p in enumerate(procs):
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise TimeoutError(f"rank {i} still running after {timeout:.0f} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for lg in logs:
            lg.close()
    out = []
    for i, p in enumerate(procs):
        with open(os.path.join(tmp, f"rank{i}.log"), "rb") as f:
            out.append((p.returncode, f.read().decode(errors="replace")[-3000:]))
    return out


def spawn(target: str, world: int, device: str, args: tuple = (), *,
          backend: str | None = None, timeout: float = 600.0,
          pythonpath=()) -> list:
    """Run ``target(mesh, *args)`` ("module:function") on ``world`` ranks,
    each a fresh process with its own mesh (engine.make_mesh on
    ``device``), and return every rank's result in rank order.  ``args``
    and the results travel pickled through files this function writes and
    reads.  ``timeout`` bounds the whole run and each collective: a rank
    still running then is killed with the others (TimeoutError), and a
    rank that fails raises RuntimeError here with every failed rank's log
    tail."""
    from ..utils.device import check_device

    dev = check_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        import torch
        if world > torch.cuda.device_count():
            raise ValueError(f"{world} NCCL ranks need {world} cards, "
                             f"{torch.cuda.device_count()} visible")
    with tempfile.TemporaryDirectory(prefix="kz_mesh_") as tmp:
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump(tuple(args), f)
        init = f"tcp://127.0.0.1:{free_port()}"
        cmds = [[sys.executable, "-m", "kanzi_tpu_torch.parallel.dryrun", "--rank", str(r),
                 "--world", str(world), "--init", init, "--device", dev.type,
                 "--backend", backend, "--target", target, "--dir", tmp,
                 "--pg-timeout", str(timeout)] for r in range(world)]
        codes = _run_processes(cmds, _env(pythonpath), timeout, tmp)
        failed = [f"rank {r} (exit {rc}):\n{log}" for r, (rc, log) in enumerate(codes) if rc]
        if failed:
            raise RuntimeError("mesh ranks failed:\n" + "\n".join(failed))
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"result{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def _rank_main(a) -> None:
    """One child of ``spawn``: join the group, build the mesh, run the
    target, pickle its result."""
    import torch
    import torch.distributed as dist

    from .engine import make_mesh

    if a.device == "cuda":
        torch.cuda.set_device(a.rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // a.world))
    dist.init_process_group(a.backend, init_method=a.init, world_size=a.world,
                            rank=a.rank, timeout=timedelta(seconds=a.pg_timeout))
    mesh = make_mesh(a.world, device=a.device)
    mod, fn = a.target.split(":")
    with open(os.path.join(a.dir, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    result = getattr(importlib.import_module(mod), fn)(mesh, *args)
    with open(os.path.join(a.dir, f"result{a.rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the dry runs
# ---------------------------------------------------------------------------

def entry(device="cuda"):
    """The flagship step and its inputs: the ANS0 encode scan and the
    compaction of a chunk batch with given tables (uniform over 64 symbols,
    sum 4096) on ``device``; 32 chunks of 16 KiB on ``cuda``, 8 of 4 KiB on
    ``cpu`` (the plain versions).  Returns (fn, args); fn(*args) ->
    (payload, n_emit, states) tensors."""
    import numpy as np

    from ..ops import ans_cuda
    from ..utils.device import check_device

    dev = check_device(device)
    n, c = (32, 16384) if dev.type == "cuda" else (8, 4096)
    rng = np.random.default_rng(0)
    chunks = rng.integers(0, 64, (n, c)).astype(np.uint8)
    freq = np.zeros((n, 256), dtype=np.int32)
    freq[:, :64] = 64
    cum = np.cumsum(freq, axis=1, dtype=np.int32) - freq

    def fn(x, f, cm):
        words, flags, states = ans_cuda.encode_scan(x, ans_cuda.pack_tables(f, cm))
        payload, n_emit = ans_cuda.compact(words, flags)
        return payload, n_emit, states

    return fn, tuple(ans_cuda.to_device(a, dev) for a in (chunks, freq, cum))


def multichip_rank(mesh, size: int, block: int, jobs: int) -> dict | None:
    """Every rank of ``dryrun_multichip``: level 1, the ANS0 stage and level
    5 over the mesh, each checked on rank 0 (round trips through the host
    reader and the mesh decoders).  Returns rank 0's report, None
    elsewhere."""
    import hashlib
    import io

    import numpy as np

    from ..io.stream import CompressedInputStream
    from ..utils.corpus import mixed_corpus
    from . import engine as E

    root = mesh.rank == 0
    rep: dict = {"ranks": mesh.size, "device": str(mesh.device), "backend": mesh.backend}

    def host_decode(blob: bytes) -> bytes:
        with CompressedInputStream(io.BytesIO(blob), {"jobs": 2}, device=None) as cis:
            return cis.read(-1)

    data = mixed_corpus(size, seed=11)
    t = time.perf_counter()
    wire = E.mesh_l1_compress(mesh, data, block_size=block, jobs=jobs)
    if root:
        rep["l1"] = {"bytes_in": data.size, "bytes_out": len(wire),
                     "compress_s": time.perf_counter() - t,
                     "sha256": hashlib.sha256(wire).hexdigest()}
        if host_decode(wire) != data.tobytes():
            raise RuntimeError("level 1: the mesh stream does not round-trip")

    chunk = 16384 if mesh.device.type == "cuda" else 4096
    rng = np.random.default_rng(1)
    n = 2 * mesh.size + 1                # an odd count: the batch pads
    blob = rng.normal(48, 14, n * chunk + 257).clip(0, 255).astype(np.uint8)
    wire = E.mesh_ans0_compress(mesh, blob, chunk=chunk)
    got = E.mesh_ans0_decompress(mesh, wire, blob.size, chunk=chunk)
    if root:
        if not np.array_equal(got, blob):
            raise RuntimeError("ANS0: the mesh decode differs from the input")
        rep["ans0"] = {"bytes_in": blob.size, "bytes_out": len(wire), "chunk": chunk}

    data = mixed_corpus(size, seed=12)
    t = time.perf_counter()
    wire = E.mesh_l5_compress(mesh, data, block_size=block, jobs=jobs)
    t_c = time.perf_counter() - t
    t = time.perf_counter()
    got = E.mesh_decompress(mesh, wire, jobs=jobs)
    if root:
        if host_decode(wire) != data.tobytes() or got != data.tobytes():
            raise RuntimeError("level 5: the mesh stream does not round-trip")
        rep["l5"] = {"bytes_in": data.size, "bytes_out": len(wire), "compress_s": t_c,
                     "mesh_decompress_s": time.perf_counter() - t,
                     "sha256": hashlib.sha256(wire).hexdigest()}
        rep["stats"] = mesh.stats
    return rep if root else None


def scaling_rank(mesh, nb: int, block: int, reps: int = 3) -> list:
    """Every rank of the scaling line: its share of ``nb`` blocks of
    ``block`` bytes of mixed_corpus(seed=5) through engine.make_l1_step, one
    warm run, then ``reps`` runs, each started at a barrier.  Returns this
    rank's (wall seconds, cpu seconds by os.times()) of each run."""
    import numpy as np
    import torch.distributed as dist

    from ..utils.corpus import mixed_corpus
    from .engine import _l1_batch_arrays, make_l1_step

    blocks = list(mixed_corpus(nb * block, seed=5).reshape(nb, block))
    own = np.array_split(np.arange(nb), mesh.size)[mesh.rank].tolist()
    bufs, send, mdist, _, _ = _l1_batch_arrays(blocks, own, 1)
    step = make_l1_step(mesh, 4)
    step(bufs, send, mdist)
    runs = []
    for _ in range(reps):
        dist.barrier(group=mesh.group)
        c0, t0 = os.times(), time.perf_counter()
        step(bufs, send, mdist)         # ends in a gather: every rank is done
        dt, c1 = time.perf_counter() - t0, os.times()
        runs.append((dt, (c1.user + c1.system) - (c0.user + c0.system)))
    return runs


def scaling(n_devices: int, device: str, block: int, timeout: float) -> dict:
    """The sharded LZX stage on the same total work, max(n, 8) blocks, at 1
    rank (a world of its own), at 2 on ``cpu``, and at ``n_devices``; each
    world's best run of rank 0 and the cpu seconds of that run, rank 0's
    and all ranks' together.  Prints the scaling line: t1, tN, the
    efficiency t1 / (n tN) against its ceiling (on ``cpu`` the ranks share
    the host's cores: min(cores, n) / n; on ``cuda`` each rank has a card:
    1.0), and on ``cpu`` the 2-rank attribution of the loss."""
    from ..utils.device import check_device

    cuda = check_device(device).type == "cuda"
    nb = max(n_devices, 8)
    worlds = sorted({1, n_devices} | (set() if cuda else {min(2, n_devices)}))
    res = {}
    for w in worlds:
        ranks = spawn("kanzi_tpu_torch.parallel.dryrun:scaling_rank", w, device, (nb, block),
                      timeout=timeout)
        best = min(range(len(ranks[0])), key=lambda i: ranks[0][i][0])
        res[w] = {"t": ranks[0][best][0], "runs": [r[0] for r in ranks[0]],
                  "cpu_s": ranks[0][best][1], "cpu_s_all": sum(r[best][1] for r in ranks)}
    cores = os.cpu_count() or 1
    t1, tn = res[1]["t"], res[n_devices]["t"]
    raw = t1 / (n_devices * tn)
    ceiling = 1.0 if cuda else min(cores, n_devices) / n_devices
    out = {"work_bytes": nb * block, "blocks": nb, "worlds": res, "t1": t1, "tN": tn,
           "raw": raw, "ceiling": ceiling, "efficiency": min(raw / ceiling, 1.0)}
    note = (f"raw {raw:.3f} vs ceiling {ceiling:.2f}: "
            + ("one card a rank" if cuda else f"{n_devices} ranks share {cores} host cores")
            + "; rank 0 cpu-s a run " + ", ".join(f"{w}: {res[w]['cpu_s']:.3f}" for w in worlds))
    if 2 in res and n_devices > 2:
        c1, c2 = res[1]["cpu_s_all"], res[2]["cpu_s_all"]
        raw2 = t1 / (2 * res[2]["t"])
        cores1, cores2 = c1 / t1, c2 / res[2]["t"]
        # raw2 = work-efficiency x cores2 / (2 cores1), exactly: sharding's
        # extra work, and the 1-rank world's intra-op threads, which already
        # busy several cores (a rank of a card cannot borrow another card)
        out["attribution"] = {"raw2": raw2, "work_efficiency": c1 / c2,
                              "cores_busy_1": cores1, "cores_busy_2": cores2}
        note += (f"; 2-rank raw {raw2:.3f} at ceiling 1.0 = work-efficiency {c1 / c2:.3f} "
                 f"(cpu-s of all ranks {c1:.3f} -> {c2:.3f}) x cores busy {cores2:.2f} / "
                 f"(2 x {cores1:.2f} at 1 rank, torch's intra-op threads)")
    print(f"scaling [{(nb * block) >> 20} MiB sharded LZX stage, {nb} blocks, {device}]: "
          f"t1={t1:.4f}s tN={tn:.4f}s | scaling efficiency={out['efficiency']:.3f} "
          f"({note})", flush=True)
    return out


def dryrun_multichip(n_devices: int, device: str, *, size: int = 64 << 20,
                     block: int = 1 << 20, jobs: int | None = None,
                     timeout: float = 1800.0) -> dict:
    """``n_devices`` ranks (gloo on ``cpu``; NCCL on ``cuda``, one card a
    rank, more ranks than cards raise) run level 1, the ANS0 stage and level
    5 over ``size`` bytes in ``block``-byte blocks, ``jobs`` blocks a write
    (default: one a rank, as kanzi_tpu's dry run), each round-tripped; then
    the scaling line of the sharded LZX stage on ``block``-byte blocks.
    Prints and returns rank 0's report, the scaling under "scaling"."""
    rep = spawn("kanzi_tpu_torch.parallel.dryrun:multichip_rank", n_devices, device,
                (size, block, jobs or n_devices), timeout=timeout)[0]
    for k in ("l1", "ans0", "l5"):
        print(f"dryrun_multichip({n_devices}, {device}): {k} {rep[k]}", flush=True)
    rep["scaling"] = scaling(n_devices, device, block, timeout)
    return rep


def dryrun_multihost(num_processes: int, device: str, timeout: float = 900.0) -> list:
    """``num_processes`` processes run kanzi_tpu_torch.parallel.multihost,
    each feeding its own rows; every one must write "OK".  Returns their
    lines."""
    from ..utils.device import check_device

    dev = check_device(device)
    coord = f"127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory(prefix="kz_multihost_") as tmp:
        outs = [os.path.join(tmp, f"out{i}.txt") for i in range(num_processes)]
        cmds = [[sys.executable, "-m", "kanzi_tpu_torch.parallel.multihost",
                 "--process-id", str(i), "--num-processes", str(num_processes),
                 "--coordinator", coord, "--out", outs[i], "--device", dev.type,
                 "--timeout", str(timeout)] for i in range(num_processes)]
        codes = _run_processes(cmds, _env(), timeout, tmp)
        lines = []
        for i, (rc, log) in enumerate(codes):
            text = open(outs[i]).read().strip() if os.path.exists(outs[i]) else ""
            if rc or not text.startswith("OK"):
                raise RuntimeError(f"multihost process {i} failed (exit {rc}): "
                                   f"{text or log}")
            lines.append(text)
    for line in lines:
        print(f"  {line}", flush=True)
    return lines


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--size", type=int, default=64 << 20)
    ap.add_argument("--block", type=int, default=1 << 20)
    ap.add_argument("--jobs", type=int, default=None, help="default: --ranks")
    # one rank of spawn()
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--init", help=argparse.SUPPRESS)
    ap.add_argument("--backend", help=argparse.SUPPRESS)
    ap.add_argument("--target", help=argparse.SUPPRESS)
    ap.add_argument("--dir", help=argparse.SUPPRESS)
    ap.add_argument("--pg-timeout", type=float, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.rank is not None:
        try:
            _rank_main(a)
        except BaseException:
            traceback.print_exc()
            sys.stderr.flush()
            os._exit(1)      # leave the group's teardown to the timeout
        return
    fn, args = entry(a.device)
    print("entry ok:", [tuple(o.shape) for o in fn(*args)], flush=True)
    dryrun_multichip(a.ranks, a.device, size=a.size, block=a.block, jobs=a.jobs)
    dryrun_multihost(a.ranks, a.device)


if __name__ == "__main__":
    main()
