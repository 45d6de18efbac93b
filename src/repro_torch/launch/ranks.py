"""Starting the processes of a ``torch.distributed`` world on one host:
one process per rank, as ``chip_smoke.py``'s ``multi_device`` phase and
``tests/test_torch_sharded.py`` run them (the mesh over their ranks is
``core.collectives``)."""
from __future__ import annotations

import contextlib
import os
import subprocess
import tempfile
import time
from typing import List

__all__ = ["init_world", "run_ranks", "rank_env"]


def init_world(rank: int, world: int, store_file: str) -> None:
    """Join a gloo process group of ``world`` ranks through a ``file://``
    store (no TCP port: several worlds may run on one host at once).
    gloo, because NCCL refuses two ranks on one device."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store_file}",
                            rank=rank, world_size=world)


def run_ranks(argv_of_rank, world: int, timeout: float, env=None,
              cwd=None) -> List[str]:
    """Run ``world`` processes at once, rank r as ``argv_of_rank(r)``, and
    wait for all of them within ``timeout`` seconds. Every process is
    killed if one fails or the time runs out, and the call then raises
    with the failed ranks' standard error. Returns each rank's standard
    output, in rank order."""
    with contextlib.ExitStack() as stack:
        files = [(stack.enter_context(tempfile.TemporaryFile("w+")),
                  stack.enter_context(tempfile.TemporaryFile("w+")))
                 for _ in range(world)]
        procs = [subprocess.Popen(argv_of_rank(r), stdout=o, stderr=e,
                                  text=True, env=env, cwd=cwd)
                 for r, (o, e) in enumerate(files)]

        def tail(r):
            files[r][1].seek(0)
            return files[r][1].read()[-4000:]

        deadline = time.monotonic() + timeout
        try:
            while True:
                rcs = [p.poll() for p in procs]
                failed = [r for r, rc in enumerate(rcs)
                          if rc not in (None, 0)]
                if failed:
                    raise RuntimeError("".join(
                        f"rank {r} exited {rcs[r]}:\n{tail(r)}\n"
                        for r in failed))
                if all(rc == 0 for rc in rcs):
                    break
                if time.monotonic() > deadline:
                    late = [r for r, rc in enumerate(rcs) if rc is None]
                    raise RuntimeError(f"ranks {late} still running after "
                                       f"{timeout} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        outs = []
        for o, _ in files:
            o.seek(0)
            outs.append(o.read())
        return outs


def rank_env(threads: int = 1) -> dict:
    """The environment of a rank process: this one's, with its OpenMP
    threads capped (ranks share the host's cores), ``src`` on its path and
    the
    kernel libraries loaded only (``kernels.build`` raises where one is
    missing; the parent builds them first)."""
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = str(threads)
    env["REPRO_TORCH_PREBUILT"] = "1"
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                 if p])
    return env

