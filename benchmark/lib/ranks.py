"""The processes of a data-parallel cell. Rank 0 is the run's own process; it
starts ranks 1 to W−1, one a card, through ``torch.multiprocessing``'s spawn
context, and each runs ``rank_main`` of a file of the benchmark (the cell's
driver, or the calibration) on its own card.

No process may outlive a failure or hang in a collective:

- a thread of rank 0 watches the workers: when one ends with another code
  than 0, or when rank 0 has not reported a step for ``stall_s`` seconds,
  it says so on standard error, kills every worker and ends rank 0 with
  exit code 1, before NCCL's own timeout would;
- each worker holds the read end of a pipe whose write end only rank 0
  holds, and ends itself when it reads the end of it: rank 0 is gone;
- workers write nothing to standard output (it is joined to standard
  error), and hand rank 0 their report, with the modules of JAX they
  found loaded, through a pipe of their own before they end.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time
import traceback
from multiprocessing.connection import wait


def free_address() -> str:
    """``localhost:<port>`` at a port free now, for the rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"localhost:{s.getsockname()[1]}"


def _fatal(message: str, procs) -> None:
    print(f"data-parallel run ended: {message}", file=sys.stderr, flush=True)
    for p in procs:
        if p.exitcode is None:
            p.kill()
    for p in procs:
        p.join(10)
    os._exit(1)


class Workers:
    """Ranks 1 to ``world − 1`` running ``spec`` (a JSON-able dict that
    names the file, ``entry`` under ``benchmark/``, and holds everything a
    rank needs), watched from rank 0."""

    def __init__(self, spec: dict, world: int, stall_s: float):
        import torch.multiprocessing as tmp

        mp = tmp.get_context("spawn")
        self.stall_s = stall_s
        self.last_beat = time.monotonic()
        self.done = False
        self.procs, self.reports, self.lifelines = [], [], []
        for rank in range(1, world):
            report_r, report_w = mp.Pipe(duplex=False)
            life_r, life_w = mp.Pipe(duplex=False)
            p = mp.Process(target=worker_main, args=(rank, spec, report_w, life_r),
                           name=f"rank{rank}", daemon=True)
            p.start()
            report_w.close()
            life_r.close()
            self.procs.append(p)
            self.reports.append(report_r)
            self.lifelines.append(life_w)
        self.thread = threading.Thread(target=self._watch, daemon=True)
        self.thread.start()

    def beat(self) -> None:
        """Rank 0 has made progress."""
        self.last_beat = time.monotonic()

    def _watch(self) -> None:
        while True:
            live = [p for p in self.procs if p.exitcode is None]
            if live:
                wait([p.sentinel for p in live], timeout=2.0)
            for rank, p in enumerate(self.procs, 1):
                if p.exitcode not in (None, 0):
                    _fatal(f"rank {rank} ended with exit code {p.exitcode}", self.procs)
            if self.done or not live:
                return
            if time.monotonic() - self.last_beat > self.stall_s:
                _fatal(f"rank 0 made no progress for {self.stall_s:.0f} s", self.procs)

    def finish(self, timeout: float) -> list:
        """Each worker's report, once it has ended with exit code 0."""
        out = []
        for rank, (p, conn) in enumerate(zip(self.procs, self.reports), 1):
            if not conn.poll(timeout):
                _fatal(f"rank {rank} sent no report within {timeout:.0f} s", self.procs)
            out.append(json.loads(conn.recv()))
            # The watching thread reaps the workers too: read the exit code
            # until one of the two has (``join`` here could find it reaped).
            end = time.monotonic() + timeout
            while p.exitcode is None and time.monotonic() < end:
                time.sleep(0.05)
            if p.exitcode != 0:
                _fatal(f"rank {rank} ended with exit code {p.exitcode}", self.procs)
        self.done = True
        self.thread.join()
        for c in self.reports + self.lifelines:
            c.close()
        return out

    def kill(self) -> None:
        """End every worker (rank 0 failed)."""
        self.done = True
        for p in self.procs:
            if p.exitcode is None:
                p.kill()
        for p in self.procs:
            p.join(10)
        for c in self.reports + self.lifelines:
            c.close()


def _lifeline(conn) -> None:
    try:
        conn.recv()
    except (EOFError, OSError):
        pass
    print("rank 0 is gone: this rank ends", file=sys.stderr, flush=True)
    os._exit(1)


def worker_main(rank: int, spec: dict, report, lifeline) -> None:
    """A worker's process: ``rank_main(spec, rank)`` of the file ``entry``,
    whose record (JSON-able) goes to rank 0 with the forbidden modules
    found."""
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    threading.Thread(target=_lifeline, args=(lifeline,), daemon=True).start()
    from benchmark.lib import harness

    try:
        rec = harness.load_module(harness.BENCH / spec["entry"]).rank_main(spec, rank)
    except Exception:
        # Exit at once: the interpreter's own exit can wait on the process
        # group's peers. Rank 0's watching thread then ends the run.
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    rec["forbidden"] = harness.forbidden_modules()
    report.send(json.dumps(rec))
    report.close()
