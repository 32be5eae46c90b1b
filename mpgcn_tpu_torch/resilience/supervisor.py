"""The process supervisor: launch, watch, relaunch (counterpart of
mpgcn_tpu/resilience/supervisor.py).

``python -m mpgcn_tpu_torch.cli supervise --procs 1 -- <command flags>``
runs the port's command (``python -m mpgcn_tpu_torch.cli ...``: the
trainer, or ``daemon ...``) as a child and turns its exit into the
recovery the checkpoint layer makes possible:

  exit 0              clean finish (or graceful preemption) -> done
  exit 113 / 114      own-hang / wedged-collective watchdog -> state is
                      on disk; relaunch and resume
  exit 115            peer loss -> relaunch and resume
  killed / crashed    relaunch with ``-resume``

Every relaunch appends ``-resume``: the trainer's resume chain (last ->
best -> scratch, corruption-tolerant) or the daemon's on-disk loop state
does the rest. The restart budget is bounded (``--max-restarts``); a
generation that runs past ``--gen-timeout`` is killed and retried. A
first SIGTERM or SIGINT is forwarded to the child, a second one kills
it.

The port runs one process: ``--procs`` above 1 (a process group over
several devices) is refused, and the JAX supervisor's
``--devices-per-proc`` (an XLA virtual-device count) has no counterpart;
both wait for the multi-device slice, and with them the JAX shrink of
the world around dead hosts; ``--procs`` defaults to 1 (the JAX one to
2). Needs neither torch nor numpy: the supervisor only starts and
watches its child.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

from mpgcn_tpu_torch.resilience.watchdog import WATCHDOG_EXIT_CODE

#: the JAX package's exit codes of a wedged collective and of a lost peer
#: (mpgcn_tpu/resilience/watchdog.py); a process of the port never exits
#: with them yet, but a supervised child that does left resumable state
COLLECTIVE_EXIT_CODE = 114
PEER_LOSS_EXIT_CODE = 115

#: exit codes after which the on-disk state is known to be resumable
RESUMABLE_EXITS = frozenset(
    {WATCHDOG_EXIT_CODE, COLLECTIVE_EXIT_CODE, PEER_LOSS_EXIT_CODE})


def _output_dir(train_args: list[str]) -> str:
    """The -out/--output_dir the child writes to (the supervisor's log
    lives next to the state it describes)."""
    for i, a in enumerate(train_args):
        if a in ("-out", "--output_dir") and i + 1 < len(train_args):
            return train_args[i + 1]
    return "./output"


class _Log:
    """A small JSONL event log that needs no torch."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path), exist_ok=True)

    def log(self, event: str, **fields):
        rec = {"event": event, "t": round(time.time(), 3), **fields}
        try:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            pass
        print(f"[supervisor] {event} "
              + " ".join(f"{k}={v}" for k, v in fields.items()),
              flush=True)


def _launch(world: int, train_args: list[str], resume: bool, gen: int,
            log_dir: str):
    """Start one generation of ``world`` processes of the port's command;
    returns (procs, log file handles)."""
    args = list(train_args)
    if resume and "-resume" not in args and "--resume" not in args:
        args.append("-resume")
    procs, handles = [], []
    for i in range(world):
        log_path = os.path.join(log_dir, f"gen{gen}_p{i}.log")
        handle = open(log_path, "w")
        handles.append(handle)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mpgcn_tpu_torch.cli"] + args,
            stdout=handle, stderr=subprocess.STDOUT, env=dict(os.environ)))
    return procs, handles


def _wait(procs, gen_timeout: float,
          stop_flag: dict) -> tuple[list[int], bool]:
    """Poll until every child exits (or the generation times out, or the
    supervisor is told to stop: the children are then signalled and
    reaped). Returns (return codes, timed_out): the caller must not read
    a kill the supervisor made as a death of its own."""
    deadline = time.monotonic() + gen_timeout if gen_timeout > 0 else None
    forwarded = 0
    timed_out = False
    while any(p.poll() is None for p in procs):
        if stop_flag["count"] > forwarded:
            forwarded = stop_flag["count"]
            for p in procs:
                if p.poll() is None:
                    try:
                        if forwarded >= 2:
                            # a second signal: the graceful path did not
                            # land, so escalate, or the supervisor itself
                            # cannot be stopped with --gen-timeout 0
                            p.kill()
                        else:
                            p.send_signal(stop_flag["sig"])
                    except OSError:
                        pass
        if deadline is not None and time.monotonic() > deadline:
            timed_out = True
            for p in procs:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(0.25)
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    return [p.returncode for p in procs], timed_out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mpgcn_tpu_torch.cli supervise",
        description="Supervisor: run the port's command, relaunch it with "
                    "-resume when it dies or exits resumable.")
    ap.add_argument("--procs", type=int, default=1,
                    help="processes of the command (the port runs one: "
                         "more is refused until the multi-device slice)")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="relaunch budget across the whole run")
    ap.add_argument("--gen-timeout", type=float, default=0.0,
                    help="kill + restart a generation with no exit after "
                         "this many seconds (0 = rely on the in-process "
                         "watchdogs)")
    ap.add_argument("train_args", nargs=argparse.REMAINDER,
                    help="the command's flags, after `--`")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    ns = ap.parse_args(argv)
    if ns.procs < 1:
        ap.error(f"--procs {ns.procs} must be >= 1")
    if ns.procs > 1:
        ap.error(f"--procs {ns.procs}: the port runs one process; a "
                 f"multi-device process group (ROADMAP Queue 1 item 6) "
                 f"is not ported yet")
    train_args = ns.train_args
    if train_args and train_args[0] == "--":
        train_args = train_args[1:]

    out_dir = _output_dir(train_args)
    log_dir = os.path.join(out_dir, "supervisor")
    log = _Log(os.path.join(log_dir, "supervisor_log.jsonl"))

    stop_flag = {"sig": None, "count": 0}

    def _on_sig(signum, frame):
        stop_flag["sig"] = signum
        stop_flag["count"] += 1

    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[sig] = signal.signal(sig, _on_sig)
        except ValueError:
            pass

    world = ns.procs
    resume = False
    restarts = 0
    gen = 0
    try:
        while True:
            log.log("generation_start", gen=gen, world=world,
                    resume=resume, restarts=restarts)
            procs, handles = _launch(world, train_args, resume, gen,
                                     log_dir)
            rcs, timed_out = _wait(procs, ns.gen_timeout, stop_flag)
            for h in handles:
                h.close()
            log.log("generation_end", gen=gen, world=world, rcs=rcs,
                    timed_out=timed_out)
            if all(rc == 0 for rc in rcs):
                log.log("done", gen=gen, restarts=restarts)
                return 0
            if stop_flag["sig"] is not None:
                # the child was asked to stop; whatever it returned, the
                # supervisor's job is over (a new `supervise` resumes)
                log.log("stopped_by_signal", sig=int(stop_flag["sig"]),
                        rcs=rcs)
                return 0
            if restarts >= ns.max_restarts:
                log.log("restart_budget_exhausted", restarts=restarts,
                        rcs=rcs)
                return 1
            restarts += 1
            gen += 1
            log.log("relaunch", gen=gen, resumable=all(
                rc in RESUMABLE_EXITS for rc in rcs if rc != 0))
            resume = True
    finally:
        for sig, h in prev.items():
            signal.signal(sig, h if h is not None else signal.SIG_DFL)


if __name__ == "__main__":
    raise SystemExit(main())
