"""Stall-watchdog supervisor for the port's train CLI: recovery on one card.

Counterpart of `scripts/train_supervised.py`. A training process can hang
with its log silent (a device call that never returns); the supervisor:

  1. runs `python -m gsplat_tpu_torch.cli.train <args> --checkpoint_every N`,
     teeing its output to a log;
  2. watches for progress, log growth or a fresh rolling checkpoint; after
     --stall_timeout seconds without either (evaluation sweeps print
     nothing, so the timeout must exceed the longest silent phase) it kills
     the child's whole process group;
  3. relaunches from <model>/rolling_chkpnt.pkl (written atomically, so
     always loadable) until the run completes or --max_restarts is spent.

Usage:
  python -m gsplat_tpu_torch.cli.train_supervised [supervisor flags] -- <train args...>
  e.g. python -m gsplat_tpu_torch.cli.train_supervised --stall_timeout 600 -- \\
       -s data/lego -m output/lego --iterations 30000
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from argparse import ArgumentParser
from pathlib import Path

POLL_S = 5.0
RESTART_PAUSE_S = 10.0  # a child that fails at once does not spin the restarts
# the directory that holds the package, so the child imports this checkout's
# package from any working directory
PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])


def parse_args(argv):
    p = ArgumentParser(description="gsplat_tpu_torch.cli.train stall watchdog")
    p.add_argument("--stall_timeout", type=float, default=600.0,
                   help="seconds without progress before the run is declared hung")
    p.add_argument("--startup_grace", type=float, default=1200.0,
                   help="silence allowance before the first log line "
                   "(data load and the first kernel build)")
    p.add_argument("--max_restarts", type=int, default=20)
    p.add_argument("--checkpoint_every", type=int, default=500)
    p.add_argument("--log", type=str, default="",
                   help="tee child output here (default <model>/train_supervised.log)")
    if "--" not in argv:
        p.error("separate the train CLI's args with `--`")
    split = argv.index("--")
    args = p.parse_args(argv[:split])
    return args, argv[split + 1:]


def model_path_of(train_args):
    for flag in ("-m", "--model_path"):
        if flag in train_args:
            return train_args[train_args.index(flag) + 1]
    return None


def run_once(train_args, log_f):
    """Launch the train CLI in its own process group; return the Popen."""
    cmd = [sys.executable, "-m", "gsplat_tpu_torch.cli.train"] + train_args
    # unbuffered child stdout: into a file the child would buffer 8 KB
    # chunks, and progress could sit unflushed long enough to read as a stall
    path = os.pathsep.join(p for p in (PACKAGE_ROOT, os.environ.get("PYTHONPATH")) if p)
    env = {**os.environ, "PYTHONUNBUFFERED": "1", "PYTHONPATH": path}
    return subprocess.Popen(
        cmd, stdout=log_f, stderr=subprocess.STDOUT, start_new_session=True, env=env
    )


def kill_group(proc):
    """Kill exactly the child's process group (never by pattern)."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def main(argv=None):
    args, train_args = parse_args(argv if argv is not None else sys.argv[1:])
    model_path = model_path_of(train_args)
    if not model_path:
        print("supervisor: train args must include -m/--model_path", file=sys.stderr)
        return 2
    os.makedirs(model_path, exist_ok=True)
    log_path = args.log or os.path.join(model_path, "train_supervised.log")
    rolling = os.path.join(model_path, "rolling_chkpnt.pkl")
    base_args = list(train_args) + ["--checkpoint_every", str(args.checkpoint_every)]

    def mtime():
        return os.path.getmtime(rolling) if os.path.exists(rolling) else 0.0

    restarts = 0
    while True:
        cur_args = list(base_args)
        if restarts > 0 and os.path.exists(rolling):
            cur_args += ["--start_checkpoint", rolling]
        with open(log_path, "ab", buffering=0) as log_f:
            log_f.write(f"\n===== supervisor: attempt {restarts + 1} =====\n".encode())
            proc = run_once(cur_args, log_f)
            deadline = time.time() + args.startup_grace
            last_size, last_ckpt = os.path.getsize(log_path), mtime()
            while True:
                try:
                    rc = proc.wait(timeout=POLL_S)
                    break
                except subprocess.TimeoutExpired:
                    pass
                # progress = log growth or a fresh rolling checkpoint (quiet
                # runs print nothing between their test iterations)
                size, ckpt = os.path.getsize(log_path), mtime()
                if size != last_size or ckpt != last_ckpt:
                    last_size, last_ckpt = size, ckpt
                    deadline = time.time() + args.stall_timeout
                if time.time() > deadline:
                    print(f"supervisor: stall ({args.stall_timeout:.0f}s silent) — "
                          f"killing pid {proc.pid}", flush=True)
                    log_f.write(b"\n===== supervisor: STALL, killing =====\n")
                    kill_group(proc)
                    rc = None
                    break
        if rc == 0:
            print("supervisor: training completed", flush=True)
            return 0
        restarts += 1
        if restarts > args.max_restarts:
            print("supervisor: max restarts exhausted", file=sys.stderr)
            return 1
        why = f"exit {rc}" if rc is not None else "stall"
        resume = rolling if os.path.exists(rolling) else "scratch"
        print(f"supervisor: restart {restarts} ({why}; resume from {resume})", flush=True)
        time.sleep(RESTART_PAUSE_S)


if __name__ == "__main__":
    sys.exit(main())
