"""Fault-tolerant training demo on the port: train, inject a node failure,
auto-resume, verify the loss trajectory is seamless.

Twin of ``examples/train_resume.py``::

    PYTHONPATH=src python examples/torch_train_resume.py                # cuda
    PYTHONPATH=src python examples/torch_train_resume.py --device cpu

Run 1 trains xlstm-125m's smoke config for 30 steps, fails (injected) at
step 17 and recovers in process from the step-10 snapshot.  Run 2 is a
fresh process (``python -m repro_torch.launch.train``) asked for 40 steps:
it resumes from run 1's last snapshot (step 29) and trains the rest.
"""
import argparse
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

from repro_torch.core.columnar import resolve_device
from repro_torch.launch import train as train_mod

SRC = pathlib.Path(train_mod.__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where training runs: cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    common = ["--arch", "xlstm-125m", "--batch", "4", "--seq-len", "64",
              "--save-every", "10", "--log-every", "10",
              "--device", args.device]
    d = tempfile.mkdtemp(prefix="repro_ft_")
    try:
        print("== run 1: fails (injected) at step 17, recovers in-process ==",
              flush=True)
        train_mod.main(["--steps", "30", "--fail-at", "17", "--ckpt-dir", d,
                        *common])
        print("== run 2: fresh process auto-resumes from the last snapshot ==",
              flush=True)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            filter(None, (str(SRC), os.environ.get("PYTHONPATH")))))
        rc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                             "--steps", "40", "--ckpt-dir", d, *common],
                            env=env).returncode
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
