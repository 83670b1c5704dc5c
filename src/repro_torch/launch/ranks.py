"""Start the ranks of a multi-process run on one host.

``spawn_ranks(cmd, world)`` runs ``python <cmd> --rank r --init-file F``
for r in 0..world-1, all joined through the file F in a temporary
directory (``torch.distributed``'s ``file://`` rendezvous: no network),
and returns the largest exit code. The training launcher and the
clustering examples start their ranks this way.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile


def spawn_ranks(cmd: list[str], world: int) -> int:
    env = dict(os.environ, OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "1"))
    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "init")
        procs = [subprocess.Popen([sys.executable, *cmd, "--rank", str(r), "--init-file", init],
                                  env=env) for r in range(world)]
        try:
            return max(p.wait() for p in procs)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
