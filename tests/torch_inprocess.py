"""What the port's test files share to run cheaply beside each other.

``run``: a stand-in for ``subprocess.run`` that runs a drive leg's command
(``python -m MODULE ARGS...``, as ``axcnn_torch.drives.common`` builds it)
in this process: ``MODULE.main(ARGS)``, its output where the child's would
go, its exit code from ``SystemExit`` or an int ``main`` returns; any other
command runs as it would. The toy drive tests patch it in for
``subprocess.run`` so that their CLI legs cost no interpreter start-up; a
leg that starts ranks still spawns them.

``capped_threads``: a module fixture (``capped_threads =
torch_inprocess.capped_threads`` in a test file makes it that file's, and
autouse there) that gives torch ``THREADS`` intra-op threads in the test
process and, through ``OMP_NUM_THREADS``, in every process it starts (Gloo
ranks, CLI subprocesses, spawned ranks), for the file's duration. The
port's tests run at toy sizes in parallel workers: a thread pool on every
core in each worker and each rank spins against the others' and multiplies
the CPU seconds a test burns, while one thread loses little on tensors
this small.
"""

import contextlib
import importlib
import io
import subprocess
import sys

import pytest
import torch

_RUN = subprocess.run
THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def capped_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", str(THREADS))
        mp.setenv("MKL_NUM_THREADS", str(THREADS))
        yield
    torch.set_num_threads(threads)


def run(cmd, *args, stdout=None, stderr=None, capture_output=False, **kw):
    if list(cmd[:2]) != [sys.executable, "-m"]:
        return _RUN(cmd, *args, stdout=stdout, stderr=stderr, capture_output=capture_output,
                    **kw)
    module, args = cmd[2], list(cmd[3:])
    out = io.StringIO() if capture_output else stdout
    err = io.StringIO() if capture_output else (out if stderr == subprocess.STDOUT else stderr)
    with contextlib.ExitStack() as stack:
        if out is not None:
            stack.enter_context(contextlib.redirect_stdout(out))
        if err is not None:
            stack.enter_context(contextlib.redirect_stderr(err))
        try:
            code = importlib.import_module(module).main(args)
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else int(e.code is not None)
    code = code if isinstance(code, int) else 0
    if capture_output:
        return subprocess.CompletedProcess(cmd, code, out.getvalue(), err.getvalue())
    return subprocess.CompletedProcess(cmd, code)
