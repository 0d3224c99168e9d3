"""A stand-in for ``subprocess.run`` that runs a drive leg's command
(``python -m MODULE ARGS...``, as ``axcnn_torch.drives.common`` builds it)
in this process: ``MODULE.main(ARGS)``, its output where the child's would
go, its exit code from ``SystemExit`` or an int ``main`` returns; any other
command runs as it would. The toy drive tests patch it in for
``subprocess.run`` so that their CLI legs cost no interpreter start-up; a
leg that starts ranks still spawns them."""

import contextlib
import importlib
import io
import subprocess
import sys

_RUN = subprocess.run


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
