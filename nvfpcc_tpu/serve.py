"""Warm-process command server: run many CLI commands in one process.

Every fresh process pays XLA compiles (or persistent-cache loads) for its
programs; a long-lived server pays them once and then encodes/decodes warm —
the production serving mode the reference (one-shot research scripts) has no
analog for.

Protocol: one JSON object per stdin line, ``{"cmd": "<subcommand>",
"args": ["--flag", "value", ...]}`` using the exact ``nvfpcc_tpu.cli``
argument surface. One JSON response per line on stdout:
``{"ok": true, "status": 0}`` or ``{"ok": false, "error": "..."}``.
Human-readable command output is redirected to stderr. An empty line or
``{"cmd": "quit"}`` stops the server.

Usage:
    python -m nvfpcc_tpu.serve < commands.jsonl
    # or interactively / from a pipe:
    echo '{"cmd": "decode", "args": ["pack.pk", "--recon", "out.ply"]}' \
        | python -m nvfpcc_tpu.serve
"""

from __future__ import annotations

import contextlib
import json
import sys


def handle(req: dict) -> dict:
    from nvfpcc_tpu.cli import main

    cmd = req.get("cmd")
    if not isinstance(cmd, str):
        return {"ok": False, "error": "missing 'cmd'"}
    args = req.get("args", [])
    if not isinstance(args, list) or not all(isinstance(a, str) for a in args):
        return {"ok": False, "error": "'args' must be a list of strings"}
    try:
        with contextlib.redirect_stdout(sys.stderr):
            status = main([cmd] + args)
        return {"ok": True, "status": int(status or 0)}
    except SystemExit as e:  # argparse errors and CLI raise SystemExit
        return {"ok": False, "error": f"exit: {e.code}"}
    except Exception as e:  # noqa: BLE001 — server must not die on one request
        return {"ok": False, "error": f"{type(e).__name__}: {e}"}


def serve(stream_in=None, stream_out=None) -> None:
    from nvfpcc_tpu.utils.cache import enable_compilation_cache, enable_hang_diagnostics

    enable_compilation_cache()
    enable_hang_diagnostics()
    stream_in = stream_in if stream_in is not None else sys.stdin
    stream_out = stream_out if stream_out is not None else sys.stdout
    for line in stream_in:
        line = line.strip()
        if not line:
            break
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            resp = {"ok": False, "error": f"bad json: {e}"}
        else:
            if req.get("cmd") == "quit":
                break
            resp = handle(req)
        stream_out.write(json.dumps(resp) + "\n")
        stream_out.flush()


if __name__ == "__main__":
    serve()
