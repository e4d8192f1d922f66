"""Shared libraries compiled from the repo's sources at first use.

Each library's file name carries a key: the hash of everything that went
into it (sources, headers, compiler, flags), so a changed input builds a new
library and an unchanged one is reused. The compiles of one call all start
together. Each compiles to a name of its own (the process id) and is renamed
into place, so processes that build the same library at once never load a
half-written file. A failed compile raises with the compiler's output;
nothing falls back to another implementation.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import Iterable, Mapping, Sequence


def keyed_library(build_dir: Path, name: str, inputs: Iterable[bytes]) -> Path:
    """build_dir/lib<name>-<key>.so, the key a hash of `inputs`."""
    digest = hashlib.sha256()
    for blob in inputs:
        digest.update(blob)
    return Path(build_dir) / f"lib{name}-{digest.hexdigest()[:16]}.so"


def compile_libraries(jobs: Mapping[Path, Sequence[str]], keep_log: bool = False) -> None:
    """Build each library in `jobs` (its path -> the compiler's command
    without `-o`) that does not exist yet, all compiles started together.
    With `keep_log` the compiler's output sits beside each library as
    `.log`. Raises RuntimeError with the output of every failed compile."""
    todo = {Path(lib): cmd for lib, cmd in jobs.items() if not Path(lib).exists()}
    procs = {}
    for lib, cmd in todo.items():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        procs[lib] = (cmd, tmp, subprocess.Popen([*cmd, "-o", str(tmp)], stdout=subprocess.PIPE,
                                                 stderr=subprocess.PIPE, text=True))
    failed = []
    for lib, (cmd, tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{os.path.basename(cmd[0])} failed on {cmd[-1]} (rc {proc.returncode}):\n{stdout}\n{stderr}")
            continue
        if keep_log:
            lib.with_suffix(".log").write_text(stdout + stderr)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
