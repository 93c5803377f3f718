"""What nvcc compiled: per kernel of the port's library, counts of the
SASS instructions that show whether a walk's work is there (cuobjdump
-sass; the CUDA toolkit's bin/ or PATH). An ablation that nvcc had
reduced to nothing would show fewer exponentials (MUFU.EX2), shuffles
(SHFL.BFLY) or loads than the kernel it ablates.

    python -m gsjax_torch.tools.sass_summary [library.so]

Without an argument it builds the package's kernels and reads that
library. Prints one JSON line per kernel.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

OPCODES = ("MUFU.EX2", "SHFL.BFLY", "FFMA", "LDG", "STG", "LDS", "STS", "BAR",
           "BRA", "LDL", "STL")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    path = "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(path):
        return path
    raise SystemExit("sass_summary: cuobjdump not found")


def summarize(sass: str) -> dict[str, dict[str, int]]:
    """{kernel's mangled name: {opcode: count, "instructions": n}}."""
    out = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = block.split("\n", 1)
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9.]*)", body)
        counts = {op: sum(1 for o in ops if o == op or o.startswith(op + "."))
                  for op in OPCODES}
        counts["instructions"] = len(ops)
        out[name.strip()] = counts
    return out


def main() -> None:
    if len(sys.argv) > 1:
        lib = sys.argv[1]
    else:
        from gsjax_torch.render import kernels

        lib = str(kernels.build())
    sass = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    for name, counts in sorted(summarize(sass).items()):
        print(json.dumps({"kernel": name, **counts}), flush=True)


if __name__ == "__main__":
    main()
