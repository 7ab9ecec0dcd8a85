"""Whether two builds of the kernels compiled a kernel to the same code.

    python3 tools/sass_diff.py LIB_A LIB_B PATTERN [PATTERN ...]

LIB_A and LIB_B are two builds of the port's kernel library
(colmap_tpu_torch/_build/libcolmap_tpu_torch_*.so, from two checkouts).
cuobjdump (the CUDA toolkit's) disassembles both; for each function whose
mangled name holds one of the PATTERNs, the script prints whether its SASS
is the same in both, instruction for instruction, and exits 1 if any
differs or is missing from one of them.
"""

import re
import shutil
import subprocess
import sys
from pathlib import Path


def functions(lib):
    """{mangled name: SASS lines} of a library, addresses and encodings
    dropped."""
    tool = shutil.which("cuobjdump") or str(Path("/usr/local/cuda/bin/cuobjdump"))
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            out[name].append(re.sub(r"/\*[0-9a-f]{4}\*/|/\* 0x[0-9a-f]+ \*/", "", line).strip())
    return out


def main():
    a, b, patterns = sys.argv[1], sys.argv[2], sys.argv[3:]
    fa, fb = functions(a), functions(b)
    bad = False
    for name in sorted(set(fa) | set(fb)):
        if not any(p in name for p in patterns):
            continue
        same = name in fa and name in fb and fa[name] == fb[name]
        bad |= not same
        print(f"{'same' if same else 'DIFFERS'} {len(fa.get(name, []))} / "
              f"{len(fb.get(name, []))} instructions: {name}")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
