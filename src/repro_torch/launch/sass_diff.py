"""Compares the machine code of the kernels in two builds of the kernel library.

    python -m repro_torch.launch.sass_diff OTHER_ROOT [--only NAME ...]

Builds (or finds cached) the kernel library of this checkout and of the
checkout at ``OTHER_ROOT`` (each from its own ``csrc/``, with ``nvcc`` on the
card), disassembles both with ``cuobjdump -sass`` and compares every kernel
of this build with the kernel of the same demangled name in the other one.
A kernel whose name gained a trailing ``float`` template argument
(``k<1, float>`` where the other build has ``k<1>``) is compared with the
shorter name.
Addresses are dropped and kernel-parameter offsets (``c[0x0][...]``) are
masked, so each kernel is reported as ``same``, ``same but for parameter
offsets``, ``differs`` (with the number of differing instructions) or
``new``. Prints one line a kernel, then one JSON object.
"""
from __future__ import annotations

import argparse
import difflib
import json
import os
import re
import shutil
import subprocess
import sys

_FUNC = re.compile(r"^\s*Function : (\S+)\s*$")
_INSN = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(.*?;)")
_PARAM = re.compile(r"c\[0x0\]\[0x[0-9a-f]+\]")


def _tool(name: str) -> str:
    found = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not os.path.exists(found):
        raise SystemExit(f"{name} not found")
    return found


def _library(root: str) -> str:
    """Path of the kernel library built from ``root``'s sources."""
    code = ("from repro_torch.kernels.common import build_info, library; library(); "
            "print(build_info()['path'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": os.path.join(root, "src")}, check=True)
    return out.stdout.strip().splitlines()[-1]


def _kernels(lib: str) -> dict[str, list[str]]:
    """Demangled kernel name (parameter list dropped) -> its instructions."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    funcs: dict[str, list[str]] = {}
    current = None
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            current = m.group(1)
            funcs[current] = []
        elif current is not None:
            i = _INSN.match(line)
            if i:
                funcs[current].append(" ".join(i.group(1).split()))
    names = subprocess.run([_tool("cu++filt")], input="\n".join(funcs), capture_output=True,
                           text=True, check=True).stdout.splitlines()
    return {_name(n): funcs[m] for m, n in zip(funcs, names)}


def _name(signature: str) -> str:
    """``void k<(int)1, float>(DiagRuns, ...)`` -> ``k<(int)1, float>``."""
    sig = signature.strip().removeprefix("void ")
    depth = 0
    for i in range(len(sig) - 1, -1, -1):  # the parameter list: the last balanced (...)
        depth += {")": 1, "(": -1}.get(sig[i], 0)
        if depth == 0 and sig[i] == "(":
            return sig[:i]
    return sig


def _shorter(name: str) -> str | None:
    """``k<1, float>`` -> ``k<1>``; None unless the last argument is float."""
    return name.removesuffix(", float>") + ">" if name.endswith(", float>") else None


def compare(mine: dict[str, list[str]], other: dict[str, list[str]]) -> dict[str, str]:
    out = {}
    for name, code in sorted(mine.items()):
        ref = other.get(name)
        if ref is None and _shorter(name) in other:
            ref = other[_shorter(name)]
        if ref is None:
            out[name] = "new"
        elif code == ref:
            out[name] = "same"
        elif [_PARAM.sub("c[0x0][P]", c) for c in code] == [_PARAM.sub("c[0x0][P]", c)
                                                             for c in ref]:
            out[name] = "same but for parameter offsets"
        else:
            diff = [d for d in difflib.ndiff(ref, code) if d[:1] in "+-"]
            out[name] = f"differs ({len(diff)} instructions, {len(ref)} -> {len(code)})"
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other_root", help="root of the checkout to compare with")
    ap.add_argument("--only", nargs="*", default=None,
                    help="report only kernels whose name contains one of these")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    result = compare(_kernels(_library(here)),
                     _kernels(_library(os.path.abspath(args.other_root))))
    if args.only:
        result = {k: v for k, v in result.items() if any(s in k for s in args.only)}
    for name, verdict in result.items():
        print(f"{name}: {verdict}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
