"""Count the float32 instructions of the port's compiled kernels.

    python -m nrdsample_tpu_torch.sass_ops [--out DIR]

Builds the kernels' library (``ops/_kernels.build``), disassembles it with
``cuobjdump -sass`` and, per kernel, counts the float32 ALU and MUFU
instructions (``FADD``, ``FMUL``, ``FFMA``, ``FMNMX``, ``FSETP``, ``FSEL``,
``FSET``, ``FCHK``, ``FRND``, ``FSWZADD`` and ``MUFU``; integer, load and
control instructions do not count) on the kernel's main path, in each of
its loops and in the slow-path subroutines that the IEEE divide calls only
for operands outside its fast range. These are the operation counts behind
``chip_smoke.py``'s bounds: the instructions the card issues for a
Möller-Trumbore test or a denoised pixel, each ``expf``, ``powf``,
``sqrtf`` and divide as the sequence it compiles to. ``--out`` also writes
each kernel's disassembly there. Needs the CUDA toolkit (``nvcc`` and
``cuobjdump``), not a card.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess

from nrdsample_tpu_torch.ops import _kernels

FP32 = {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK", "FRND", "FSWZADD",
        "MUFU", "FADD32I", "FMUL32I", "FFMA32I"}
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)"
                   r"([^;]*);")
_LABEL = re.compile(r"^\s*([.$\w]+):\s*$")
_TARGET = re.compile(r"`?\(?(\.L_x_\d+|\$[\w$.]+|0x[0-9a-f]+)\)?`?")


def disassemble(lib: str) -> dict[str, list[str]]:
    """{kernel (mangled name): its SASS lines} of the library."""
    tool = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return funcs


def parse(lines: list[str]):
    """(instructions [(address, opcode, modifiers, operands)], labels
    {name: address})."""
    insns, labels, pending = [], {}, []
    for line in lines:
        lm = _LABEL.match(line)
        if lm:
            pending.append(lm.group(1))
            continue
        m = _INSN.search(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for lab in pending:
            labels[lab] = addr
        pending = []
        insns.append((addr, m.group(2), m.group(3), m.group(4)))
    return insns, labels


def _target(operands: str, labels: dict) -> int | None:
    m = _TARGET.search(operands.strip())
    if not m:
        return None
    t = m.group(1)
    return int(t, 16) if t.startswith("0x") else labels.get(t)


def analyse(lines: list[str]) -> dict:
    """Counters of float32 opcodes (MUFU with its function) of one kernel:
    its main path (what is not a subroutine), the part of it outside every
    loop, each loop (a backward branch's range; nested loops are counted in
    each loop that holds them) and the subroutines that CALLs reach (the
    slow paths of the IEEE divide and sqrt, which run only for operands
    outside the fast path's range)."""
    insns, labels = parse(lines)
    calls = [_target(ops, labels) for _, op, _, ops in insns if op == "CALL"]
    rets = [a for a, op, _, _ in insns if op == "RET"]
    subs = sorted({(t, min((r for r in rets if r >= t), default=t)) for t in calls
                   if t is not None})

    def in_sub(a):
        return any(lo <= a <= hi for lo, hi in subs)

    loops = sorted({(t, a) for a, op, _, ops in insns if op == "BRA" and not in_sub(a)
                    for t in [_target(ops, labels)] if t is not None and t < a})

    def count(keep):
        c = collections.Counter()
        for a, op, mods, _ in insns:
            if op in FP32 and keep(a):
                c[op + (mods if op == "MUFU" else "")] += 1
        return c

    return {
        "main": count(lambda a: not in_sub(a)),
        "outside_loops": count(lambda a: not in_sub(a)
                               and not any(lo <= a <= hi for lo, hi in loops)),
        "loops": [(lo, hi, count(lambda a, lo=lo, hi=hi: lo <= a <= hi)) for lo, hi in loops],
        "subroutines": [(lo, hi, sum(t == lo for t in calls),
                         count(lambda a, lo=lo, hi=hi: lo <= a <= hi)) for lo, hi in subs],
    }


def short(name: str) -> str:
    """The kernel's own name in its mangled one: the shortest
    length-prefixed identifier ending in _kernel (a namespace hash's digits
    may run into the length, or read as one)."""
    found = []
    for m in re.finditer(r"\d+", name):
        for i in range(m.start(), m.end()):
            n = int(name[i:m.end()])
            ident = name[m.end():m.end() + n]
            if len(ident) == n and ident.endswith("_kernel"):
                found.append(ident)
    return min(found, key=len) if found else name


def _fmt(c: collections.Counter) -> str:
    return f"{sum(c.values())} {dict(sorted(c.items()))}"


def report(funcs: dict) -> list[str]:
    out = []
    for name, lines in sorted(funcs.items(), key=lambda kv: short(kv[0])):
        a = analyse(lines)
        out.append(f"{short(name)}: main path {_fmt(a['main'])}; outside its loops "
                   f"{_fmt(a['outside_loops'])}")
        for lo, hi, c in a["loops"]:
            rcp = c.get("MUFU.RCP", 0)
            per = f" ({sum(c.values()) / rcp:.2f} per MUFU.RCP)" if rcp else ""
            out.append(f"  loop 0x{lo:04x}-0x{hi:04x}: {_fmt(c)}{per}")
        for lo, hi, n_calls, c in a["subroutines"]:
            out.append(f"  subroutine 0x{lo:04x}-0x{hi:04x} ({n_calls} call sites): {_fmt(c)}")
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", help="directory for each kernel's disassembly")
    args = p.parse_args()
    funcs = disassemble(_kernels.build(verbose=True))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        for name, lines in funcs.items():
            with open(os.path.join(args.out, short(name) + ".sass"), "w") as f:
                f.write("\n".join(lines) + "\n")
    print("\n".join(report(funcs)))


if __name__ == "__main__":
    main()
